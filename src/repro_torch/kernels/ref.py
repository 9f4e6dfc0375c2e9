"""Plain PyTorch oracles, the port's copy of the reference's ``kernels/ref.py``.

Intentionally simple and dense — tests compare kernels and chunked paths
against them at small sizes; production paths never call them.
"""
from __future__ import annotations

import torch


def swap_argmin_ref(w, m, c, G):
    """Jointly-best 1-swap per row via the dense ΔL matrix; ties to the
    smallest flat index u·d + p, a NaN ΔL read as +inf (the port's rule;
    the reference's copy lets a NaN win). Returns (dl*, u*, p*) each
    (R,)."""
    w32 = w.float()
    c32 = c.float()
    g_diag = torch.diagonal(G).float()
    quad = (w32 * w32) * g_diag[None, :]
    a = torch.where(m > 0.5, 2.0 * w32 * c32 + quad, float("inf"))
    b = torch.where(m > 0.5, float("inf"), -2.0 * w32 * c32 + quad)
    inter = 2.0 * torch.einsum("ru,rp,up->rup", w32, w32, G.float())
    dl = a[:, :, None] + b[:, None, :] - inter
    dl = torch.where(torch.isnan(dl), float("inf"), dl)   # NaN never wins
    R, d, _ = dl.shape
    flat = dl.reshape(R, d * d)
    idx = torch.argmin(flat, dim=1)
    best = flat.gather(1, idx[:, None])[:, 0]
    return best, idx // d, idx % d


def masked_matmul_ref(x, w, mask):
    """y = x @ (mask ⊙ w)ᵀ in fp32 — pruned-layer forward.
    x: (B, d_in); w, mask: (d_out, d_in)."""
    wm = (w * mask).float()
    return x.float() @ wm.T


def gram_xtx_ref(x):
    """Xᵀ X with fp32 accumulation. x: (..., tokens, d) any float dtype."""
    x32 = x.reshape(-1, x.shape[-1]).float()
    return x32.T @ x32


def gram_accum_ref(G, x):
    """G + xᵀ x with fp32 accumulation. x: (tokens, d) any float dtype."""
    x32 = x.float()
    return G.float() + x32.T @ x32
