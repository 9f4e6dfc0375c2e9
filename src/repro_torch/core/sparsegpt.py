"""SparseGPT baseline (Frantar & Alistarh, 2023).

OBS-style one-shot pruning *with weight updates*: columns are processed
left to right in blocks; in each block the lowest-score weights
(score = w_j² / [H⁻¹]_jj) are pruned and each column's error is spread
onto the not-yet-processed columns through the upper Cholesky factor of
H⁻¹. With a fixed dense calibration pass (as the paper and this repo use)
it is a valid mask + update baseline per layer.

H = G + λ·mean(diag(G))·I (1% dampening). The reference's column
``scan`` is a loop over the columns of each block; the inverse and the
Cholesky factor are ``torch.linalg`` calls, as the reference leaves them
to ``jnp.linalg``. The mask is N:M, or keeps exactly the pattern's
per-row count: block b of nb keeps keep·(b+1)//nb − keep·b//nb weights.
Where keep is a multiple of nb that is the reference's keep·blocksize//d_in
in every block; elsewhere the reference's per-block floor keeps too few
weights per row (PerRow(0.6) at d_in = 4096: 1632 of 1638) and its
executor rejects the mask, so the port departs from it there.
"""
from __future__ import annotations

import torch

from . import masks as masks_lib


def _inv_hessian_chol(G: torch.Tensor, damp: float = 0.01) -> torch.Tensor:
    """Upper Cholesky factor U of H⁻¹ (H⁻¹ = Uᵀ U)."""
    d = G.shape[0]
    G32 = G.float()
    mean_diag = torch.diagonal(G32).mean()
    H = G32 + damp * mean_diag * torch.eye(d, dtype=torch.float32,
                                           device=G.device)
    Hinv = torch.linalg.inv(H)
    return torch.linalg.cholesky(Hinv).T


def _sparsegpt_core(W, G, *, blocksize: int, keep: int, nm_n: int,
                    nm_m: int):
    d_out, d_in = W.shape
    nb = d_in // blocksize
    U = _inv_hessian_chol(G)                      # (d, d) upper
    W_cur = W.float().clone()
    M = torch.ones_like(W_cur)
    col = torch.arange(blocksize, device=W.device)
    later_of = torch.arange(d_in, device=W.device)
    for bi in range(nb):
        cols = slice(bi * blocksize, (bi + 1) * blocksize)
        Wb = W_cur[:, cols].clone()
        Ub = U[cols, cols]
        diag = torch.diagonal(Ub)
        score = (Wb / diag[None, :]) ** 2
        if nm_m > 0:
            mb = masks_lib.topk_mask_nm(score, nm_n, nm_m)
        else:
            keep_b = keep * (bi + 1) // nb - keep * bi // nb
            mb = masks_lib.topk_mask_per_row(score, keep_b)
        # sequential column sweep inside the block (OBS error propagation)
        errs = []
        for j in range(blocksize):
            w_j = Wb[:, j].clone()
            err = (w_j * (1.0 - mb[:, j])) / Ub[j, j]
            upd = err[:, None] * Ub[j][None, :]
            Wb = Wb - upd * (col > j).float()[None, :]
            Wb[:, j] = w_j * mb[:, j]
            errs.append(err)
        # propagate the block's error to every later column
        E = torch.stack(errs, dim=1)                       # (d_out, bs)
        later = (later_of >= (bi + 1) * blocksize).float()
        W_cur = W_cur - (E @ U[cols]) * later[None, :]
        W_cur[:, cols] = Wb
        M[:, cols] = mb
    return W_cur, M


def sparsegpt(W: torch.Tensor, G: torch.Tensor, pattern: masks_lib.Pattern,
              *, blocksize: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (updated fp32 weights, mask); the weights have the mask
    applied."""
    d_out, d_in = W.shape
    blocksize = min(blocksize, d_in)
    if d_in % blocksize:
        raise ValueError(f"d_in={d_in} must be divisible by "
                         f"blocksize={blocksize}")
    if isinstance(pattern, masks_lib.NM):
        nm_n, nm_m, keep = pattern.n, pattern.m, 0
    else:
        nm_n = nm_m = 0
        keep = pattern.keep_per_row(d_in)
    return _sparsegpt_core(W, G, blocksize=blocksize, keep=keep, nm_n=nm_n,
                           nm_m=nm_m)
