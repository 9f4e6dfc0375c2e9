"""Public wrappers around the hand-written CUDA kernels.

Each wrapper checks device, dtype and shapes, allocates its outputs with
``torch.empty`` and then:

* a CUDA tensor launches the kernel — or raises (no build, no launch, a
  bad argument): nothing falls back to the plain version on the card;
* a CPU tensor takes the kernel's plain PyTorch version, which lives
  beside the launcher in the kernel's module.

``LAUNCHES[name]`` counts kernel launches (never plain-version calls), so
a run can show which kernels its main path went through.
"""
from __future__ import annotations

import torch

from repro_torch.core import swap_math as sm

from . import gram as gram_mod
from . import swap_argmin as argmin_mod
from . import swap_topk as topk_mod

LAUNCHES: dict[str, int] = {"gram_xtx": 0, "swap_topk": 0, "swap_argmin": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the inputs live on one CUDA device, False when all are on
    the CPU; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _check_swap_shapes(w, m, c, G) -> None:
    if w.ndim != 2 or w.shape != m.shape or w.shape != c.shape:
        raise ValueError(f"w, m, c must share one (R, d) shape: "
                         f"{tuple(w.shape)} {tuple(m.shape)} {tuple(c.shape)}")
    d = w.shape[1]
    if G.shape != (d, d):
        raise ValueError(f"G must be ({d}, {d}), got {tuple(G.shape)}")


def _swap_inputs(w, m, c, G):
    """a/b scoring and contiguous fp32 operands for the swap kernels."""
    w32 = w.float().contiguous()
    G32 = G.float().contiguous()
    a, b = sm.swap_scores(w32, m, c, torch.diagonal(G32))
    return a.contiguous(), b.contiguous(), w32, G32


def swap_argmin(w: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
                G: torch.Tensor):
    """Jointly-best 1-swap per row: (ΔL*, u*, p*) each (R,); ties to the
    smallest flat index u·d + p. Indices are int64."""
    _check_swap_shapes(w, m, c, G)
    if not _on_cuda(w, m, c, G):
        return argmin_mod.swap_argmin_plain(w, m, c, G)
    a, b, w32, G32 = _swap_inputs(w, m, c, G)
    R = w.shape[0]
    best = torch.empty(R, dtype=torch.float32, device=w.device)
    u = torch.empty(R, dtype=torch.int32, device=w.device)
    p = torch.empty(R, dtype=torch.int32, device=w.device)
    argmin_mod.launch(a, b, w32, G32, best, u, p)
    LAUNCHES["swap_argmin"] += 1
    return best, u.long(), p.long()


def swap_topk(w: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
              G: torch.Tensor, *, k: int):
    """k best candidate swaps per row: (ΔL, u, p) each (R, k), ascending by
    (ΔL, p). Equal to ``swap_math.topk_swaps_chunked`` on feasible entries;
    the +inf tail's indices are clamped into range. Indices are int64."""
    _check_swap_shapes(w, m, c, G)
    R, d = w.shape
    k = min(k, d)
    if not 1 <= k <= topk_mod.MAX_K:
        raise ValueError(f"swap_topk takes 1 <= k <= {topk_mod.MAX_K}, got {k}")
    if not _on_cuda(w, m, c, G):
        return topk_mod.swap_topk_plain(w, m, c, G, k=k)
    a, b, w32, G32 = _swap_inputs(w, m, c, G)
    vals = torch.empty((R, k), dtype=torch.float32, device=w.device)
    u = torch.empty((R, k), dtype=torch.int32, device=w.device)
    p = torch.empty((R, k), dtype=torch.int32, device=w.device)
    topk_mod.launch(a, b, w32, G32, vals, u, p, k=k)
    LAUNCHES["swap_topk"] += 1
    return vals, u.long(), p.long()


def gram_xtx(x: torch.Tensor) -> torch.Tensor:
    """Xᵀ X (fp32) for activations x: (..., tokens, d), fp32 or bf16."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram_xtx takes fp32 or bf16, got {x2.dtype}")
    x2 = x2.contiguous()
    if not _on_cuda(x2):
        return gram_mod.gram_xtx_plain(x2)
    d = x2.shape[1]
    out = torch.empty((d, d), dtype=torch.float32, device=x2.device)
    gram_mod.launch(x2, out)
    LAUNCHES["gram_xtx"] += 1
    return out
