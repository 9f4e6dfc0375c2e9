"""DSnoT baseline (Zhang et al., 2024b — "Dynamic Sparse No Training").

The comparison method of the paper: iterative prune-and-regrow driven by
*surrogate* statistics (per-feature means and variances of the
calibration activations) instead of the exact Gram loss, so it does not
guarantee a monotone decrease of the true pruning error. Per row:

* expected reconstruction residual  e = Σ_{j pruned} w_j μ_j;
* grow: re-activate the pruned j whose w_j μ_j best cancels e
  (variance-regularized, score = w_j μ_j / sqrt(var_j + δ));
* prune: among kept j whose removal moves e toward zero, drop the one with
  the smallest Wanda saliency |w_j|·sqrt(E[x_j²]);
* stop when |e| no longer improves in any row or after ``t_max`` cycles.

Swaps keep per-row (or within-block N:M) sparsity exactly. The
reference's ``while_loop`` is a Python loop with one host read per cycle
(does any row still improve?). ``torch.argmin`` breaks ties on the
smallest index, as ``jnp.argmin`` does.
"""
from __future__ import annotations

import torch

from . import masks as masks_lib

_DELTA = 1e-8
_INF = float("inf")


def _dsnot_rows(w, m0, mu, var, ex2, *, t_max: int, block: int | None):
    """w, m0: (R, d); mu/var/ex2: (d,) feature stats. Returns the mask."""
    R, d = w.shape
    w = w.float()
    rows = torch.arange(R, device=w.device)
    wanda = w.abs() * torch.sqrt(torch.clamp(ex2, min=0.0))[None, :]
    contrib = w * mu[None, :]                       # w_j μ_j, (R, d)
    reg = contrib / torch.sqrt(var + _DELTA)[None, :]
    if block is not None:
        blk_ids = torch.arange(d // block, device=w.device).repeat_interleave(
            block)

    m = m0.float()
    e = ((1.0 - m) * w * mu[None, :]).sum(1)        # (R,)
    t, alive = 0, True
    while t < t_max and alive:
        # grow: pruned j minimizing |e - w_j μ_j| (variance-regularized)
        cancel = (e[:, None] - contrib).abs() + _DELTA * reg.abs()
        cancel = torch.where(m < 0.5, cancel, _INF)
        grow = torch.argmin(cancel, dim=1)
        # prune: kept j, removal must move e toward 0, min Wanda score
        e_after_grow = e - contrib[rows, grow]
        moves_toward = ((e_after_grow[:, None] + contrib).abs()
                        <= e_after_grow.abs()[:, None] + _DELTA)
        score = torch.where((m > 0.5) & moves_toward, wanda, _INF)
        # fallback: if nothing moves toward zero, allow any kept weight
        score = torch.where(torch.isinf(score).all(1, keepdim=True),
                            torch.where(m > 0.5, wanda, _INF), score)
        if block is not None:
            same_blk = blk_ids[None, :] == blk_ids[grow][:, None]
            score = torch.where(same_blk, score, _INF)
        prune = torch.argmin(score, dim=1)
        ok = ~torch.isinf(score[rows, prune])
        e_new = e_after_grow + contrib[rows, prune]
        improves = (e_new.abs() < e.abs()) & ok
        m_new = m.clone()
        m_new[rows, grow] = 1.0
        m_new[rows, prune] = 0.0
        m = torch.where(improves[:, None], m_new, m)
        e = torch.where(improves, e_new, e)
        t += 1
        alive = bool(improves.any())
    return m


def dsnot(
    W: torch.Tensor,
    mask_init: torch.Tensor,
    mu: torch.Tensor,
    var: torch.Tensor,
    ex2: torch.Tensor,
    pattern: masks_lib.Pattern,
    *,
    t_max: int = 50,
    row_block: int | None = None,
) -> torch.Tensor:
    """Refine ``mask_init`` with DSnoT. ex2 = E[x_j²] (Wanda scale²)."""
    d_out, d_in = W.shape
    blk = pattern.block(d_in)
    rb = row_block or d_out
    return torch.cat([
        _dsnot_rows(W[lo:lo + rb], mask_init[lo:lo + rb], mu, var, ex2,
                    t_max=t_max, block=blk)
        for lo in range(0, d_out, rb)])
