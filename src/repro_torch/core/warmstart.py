"""Warmstart pruning criteria: magnitude, Wanda, RIA.

Each criterion maps (W, Gram stats) -> saliency scores (higher = keep);
``masks.make_mask`` then applies the sparsity pattern.

* magnitude — |W|                                  (Han et al., 2015)
* Wanda     — |W| · ‖X_j‖₂                         (Sun et al., 2024)
* RIA       — (|W_ij| / Σ_row|W_i·| + |W_ij| / Σ_col|W_·j|) · (‖X_j‖₂)^a,
              a = 0.5 by default                    (Zhang et al., 2024a)
"""
from __future__ import annotations

import torch

from . import masks as masks_lib
from .gram import feature_norms


def magnitude_scores(W: torch.Tensor, G: torch.Tensor | None = None) -> torch.Tensor:
    return W.float().abs()


def wanda_scores(W: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    return W.float().abs() * feature_norms(G)[None, :]


def ria_scores(W: torch.Tensor, G: torch.Tensor, *, a: float = 0.5) -> torch.Tensor:
    aw = W.float().abs()
    row_sum = aw.sum(1, keepdim=True)
    col_sum = aw.sum(0, keepdim=True)
    ri = aw / torch.clamp(row_sum, min=1e-12) + aw / torch.clamp(col_sum, min=1e-12)
    return ri * feature_norms(G)[None, :] ** a


CRITERIA = {
    "magnitude": magnitude_scores,
    "wanda": wanda_scores,
    "ria": ria_scores,
}


def warmstart_mask(W: torch.Tensor, G: torch.Tensor | None,
                   pattern: masks_lib.Pattern,
                   criterion: str = "wanda") -> torch.Tensor:
    """Saliency -> pattern-constrained keep-mask."""
    fn = CRITERIA[criterion]
    if criterion == "magnitude":
        scores = fn(W)
    else:
        if G is None:
            raise ValueError(f"criterion {criterion!r} needs calibration Gram stats")
        scores = fn(W, G)
    return masks_lib.make_mask(scores, pattern)
