"""Exact layer-wise pruning objective (paper Eq. 1) and error metrics."""
from __future__ import annotations

import torch

from . import swap_math as sm


def layer_loss(W: torch.Tensor, M: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """‖WX − (M⊙W)X‖_F² computed through G (scalar)."""
    return sm.row_loss(W, M, G).sum()


def layer_loss_direct(W: torch.Tensor, M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Same objective straight from X (d_in, B) — checks the Gram path."""
    E = (W - M * W).float() @ X.float()
    return (E * E).sum()


def relative_error_reduction(loss_before: torch.Tensor,
                             loss_after: torch.Tensor) -> torch.Tensor:
    """Mean relative per-row reduction, as reported in paper Tables 3/4."""
    denom = torch.clamp(loss_before, min=1e-30)
    return ((loss_before - loss_after) / denom).mean()
