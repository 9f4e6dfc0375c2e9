"""Sparsity patterns and mask utilities.

Masks follow the paper's convention: ``m == 1`` keeps a weight, ``m == 0``
prunes it. Two pattern families, both row-separable (paper §2.1.1):

* ``PerRow(sparsity)`` — keep exactly the same number of weights in every
  row ("unstructured" with equal per-row sparsity, as Wanda enforces).
* ``NM(n, m)`` — keep n out of every m consecutive weights (e.g. 2:4).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PerRow:
    """Keep ``d_in - round(sparsity * d_in)`` weights per row."""

    sparsity: float  # fraction pruned, e.g. 0.6

    def keep_per_row(self, d_in: int) -> int:
        return d_in - int(round(self.sparsity * d_in))

    def block(self, d_in: int) -> int | None:
        return None

    def describe(self) -> str:
        return f"per-row {self.sparsity:.0%}"


@dataclasses.dataclass(frozen=True)
class NM:
    """N:M semi-structured sparsity — keep n per block of m."""

    n: int
    m: int

    def keep_per_row(self, d_in: int) -> int:
        if d_in % self.m:
            raise ValueError(f"d_in={d_in} not divisible by M={self.m}")
        return d_in // self.m * self.n

    def block(self, d_in: int) -> int | None:
        return self.m

    @property
    def sparsity(self) -> float:
        return 1.0 - self.n / self.m

    def describe(self) -> str:
        return f"{self.n}:{self.m}"


Pattern = PerRow | NM


def parse_pattern(spec: Pattern | str | float) -> Pattern:
    """Parse a pattern spec: ``"0.6"``/``0.6`` -> PerRow, ``"2:4"`` -> NM."""
    if isinstance(spec, (PerRow, NM)):
        return spec
    if isinstance(spec, (int, float)):
        return PerRow(float(spec))
    s = spec.strip()
    if ":" in s:
        try:
            n, m = (int(x) for x in s.split(":"))
        except ValueError:
            raise ValueError(f"bad N:M pattern spec {spec!r}") from None
        if not (0 < n <= m):
            raise ValueError(f"bad N:M pattern spec {spec!r}: need 0 < n <= m")
        return NM(n, m)
    try:
        frac = float(s)
    except ValueError:
        raise ValueError(f"bad pattern spec {spec!r} "
                         "(want a sparsity fraction or 'n:m')") from None
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"sparsity {frac} outside [0, 1]")
    return PerRow(frac)


def format_pattern(pattern: Pattern) -> str:
    """Inverse of :func:`parse_pattern`."""
    if isinstance(pattern, NM):
        return f"{pattern.n}:{pattern.m}"
    return repr(pattern.sparsity)


def _topk_keep(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Keep the ``keep`` highest scores along the last dim; among tied
    scores at the threshold the lowest indices win. Returns a float mask."""
    kth = torch.sort(scores, dim=-1, descending=True).values[..., keep - 1:keep]
    mask = scores >= kth
    surplus = mask.sum(-1, keepdim=True) - keep
    tied = (scores == kth) & mask
    tie_rank = torch.cumsum(tied.to(torch.int64), dim=-1)   # 1-based
    n_tied = tied.sum(-1, keepdim=True)
    drop = tied & (tie_rank > (n_tied - surplus))
    return (mask & ~drop).to(torch.float32)


def topk_mask_per_row(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Keep the ``keep`` highest-score entries per row. (R, d) -> float mask."""
    d = scores.shape[-1]
    if keep >= d:
        return torch.ones_like(scores, dtype=torch.float32)
    if keep <= 0:
        return torch.zeros_like(scores, dtype=torch.float32)
    return _topk_keep(scores, keep)


def topk_mask_nm(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Keep the n highest-score entries in each length-m block per row."""
    *lead, d = scores.shape
    s = scores.reshape(*lead, d // m, m)
    return _topk_keep(s, n).reshape(*lead, d)


def make_mask(scores: torch.Tensor, pattern: Pattern) -> torch.Tensor:
    """Build a warmstart mask from saliency scores (higher = keep)."""
    if isinstance(pattern, NM):
        return topk_mask_nm(scores, pattern.n, pattern.m)
    return topk_mask_per_row(scores, pattern.keep_per_row(scores.shape[-1]))


def validate_mask(mask: torch.Tensor, pattern: Pattern) -> bool:
    """Check a mask satisfies the pattern's constraints exactly."""
    d_in = mask.shape[-1]
    keep = pattern.keep_per_row(d_in)
    if not bool(torch.all(mask.sum(-1) == keep)):
        return False
    blk = pattern.block(d_in)
    if blk is not None:
        per_block = mask.reshape(*mask.shape[:-1], d_in // blk, blk).sum(-1)
        if not bool(torch.all(per_block == pattern.n)):
            return False
    return True


def sparsity_of(mask: torch.Tensor) -> float:
    return float(1.0 - mask.float().mean())
