"""Streaming Gram-matrix accumulation (paper §2.1.2).

G = X Xᵀ (d_in × d_in) accumulates as calibration batches pass through a
layer, in fp32 whatever the activation dtype; ``update_from_acts`` takes
activations laid out (..., tokens, d_in).

* per-feature activation norms ‖X_{j,:}‖₂ (the Wanda scale) are
  sqrt(diag(G)), so no extra state is needed;
* ``GramState`` adds the feature means/variances DSnoT needs, merged with
  the Chan et al. parallel-variance update;
* ``psum_gram`` merges per-rank partial states over a process group
  (data-sharded calibration).
"""
from __future__ import annotations

import dataclasses

import torch


def update_from_acts(G: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
    """G + XᵀX from activations laid out (..., tokens, d_in)."""
    x = acts.reshape(-1, acts.shape[-1]).float()
    return G + x.T @ x


def feature_norms(G: torch.Tensor) -> torch.Tensor:
    """‖X_{j,:}‖₂ per input feature = sqrt(G_jj); ``G`` may be the (d, d)
    Gram or just its (d,) diagonal."""
    diag = G if G.ndim == 1 else torch.diagonal(G)
    return torch.sqrt(torch.clamp(diag, min=0.0))


@dataclasses.dataclass
class GramState:
    """Streaming state for one linear layer's calibration statistics."""

    G: torch.Tensor           # (d_in, d_in) fp32
    count: torch.Tensor       # scalar token count
    mean: torch.Tensor        # (d_in,) running feature mean (for DSnoT)
    m2: torch.Tensor          # (d_in,) running sum of squared deviations

    @staticmethod
    def create(d_in: int, device=None) -> "GramState":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return GramState(G=z(d_in, d_in), count=z(), mean=z(d_in), m2=z(d_in))

    def update(self, acts: torch.Tensor) -> "GramState":
        """Chan et al. parallel-variance merge of a (…, tokens, d_in) chunk."""
        x = acts.reshape(-1, acts.shape[-1]).float()
        nb = float(x.shape[0])
        G = self.G + x.T @ x
        mean_b = x.mean(0)
        m2_b = ((x - mean_b) ** 2).sum(0)
        delta = mean_b - self.mean
        tot = self.count + nb
        safe_tot = torch.clamp(tot, min=1.0)
        mean = self.mean + delta * nb / safe_tot
        m2 = self.m2 + m2_b + delta * delta * self.count * nb / safe_tot
        return GramState(G=G, count=tot, mean=mean, m2=m2)

    @property
    def variance(self) -> torch.Tensor:
        return self.m2 / torch.clamp(self.count, min=1.0)


def state_from_moments(g: torch.Tensor, s: torch.Tensor,
                       n: torch.Tensor) -> GramState:
    """Raw calibration moments (taps) -> a ``GramState``.

    ``g`` is the Gram stack (..., d, d) or its diagonal (..., d), ``s`` the
    feature sums (..., d), ``n`` the token counts (...,); ``count`` keeps a
    trailing singleton so it broadcasts against ``mean``.
    """
    g = torch.as_tensor(g, dtype=torch.float32)
    s = torch.as_tensor(s, dtype=torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32)[..., None]
    diag = g if g.shape == s.shape else torch.diagonal(g, dim1=-2, dim2=-1)
    mean = s / torch.clamp(n, min=1.0)
    m2 = diag - n * mean ** 2
    return GramState(G=g, count=n, mean=mean, m2=m2)


def moments_from_state(state: GramState) -> tuple:
    """Inverse of ``state_from_moments``: (g, s, n) raw sums."""
    n = state.count
    return state.G, state.mean * n, n[..., 0]


def psum_gram(state: GramState, group) -> GramState:
    """Combine per-rank partial Gram statistics over ``group`` (a
    ``dist.groups.Group``: data-sharded calibration).

    G, the count, Σx and Σx² are additive, so they are summed and the
    merged mean and m2 are derived again from the sums, as the reference
    does."""
    sum_x = state.mean * state.count
    sum_x2 = state.m2 + state.count * state.mean ** 2          # = Σ x²
    G = group.all_reduce(state.G)
    count = group.all_reduce(state.count)
    sum_x = group.all_reduce(sum_x)
    sum_x2 = group.all_reduce(sum_x2)
    mean = sum_x / torch.clamp(count, min=1.0)
    m2 = sum_x2 - count * mean ** 2
    return GramState(G=G, count=count, mean=mean, m2=m2)
