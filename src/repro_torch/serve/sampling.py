"""Token sampling: temperature / top-k / top-p, per-request seeds.

The sampling layer of the serving stack. Every knob is a (B,) tensor (one
value per batch slot), so one decode step serves mixed sampling configs:
one request greedy, its neighbour at T=0.9 top-p.

Determinism contract, as in the reference (the scheduler's correctness
tests lean on it):

* the PRNG key for the token at absolute position ``t`` is
  ``fold_in(key(seed), t)``, a pure function of (request seed, position):
  a request samples the same stream alone, batched with strangers, or
  after leaving the decode batch and rejoining it;
* greedy is the ``temperature == 0`` case of the same code (a
  ``torch.where`` on the temperature), not a separate path;
* ties break deterministically: the sort is stable and the draw is a pure
  function of (key, logits).

The PRNG is the reference's threefry2x32 (``_threefry``): the bits and
the uniforms equal JAX's exactly, the Gumbel noise is within a few ulp
(another ``log``). A draw can part from the reference's only where the two
best perturbed scores lie that close, or where softmax and cumsum in
another order move a top-p boundary.

``top_k == 0`` disables the top-k filter; ``top_p >= 1`` disables the
nucleus filter. Top-k applies first, then top-p over the renormalised
survivors. When the caller knows on the host that every row is greedy
(``params_arrays`` records it as ``samp["greedy"]``), ``sample`` takes
the argmax alone: the same tokens, without the sort and the noise.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _threefry

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling config. Defaults are pure greedy."""

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0

    def validate(self) -> "SamplingParams":
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        return self


GREEDY = SamplingParams()


def params_arrays(params: list[SamplingParams], device="cpu") -> dict:
    """Stack per-request params into the (B,) tensors ``sample`` reads,
    plus ``greedy``: whether every row is greedy (a host bool)."""
    return {
        "temp": torch.tensor([p.temperature for p in params],
                             dtype=torch.float32, device=device),
        "top_p": torch.tensor([p.top_p for p in params],
                              dtype=torch.float32, device=device),
        "top_k": torch.tensor([p.top_k for p in params], dtype=torch.int64,
                              device=device),
        "seed": torch.tensor([p.seed & 0xFFFFFFFF for p in params],
                             dtype=torch.int64, device=device),
        "greedy": all(p.temperature <= 0 for p in params),
    }


def perturbed_scores(logits, temp, top_p, top_k, seed, t):
    """The Gumbel-perturbed scores a draw takes the argmax of.

    logits (B, V), per-slot knobs (B,) (or scalars) -> ``(scores, order,
    before)``, each (B, V) over the vocabulary sorted by descending logit
    (``order`` maps back to token ids): the temperature-scaled logits
    plus the Gumbel noise of ``fold_in(key(seed), t)``, -1e30 where top-k
    or top-p drops a token, and each token's preceding nucleus mass
    (``before``, which top-p compares with ``top_p``).
    """
    logits = logits.float()
    B, V = logits.shape
    dev = logits.device
    col = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev) \
        .expand(B).reshape(B, 1)
    temp, top_p = col(temp, torch.float32), col(top_p, torch.float32)
    top_k = col(top_k, torch.int64)
    order = torch.sort(-logits, dim=-1, stable=True).indices
    ls = torch.gather(logits, -1, order) / torch.clamp_min(temp, 1e-6)
    ranks = torch.arange(V, device=dev)[None, :]
    keep = torch.where(top_k > 0, ranks < top_k, True)
    probs = torch.softmax(torch.where(keep, ls, _NEG), dim=-1)
    # nucleus: keep tokens whose preceding cumulative mass is < top_p
    # (the first token always survives; the one crossing top_p is kept)
    before = torch.cumsum(probs, dim=-1) - probs
    keep = keep & torch.where(top_p < 1.0, before < top_p, True)
    key = _threefry.fold_in(
        _threefry.seed_key(col(seed, torch.int64)[:, 0]),
        col(t, torch.int64)[:, 0])
    noise = _threefry.gumbel(_threefry.random_bits(key, V))
    return noise + torch.where(keep, ls, _NEG), order, before


def sample_tokens(logits, temp, top_p, top_k, seed, t) -> torch.Tensor:
    """Batched sampling: logits (B, V), per-slot knobs (B,) (or scalars)
    -> (B,) int64 tokens.

    ``t`` is the absolute sequence position of the token being sampled
    (per slot): with the seed, the only PRNG input.
    """
    scores, order, _ = perturbed_scores(logits, temp, top_p, top_k, seed, t)
    idx = torch.argmax(scores, dim=-1)
    sampled = torch.gather(order, -1, idx[:, None])[:, 0]
    greedy = torch.argmax(logits.float(), dim=-1)
    temp = torch.as_tensor(temp, device=logits.device).expand(
        logits.shape[0])
    return torch.where(temp <= 0.0, greedy, sampled)


def sample(logits, samp: dict, t, rows: int | None = None) -> torch.Tensor:
    """``sample_tokens`` with the knobs of a ``params_arrays`` dict (its
    first ``rows`` slots when given); the argmax alone when
    ``samp["greedy"]``."""
    if samp.get("greedy", False):
        return torch.argmax(logits, dim=-1)
    cut = (lambda x: x) if rows is None else (lambda x: x[:rows])
    return sample_tokens(logits, cut(samp["temp"]), cut(samp["top_p"]),
                         cut(samp["top_k"]), cut(samp["seed"]), t)


def parse_sample_flag(spec: str) -> SamplingParams:
    """'temp[,top_p[,top_k]]' -> SamplingParams (the --sample CLI flag)."""
    parts = [s.strip() for s in spec.split(",") if s.strip()]
    if not parts:
        raise ValueError(f"empty --sample spec {spec!r}")
    temp = float(parts[0])
    top_p = float(parts[1]) if len(parts) > 1 else 1.0
    top_k = int(parts[2]) if len(parts) > 2 else 0
    return SamplingParams(temperature=temp, top_p=top_p,
                          top_k=top_k).validate()
