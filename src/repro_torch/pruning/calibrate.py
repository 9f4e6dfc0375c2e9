"""Calibration: accumulate per-layer Gram statistics in dense forward passes.

SparseSwaps (like Wanda) leaves surviving weights unchanged, so every
layer's calibration input is the *dense* model's activation: all layers'
Grams accumulate in ONE forward pass per batch (paper §2.1.2). The taps
mechanism (``models.common.dense``) emits {g, s, n} per prunable site;
summing over batches is exact because G, Σx and counts are additive.

This folds in the single-device part of the reference's ``pruning/stats``:
a ``CalibSpec`` names the statistics each tap accumulates, and its tap
policy sends every Gram contribution through ``kernels.ops.gram_xtx`` —
the CUDA kernel for activations on the card, its plain version on the
CPU. Mesh sharding, moments-only levels and accumulator checkpoints are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch.kernels import ops
from repro_torch.models import ModelApi
from repro_torch.models import common as common_lib

from . import sites as sites_lib

_FIELDS = {"none": (), "gram": ("g", "s", "n")}


@dataclasses.dataclass(frozen=True)
class CalibSpec:
    """Statistics level per emitted tap name ("gram" or "none")."""

    levels: tuple[tuple[str, str], ...]

    def __post_init__(self):
        bad = [lvl for _, lvl in self.levels if lvl not in _FIELDS]
        if bad:
            raise ValueError(f"unknown levels {bad}; have {sorted(_FIELDS)}")
        object.__setattr__(self, "levels",
                           tuple(sorted(dict(self.levels).items())))

    @classmethod
    def full(cls, cfg) -> "CalibSpec":
        """Every tap at gram level."""
        names = {tpath[-1] for _, _, tpath, _ in sites_lib._table(cfg)}
        return cls(levels=tuple((n, "gram") for n in sorted(names)))

    def policy(self) -> common_lib.TapPolicy:
        return _SpecTapPolicy(self)


class _SpecTapPolicy(common_lib.TapPolicy):
    """TapPolicy driven by a CalibSpec; Grams go through the kernel wrapper."""

    def __init__(self, spec: CalibSpec):
        self._levels = dict(spec.levels)

    def fields(self, name: str) -> tuple[str, ...]:
        return _FIELDS[self._levels.get(name, "none")]

    def gram(self, x2: torch.Tensor) -> torch.Tensor:
        return ops.gram_xtx(x2)


@dataclasses.dataclass
class CalibStats:
    """Accumulated calibration statistics: the model-structured tap tree
    of raw additive moments, and the number of batches folded in."""

    taps: dict
    spec: CalibSpec
    batches: int = 0


def _add_into(acc: dict, new: dict) -> None:
    for k, v in new.items():
        if isinstance(v, dict):
            _add_into(acc[k], v)
        else:
            acc[k] += v


@torch.no_grad()
def accumulate_stats(api: ModelApi, params, batches: Iterable[dict], *,
                     spec: CalibSpec | None = None) -> CalibStats:
    """Stream calibration batches into a ``CalibStats`` accumulator.

    The first batch's taps become the accumulator and later batches add
    into it in place (0 + x == x, so the sums equal the reference's
    zero-initialised carry bit for bit).
    """
    spec = spec if spec is not None else CalibSpec.full(api.cfg)
    policy = spec.policy()
    total, n = None, 0
    for batch in batches:
        _, aux = api.loss(params, batch, masks=None, want_taps=True,
                          tap_policy=policy)
        if total is None:
            total = aux["taps"]
        else:
            _add_into(total, aux["taps"])
        n += 1
    if total is None:
        raise ValueError("no calibration batches provided")
    return CalibStats(taps=total, spec=spec, batches=n)


def accumulate(api: ModelApi, params, batches: Iterable[dict]) -> dict:
    """Sum tap statistics over calibration batches: the taps dict
    ``prune_model(taps=...)`` takes."""
    return accumulate_stats(api, params, batches).taps


def calibration_batches(cfg_arch, *, n_samples: int, seq_len: int,
                        batch_size: int, seed: int = 0, device="cuda"):
    """The paper's calibration protocol on the synthetic corpus:
    ``n_samples`` sequences of ``seq_len`` tokens from the calib split,
    keyed by (seed, step) — restart-replayable."""
    from repro_torch.data import synthetic

    corpus = synthetic.CorpusConfig(cfg_arch.vocab_size, seed=seed)
    n_batches = (n_samples + batch_size - 1) // batch_size
    pipe = synthetic.DataPipeline(corpus, batch_size, seq_len, split="calib",
                                  device=device)
    for i in range(n_batches):
        yield pipe.get(i)
