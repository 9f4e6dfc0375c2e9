"""Calibration: accumulate per-layer Gram statistics in dense forward passes.

SparseSwaps (like Wanda) leaves surviving weights unchanged, so every
layer's calibration input is the *dense* model's activation: all layers'
Grams accumulate in ONE forward pass per batch (paper §2.1.2). The taps
mechanism (``models.common.dense``) emits {g, s, n} per prunable site;
summing over batches is exact because G, Σx and counts are additive.

A thin caller of ``pruning.stats`` — the recipe-aware streaming
accumulator: ``accumulate`` keeps the historical contract (full
statistics for every tap, the taps dict ``prune_model(taps=...)`` takes).
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.models import ModelApi

from . import stats as stats_lib


def accumulate(api: ModelApi, params, batches: Iterable[dict]) -> dict:
    """Sum tap statistics over calibration batches, every tap at gram
    level."""
    return stats_lib.accumulate_stats(api, params, batches).taps


def calibration_batches(cfg_arch, *, n_samples: int, seq_len: int,
                        batch_size: int, seed: int = 0, device="cuda"):
    """The paper's calibration protocol on the synthetic corpus:
    ``n_samples`` sequences of ``seq_len`` tokens from the calib split,
    keyed by (seed, step) — restart-replayable — with the frontend
    embeddings a cross-attention family reads (``synthetic.with_modality``,
    keyed the same way)."""
    from repro_torch.data import synthetic

    corpus = synthetic.CorpusConfig(cfg_arch.vocab_size, seed=seed)
    n_batches = (n_samples + batch_size - 1) // batch_size
    pipe = synthetic.DataPipeline(corpus, batch_size, seq_len, split="calib",
                                  device=device)
    for i in range(n_batches):
        yield synthetic.with_modality(pipe.get(i), cfg_arch, seed, i)
