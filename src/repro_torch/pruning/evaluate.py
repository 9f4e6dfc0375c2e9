"""Post-pruning evaluation: perplexity + a zero-shot-style accuracy proxy.

Offline stand-ins for the paper's WikiText perplexity and zero-shot
accuracy: perplexity on the synthetic validation split, and next-token
top-1 accuracy on held-out sequences.
"""
from __future__ import annotations

from repro_torch.data import synthetic
from repro_torch.models import ModelApi
from repro_torch.train import steps as steps_lib


def val_batches(cfg_arch, *, n_batches: int = 4, batch: int = 8,
                seq: int = 128, seed: int = 0, device="cuda"):
    corpus = synthetic.CorpusConfig(cfg_arch.vocab_size, seed=seed)
    pipe = synthetic.DataPipeline(corpus, batch, seq, split="val",
                                  device=device)
    return [synthetic.with_modality(pipe.get(i), cfg_arch, seed + 1, i)
            for i in range(n_batches)]


def perplexity(api: ModelApi, params, batches, *, masks=None) -> float:
    """Token-weighted mean-CE perplexity (``train.steps.perplexity``)."""
    return steps_lib.perplexity(api, params, batches, masks=masks)


def top1_accuracy(api: ModelApi, params, batches, *, masks=None) -> float:
    """Zero-shot proxy: next-token top-1 accuracy (higher is better)."""
    return steps_lib.eval_metrics(api, params, batches,
                                  masks=masks)["accuracy"]


def evaluate(api: ModelApi, params, *, masks=None, n_batches: int = 4,
             batch: int = 8, seq: int = 128, seed: int = 0,
             device="cuda") -> dict:
    """``perplexity`` and ``top1_accuracy`` on the validation batches, from
    one forward a batch (``train.steps.eval_metrics``)."""
    bs = val_batches(api.cfg, n_batches=n_batches, batch=batch, seq=seq,
                     seed=seed, device=device)
    return steps_lib.eval_metrics(api, params, bs, masks=masks)
