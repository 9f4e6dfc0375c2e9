"""Model registry: ``build(cfg) -> ModelApi``, dense family.

The surface mirrors the reference's ``ModelApi`` for the calls the pruning
path makes:

    init(seed=0, device="cuda") -> params
    loss(params, batch, masks=None, want_taps=False, tap_policy=None)
        -> (loss, aux_dict)
    forward(params, batch, masks=None, want_taps=False, tap_policy=None)
        -> (hidden, taps, aux)
    init_cache(params, batch, s_max) -> cache
    prefill(params, batch, cache, masks=None) -> (logits, cache)
    decode_step(params, token, cache, masks=None) -> (logits, cache)

The windowed-prefill continuation and rolling caches come with
continuous batching; the
MoE, SSM, RWKV, VLM and encoder-decoder families with their slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig

from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    module: Any


def build(cfg: ArchConfig) -> ModelApi:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port runs the dense family so far, not {cfg.family!r}")
    mod = transformer
    return ModelApi(
        cfg=cfg,
        init=lambda seed=0, device="cuda": mod.init_params(
            cfg, seed=seed, device=device),
        loss=lambda p, b, masks=None, want_taps=False, tap_policy=None:
            mod.loss_fn(p, b, cfg, masks=masks, want_taps=want_taps,
                        tap_policy=tap_policy),
        forward=lambda p, b, masks=None, want_taps=False, tap_policy=None:
            mod.forward(p, b, cfg, masks=masks, want_taps=want_taps,
                        tap_policy=tap_policy),
        init_cache=lambda p, batch, s_max: mod.init_decode_cache(
            p, cfg, batch, s_max),
        prefill=lambda p, b, cache, masks=None: mod.prefill(
            p, b, cfg, cache, masks=masks),
        decode_step=lambda p, tok, cache, masks=None: mod.decode_step(
            p, tok, cfg, cache, masks=masks),
        module=mod,
    )


def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count from the initializer's shapes on
    ``device="meta"`` (no memory, no FLOPs): the counterpart of the
    reference's ``jax.eval_shape`` count. Active-only counts wait for
    MoE."""
    params = build(cfg).init(device="meta")
    return sum(math.prod(t.shape) for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def embedding_params(cfg: ArchConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


__all__ = ["ModelApi", "build", "embedding_params", "param_count"]
