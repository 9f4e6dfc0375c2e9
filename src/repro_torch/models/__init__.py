"""Model registry: ``build(cfg) -> ModelApi``, every family of the
reference.

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
    prefill_window(params, batch, cache, masks=None) -> (logits, cache)

``prefill_window`` is the chunked-prefill continuation the continuous
scheduler drives. The dense, MoE and VLM families run
``models.transformer`` (an MoE config's layers hold the ``models.moe``
block; a VLM's layers run in groups with a gated cross-attention layer,
its batches carrying ``img``); the encoder-decoder (seamless-m4t-medium)
runs ``models.encdec`` (batches carry ``src``), the hybrid family
(zamba2-7b) ``models.zamba`` and rwkv6-1.6b ``models.rwkv_model``. The
continuous scheduler refuses all but the plain decoder-only transformers
(``ServeEngine.supports_continuous``), as the reference does. Rolling
caches (the reference's long-context serving) wait for ROADMAP A5, item
3.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig

from . import encdec, rwkv_model, transformer, zamba


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
    prefill_window: Callable | None = None   # chunked-prefill continuation


def build(cfg: ArchConfig) -> ModelApi:
    if cfg.is_rwkv:
        mod = rwkv_model
    elif cfg.is_encdec:
        mod = encdec
    elif cfg.family == "hybrid":
        mod = zamba
    else:
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
        prefill_window=(
            (lambda p, b, cache, masks=None: mod.prefill_window(
                p, b, cfg, cache, masks=masks))
            if hasattr(mod, "prefill_window") else None),
    )


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count from the initializer's shapes on
    ``device="meta"`` (no memory, no FLOPs): the counterpart of the
    reference's ``jax.eval_shape`` count. ``active_only``: an MoE model's
    expert weights count ``top_k / n_experts`` of theirs (the parameters
    one token runs through), as the reference counts them."""
    params = build(cfg).init(device="meta")
    total = sum(math.prod(t.shape) for _, t in _leaves(params))
    if active_only and cfg.is_moe:
        expert = sum(math.prod(t.shape) for path, t in _leaves(params)
                     if "moe" in path and path[-1] in ("w_gate", "w_up",
                                                       "w_down"))
        total = total - expert + expert * cfg.top_k // cfg.n_experts
    return total


def _leaves(tree, path=()):
    """(key path, leaf) of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def embedding_params(cfg: ArchConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


__all__ = ["ModelApi", "build", "embedding_params", "param_count"]
