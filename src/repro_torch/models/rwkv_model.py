"""RWKV6 full model: embed -> ln_in -> [time-mix + channel-mix] x L -> head,
the counterpart of the reference's ``models/rwkv_model``.

Attention-free: the serving state is O(1) a sequence per layer, the fp32
(H, dh, dh) WKV matrix and the two token-shift vectors (the last token's
normed inputs of the time-mix and the channel-mix). Layer params are
stacked on a leading L axis with the prunable leaves under ``"tm"``; the
mask tree mirrors it, so each layer's mask slice hands its ``"tm"``
subtree to both mixers. Taps come back stacked on L per tap name, as the
transformer's do. Where the reference scans over layers, the port loops
(``transformer.layer_loop``); with ``cfg.remat`` under autograd each
layer (time-mix plus channel-mix) runs under ``torch.utils.checkpoint``,
the reference's per-layer ``jax.checkpoint``. The cache's
clock ``t`` is a host int (the fixed-batch path); continuous batching is
refused for this family, as in the reference
(``serve.engine.ServeEngine.supports_continuous``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import common
from . import rwkv6
from .transformer import (_apply_norm, _index, _norm_params, _stack,
                          _TapStack, ce_loss, layer_loop, lm_head, remat_on)


class RWKVDecodeCache(NamedTuple):
    s: torch.Tensor      # (L, B, H, dh, dh) fp32
    x_tm: torch.Tensor   # (L, B, D) model dtype
    x_cm: torch.Tensor   # (L, B, D) model dtype
    t: int               # next position


def init_layer(gen, cfg, *, device) -> dict:
    return {
        "ln1": _norm_params(cfg, device),
        "tm": rwkv6.init_rwkv_params(gen, cfg, device=device),
        "ln2": _norm_params(cfg, device),
    }


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` with the reference's
    shapes and init scales; on ``device="meta"`` shapes only."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = getattr(torch, cfg.dtype)
    return {
        "embed": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                    dt, device),
        "ln_in": _norm_params(cfg, device),
        "layers": _stack([init_layer(gen, cfg, device=device)
                          for _ in range(cfg.n_layers)]),
        "ln_f": _norm_params(cfg, device),
        "head": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                   dt, device),
    }


def rwkv_layer(p, x, cfg, *, masks=None, taps=None, cache=None):
    """One RWKV6 layer (train / prefill) on unstacked params. Returns (x,
    the layer's ``rwkv6.RWKVCache`` after the sequence)."""
    # the mask tree mirrors the param tree: the per-layer slice nests the
    # prunable leaves under "tm" exactly like ``p`` does
    mm = None if masks is None else masks.get("tm")
    h = _apply_norm(p["ln1"], x, cfg)
    a, s_fin, x_tm_last = rwkv6.time_mix(p["tm"], h, cfg, masks=mm,
                                         taps=taps, cache=cache)
    x = x + a
    h2 = _apply_norm(p["ln2"], x, cfg)
    f, x_cm_last = rwkv6.channel_mix(
        p["tm"], h2, cfg, masks=mm, taps=taps,
        x_prev=None if cache is None else cache.x_cm)
    return x + f, rwkv6.RWKVCache(s=s_fin, x_tm=x_tm_last, x_cm=x_cm_last)


def _body(p, x, *, cfg, masks=None, taps=None):
    return rwkv_layer(p, x, cfg, masks=masks, taps=taps)[0], None


def _embed(params, tokens, cfg):
    x = torch.nn.functional.embedding(tokens, params["embed"])
    return _apply_norm(params["ln_in"], x, cfg)


def forward(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    """Training/scoring forward. batch["tokens"]: (B, S) int.

    Returns (hidden (B, S, D), taps, aux = 0). ``taps`` maps each tap name
    to {field: stacked (L, ...) tensor}; empty unless ``want_taps``.
    """
    x = _embed(params, batch["tokens"], cfg)
    m_layers = None if masks is None else masks["layers"]
    stacked = _TapStack((cfg.n_layers,)) if want_taps else None
    aux = torch.zeros((), device=x.device)
    x, aux = layer_loop(functools.partial(_body, cfg=cfg), params["layers"],
                        x, range(cfg.n_layers), m_layers, aux,
                        remat=remat_on(cfg, want_taps), taps=stacked,
                        tap_policy=tap_policy)
    x = _apply_norm(params["ln_f"], x, cfg)
    taps = stacked.tree if want_taps else {}
    return x, taps, aux


def loss_fn(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    hidden, taps, aux = forward(params, batch, cfg, masks=masks,
                                want_taps=want_taps, tap_policy=tap_policy)
    loss = ce_loss(params, hidden, batch["labels"], cfg)
    return loss, {"ce": loss, "aux": aux, "taps": taps}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_decode_cache(params, cfg, batch: int, s_max: int) -> RWKVDecodeCache:
    """Zero states on the params' device; ``s_max`` is unused (the state
    does not grow with the sequence)."""
    L, D = cfg.n_layers, cfg.d_model
    H, dh = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dev, dt = params["embed"].device, getattr(torch, cfg.dtype)
    return RWKVDecodeCache(
        s=torch.zeros((L, batch, H, dh, dh), dtype=torch.float32, device=dev),
        x_tm=torch.zeros((L, batch, D), dtype=dt, device=dev),
        x_cm=torch.zeros((L, batch, D), dtype=dt, device=dev),
        t=0)


@torch.no_grad()
def prefill(params, batch, cfg, cache: RWKVDecodeCache, *, masks=None):
    """Run the prompt from a zero state, writing each layer's state into
    the cache in place. Returns (last-token logits (B, 1, V), cache).
    Prompts are not right-padded here: the state would run through the
    pad (the reference reads no ``n_valid`` either)."""
    if batch.get("n_valid") is not None:
        raise ValueError("the rwkv family serves unpadded prompts only")
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    m_layers = None if masks is None else masks["layers"]
    for i in range(cfg.n_layers):
        x, st = rwkv_layer(_index(params["layers"], i), x, cfg,
                           masks=_index(m_layers, i))
        cache.s[i] = st.s
        cache.x_tm[i] = st.x_tm
        cache.x_cm[i] = st.x_cm
    x = _apply_norm(params["ln_f"], x[:, -1:], cfg)
    return lm_head(params, x, cfg), cache._replace(t=tokens.shape[1])


@torch.no_grad()
def decode_step(params, token, cfg, cache: RWKVDecodeCache, *, masks=None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    cache advanced by one position, updated in place)."""
    x = _embed(params, token, cfg)                            # (B, 1, D)
    m_layers = None if masks is None else masks["layers"]
    for i in range(cfg.n_layers):
        lp, lm = _index(params["layers"], i), _index(m_layers, i)
        mm = None if lm is None else lm.get("tm")
        lc = rwkv6.RWKVCache(s=cache.s[i], x_tm=cache.x_tm[i],
                             x_cm=cache.x_cm[i])
        h = _apply_norm(lp["ln1"], x, cfg)
        a, s_new, x_tm_last = rwkv6.time_mix_decode(lp["tm"], h, lc, cfg,
                                                    masks=mm)
        x = x + a
        h2 = _apply_norm(lp["ln2"], x, cfg)
        f, x_cm_last = rwkv6.channel_mix(lp["tm"], h2, cfg, masks=mm,
                                         x_prev=lc.x_cm)
        x = x + f
        cache.s[i] = s_new
        cache.x_tm[i] = x_tm_last
        cache.x_cm[i] = x_cm_last
    x = _apply_norm(params["ln_f"], x, cfg)
    return lm_head(params, x, cfg), cache._replace(t=cache.t + 1)
