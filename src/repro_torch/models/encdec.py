"""Encoder-decoder transformer (the seamless-m4t backbone).

The audio frontend is a stub: ``batch["src"]`` carries precomputed frame
embeddings (B, S_src, d_frontend or d_model). A bidirectional encoder,
then a causal decoder whose every layer attends to the encoder output
through its own cross-attention (``xattn``). Every q/k/v/o and MLP
linear of the encoder, the decoder's self attention and its cross
attention is prunable.

Layout as in the reference: ``enc_layers`` and ``dec_layers`` stacked on
their layer axis, the masks tree mirroring them; where the reference
scans over layers, the port loops. Taps come back as {"enc": {tap: (L_enc,
...)}, "dec": {tap: (L_dec, ...)}}; a decoder layer's cross-attention
taps are emitted in a namespace of their own (under the projection names,
which a ``TapPolicy`` looks up) and come back with an ``x_`` prefix
("x_wq", ...), as in the reference.

Serving: ``init_decode_cache`` -> ``prefill`` (encode ``src``, project the
encoder output once per decoder layer into the cross KV, through the
xattn wk / wv masks or packed leaves, then the target prefix) ->
``decode_step`` per new token. The self KV cache is updated in place and
its clock ``t`` is a Python int on the fixed-batch path, as in
``models.transformer``. The continuous scheduler refuses this family, as
the reference's does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import attention as attn
from . import common
from . import mlp as mlp_lib
from .transformer import (_apply_norm, _finish_prefill, _index, _layer_cache,
                          _norm_params, _stack, _TapStack, ce_loss,
                          layer_loop, lm_head, remat_on)

__all__ = ["EncDecCache", "decode_step", "encode", "forward",
           "init_decode_cache", "init_params", "lm_head", "loss_fn",
           "prefill"]


class EncDecCache(NamedTuple):
    kv: attn.KVCache        # decoder self KV, leaves stacked (L_dec, ...)
    cross_kv: tuple | None  # (k, v), each (L_dec, B, S_src, kvH, dh)
    t: int | torch.Tensor   # next position


def init_enc_layer(gen, cfg, *, device) -> dict:
    return {
        "ln1": _norm_params(cfg, device),
        "attn": attn.init_attn_params(gen, cfg, device=device),
        "ln2": _norm_params(cfg, device),
        "mlp": mlp_lib.init_mlp_params(gen, cfg, device=device),
    }


def init_dec_layer(gen, cfg, *, device) -> dict:
    return {
        "ln1": _norm_params(cfg, device),
        "attn": attn.init_attn_params(gen, cfg, device=device),
        "ln_x": _norm_params(cfg, device),
        "xattn": attn.init_attn_params(gen, cfg, device=device, cross=True),
        "ln2": _norm_params(cfg, device),
        "mlp": mlp_lib.init_mlp_params(gen, cfg, device=device),
    }


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's shapes and init scales; on ``device="meta"`` shapes
    and dtypes only."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = getattr(torch, cfg.dtype)
    return {
        "embed": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                    dt, device),
        "enc_layers": _stack([init_enc_layer(gen, cfg, device=device)
                              for _ in range(cfg.n_enc_layers)]),
        "ln_enc": _norm_params(cfg, device),
        "dec_layers": _stack([init_dec_layer(gen, cfg, device=device)
                              for _ in range(cfg.n_layers)]),
        "ln_f": _norm_params(cfg, device),
        "head": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                   dt, device),
    }


# ---------------------------------------------------------------------------
# per-layer bodies
# ---------------------------------------------------------------------------

def encoder_layer(p, x, positions, cfg, *, masks=None, taps=None):
    h = _apply_norm(p["ln1"], x, cfg)
    a, _ = attn.self_attention(p["attn"], h, positions, cfg,
                               masks=attn._m(masks, "attn"), taps=taps,
                               causal=False)
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    return x + mlp_lib.mlp_block(p["mlp"], h, cfg,
                                 masks=attn._m(masks, "mlp"), taps=taps)


def decoder_layer(p, x, enc_out, positions, cfg, *, masks=None, taps=None,
                  mode: str = "train", cache: attn.KVCache | None = None,
                  cross_kv: tuple | None = None, t=None):
    """One decoder layer: causal self attention ("train", "prefill" into
    ``cache``, or "decode" at the (B,) positions ``t``), cross attention
    to ``enc_out`` (or to the precomputed ``cross_kv``), the MLP."""
    h = _apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        a, _ = attn.decode_attention(p["attn"], h, t, cfg, cache,
                                     masks=attn._m(masks, "attn"), taps=taps)
    else:
        a, _ = attn.self_attention(p["attn"], h, positions, cfg,
                                   masks=attn._m(masks, "attn"), taps=taps,
                                   cache=cache, mode=mode)
    x = x + a
    h = _apply_norm(p["ln_x"], x, cfg)
    # a namespace of its own: the cross attention's Grams are not the
    # self attention's
    taps_x = None if taps is None else common.Taps(taps.policy)
    xa = attn.cross_attention(p["xattn"], h, enc_out, cfg,
                              masks=attn._m(masks, "xattn"), taps=taps_x,
                              kv_cache=cross_kv)
    if taps is not None:
        taps.entries.update({f"x_{k}": v for k, v in taps_x.entries.items()})
    x = x + xa
    h = _apply_norm(p["ln2"], x, cfg)
    return x + mlp_lib.mlp_block(p["mlp"], h, cfg,
                                 masks=attn._m(masks, "mlp"), taps=taps)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _enc_body(p, x, *, positions, cfg, masks=None, taps=None):
    return encoder_layer(p, x, positions, cfg, masks=masks, taps=taps), None


def _dec_body(p, x, *, enc_out, positions, cfg, masks=None, taps=None):
    return decoder_layer(p, x, enc_out, positions, cfg, masks=masks,
                         taps=taps), None


def encode(params, src, cfg, *, masks=None, want_taps=False,
           tap_policy: common.TapPolicy | None = None):
    """src: (B, S_src, d) frame embeddings -> (encoder states, taps)."""
    x = src.to(getattr(torch, cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    taps = _TapStack((cfg.n_enc_layers,)) if want_taps else None
    x, _ = layer_loop(functools.partial(_enc_body, positions=positions,
                                        cfg=cfg),
                      params["enc_layers"], x, range(cfg.n_enc_layers),
                      None if masks is None else masks["enc_layers"], None,
                      remat=remat_on(cfg, want_taps), taps=taps,
                      tap_policy=tap_policy)
    return (_apply_norm(params["ln_enc"], x, cfg),
            {} if taps is None else taps.tree)


def forward(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    """Training / scoring forward. batch: tokens (B, S), src (B, S_src, d).
    Returns (hidden (B, S, D), taps, aux = 0)."""
    enc_out, enc_taps = encode(params, batch["src"], cfg, masks=masks,
                               want_taps=want_taps, tap_policy=tap_policy)
    tokens = batch["tokens"]
    x = torch.nn.functional.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    taps = _TapStack((cfg.n_layers,)) if want_taps else None
    x, _ = layer_loop(functools.partial(_dec_body, enc_out=enc_out,
                                        positions=positions, cfg=cfg),
                      params["dec_layers"], x, range(cfg.n_layers),
                      None if masks is None else masks["dec_layers"], None,
                      remat=remat_on(cfg, want_taps), taps=taps,
                      tap_policy=tap_policy)
    x = _apply_norm(params["ln_f"], x, cfg)
    taps = {"enc": enc_taps, "dec": taps.tree} if want_taps else {}
    return x, taps, torch.zeros((), device=x.device)


def loss_fn(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    hidden, taps, aux = forward(params, batch, cfg, masks=masks,
                                want_taps=want_taps, tap_policy=tap_policy)
    loss = ce_loss(params, hidden, batch["labels"], cfg)
    return loss, {"ce": loss, "aux": aux, "taps": taps}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_decode_cache(params, cfg, batch: int, s_max: int) -> EncDecCache:
    """An empty (L_dec, batch, s_max) self KV cache on the params' device;
    the cross KV is left to ``prefill``, which computes it whole."""
    one = attn.init_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                          getattr(torch, cfg.dtype),
                          device=params["embed"].device)
    kv = attn.KVCache(*(t.expand(cfg.n_layers, *t.shape).clone()
                        for t in one))
    return EncDecCache(kv=kv, cross_kv=None, t=0)


def precompute_cross_kv(params, enc_out, cfg, *, masks=None) -> tuple:
    """Every decoder layer's cross (k, v) of the encoder output, stacked
    (L_dec, B, S_src, kvH, dh), through the xattn wk / wv masks (or their
    packed leaves): the projection ``decoder_layer`` would otherwise run
    masked."""
    m = None if masks is None else masks["dec_layers"].get("xattn")
    kvs = [attn.precompute_cross_kv(_index(params["dec_layers"], i)["xattn"],
                                    enc_out, cfg, masks=_index(m, i))
           for i in range(cfg.n_layers)]
    return tuple(torch.stack(t) for t in zip(*kvs))


@torch.no_grad()
def prefill(params, batch, cfg, cache: EncDecCache, *, masks=None):
    """Encode ``batch["src"]``, precompute the cross KV, run the target
    prefix ``batch["tokens"]`` into the self KV cache. Returns (last-token
    logits (B, 1, V), cache)."""
    enc_out, _ = encode(params, batch["src"], cfg, masks=masks)
    cross = precompute_cross_kv(params, enc_out, cfg, masks=masks)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    m = None if masks is None else masks["dec_layers"]
    for i in range(cfg.n_layers):
        x = decoder_layer(_index(params["dec_layers"], i), x, None,
                          positions, cfg, masks=_index(m, i), mode="prefill",
                          cache=_layer_cache(cache.kv, i),
                          cross_kv=(cross[0][i], cross[1][i]))
    kv, t_next, x_last = _finish_prefill(cache.kv, x, S, batch.get("n_valid"))
    x = _apply_norm(params["ln_f"], x_last, cfg)
    return lm_head(params, x, cfg), EncDecCache(kv=kv, cross_kv=cross,
                                                t=t_next)


@torch.no_grad()
def decode_step(params, token, cfg, cache: EncDecCache, *, masks=None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    cache advanced by one position)."""
    x = params["embed"][token]
    t = cache.kv.pos.new_zeros(token.shape[0]).add_(cache.t)
    m = None if masks is None else masks["dec_layers"]
    for i in range(cfg.n_layers):
        x = decoder_layer(_index(params["dec_layers"], i), x, None, None, cfg,
                          masks=_index(m, i), mode="decode",
                          cache=_layer_cache(cache.kv, i),
                          cross_kv=(cache.cross_kv[0][i],
                                    cache.cross_kv[1][i]), t=t)
    x = _apply_norm(params["ln_f"], x, cfg)
    return lm_head(params, x, cfg), cache._replace(t=cache.t + 1)
