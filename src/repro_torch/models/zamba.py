"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block,
the counterpart of the reference's ``models/zamba``.

The shared block (a full attn+MLP transformer block) has one set of
weights invoked every ``cfg.shared_attn_every`` backbone layers, before
that layer's mixer; its input is concat([hidden, embedding]), 2·d wide.
Because its weights are shared across the invocation sites, their pruning
Gram is the SUM of the per-site Grams: the layer-wise loss sums over the
sites. The reference emits zero taps at every non-site layer and sums the
(L, ...) stack (``_zero_shared_taps``); here one ``Taps`` accumulates the
shared block's entries at the sites alone, which is the same sum without
L copies of the block's Grams. A ``TapPolicy`` that skips a shared tap
leaves no entry for it, as in the reference.

Taps come back as ``{"shared": {name: entry}, "mamba": {name: (L, ...)
stacked entry}}``. Where the reference scans over layers, the port loops;
with ``cfg.remat`` under autograd each layer (the shared block where it
runs, then the Mamba2 layer) runs under ``torch.utils.checkpoint``, the
reference's per-layer ``jax.checkpoint`` of its scan body.

Serving: Mamba states are O(1) a sequence; the shared block keeps one KV
cache per invocation site. The cache's clock ``t`` is a host int (the
fixed-batch path). Rolling caches for long-context serving wait for
ROADMAP A5, item 3; continuous batching is refused for this family, as in the
reference (``serve.engine.ServeEngine.supports_continuous``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint

from . import attention as attn
from . import common
from . import mamba2
from . import mlp as mlp_lib
from .transformer import (_apply_norm, _index, _norm_params, _stack,
                          _TapStack, ce_loss, lm_head, remat_on)


class ZambaCache(NamedTuple):
    ssm: mamba2.SSMCache       # leaves stacked (L, ...)
    shared_kv: attn.KVCache    # leaves stacked (n_sites, ...)
    t: int                     # next position


def n_sites(cfg) -> int:
    return (cfg.n_layers + cfg.shared_attn_every - 1) // cfg.shared_attn_every


def init_shared_block(gen, cfg, *, device) -> dict:
    d2 = 2 * cfg.d_model
    return {
        "ln1": _norm_params(cfg, device, d2),
        "attn": attn.init_attn_params(gen, cfg, device=device, d_in=d2),
        "ln2": _norm_params(cfg, device, d2),
        "mlp": mlp_lib.init_mlp_params(gen, cfg, device=device, d_in=d2),
    }


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` with the reference's
    shapes and init scales; on ``device="meta"`` shapes only."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = getattr(torch, cfg.dtype)
    layers = [{"ln": _norm_params(cfg, device),
               "mamba": mamba2.init_mamba_params(gen, cfg, device=device)}
              for _ in range(cfg.n_layers)]
    return {
        "embed": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                    dt, device),
        "layers": _stack(layers),
        "shared": init_shared_block(gen, cfg, device=device),
        "ln_f": _norm_params(cfg, device),
        "head": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                   dt, device),
    }


# ---------------------------------------------------------------------------
# per-layer bodies
# ---------------------------------------------------------------------------

def shared_block(p, x, x0, positions, cfg, *, masks=None, taps=None,
                 mode="train", cache=None, t=None):
    """The shared attn+MLP block on concat([x, x0]). ``mode`` is "train",
    "prefill" (writes the prompt's KV into ``cache``) or "decode" (one
    token a row at the (B,) positions ``t``). Returns x."""
    g = (lambda n: None) if masks is None else masks.get
    h = _apply_norm(p["ln1"], torch.cat([x, x0], dim=-1), cfg)
    if mode == "decode":
        a, _ = attn.decode_attention(p["attn"], h, t, cfg, cache,
                                     masks=g("attn"), taps=taps)
    else:
        a, _ = attn.self_attention(p["attn"], h, positions, cfg,
                                   masks=g("attn"), taps=taps, cache=cache,
                                   mode=mode)
    x = x + a
    h = _apply_norm(p["ln2"], torch.cat([x, x0], dim=-1), cfg)
    return x + mlp_lib.mlp_block(p["mlp"], h, cfg, masks=g("mlp"), taps=taps)


def mamba_layer(p, x, cfg, *, masks=None, taps=None):
    mm = None if masks is None else masks.get("mamba")
    h = _apply_norm(p["ln"], x, cfg)
    return x + mamba2.mamba_block(p["mamba"], h, cfg, masks=mm, taps=taps)


def _layer(lp, sp, x, x0, positions, cfg, *, site: bool, masks=None,
           m_shared=None, taps=None, shared_taps=None):
    """One backbone layer: the shared block first at a site, then the
    Mamba2 layer."""
    if site:
        x = shared_block(sp, x, x0, positions, cfg, masks=m_shared,
                         taps=shared_taps)
    return mamba_layer(lp, x, cfg, masks=masks, taps=taps)


def _masks(masks):
    if masks is None:
        return None, None
    return masks["layers"], masks.get("shared")


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def forward(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    """Training/scoring forward. batch["tokens"]: (B, S) int.

    Returns (hidden (B, S, D), taps, aux = 0). ``taps`` is empty unless
    ``want_taps``; then the shared block's entries are summed over its
    sites and the mamba entries stacked on L. With ``cfg.remat`` and
    autograd on (no taps), each layer runs under ``torch.utils.checkpoint``.
    """
    tokens = batch["tokens"]
    x = torch.nn.functional.embedding(tokens, params["embed"])
    x0 = x
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    m_layers, m_shared = _masks(masks)
    shared_taps = common.Taps(tap_policy) if want_taps else None
    stacked = _TapStack((cfg.n_layers,)) if want_taps else None
    remat = remat_on(cfg, want_taps)
    for i in range(cfg.n_layers):
        kw = dict(site=i % cfg.shared_attn_every == 0,
                  masks=_index(m_layers, i), m_shared=m_shared)
        args = (_index(params["layers"], i), params["shared"], x, x0,
                positions, cfg)
        if remat:
            x = torch.utils.checkpoint.checkpoint(_layer, *args, **kw,
                                                  use_reentrant=False)
            continue
        taps = common.Taps(tap_policy) if want_taps else None
        x = _layer(*args, **kw, taps=taps, shared_taps=shared_taps)
        if want_taps:
            stacked.put((i,), taps.entries)
    x = _apply_norm(params["ln_f"], x, cfg)
    taps = ({"shared": shared_taps.entries, "mamba": stacked.tree}
            if want_taps else {})
    return x, taps, torch.zeros((), device=x.device)


def loss_fn(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    hidden, taps, aux = forward(params, batch, cfg, masks=masks,
                                want_taps=want_taps, tap_policy=tap_policy)
    loss = ce_loss(params, hidden, batch["labels"], cfg)
    return loss, {"ce": loss, "aux": aux, "taps": taps}


def init_decode_cache(params, cfg, batch: int, s_max: int) -> ZambaCache:
    """Per-layer SSM states and one (batch, s_max) KV cache per site, on
    the params' device."""
    dev, dt = params["embed"].device, getattr(torch, cfg.dtype)
    L, ns = cfg.n_layers, n_sites(cfg)
    ssm = mamba2.init_ssm_cache(batch, cfg, dt, device=dev)
    kv = attn.init_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim, dt,
                         device=dev)
    return ZambaCache(
        ssm=mamba2.SSMCache(*(t.expand(L, *t.shape).clone() for t in ssm)),
        shared_kv=attn.KVCache(*(t.expand(ns, *t.shape).clone() for t in kv)),
        t=0)


def _site_cache(kv: attn.KVCache, site: int) -> attn.KVCache:
    """Views of one site's cache (writes go through)."""
    return attn.KVCache(kv.k[site], kv.v[site], kv.pos[site])


@torch.no_grad()
def prefill(params, batch, cfg, cache: ZambaCache, *, masks=None):
    """Run the prompt, filling the cache in place. Returns (last-token
    logits (B, 1, V), cache). Prompts are not right-padded here: the
    SSM state would run through the pad (the reference reads no
    ``n_valid`` either)."""
    if batch.get("n_valid") is not None:
        raise ValueError("the hybrid family serves unpadded prompts only")
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    x0 = x
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    m_layers, m_shared = _masks(masks)
    every = cfg.shared_attn_every
    for i in range(cfg.n_layers):
        if i % every == 0:
            x = shared_block(params["shared"], x, x0, positions, cfg,
                             masks=m_shared, mode="prefill",
                             cache=_site_cache(cache.shared_kv, i // every))
        lp, lm = _index(params["layers"], i), _index(m_layers, i)
        h = _apply_norm(lp["ln"], x, cfg)
        out, st = mamba2.mamba_block(
            lp["mamba"], h, cfg, masks=None if lm is None else lm.get("mamba"),
            return_cache=True)
        cache.ssm.h[i] = st.h
        cache.ssm.conv[i] = st.conv.to(cache.ssm.conv.dtype)
        x = x + out
    x = _apply_norm(params["ln_f"], x[:, -1:], cfg)
    return lm_head(params, x, cfg), cache._replace(t=tokens.shape[1])


@torch.no_grad()
def decode_step(params, token, cfg, cache: ZambaCache, *, masks=None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    cache advanced by one position, updated in place)."""
    x = params["embed"][token]
    x0 = x
    t = cache.shared_kv.pos.new_zeros(token.shape[0]).add_(cache.t)
    m_layers, m_shared = _masks(masks)
    every = cfg.shared_attn_every
    for i in range(cfg.n_layers):
        if i % every == 0:
            x = shared_block(params["shared"], x, x0, None, cfg,
                             masks=m_shared, mode="decode",
                             cache=_site_cache(cache.shared_kv, i // every),
                             t=t)
        lp, lm = _index(params["layers"], i), _index(m_layers, i)
        h = _apply_norm(lp["ln"], x, cfg)
        out, st = mamba2.mamba_decode(
            lp["mamba"], h,
            mamba2.SSMCache(cache.ssm.h[i], cache.ssm.conv[i]), cfg,
            masks=None if lm is None else lm.get("mamba"))
        cache.ssm.h[i] = st.h
        cache.ssm.conv[i] = st.conv
        x = x + out
    x = _apply_norm(params["ln_f"], x, cfg)
    return lm_head(params, x, cfg), cache._replace(t=cache.t + 1)
