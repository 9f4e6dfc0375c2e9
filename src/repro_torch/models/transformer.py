"""Decoder-only transformer stack, dense family.

Layout as in the reference: layer params are stacked on a leading L axis;
pruning masks mirror the stacked param tree (prunable leaves only); Gram
taps come back stacked per tap site, (L, d, d) fp32, when ``want_taps``.
A prunable leaf may be a stacked ``core.packed.PackedWeight`` (serving a
packed model); ``_index`` slices it per layer. Where the reference scans
over layers, the port loops over them.

Serving: ``init_decode_cache`` -> ``prefill`` (the prompt; fills the KV
cache) -> ``decode_step`` per new token. The cache is updated in place
and its clock ``t`` is a Python int, so the decode loop never waits on
the device for a position.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.packed import PackedWeight

from . import attention as attn
from . import common
from . import mlp as mlp_lib


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_params(cfg, device):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def _apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return common.layernorm(x, p["scale"], p["bias"])
    return common.rmsnorm(x, p["scale"])


def init_layer(gen, cfg, *, device) -> dict:
    return {
        "ln1": _norm_params(cfg, device),
        "attn": attn.init_attn_params(gen, cfg, device=device),
        "ln2": _norm_params(cfg, device),
        "mlp": mlp_lib.init_mlp_params(gen, cfg, device=device),
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (None passes through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(tree, values=tree.values[i],
                                   idx=tree.idx[i])
    return tree[i]


class DecodeCache(NamedTuple):
    kv: attn.KVCache        # leaves stacked (L, ...)
    t: int                  # next position


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's shapes and init scales (normal, 0.02 for embeddings,
    d_in^-0.5 for linears). On ``device="meta"`` only shapes and dtypes
    exist (no generator, no memory): what planning reads."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = getattr(torch, cfg.dtype)
    params = {
        "embed": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                    dt, device),
        "ln_f": _norm_params(cfg, device),
        "layers": _stack([init_layer(gen, cfg, device=device)
                          for _ in range(cfg.n_layers)]),
    }
    if not cfg.tie_embeddings:
        params["head"] = common.normal_init(
            gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def decoder_layer(p, x, positions, cfg, *, masks=None, taps=None,
                  mode: str = "train", cache: attn.KVCache | None = None,
                  t: int | None = None):
    """One pre-norm decoder layer on unstacked params.

    ``mode`` is "train", "prefill" (writes the prompt's KV into
    ``cache``) or "decode" (one token at position ``t`` against
    ``cache``). Returns x.
    """
    am = None if masks is None else masks.get("attn")
    h = _apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        a, _ = attn.decode_attention(p["attn"], h, t, cfg, cache, masks=am,
                                     taps=taps)
    else:
        a, _ = attn.self_attention(p["attn"], h, positions, cfg, masks=am,
                                   taps=taps, cache=cache, mode=mode)
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    mm = None if masks is None else masks.get("mlp")
    return x + mlp_lib.mlp_block(p["mlp"], h, cfg, masks=mm, taps=taps)


def _layer_cache(kv: attn.KVCache, i: int) -> attn.KVCache:
    """Views of layer ``i`` of a stacked cache (writes go through)."""
    return attn.KVCache(kv.k[i], kv.v[i], kv.pos[i])


def _run_layers(params, x, positions, cfg, *, masks, mode, cache, t=None):
    m_layers = None if masks is None else masks["layers"]
    for i in range(cfg.n_layers):
        x = decoder_layer(_index(params["layers"], i), x, positions, cfg,
                          masks=_index(m_layers, i), mode=mode,
                          cache=_layer_cache(cache.kv, i), t=t)
    return x


def forward(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    """Training/scoring forward. batch["tokens"]: (B, S) int.

    Returns (hidden (B, S, D), taps, aux). ``taps`` maps each tap name to
    {field: stacked (L, ...) tensor}; empty unless ``want_taps``.
    """
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    m_layers = None if masks is None else masks["layers"]
    per_layer = []
    for i in range(cfg.n_layers):
        taps = common.Taps(tap_policy) if want_taps else None
        x = decoder_layer(_index(params["layers"], i), x, positions, cfg,
                          masks=_index(m_layers, i), taps=taps)
        if want_taps:
            per_layer.append(taps.entries)
    x = _apply_norm(params["ln_f"], x, cfg)
    taps = _stack(per_layer) if per_layer else {}
    return x, taps, torch.zeros((), device=x.device)


def lm_head(params, hidden, cfg):
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return hidden @ head.T.to(hidden.dtype)


def ce_loss(params, hidden, labels, cfg):
    """Mean cross-entropy over the valid (label >= 0) tokens."""
    tot, cnt = _ce_sums(params, hidden, labels, cfg)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_sums(params, hidden, labels, cfg):
    logits = lm_head(params, hidden, cfg).float()
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.float().sum()


def loss_fn(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    hidden, taps, aux = forward(params, batch, cfg, masks=masks,
                                want_taps=want_taps, tap_policy=tap_policy)
    loss = ce_loss(params, hidden, batch["labels"], cfg)
    return loss + aux, {"ce": loss, "aux": aux, "taps": taps}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_decode_cache(params, cfg, batch: int, s_max: int) -> DecodeCache:
    """An empty (L, batch, s_max) KV cache on the params' device."""
    one = attn.init_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                          getattr(torch, cfg.dtype),
                          device=params["embed"].device)
    L = cfg.n_layers
    kv = attn.KVCache(*(t.expand(L, *t.shape).clone() for t in one))
    return DecodeCache(kv=kv, t=0)


@torch.no_grad()
def prefill(params, batch, cfg, cache: DecodeCache, *, masks=None):
    """Run the prompt, filling the cache. Returns (last-token logits
    (B, 1, V), cache).

    ``batch["n_valid"]`` (optional int) marks a right-padded prompt: only
    the first ``n_valid`` tokens are real. The pad tail is masked out of
    the cache (pos = -1), the logits are taken at position
    ``n_valid - 1``, and decoding resumes at ``t = n_valid``.
    """
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    x = _run_layers(params, x, positions, cfg, masks=masks, mode="prefill",
                    cache=cache)
    kv, t_next, x_last = _finish_prefill(cache.kv, x, S, batch.get("n_valid"))
    x = _apply_norm(params["ln_f"], x_last, cfg)
    return lm_head(params, x, cfg), DecodeCache(kv=kv, t=t_next)


def _finish_prefill(kv: attn.KVCache, x, S: int, n_valid):
    """-> (kv with pad keys masked, next position, last REAL hidden state)."""
    if n_valid is None:
        return kv, S, x[:, -1:]
    nv = int(n_valid)
    # pad slots were written with pos >= n_valid; -1 hides them from every
    # later query (the decode steps then overwrite them in order)
    kv.pos.masked_fill_(kv.pos >= nv, -1)
    return kv, nv, x[:, nv - 1:nv]


@torch.no_grad()
def decode_step(params, token, cfg, cache: DecodeCache, *, masks=None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    cache advanced by one position)."""
    x = params["embed"][token]
    x = _run_layers(params, x, None, cfg, masks=masks, mode="decode",
                    cache=cache, t=cache.t)
    x = _apply_norm(params["ln_f"], x, cfg)
    return lm_head(params, x, cfg), DecodeCache(kv=cache.kv, t=cache.t + 1)
