"""Decoder-only transformer stack: dense, MoE and cross-attention (VLM).

Layout as in the reference: layer params are stacked on a leading L axis;
pruning masks mirror the stacked param tree (prunable leaves only); Gram
taps come back stacked per tap site, (L, d, d) fp32 — (L, E, d, d) for
an MoE tap — when ``want_taps``, each layer's statistics written into
their slot of the stack as the layer finishes (``_TapStack``, no stack
copy; ``layer_loop`` runs the layers for every family with a layer stack
of this kind, the encoder-decoder's included). A prunable leaf may be a stacked
``core.packed.PackedWeight`` (serving a packed model); ``_index`` slices
it per layer, leaving an MoE leaf's expert dim. Where the reference scans
over layers, the port loops over them. An MoE config's layers hold
``p["moe"]`` (``models.moe``) in place of ``p["mlp"]``; each layer's aux
loss (load balance + router z-loss) sums into ``forward``'s aux, and
``loss_fn`` returns ce + aux.

VLM (``cfg.cross_attn_every = k``, llama-3.2-vision): the layers run in
G = n_layers / k groups of k - 1 self layers and one gated cross-attention
layer (``cross_layer``: x + tanh(gate) · block, the gates fp32 scalars),
as the reference's grouped scan runs them. ``layers`` is stacked
(G, k - 1, ...) and ``cross_layers`` (G, ...); taps come back as
{"self": {tap: (G, k - 1, ...)}, "cross": {tap: (G, ...)}} (at
llama-3.2-vision-90b's width one layer's taps are 4.9 GB). The image states ``batch["img"]`` (B, n_img_tokens,
d_frontend or d_model) go to the cross layers as an argument; the
reference's trick of riding them in the params dict would leak into
packing and the site walk. ``prefill`` projects them once per cross layer
into ``DecodeCache.cross_kv`` (through the wk / wv masks or packed
leaves), which ``decode_step`` reads.

Serving: ``init_decode_cache`` -> ``prefill`` (the prompt; fills the KV
cache) -> ``decode_step`` per new token. The cache is updated in place.
Its clock ``t`` is a Python int on the fixed-batch path, so the decode
loop never waits on the device for a position; the continuous scheduler
keeps a (B,) tensor of per-row clocks instead, and ``prefill_window``
(chunked prefill) takes its window offset and prompt length as tensors,
so neither path reads the device from the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.core.packed import PackedWeight

from . import attention as attn
from . import common
from . import mlp as mlp_lib
from . import moe as moe_lib


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_params(cfg, device, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def _apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return common.layernorm(x, p["scale"], p["bias"])
    return common.rmsnorm(x, p["scale"])


def init_layer(gen, cfg, *, device) -> dict:
    p = {
        "ln1": _norm_params(cfg, device),
        "attn": attn.init_attn_params(gen, cfg, device=device),
        "ln2": _norm_params(cfg, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe_params(gen, cfg, device=device)
    else:
        p["mlp"] = mlp_lib.init_mlp_params(gen, cfg, device=device)
    return p


def init_cross_layer(gen, cfg, *, device) -> dict:
    """A gated cross-attention layer: wk / wv over the frontend width, a
    dense MLP, and the two fp32 scalar gates, 0 at init (tanh(0) = 0: the
    layer starts as the identity, as in the reference)."""
    return {
        "ln1": _norm_params(cfg, device),
        "attn": attn.init_attn_params(gen, cfg, device=device, cross=True),
        "ln2": _norm_params(cfg, device),
        "mlp": mlp_lib.init_mlp_params(gen, cfg, device=device),
        "gate_attn": torch.zeros((), device=device),
        "gate_mlp": torch.zeros((), device=device),
    }


def groups(cfg) -> tuple[int, int]:
    """(G, NS) of a VLM: groups, and self layers a group."""
    k = cfg.cross_attn_every
    return cfg.n_layers // k, k - 1


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
    kv: attn.KVCache        # leaves stacked (L, ...); a VLM's (G, NS, ...)
    t: int | torch.Tensor   # next position: an int, or per row (B,)
    cross_kv: tuple | None = None   # VLM: (k, v), each (G, B, P, kvH, dh)


class _TapStack:
    """Stacked tap entries filled a layer at a time: each field's
    (*stack, ...) tensor is allocated at its first layer, and every
    layer's entry is copied into its slot as the layer finishes (bitwise
    what stacking the per-layer entries would give, without holding
    both)."""

    def __init__(self, stack: tuple[int, ...]):
        self.stack, self.tree = stack, {}

    def put(self, idx: tuple[int, ...], entries: dict) -> None:
        for name, ent in entries.items():
            node = self.tree.setdefault(name, {})
            for f, v in ent.items():
                if f not in node:
                    node[f] = v.new_empty((*self.stack, *v.shape))
                node[f][idx].copy_(v)


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
    }
    if cfg.cross_attn_every:
        G, NS = groups(cfg)
        params["layers"] = _stack([
            _stack([init_layer(gen, cfg, device=device) for _ in range(NS)])
            for _ in range(G)])
        params["cross_layers"] = _stack([
            init_cross_layer(gen, cfg, device=device) for _ in range(G)])
    else:
        params["layers"] = _stack([init_layer(gen, cfg, device=device)
                                   for _ in range(cfg.n_layers)])
    if not cfg.tie_embeddings:
        params["head"] = common.normal_init(
            gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def decoder_layer(p, x, positions, cfg, *, masks=None, taps=None,
                  mode: str = "train", cache: attn.KVCache | None = None,
                  t=None):
    """One pre-norm decoder layer on unstacked params.

    ``mode`` is "train", "prefill" (writes the prompt's KV into
    ``cache``), "decode" (one token per row at the (B,) positions ``t``
    against ``cache``) or "window" (a chunked-prefill window starting at
    the () tensor ``t``). Returns (x, aux): the MoE block's aux loss, or
    None for a dense layer.
    """
    am = None if masks is None else masks.get("attn")
    h = _apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        a, _ = attn.decode_attention(p["attn"], h, t, cfg, cache, masks=am,
                                     taps=taps)
    elif mode == "window":
        a, _ = attn.window_attention(p["attn"], h, t, cfg, cache, masks=am,
                                     taps=taps)
    else:
        a, _ = attn.self_attention(p["attn"], h, positions, cfg, masks=am,
                                   taps=taps, cache=cache, mode=mode)
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    if cfg.is_moe:
        mm = None if masks is None else masks.get("moe")
        f, aux = moe_lib.moe_block(p["moe"], h, cfg, masks=mm, taps=taps)
        return x + f, aux
    mm = None if masks is None else masks.get("mlp")
    return x + mlp_lib.mlp_block(p["mlp"], h, cfg, masks=mm, taps=taps), None


def cross_layer(p, x, kv_states, cfg, *, masks=None, taps=None,
                kv_cache: tuple | None = None):
    """One gated cross-attention layer (VLM) on unstacked params:
    x + tanh(gate_attn) · cross-attention, then x + tanh(gate_mlp) · MLP.
    kv_states: (B, P, d) image states, or None with ``kv_cache``."""
    am = None if masks is None else masks.get("attn")
    h = _apply_norm(p["ln1"], x, cfg)
    a = attn.cross_attention(p["attn"], h, kv_states, cfg, masks=am,
                             taps=taps, kv_cache=kv_cache)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * a
    h = _apply_norm(p["ln2"], x, cfg)
    mm = None if masks is None else masks.get("mlp")
    f = mlp_lib.mlp_block(p["mlp"], h, cfg, masks=mm, taps=taps)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * f


def _layer_cache(kv: attn.KVCache, *idx: int) -> attn.KVCache:
    """Views of one layer of a stacked cache (writes go through); a VLM's
    layer is (group, self layer)."""
    return attn.KVCache(kv.k[idx], kv.v[idx], kv.pos[idx])


def _cross_masks(masks):
    return None if masks is None else masks.get("cross_layers")


def _run_layers(params, x, positions, cfg, *, masks, mode, cache, t=None):
    m_layers = None if masks is None else masks["layers"]
    if not cfg.cross_attn_every:
        for i in range(cfg.n_layers):
            x, _ = decoder_layer(_index(params["layers"], i), x, positions,
                                 cfg, masks=_index(m_layers, i), mode=mode,
                                 cache=_layer_cache(cache.kv, i), t=t)
        return x
    # a VLM's groups: its self layers, then its cross layer on the cross
    # KV that prefill precomputed
    G, NS = groups(cfg)
    m_cross = _cross_masks(masks)
    for g in range(G):
        pg, mg = _index(params["layers"], g), _index(m_layers, g)
        for j in range(NS):
            x, _ = decoder_layer(_index(pg, j), x, positions, cfg,
                                 masks=_index(mg, j), mode=mode,
                                 cache=_layer_cache(cache.kv, g, j), t=t)
        x = cross_layer(_index(params["cross_layers"], g), x, None, cfg,
                        masks=_index(m_cross, g),
                        kv_cache=(cache.cross_kv[0][g], cache.cross_kv[1][g]))
    return x


def layer_loop(body, params, x, layers, masks, aux, *, remat: bool,
               taps: _TapStack | None, at: tuple = (),
               tap_policy: common.TapPolicy | None = None):
    """Run ``body(p, x, masks=, taps=) -> (x, aux or None)`` over the
    layers ``layers`` of the stacked ``params`` / ``masks``; returns (x,
    ``aux`` plus the layers' aux losses). Each layer's tap entries go
    into their slot ``(*at, i)`` of ``taps`` as it finishes. Under
    ``remat`` (autograd on, no taps) each layer runs under
    ``torch.utils.checkpoint``: the reference's per-layer
    ``jax.checkpoint``, which keeps only the layer's input and recomputes
    the rest in the backward pass."""
    for i in layers:
        lp, lm = _index(params, i), _index(masks, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                body, lp, x, masks=lm, use_reentrant=False)
        else:
            t = None if taps is None else common.Taps(tap_policy)
            x, a = body(lp, x, masks=lm, taps=t)
            if taps is not None:
                taps.put((*at, i), t.entries)
        if a is not None:
            aux = aux + a
    return x, aux


def remat_on(cfg, want_taps: bool) -> bool:
    """Whether ``layer_loop`` recomputes its layers: ``cfg.remat``, under
    autograd, with no taps wanted."""
    return cfg.remat and not want_taps and torch.is_grad_enabled()


def _cross_body(p, x, *, img, cfg, masks=None, taps=None):
    return cross_layer(p, x, img, cfg, masks=masks, taps=taps), None


def forward(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    """Training/scoring forward. batch["tokens"]: (B, S) int.
    Differentiable end to end (nothing in place); with ``cfg.remat`` and
    autograd on, each layer runs under ``torch.utils.checkpoint``.

    Returns (hidden (B, S, D), taps, aux). ``taps`` maps each tap name to
    {field: stacked (L, ...) tensor} (a VLM's: {"self": ..., "cross":
    ...}, see the module's docstring); empty unless ``want_taps``.
    ``aux`` is the sum of the layers' aux losses (0 for the dense family).
    A VLM reads ``batch["img"]``.
    """
    tokens = batch["tokens"]
    # F.embedding, not indexing: its backward sums each row's gradients in
    # a fixed order on the CPU and the card, where indexing's backward
    # (index_put_ with accumulate) may add them in any order on the CPU
    x = torch.nn.functional.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    m_layers = None if masks is None else masks["layers"]
    loop = dict(remat=remat_on(cfg, want_taps), tap_policy=tap_policy)
    body = functools.partial(decoder_layer, positions=positions, cfg=cfg)
    aux = torch.zeros((), device=x.device)
    if not cfg.cross_attn_every:
        taps = _TapStack((cfg.n_layers,)) if want_taps else None
        x, aux = layer_loop(body, params["layers"], x, range(cfg.n_layers),
                            m_layers, aux, taps=taps, **loop)
        taps = {} if taps is None else taps.tree
    else:
        # a VLM's groups: NS self layers, then the group's cross layer
        G, NS = groups(cfg)
        cross = functools.partial(_cross_body, img=batch["img"].to(x.dtype),
                                  cfg=cfg)
        taps_s, taps_c = ((_TapStack((G, NS)), _TapStack((G,))) if want_taps
                          else (None, None))
        for g in range(G):
            x, aux = layer_loop(body, _index(params["layers"], g), x,
                                range(NS), _index(m_layers, g), aux,
                                taps=taps_s, at=(g,), **loop)
            x, aux = layer_loop(cross, params["cross_layers"], x,
                                range(g, g + 1), _cross_masks(masks), aux,
                                taps=taps_c, **loop)
        taps = ({"self": taps_s.tree, "cross": taps_c.tree} if want_taps
                else {})
    return _apply_norm(params["ln_f"], x, cfg), taps, aux


def lm_head(params, hidden, cfg):
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return hidden @ head.T.to(hidden.dtype)


def ce_loss(params, hidden, labels, cfg):
    """Mean cross-entropy over the valid (label >= 0) tokens."""
    return ce_of_logits(lm_head(params, hidden, cfg), labels)


def ce_of_logits(logits, labels):
    """``ce_loss`` from the head's logits."""
    tot, cnt = _ce_sums(logits, labels)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_sums(logits, labels):
    logits = logits.float()
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
    """An empty (L, batch, s_max) KV cache on the params' device; a VLM's
    (G, NS, batch, s_max), its cross KV left to ``prefill``."""
    one = attn.init_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                          getattr(torch, cfg.dtype),
                          device=params["embed"].device)
    L = groups(cfg) if cfg.cross_attn_every else (cfg.n_layers,)
    kv = attn.KVCache(*(t.expand(*L, *t.shape).clone() for t in one))
    return DecodeCache(kv=kv, t=0)


def precompute_cross_kv(params, img, cfg, *, masks=None) -> tuple:
    """A VLM's cross KV: each cross layer's (k, v) of the image states,
    stacked (G, B, P, kvH, dh), through the cross wk / wv masks (or their
    packed leaves), the projection ``cross_layer`` would otherwise run."""
    mc = _cross_masks(masks)
    mc = None if mc is None else mc.get("attn")
    kvs = [attn.precompute_cross_kv(
        _index(params["cross_layers"], g)["attn"], img, cfg,
        masks=_index(mc, g)) for g in range(groups(cfg)[0])]
    return tuple(torch.stack(t) for t in zip(*kvs))


@torch.no_grad()
def prefill(params, batch, cfg, cache: DecodeCache, *, masks=None):
    """Run the prompt, filling the cache. Returns (last-token logits
    (B, 1, V), cache).

    ``batch["n_valid"]`` (optional int, or a () integer tensor) marks a
    right-padded prompt: only the first ``n_valid`` tokens are real. The
    pad tail is masked out of the cache (pos = -1), the logits are taken
    at position ``n_valid - 1``, and decoding resumes at ``t = n_valid``
    (a tensor when ``n_valid`` is one: nothing reads it on the host).
    A VLM first projects ``batch["img"]`` into the cache's cross KV.
    """
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    if cfg.cross_attn_every:
        cache = cache._replace(cross_kv=precompute_cross_kv(
            params, batch["img"].to(x.dtype), cfg, masks=masks))
    positions = torch.arange(S, device=tokens.device)
    x = _run_layers(params, x, positions, cfg, masks=masks, mode="prefill",
                    cache=cache)
    kv, t_next, x_last = _finish_prefill(cache.kv, x, S, batch.get("n_valid"))
    x = _apply_norm(params["ln_f"], x_last, cfg)
    return lm_head(params, x, cfg), DecodeCache(kv=kv, t=t_next,
                                                cross_kv=cache.cross_kv)


def _finish_prefill(kv: attn.KVCache, x, S: int, n_valid):
    """-> (kv with pad keys masked, next position, last REAL hidden state).

    The next position is ``n_valid`` as given: a host int stays one (the
    fixed-batch clock), a tensor stays on the device.
    """
    if n_valid is None:
        return kv, S, x[:, -1:]
    nv = torch.as_tensor(n_valid, device=x.device)
    # pad slots were written with pos >= n_valid; -1 hides them from every
    # later query (the decode steps then overwrite them in order)
    kv.pos.masked_fill_(kv.pos >= nv, -1)
    return kv, n_valid, x.index_select(1, (nv - 1).reshape(1))


@torch.no_grad()
def prefill_window(params, batch, cfg, cache: DecodeCache, *, masks=None):
    """One fixed-width window of a chunked prefill. Returns (logits
    (B, 1, V), cache).

    ``batch`` carries ``tokens`` (B, W), the prompt slice at absolute
    positions ``[offset, offset + W)``, and () int64 tensors ``offset``
    (window start) and ``n_valid`` (the real prompt length). The cache
    must already hold KV for ``[0, offset)``; the window's KV is written
    in place and attends over prior slots and the window
    (``attention.window_attention``).

    Every call returns the logits at the last real prompt position seen
    so far (``min(n_valid, offset + W) - 1``) and masks written pad slots
    (pos >= n_valid) to -1, so only the final window's logits are the
    request's. ``cache.t`` advances to the window end, clamped to
    ``n_valid``.
    """
    tokens = batch["tokens"]
    W = tokens.shape[1]
    offset, n_valid = batch["offset"], batch["n_valid"]
    x = params["embed"][tokens]
    x = _run_layers(params, x, None, cfg, masks=masks, mode="window",
                    cache=cache, t=offset)
    cache.kv.pos.masked_fill_(cache.kv.pos >= n_valid, -1)
    # the last real row within this window (pad rows of the final window
    # sit past it)
    idx = torch.clamp(torch.minimum(n_valid, offset + W) - 1 - offset, 0,
                      W - 1)
    x_last = _apply_norm(params["ln_f"], x.index_select(1, idx.reshape(1)),
                         cfg)
    t_next = torch.minimum(offset + W, n_valid)
    return lm_head(params, x_last, cfg), DecodeCache(
        kv=cache.kv, t=t_next, cross_kv=cache.cross_kv)


@torch.no_grad()
def decode_step(params, token, cfg, cache: DecodeCache, *, masks=None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    cache advanced by one position).

    ``cache.t`` is a host int (the fixed-batch path) or a (B,) tensor of
    per-row clocks (the continuous scheduler); the layers see a (B,)
    int32 tensor either way, made on the device without a host read.
    """
    x = params["embed"][token]
    t = cache.kv.pos.new_zeros(token.shape[0]).add_(cache.t)
    x = _run_layers(params, x, None, cfg, masks=masks, mode="decode",
                    cache=cache, t=t)
    x = _apply_norm(params["ln_f"], x, cfg)
    return lm_head(params, x, cfg), DecodeCache(kv=cache.kv, t=cache.t + 1,
                                                cross_kv=cache.cross_kv)
