"""Multi-head self-attention: GQA/MQA, partial RoPE, sliding window.

The ``full`` path of the reference: one (S, S) score matrix per head,
written as a matmul and a softmax (as the reference writes it), so the
port computes the same function in the same order; plus the KV cache,
the prefill cache write and single-token decode against the cache.

Cache (single layer; the stacks add a leading L dim):
    KVCache.k/v : (B, S_max, kvH, dh)
    KVCache.pos : (B, S_max) int32 absolute position per slot, -1 = empty.
                  Decode writes slot t (the last slot once t >= S_max).

The port writes the cache in place (the reference returns a new one).
RoPE is applied at write time with absolute positions, so cached keys
never need re-rotation. Decode takes one position ``t`` for the whole
batch; per-row positions (continuous batching), rolling caches,
windowed prefill and cross-attention are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import common
from .common import dense

_NEG = -1e30

PRUNABLE_ATTN = ("wq", "wk", "wv", "wo")


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, S_max, kvH, dh)
    v: torch.Tensor         # (B, S_max, kvH, dh)
    pos: torch.Tensor       # (B, S_max) int32, -1 empty


def init_cache(batch: int, s_max: int, n_kv: int, dh: int, dtype, *,
               device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, s_max, n_kv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, s_max, n_kv, dh), dtype=dtype, device=device),
        pos=torch.full((batch, s_max), -1, dtype=torch.int32, device=device),
    )


def init_attn_params(gen, cfg, *, device) -> dict:
    """q/k/v/o projections, (d_out, d_in) each."""
    d = cfg.d_model
    dh, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = getattr(torch, cfg.dtype)
    p = {
        "wq": common.linear_init(gen, h * dh, d, dt, device),
        "wk": common.linear_init(gen, kvh * dh, d, dt, device),
        "wv": common.linear_init(gen, kvh * dh, d, dt, device),
        "wo": common.linear_init(gen, cfg.d_model, h * dh, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * dh, dtype=dt, device=device)
        p["bk"] = torch.zeros(kvh * dh, dtype=dt, device=device)
        p["bv"] = torch.zeros(kvh * dh, dtype=dt, device=device)
    return p


def _m(masks, name):
    return None if masks is None else masks.get(name)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, kvH, dh) -> (B, S, H, dh) by group repetition."""
    kvh = k.shape[-2]
    if kvh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kvh, dim=-2)


def _scores_mask(q_pos, k_pos, *, causal: bool, window: int) -> torch.Tensor:
    """(..., Sq, Sk) bool validity mask from absolute positions; a -1 key
    slot is empty. Shared positions give (Sq, Sk), per-row (B, Sq, Sk)."""
    q, k = q_pos[..., :, None], k_pos[..., None, :]
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
    if window > 0:
        valid = valid & (k > q - window)
    return valid


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,H,dh) k,v: (B,Sk,H,dh) mask: (Sq,Sk)|(B,Sq,Sk)
    -> (B,Sq,H,dh)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (dh ** -0.5)
    m = mask[None, None] if mask.ndim == 2 else mask[:, None]
    scores = torch.where(m, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _proj_qkv(p, x, cfg, masks, taps):
    B, S = x.shape[:2]
    q = dense(x, p["wq"], mask=_m(masks, "wq"), tap="wq", taps=taps,
              bias=p.get("bq")).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = dense(x, p["wk"], mask=_m(masks, "wk"), tap="wk", taps=taps,
              bias=p.get("bk")).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(x, p["wv"], mask=_m(masks, "wv"), tap="wv", taps=taps,
              bias=p.get("bv")).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _attend(p, q, k, v, mask, cfg, masks, taps):
    """Softmax attention of q over k/v, then the output projection."""
    out = _sdpa(q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads),
                mask)
    out = out.reshape(*q.shape[:2], cfg.n_heads * cfg.head_dim)
    return dense(out, p["wo"], mask=_m(masks, "wo"), tap="wo", taps=taps)


def self_attention(p, x, positions, cfg, *, masks=None, taps=None,
                   cache: KVCache | None = None, mode: str = "train"):
    """Full-sequence causal self attention (train / prefill).

    x: (B, S, d); positions: (S,). Returns (out, cache): with
    ``mode == "prefill"`` the prompt's keys and values fill the first S
    slots of ``cache`` (in place); otherwise the cache passes through.
    """
    q, k, v = _proj_qkv(p, x, cfg, masks, taps)
    pos = positions[None, :]
    q = common.apply_rope(q, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = common.apply_rope(k, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    if mode == "prefill" and cache is not None:
        S = k.shape[1]
        cache.k[:, :S] = k.to(cache.k.dtype)
        cache.v[:, :S] = v.to(cache.v.dtype)
        cache.pos[:, :S] = positions.to(torch.int32)
    mask = _scores_mask(positions, positions, causal=True,
                        window=cfg.sliding_window)
    return _attend(p, q, k, v, mask, cfg, masks, taps), cache


def decode_attention(p, x, t: int, cfg, cache: KVCache, *, masks=None,
                     taps=None):
    """One-token self attention against a cache.

    x: (B, 1, d); t: absolute position of the new token, the same for
    every row. Writes its key and value at slot min(t, S_max - 1) in
    place. Returns (out (B, 1, d), cache).
    """
    B = x.shape[0]
    q, k, v = _proj_qkv(p, x, cfg, masks, taps)
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = common.apply_rope(q, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = common.apply_rope(k, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    s_max = cache.k.shape[1]
    slot = min(t, s_max - 1)
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.pos[:, slot] = t
    mask = _scores_mask(pos, cache.pos, causal=True,
                        window=cfg.sliding_window)          # (B, 1, S_max)
    return _attend(p, q, cache.k, cache.v, mask, cfg, masks, taps), cache
