"""Multi-head self-attention: GQA/MQA, partial RoPE, sliding window.

The ``full`` path of the reference: one (S, S) score matrix per head,
written as a matmul and a softmax (as the reference writes it), so the
port computes the same function in the same order; plus the KV cache,
the prefill cache write, the windowed-prefill continuation and
single-token decode against the cache.

Cache (single layer; the stacks add a leading L dim):
    KVCache.k/v : (B, S_max, kvH, dh)
    KVCache.pos : (B, S_max) int32 absolute position per slot, -1 = empty.
                  Decode writes slot t (the last slot once t >= S_max),
                  each row at its own position ``t``, a (B,) tensor.

The port writes the cache in place (the reference returns a new one).
RoPE is applied at write time with absolute positions, so cached keys
never need re-rotation. Rolling caches come with the sliding-window
configs (ROADMAP A4; the dense configs have ``sliding_window = 0``), and
cross-attention with its families.
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


def window_attention(p, x, offset, cfg, cache: KVCache, *, masks=None,
                     taps=None):
    """Windowed-prefill continuation: a W-token window against prior KV.

    x: (B, W, d), the prompt slice at absolute positions
    ``[offset, offset + W)``; ``offset`` is a () integer tensor (read by
    no host code), so every window of a chunked prefill runs one shape.
    The cache already holds KV for positions ``[0, offset)``; the
    window's KV is written at slots ``[offset, offset + W)`` first (in
    place), then the window's queries attend over the WHOLE cache with
    the positional mask doing the causal and empty-slot filtering.

    As in the reference, every per-row reduction has the length of the
    one-shot prefill over the same cache capacity (scores and
    probs @ v run over all ``s_max`` slots; empty slots carry pos = -1,
    underflow to an exact 0 in the softmax and add exact zeros), so
    chunked prefill reproduces one-shot prefill wherever the projections
    give each row the same sums at both row counts.
    """
    W = x.shape[1]
    q, k, v = _proj_qkv(p, x, cfg, masks, taps)
    pos_w = offset + torch.arange(W, device=x.device)
    q = common.apply_rope(q, pos_w[None, :], pct=cfg.rope_pct,
                          theta=cfg.rope_theta)
    k = common.apply_rope(k, pos_w[None, :], pct=cfg.rope_pct,
                          theta=cfg.rope_theta)
    cache.k.index_copy_(1, pos_w, k.to(cache.k.dtype))
    cache.v.index_copy_(1, pos_w, v.to(cache.v.dtype))
    cache.pos.index_copy_(1, pos_w, pos_w.to(torch.int32)
                          .expand(x.shape[0], W))
    # (B, W, s_max): per-row key positions (prior windows' slots hold
    # their absolute positions, untouched slots hold -1)
    mask = _scores_mask(pos_w, cache.pos, causal=True,
                        window=cfg.sliding_window)
    return _attend(p, q, cache.k, cache.v, mask, cfg, masks, taps), cache


def decode_attention(p, x, t, cfg, cache: KVCache, *, masks=None,
                     taps=None):
    """One-token self attention against a cache.

    x: (B, 1, d); t: (B,) int32 tensor, each row's absolute position
    (one value repeated on the fixed-batch path; per row under continuous
    batching, where each slot of the decode batch sits at its own
    position). Writes each row's key and value at slot
    min(t, S_max - 1) in place. Returns (out (B, 1, d), cache).
    """
    B = x.shape[0]
    q, k, v = _proj_qkv(p, x, cfg, masks, taps)
    pos = t[:, None]
    slot = torch.clamp_max(t, cache.k.shape[1] - 1).long()
    rows = torch.arange(B, device=x.device)
    q = common.apply_rope(q, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = common.apply_rope(k, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    cache.pos[rows, slot] = t
    mask = _scores_mask(pos, cache.pos, causal=True,
                        window=cfg.sliding_window)          # (B, 1, S_max)
    return _attend(p, q, cache.k, cache.v, mask, cfg, masks, taps), cache
