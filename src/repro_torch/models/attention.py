"""Multi-head self-attention: GQA/MQA, partial RoPE, sliding window.

The ``full`` path of the reference: one (S, S) score matrix per head,
written as a matmul and a softmax (as the reference writes it), so the
port computes the same function in the same order. Caches, decode,
windowed prefill and cross-attention come with the serving slice.
"""
from __future__ import annotations

import torch

from . import common
from .common import dense

_NEG = -1e30

PRUNABLE_ATTN = ("wq", "wk", "wv", "wo")


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
    """(Sq, Sk) bool validity mask from absolute positions."""
    q, k = q_pos[..., :, None], k_pos[..., None, :]
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
    if window > 0:
        valid = valid & (k > q - window)
    return valid


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,H,dh) k,v: (B,Sk,H,dh) mask: (Sq,Sk) -> (B,Sq,H,dh)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (dh ** -0.5)
    scores = torch.where(mask[None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def self_attention(p, x, positions, cfg, *, masks=None, taps=None):
    """Full-sequence causal self attention. x: (B, S, d); positions: (S,)."""
    B, S = x.shape[:2]
    q = dense(x, p["wq"], mask=_m(masks, "wq"), tap="wq", taps=taps,
              bias=p.get("bq")).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = dense(x, p["wk"], mask=_m(masks, "wk"), tap="wk", taps=taps,
              bias=p.get("bk")).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(x, p["wv"], mask=_m(masks, "wv"), tap="wv", taps=taps,
              bias=p.get("bv")).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    pos = positions[None, :]
    q = common.apply_rope(q, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = common.apply_rope(k, pos, pct=cfg.rope_pct, theta=cfg.rope_theta)
    mask = _scores_mask(positions, positions, causal=True,
                        window=cfg.sliding_window)
    out = _sdpa(q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads), mask)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return dense(out, p["wo"], mask=_m(masks, "wo"), tap="wo", taps=taps)
