"""RWKV6 "Finch" time-mix and channel-mix, the counterpart of the
reference's ``models/rwkv6``.

Per head (key dim = value dim = cfg.rwkv_head_dim), the WKV recurrence
with per-channel data-dependent decay w_t in (0,1)^dh and bonus u:

    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv_chunked`` evaluates it in chunks of C = cfg.rwkv_chunk as matmuls,
with b_t = cumsum(log w) and the per-channel midpoint beta = b_C / 2:

    r~_t = r_t * exp(b_{t-1} - beta),   k~_i = k_i * exp(beta - b_i)
    intra = strict_lower(r~ k~^T) + diag(r_t . (u*k_t))
    o     = intra @ V + (exp(b_{t-1}) * r_t) @ S_in
    S_out = exp(b_C) * S_in + (exp(b_C - b_i) * k_i)^T V

The midpoint split bounds every exponent by |b_C|/2 <= 88 (log w clamped
to [LOGW_MIN, 0), C = 16), inside fp32's range and far outside bf16's,
so every exponent and product here is fp32. The reference combines the
chunk states with ``lax.associative_scan``; the port passes them from
chunk to chunk in a Python loop, as ``models.mamba2.ssd_chunked`` does:
the two differ only in the order of the fp32 sums. b_t is
``common.inclusive_sum``, a triangular product in a fixed order on the
card, where ``torch.cumsum`` has no deterministic implementation.

The WKV and the token-shift interpolation (``_ddlerp``, whose small
LoRA products are fp32 matmuls) are plain torch in both packages, no
Pallas kernel. The ten prunable linears go through ``common.dense``, so a
packed model's projections run ``ops.spmm`` (wg with the silu epilogue,
cm_wk with relu2). ``wkv_step`` is the exact one-token recurrence decode
runs; the chunked path is tested against it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import common
from .common import dense

LOGW_MIN = -11.0  # per-step clamp; exp(-11) ≈ 1.7e-5 decay

PRUNABLE_RWKV = ("wr", "wk", "wv", "wg", "wo", "td_w1", "td_w2",
                 "cm_wk", "cm_wv", "cm_wr")


class RWKVCache(NamedTuple):
    s: torch.Tensor      # (B, H, dh, dh) fp32 wkv state
    x_tm: torch.Tensor   # (B, D) previous token (time-mix shift)
    x_cm: torch.Tensor   # (B, D) previous token (channel-mix shift)


def init_rwkv_params(gen, cfg, *, device) -> dict:
    """One layer's time-mix and channel-mix leaves, the reference's shapes,
    dtypes and init scales."""
    D, Fd = cfg.d_model, cfg.d_ff
    H, dh = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    lm, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    dt = getattr(torch, cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def lin(d_out, d_in):
        return common.linear_init(gen, d_out, d_in, dt, device)

    return {
        # time-mix projections (prunable)
        "wr": lin(D, D), "wk": lin(D, D), "wv": lin(D, D), "wg": lin(D, D),
        "wo": lin(D, D),
        # data-dependent decay LoRA (prunable)
        "td_w1": lin(ld, D), "td_w2": lin(D, ld),
        # token-shift ddlerp (small, unpruned)
        "maa_x": torch.zeros(D, **f32),
        "maa_rkvwg": torch.zeros((5, D), **f32),
        "maa_w1": common.normal_init(gen, (5 * lm, D), D ** -0.5,
                                     torch.float32, device),
        "maa_w2": common.normal_init(gen, (5, D, lm), lm ** -0.5,
                                     torch.float32, device),
        "decay_base": torch.full((D,), -4.0, **f32),
        "u": common.normal_init(gen, (H, dh), 0.1, torch.float32, device),
        "ln_x_scale": torch.ones(D, **f32),
        "ln_x_bias": torch.zeros(D, **f32),
        # channel-mix (prunable)
        "cm_wk": lin(Fd, D), "cm_wv": lin(D, Fd), "cm_wr": lin(D, D),
        "cm_maa_k": torch.zeros(D, **f32),
        "cm_maa_r": torch.zeros(D, **f32),
    }


def _getter(masks):
    return (lambda n: None) if masks is None else masks.get


def _shift(x, x_prev=None):
    """Token shift: y_t = x_{t-1}. x: (B, S, D); x_prev: (B, D) carry-in."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x, sx):
    """Data-dependent token-shift interpolation -> (xw, xk, xv, xr, xg)."""
    dx = (sx - x).float()
    x32 = x.float()
    base = x32 + dx * p["maa_x"]
    z = torch.tanh(base @ p["maa_w1"].T)                  # (B, S, 5*lm)
    lm = p["maa_w2"].shape[-1]
    z5 = z.reshape(*z.shape[:-1], 5, lm)
    mix = torch.einsum("...fl,fdl->f...d", z5, p["maa_w2"])
    outs = x32[None] + dx[None] * (p["maa_rkvwg"][:, None, None, :] + mix)
    return tuple(outs[i].to(x.dtype) for i in range(5))


def _decay(p, xw, masks=None, taps=None):
    """Per-channel log decay, clamped for the chunked path. (B, S, D) fp32."""
    m = _getter(masks)
    h = dense(xw, p["td_w1"], mask=m("td_w1"), tap="td_w1", taps=taps)
    lo = dense(torch.tanh(h.float()).to(xw.dtype), p["td_w2"],
               mask=m("td_w2"), tap="td_w2", taps=taps)
    ww = p["decay_base"] + lo.float()
    return torch.clamp(-torch.exp(ww), LOGW_MIN, -1e-8)


def _groupnorm_heads(o, scale, bias, n_heads, eps=64e-5):
    """LayerNorm within each head (RWKV's GroupNorm(H)); fp32 out."""
    B, S, D = o.shape
    oh = o.reshape(B, S, n_heads, D // n_heads).float()
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, unbiased=False)
    oh = (oh - mu) * torch.rsqrt(var + eps)
    return oh.reshape(B, S, D) * scale + bias


# ---------------------------------------------------------------------------
# chunked WKV
# ---------------------------------------------------------------------------

def wkv_chunked(r, k, v, logw, u, *, chunk: int, s0=None):
    """r, k, v: (B, S, H, dh); logw: (B, S, H, dh) fp32 (< 0); u: (H, dh).

    Returns (o (B, S, H, dh) in r's dtype, s_final (B, H, dh, dh) fp32).
    """
    B, S, H, dh = r.shape
    S0 = S
    if S % chunk:
        # zero-pad: logw = 0 gives decay 1 and k = v = 0 add nothing, so
        # the final state and the real outputs are exact
        pad = (0, 0, 0, 0, 0, chunk - S % chunk)
        r, k, v, logw = (F.pad(t, pad) for t in (r, k, v, logw))
        S = r.shape[1]
    NC, C = S // chunk, chunk
    rs = r.reshape(B, NC, C, H, dh).float()
    ks = k.reshape(B, NC, C, H, dh).float()
    vs = v.reshape(B, NC, C, H, dh).float()
    lw = logw.reshape(B, NC, C, H, dh).float()

    b = common.inclusive_sum(lw, 2)                   # inclusive
    b_prev = b - lw                                   # exclusive (b_{t-1})
    b_last = b[:, :, -1]                              # (B, NC, H, dh)
    beta = 0.5 * b_last[:, :, None]                   # midpoint

    r_t = rs * torch.exp(b_prev - beta)
    k_t = ks * torch.exp(beta - b)
    scores = torch.einsum("bnthd,bnihd->bnhti", r_t, k_t)     # (B,NC,H,C,C)
    strict = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(strict, scores, 0.0)
    du = torch.einsum("bnthd,bnthd->bnht", rs, u * ks)
    scores = scores + torch.eye(C, device=r.device) * du[..., None]
    o_intra = torch.einsum("bnhti,bnihd->bnthd", scores, vs)

    # chunk summaries
    k_dec = ks * torch.exp(b_last[:, :, None] - b)             # <= k
    T = torch.einsum("bnihd,bnihv->bnhdv", k_dec, vs)          # (B,NC,H,dh,dh)
    a = torch.exp(b_last)                                      # (B,NC,H,dh)

    # chunk states in order: s_n = a_n s_{n-1} + T_n
    s = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    s_in = []
    for n in range(NC):
        s_in.append(s)
        s = a[:, n, :, :, None] * s + T[:, n]
    s_in = torch.stack(s_in, dim=1)                            # (B,NC,H,dh,dh)

    o_inter = torch.einsum("bnthd,bnhdv->bnthv", rs * torch.exp(b_prev), s_in)
    o = (o_intra + o_inter).reshape(B, S, H, dh)[:, :S0]
    return o.to(r.dtype), s


def wkv_step(r_t, k_t, v_t, logw_t, u, s):
    """Exact one-token WKV. r/k/v/logw: (B, H, dh); s: (B, H, dh, dh)."""
    r32, k32, v32 = r_t.float(), k_t.float(), v_t.float()
    kv = torch.einsum("bhd,bhv->bhdv", k32, v32)
    o = torch.einsum("bhd,bhdv->bhv", r32, s + u[None, :, :, None] * kv)
    s_new = torch.exp(logw_t)[..., None] * s + kv
    return o.to(r_t.dtype), s_new


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _projections(p, xr, xk, xv, xg, m, taps):
    r = dense(xr, p["wr"], mask=m("wr"), tap="wr", taps=taps)
    k = dense(xk, p["wk"], mask=m("wk"), tap="wk", taps=taps)
    v = dense(xv, p["wv"], mask=m("wv"), tap="wv", taps=taps)
    g = dense(xg, p["wg"], mask=m("wg"), tap="wg", taps=taps, act="silu")
    return r, k, v, g


def _output(p, o, g, x_dtype, n_heads, m, taps):
    """Group norm, the fp32 gate and wo. o: (B, S, D)."""
    o = _groupnorm_heads(o, p["ln_x_scale"], p["ln_x_bias"], n_heads)
    o = (o * g.float()).to(x_dtype)
    return dense(o, p["wo"], mask=m("wo"), tap="wo", taps=taps)


def time_mix(p, x, cfg, *, masks=None, taps=None,
             cache: RWKVCache | None = None):
    """Full-sequence time-mix. x: (B, S, D). Returns (out, s_final,
    x_last)."""
    m = _getter(masks)
    H, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    sx = _shift(x, None if cache is None else cache.x_tm)
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    r, k, v, g = _projections(p, xr, xk, xv, xg, m, taps)
    logw = _decay(p, xw, masks=masks, taps=taps)
    B, S, D = x.shape
    shp = (B, S, H, dh)
    o, s_fin = wkv_chunked(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                           logw.reshape(shp), p["u"], chunk=cfg.rwkv_chunk,
                           s0=None if cache is None else cache.s)
    out = _output(p, o.reshape(B, S, D), g, x.dtype, H, m, taps)
    return out, s_fin, x[:, -1]


def channel_mix(p, x, cfg, *, masks=None, taps=None, x_prev=None):
    """RWKV channel-mix (squared-relu MLP with token shift). Returns (out,
    x_last)."""
    m = _getter(masks)
    sx = _shift(x, x_prev)
    dx = (sx - x).float()
    xk = (x.float() + dx * p["cm_maa_k"]).to(x.dtype)
    xr = (x.float() + dx * p["cm_maa_r"]).to(x.dtype)
    k = dense(xk, p["cm_wk"], mask=m("cm_wk"), tap="cm_wk", taps=taps,
              act="relu2")
    kv = dense(k, p["cm_wv"], mask=m("cm_wv"), tap="cm_wv", taps=taps)
    rgate = torch.sigmoid(
        dense(xr, p["cm_wr"], mask=m("cm_wr"), tap="cm_wr", taps=taps).float())
    return (rgate * kv.float()).to(x.dtype), x[:, -1]


def time_mix_decode(p, x_t, cache: RWKVCache, cfg, *, masks=None,
                    taps=None):
    """One-token time-mix. x_t: (B, 1, D). Returns (out, s_new, x_last)."""
    m = _getter(masks)
    H, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x_t, cache.x_tm[:, None])
    r, k, v, g = _projections(p, xr, xk, xv, xg, m, taps)
    logw = _decay(p, xw, masks=masks, taps=taps)
    B = x_t.shape[0]
    shp = (B, H, dh)
    o, s_new = wkv_step(r[:, 0].reshape(shp), k[:, 0].reshape(shp),
                        v[:, 0].reshape(shp), logw[:, 0].reshape(shp),
                        p["u"], cache.s)
    out = _output(p, o.reshape(B, 1, -1), g, x_t.dtype, H, m, taps)
    return out, s_new, x_t[:, -1]
