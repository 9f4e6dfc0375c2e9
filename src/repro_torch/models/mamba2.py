"""Mamba2 (SSD) mixer, the counterpart of the reference's ``models/mamba2``.

The selective state-space recurrence (per head h, scalar decay):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T        h: (dh, ds)
    y_t = h_t C_t + D * x_t

is evaluated in chunked form (Dao & Gu 2024): within a chunk of length Q
everything is dense matmuls; the chunk-boundary states pass from chunk to
chunk in a Python loop (the reference runs ``lax.associative_scan``; the
two differ only in the rounding of the fp32 sums). As in the reference,
decay factors appear only as ``exp(b_t - b_i)`` with ``b_t <= b_i``
subtracted before the exp, so the chunked path is stable for any dt, and
a ragged last chunk is zero-padded (dt = 0: decay 1, no input), which
leaves the final state and the real outputs exact. The in-chunk decay
sums b_t are ``common.inclusive_sum`` (a triangular product, fixed order
on the card), not ``torch.cumsum``, which has no deterministic CUDA
implementation: training's backward repeats bitwise. The intra-chunk
decay is masked above the diagonal before its exp, where the reference
masks after it: the same values, but the reference's backward is NaN
once a chunk's decay sum passes fp32's exp range (zamba2-7b at full
width: a step's loss is finite, its gradients NaN).

``ssd_chunked`` is plain torch in both packages (the reference's is plain
``jnp``, no Pallas kernel). ``in_proj`` and ``out_proj`` go through
``common.dense``, so a packed model's projections run ``ops.spmm``.
``ssm_step`` is the exact one-token recurrence decode runs; the chunked
path is tested against it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import common
from .common import dense

PRUNABLE_MAMBA = ("in_proj", "out_proj")


class SSMCache(NamedTuple):
    h: torch.Tensor      # (B, H, dh, ds) fp32 state
    conv: torch.Tensor   # (B, d_conv - 1, d_xbc) conv tail


def d_xbc(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba_params(gen, cfg, *, device) -> dict:
    D, di, H = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    dt = getattr(torch, cfg.dtype)
    d_proj = 2 * di + 2 * cfg.ssm_state + H      # [z, xBC..., dt]
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": common.linear_init(gen, d_proj, D, dt, device),
        "out_proj": common.linear_init(gen, D, di, dt, device),
        "conv_w": common.normal_init(gen, (cfg.ssm_conv, d_xbc(cfg)), 0.5,
                                     torch.float32, device),
        "conv_b": torch.zeros(d_xbc(cfg), **f32),
        "A_log": torch.zeros(H, **f32),            # A = -exp(A_log) = -1
        "D": torch.ones(H, **f32),
        "dt_bias": torch.full((H,), 0.5, **f32),
        "norm_scale": torch.ones(di, **f32),
    }


def _split_proj(proj, cfg):
    di = cfg.d_inner
    z = proj[..., :di]
    xbc = proj[..., di:di + d_xbc(cfg)]
    dt = proj[..., di + d_xbc(cfg):]
    assert dt.shape[-1] == cfg.n_ssm_heads
    return z, xbc, dt


def _causal_conv(xbc, p):
    """Depthwise causal conv of width d_conv by stacked shifts, summed in
    the reference's order. xbc: (B, S, C)."""
    w = p["conv_w"]                                    # (d_conv, C)
    S = xbc.shape[1]
    out = xbc.float() * w[-1]
    for i in range(1, w.shape[0]):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :S]
        out = out + shifted.float() * w[-1 - i]
    return F.silu(out + p["conv_b"]).to(xbc.dtype)


def _conv_step(x_t, tail, p):
    """One-token causal conv. x_t: (B, C); tail: (B, d_conv - 1, C)."""
    window = torch.cat([tail, x_t[:, None]], dim=1)     # (B, d_conv, C)
    out = torch.einsum("btc,tc->bc", window.float(), p["conv_w"])
    return F.silu(out + p["conv_b"]).to(x_t.dtype), window[:, 1:]


def _gated_norm(y, z, scale, eps=1e-5):
    g = y.float() * F.silu(z.float())
    var = (g * g).mean(-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _softplus(x):
    # jax.nn.softplus, logaddexp(x, 0), without torch's linear threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def ssd_chunked(x, Bm, Cm, dt, A, *, chunk: int, h0=None):
    """x: (B, S, H, dh); Bm, Cm: (B, S, ds); dt: (B, S, H) (post-softplus);
    A: (H,). Returns (y (B, S, H, dh) in x's dtype, h_final (B, H, dh, ds)
    fp32)."""
    Bsz, S, H, dh = x.shape
    ds = Bm.shape[-1]
    S0 = S
    if S % chunk:
        # zero-pad to a chunk multiple: dt = 0 gives decay exp(0) = 1 and
        # no input, so the final state and the real outputs are exact
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        S = S + pad
    NC, Q = S // chunk, chunk
    xc = x.reshape(Bsz, NC, Q, H, dh).float()
    Bc = Bm.reshape(Bsz, NC, Q, ds).float()
    Cc = Cm.reshape(Bsz, NC, Q, ds).float()
    dtc = dt.reshape(Bsz, NC, Q, H).float()

    la = dtc * A                                     # log decay, <= 0
    b = common.inclusive_sum(la, 2)                  # inclusive (B,NC,Q,H)
    b_last = b[:, :, -1:, :]                         # (B,NC,1,H)

    # intra-chunk: scores_ti = (C_t . B_i) * exp(b_t - b_i) * dt_i, i <= t
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)     # (B,NC,Q,Q)
    ldiff = b[:, :, :, None, :] - b[:, :, None, :, :]          # (B,NC,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # masked before the exp: above the diagonal b_t - b_i > 0 can pass
    # fp32's exp range (a 64-step chunk at full width), and exp's backward
    # there would be 0 * inf = NaN; below it the values are exp's own
    L = torch.exp(torch.where(tri[None, None, :, :, None], ldiff,
                              float("-inf")))
    scores = CB[..., None] * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnqkh,bnkhd->bnqhd", scores, xc)

    # chunk summaries: T_n = sum_i exp(b_Q - b_i) dt_i x_i B_i^T
    wght = torch.exp(b_last - b) * dtc                         # (B,NC,Q,H)
    T = torch.einsum("bnqhd,bnqs->bnhds", wght[..., None] * xc, Bc)
    a = torch.exp(b_last[:, :, 0, :])                          # (B,NC,H)

    # chunk states in order: h_n = a_n h_{n-1} + T_n
    h = (torch.zeros((Bsz, H, dh, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for n in range(NC):
        h_in.append(h)
        h = a[:, n, :, None, None] * h + T[:, n]
    h_in = torch.stack(h_in, dim=1)                            # (B,NC,H,dh,ds)

    # inter-chunk: y_t += exp(b_t) * C_t . h_in
    y_inter = torch.exp(b)[..., None] * torch.einsum(
        "bnqs,bnhds->bnqhd", Cc, h_in)
    y = (y_intra + y_inter).reshape(Bsz, S, H, dh)[:, :S0]
    return y.to(x.dtype), h


def ssm_step(x_t, B_t, C_t, dt_t, A, h):
    """Exact one-token recurrence. x_t: (B, H, dh); B_t, C_t: (B, ds);
    dt_t: (B, H); h: (B, H, dh, ds). Returns (y_t (B, H, dh), h')."""
    x32, dt32 = x_t.float(), dt_t.float()
    decay = torch.exp(dt32 * A)                                # (B,H)
    upd = torch.einsum("bh,bhd,bs->bhds", dt32, x32, B_t.float())
    h_new = decay[..., None, None] * h + upd
    y = torch.einsum("bhds,bs->bhd", h_new, C_t.float())
    return y.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# the mixer block
# ---------------------------------------------------------------------------

def _ssm_inputs(xbc, dt_raw, p, cfg):
    di, ds = cfg.d_inner, cfg.ssm_state
    xs = xbc[..., :di].reshape(*xbc.shape[:-1], cfg.n_ssm_heads,
                               cfg.ssm_head_dim)
    Bm = xbc[..., di:di + ds]
    Cm = xbc[..., di + ds:]
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, Bm, Cm, dt, A


def mamba_block(p, x, cfg, *, masks=None, taps=None,
                return_cache: bool = False):
    """Full-sequence Mamba2 mixer. x: (B, S, D) -> (B, S, D) [, SSMCache]."""
    m = (lambda n: None) if masks is None else masks.get
    proj = dense(x, p["in_proj"], mask=m("in_proj"), tap="in_proj",
                 taps=taps)
    z, xbc_raw, dt_raw = _split_proj(proj, cfg)
    xs, Bm, Cm, dt, A = _ssm_inputs(_causal_conv(xbc_raw, p), dt_raw, p, cfg)
    y, h_fin = ssd_chunked(xs, Bm, Cm, dt, A, chunk=cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(*x.shape[:-1], cfg.d_inner)
    y = _gated_norm(y, z, p["norm_scale"]).to(x.dtype)
    out = dense(y, p["out_proj"], mask=m("out_proj"), tap="out_proj",
                taps=taps)
    if return_cache:
        tail = xbc_raw[:, -(cfg.ssm_conv - 1):].to(x.dtype)
        return out, SSMCache(h=h_fin, conv=tail)
    return out


def mamba_decode(p, x_t, cache: SSMCache, cfg, *, masks=None, taps=None):
    """One-token Mamba2 step. x_t: (B, 1, D). Returns (out (B, 1, D),
    cache')."""
    m = (lambda n: None) if masks is None else masks.get
    proj = dense(x_t[:, 0], p["in_proj"], mask=m("in_proj"), tap="in_proj",
                 taps=taps)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, conv_tail = _conv_step(xbc, cache.conv, p)
    xs, Bm, Cm, dt, A = _ssm_inputs(xbc, dt_raw, p, cfg)
    y, h_new = ssm_step(xs, Bm, Cm, dt, A, cache.h)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(-1, cfg.d_inner)
    y = _gated_norm(y, z, p["norm_scale"]).to(x_t.dtype)
    out = dense(y, p["out_proj"], mask=m("out_proj"), tap="out_proj",
                taps=taps)
    return out[:, None], SSMCache(h=h_new, conv=conv_tail)


def init_ssm_cache(batch: int, cfg, dtype, *, device) -> SSMCache:
    return SSMCache(
        h=torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_xbc(cfg)), dtype=dtype,
                         device=device),
    )
