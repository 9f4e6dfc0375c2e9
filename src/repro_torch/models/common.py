"""Shared model building blocks.

Conventions (as in the reference package):
* params are nested dicts of tensors; linear weights are (d_out, d_in) —
  the paper's orientation, so pruning masks apply as ``(M ⊙ W)``;
* every prunable linear goes through ``dense``, which applies an optional
  pruning mask and, when given a ``Taps``, accumulates the calibration
  statistics of its input (paper §2.1.2);
* a ``core.packed.PackedWeight`` leaf (serving a packed sparse model)
  dispatches to ``kernels.ops.spmm`` with the bias and activation fused
  (a leaf stacked on the expert dim, in ``models.moe``, to
  ``kernels.ops.spmm_stacked``);
* the compute dtype follows the params (bf16 on the card); Gram taps and
  norms are fp32.

The reference routes ``dense`` through a global ``MatmulPolicy``
(``use_matmul_policy``, ``kernel=auto|pallas|jnp``). The port has no
such knob: the device of the tensors decides. On a CUDA tensor a packed
leaf runs the hand-written spmm kernel; on a CPU tensor it runs the
kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.packed import PackedWeight
from repro_torch.kernels import ops
from repro_torch.kernels.spmm import EPILOGUES, apply_epilogue  # noqa: F401


class TapPolicy:
    """Decides what calibration statistics a tap site emits, and how.

    * ``fields(name)`` — which of ``("g", "d", "s", "n")`` the tap named
      ``name`` emits: the (d, d) Gram contribution, its diagonal only
      (Σx² per feature, the moments level), the feature sums and the
      token count. An empty tuple skips the tap.
    * ``gram(x2)`` — XᵀX in fp32 for a flattened (tokens, d) chunk in
      the activations' own dtype (bf16 on the card): products of bf16
      values are exact in fp32, so only the order of the fp32 sums is the
      policy's. Calibration installs a policy that sends it to the CUDA
      kernel (``repro_torch.pruning.stats.CalibSpec``).
    * ``gram_experts(x3)`` — the MoE variant: X_eᵀX_e in fp32 per expert
      of an expert-major capacity buffer (E, tokens, d), -> (E, d, d).
    """

    def fields(self, name: str) -> tuple[str, ...]:
        return ("g", "s", "n")

    def gram(self, x2: torch.Tensor) -> torch.Tensor:
        x = x2.float()
        return x.T @ x

    def gram_experts(self, x3: torch.Tensor) -> torch.Tensor:
        x = x3.float()
        return torch.einsum("eti,etj->eij", x, x)


DEFAULT_TAP_POLICY = TapPolicy()


class Taps:
    """One layer's tap entries, ``entries[name] = {g, s, n}``, and the
    policy that computes them. The reference keeps the policy in a
    module-level variable; here it travels with the entries."""

    def __init__(self, policy: TapPolicy | None = None):
        self.policy = policy or DEFAULT_TAP_POLICY
        self.entries: dict[str, dict] = {}


def emit_tap(taps: Taps, name: str, x: torch.Tensor) -> None:
    """Accumulate ``x``'s calibration statistics into ``taps.entries[name]``
    (created on first use), as ``taps.policy`` selects them."""
    pol = taps.policy
    fields = pol.fields(name)
    if not fields:
        return
    xd = x.reshape(-1, x.shape[-1])
    x2 = xd.float()
    ent = {}
    if "g" in fields:
        ent["g"] = pol.gram(xd)
    if "d" in fields:
        ent["d"] = (x2 * x2).sum(0)
    if "s" in fields:
        ent["s"] = x2.sum(0)
    if "n" in fields:
        ent["n"] = torch.tensor(float(x2.shape[0]), device=x2.device)
    prev = taps.entries.get(name)
    taps.entries[name] = ent if prev is None else {
        k: prev[k] + v for k, v in ent.items()}


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (scale * x).to(dtype)


def linear_init(gen: torch.Generator, d_out: int, d_in: int, dtype,
                device) -> torch.Tensor:
    return normal_init(gen, (d_out, d_in), d_in ** -0.5, dtype, device)


# ---------------------------------------------------------------------------
# dense layer with mask + gram tap
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor, *, mask: torch.Tensor | None = None,
          tap: str | None = None, taps: Taps | None = None,
          bias: torch.Tensor | None = None, act: str | None = None) -> torch.Tensor:
    """y = act(x @ (mask ⊙ w)ᵀ + bias). x: (..., d_in), w: (d_out, d_in)
    or a ``PackedWeight``.

    With a ``Taps`` and a ``tap`` name, first accumulates the statistics
    of ``x`` under that name (``emit_tap``). A packed ``w`` already
    encodes its mask (``mask`` must be None) and runs ``ops.spmm`` with
    ``bias``/``act`` fused on the fp32 sum; a dense ``w`` applies them in
    the compute dtype, as the reference does.
    """
    if taps is not None and tap is not None:
        emit_tap(taps, tap, x)
    if isinstance(w, PackedWeight):
        if mask is not None:
            raise ValueError("PackedWeight already encodes its mask; "
                             "serve packed params with masks=None")
        return ops.spmm(x, w, bias=bias, act=act)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return apply_epilogue(x @ w.T.to(x.dtype), bias, act)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def inclusive_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)`` as a product with a lower-triangular ones
    matrix over that (short: a scan chunk's) axis. torch.cumsum has no
    deterministic implementation for floating CUDA tensors; a matmul sums
    in an order fixed by the shape, on the card (TF32 off) and the CPU,
    in the forward and the backward."""
    n = x.shape[dim]
    tri = torch.ones((n, n), dtype=x.dtype, device=x.device).tril()
    return torch.movedim(torch.matmul(tri, torch.movedim(x, dim, -2)), -2,
                         dim)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_rot: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    return 1.0 / theta ** exps


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, pct: float = 1.0,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the leading ``pct`` fraction of the head dim.

    x: (B, S, H, Dh); positions: (B, S). Pairs are interleaved
    (dims 2i, 2i+1), as in the reference.
    """
    dh = x.shape[-1]
    d_rot = int(dh * pct) // 2 * 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, device=x.device)         # (d_rot/2,)
    ang = positions[..., None].float() * freqs                 # (B, S, d_rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)
