"""Packed sparse matmul with a fused epilogue: the CUDA kernel's launcher,
its plain PyTorch version, and the epilogue table.

``y = act(x @ (mask ⊙ W)ᵀ + b)`` from a ``core.packed`` format (nm24 or
gathered), for one weight or, stacked, for each of E (x_e, W_e) pairs in
one launch (MoE experts). The kernels (``csrc/spmm.cu``) replace the
Pallas TPU kernel ``src/repro/kernels/spmm.py::_spmm_kernel``; the
source's head note
gives the design and what bounds it. In short, for bf16: in nm24 (2:4)
a producer warp streams 128-row x 128-column tiles of packed values,
positions and x by TMA through a ring of 4 shared-memory stages, and 8
warps build their ``mma.sync`` A fragments in registers from the
(value, position) pairs — no dense tile in shared memory; in gathered
each row's (value, column) slots stream into rings in shared memory by
bulk copies, each slot read once; 8 scatter warps, two lanes a row, walk
them into dense A tiles there, which 8 other warps (also the rings'
copiers) multiply, while a producer warp streams x by TMA.
Both split d_in by one plan, a function of the shapes (whole 128-column
tiles; one block per SM; scratch no larger than the nm24 weight), and
run the same MMA chain per output element, so the two packings of one
2:4 mask give bitwise equal y. Both are bound by the weight bytes they
stream; 2:4 sparse MMA (``mma.sp``) is not used, since it would break
that equality. ``launch`` always runs a stack, which replaces the
reference's ``vmap`` of that kernel (``spmm.py::spmm_stacked``): each
kernel takes the expert from its grid's z axis and runs it under the
unstacked call's split plan, so every expert's y is bitwise that of a
stack of one (an unstacked call) on its slice.
``repro_torch.kernels.ops.spmm`` (and ``spmm_nm24``/``spmm_gather``) and
``ops.spmm_stacked`` are the public wrappers.

Both versions compute in fp32 — products, sum, bias and activation —
and cast once to x's dtype, as the reference's ``_dispatch`` does.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.packed import PackedWeight, unpack

from . import build


def relu2(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu default is the tanh approximation
    return F.gelu(x, approximate="tanh")


# activations servable as a fused epilogue; the kernel's codes follow
# this order (0 = none)
EPILOGUES = {
    "silu": F.silu,
    "gelu": gelu_tanh,
    "relu": F.relu,
    "relu2": relu2,
    "sigmoid": torch.sigmoid,
}
_ACT_CODE = {None: 0, **{name: i + 1 for i, name in enumerate(EPILOGUES)}}


def apply_epilogue(y: torch.Tensor, bias=None, act: str | None = None):
    """``act(y + bias)`` — the unfused epilogue, in y's dtype."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act is not None:
        y = EPILOGUES[act](y)
    return y


def spmm_plain(x2: torch.Tensor, pw: PackedWeight, bias=None,
               act: str | None = None) -> torch.Tensor:
    """Unpack to a dense fp32 weight, one matmul, the epilogue in fp32,
    one cast to x's dtype. x2: (T, d_in); pw unstacked (d_out, k)."""
    w32 = unpack(pw).float()
    y = apply_epilogue(x2.float() @ w32.T,
                       None if bias is None else bias.float(), act)
    return y.to(x2.dtype)


def spmm_stacked_plain(x3: torch.Tensor, pw: PackedWeight, bias=None,
                       act: str | None = None) -> torch.Tensor:
    """``spmm_plain`` per slice: x3 (E, T, d_in), pw stacked (E, d_out, k)
    -> (E, T, d_out); one ``bias`` (d_out,) for every slice."""
    return torch.stack([
        spmm_plain(x3[e], dataclasses.replace(pw, values=pw.values[e],
                                              idx=pw.idx[e]), bias, act)
        for e in range(x3.shape[0])])


_FNS: dict[str, object] = {}


def _lib_fn(name: str, argtypes, restype):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("spmm"), name)
        fn.argtypes, fn.restype = argtypes, restype
        _FNS[name] = fn
    return fn


def launch(x3: torch.Tensor, pw: PackedWeight, bias, act: str | None,
           y: torch.Tensor) -> None:
    """Run the kernels once over a stack: y[e] = act(x3[e] @
    unpack(pw[e])ᵀ + bias); an unstacked call is a stack of one.

    x3: (E, T, d_in) contiguous fp32/bf16 CUDA tensor, E, T > 0, 16-byte
    aligned; pw.values (E, d_out, k) (or (d_out, k) when E = 1)
    contiguous in x3's dtype; pw.idx contiguous uint8 (nm24) or int32
    (gathered) of the same shape; bias
    contiguous fp32 (d_out,) or None; y (E, T, d_out) contiguous in x3's
    dtype. The caller checks all of it. Split-d_in scratch is allocated
    here.
    """
    E, T, d_in = x3.shape
    d_out, k = pw.values.shape[-2:]
    kind = 0 if pw.fmt == "nm24" else 1
    bf16 = int(x3.dtype == torch.bfloat16)
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    run = _lib_fn("spmm_run_stacked", [c_ptr] * 6 + [c_int] * 10 + [c_ptr],
                  c_int)
    with torch.cuda.device(x3.device):
        n_ws = _lib_fn("spmm_workspace_stacked", [c_int] * 8,
                       ctypes.c_longlong)(E, T, d_in, d_out, pw.n, pw.m, kind,
                                          bf16)
        ws = torch.empty(n_ws, dtype=torch.float32, device=x3.device) \
            if n_ws else None
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = run(x3.data_ptr(), pw.values.data_ptr(), pw.idx.data_ptr(),
                  None if bias is None else bias.data_ptr(), y.data_ptr(),
                  None if ws is None else ws.data_ptr(), E, T, d_in, d_out, k,
                  pw.n, pw.m, _ACT_CODE[act], kind, bf16, stream)
    if err != 0:
        raise RuntimeError(f"spmm kernel launch failed: CUDA error {err}")
