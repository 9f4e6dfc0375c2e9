"""Gram accumulation XᵀX in fp32: the CUDA kernel's launcher and its
plain PyTorch versions, unstacked (x (T, d)) and stacked (x (E, T, d) ->
(E, d, d), one Gram per MoE expert; the launcher always takes a stack).

The kernel (``csrc/gram.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gram.py::_kernel`` and, stacked, the reference's
``vmap`` of it (``kernels/ops.py::gram_xtx_stacked``): the expert is the
grid's y axis, so a stacked call is one launch. See the source for its
design and what bounds it. bf16 activations run on the tensor cores, fp32
ones on the CUDA cores. ``repro_torch.kernels.ops.gram_xtx`` and
``gram_xtx_stacked`` are the public wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SYMBOLS = {torch.float32: "gram_xtx_stacked_f32",
            torch.bfloat16: "gram_xtx_stacked_bf16"}
# the row length each path reads in: a multiple of 16 bytes (the TMA's row
# stride for bf16, 16-byte cp.async for fp32)
_ROW_ALIGN = {torch.float32: 4, torch.bfloat16: 8}


def gram_xtx_plain(x: torch.Tensor) -> torch.Tensor:
    """Xᵀ X with fp32 accumulation. x: (tokens, d) fp32 or bf16."""
    x32 = x.float()
    return x32.T @ x32


def gram_xtx_stacked_plain(x: torch.Tensor) -> torch.Tensor:
    """X_eᵀ X_e per slice with fp32 accumulation. x: (E, tokens, d) fp32
    or bf16 -> (E, d, d) fp32."""
    x32 = x.float()
    return torch.einsum("eti,etj->eij", x32, x32)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """x (..., T, d) as the kernel reads it: contiguous, 16-byte aligned,
    rows of a multiple of ``_ROW_ALIGN`` elements. Where x is not so
    already (d not a multiple, or a view), a copy into a zero-padded
    (..., T, round_up(d)) buffer, as the reference pads its operands; the
    padding adds zero rows and columns to XᵀX, which the kernel does not
    write."""
    d = x.shape[-1]
    ld = -(-d // _ROW_ALIGN[x.dtype]) * _ROW_ALIGN[x.dtype]
    if ld == d and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    xp = torch.zeros((*x.shape[:-1], ld), dtype=x.dtype, device=x.device)
    xp[..., :d] = x
    return xp


def _fn(dtype: torch.dtype):
    lib = build.load("gram")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """Run the kernel on a stack, in one launch: out[e] = X_eᵀ X_e; an
    unstacked Gram is a stack of one.

    x: (E, T, d) fp32/bf16 CUDA tensor with E, T > 0 (copied by
    ``_padded`` where the kernel cannot read it as it is); out: (E, d, d)
    contiguous fp32 on the same device. The caller checks shapes and
    devices.
    """
    E, T, d = x.shape
    xp = _padded(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(x.dtype)(xp.data_ptr(), out.data_ptr(), E, T, d,
                           xp.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"gram_xtx kernel launch failed: CUDA error {err}")
