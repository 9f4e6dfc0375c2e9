"""Gram accumulation XᵀX in fp32: the CUDA kernel's launcher and its plain
PyTorch version.

The kernel (``csrc/gram.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gram.py::_kernel``; see the source for its design and
what bounds it. ``repro_torch.kernels.ops.gram_xtx`` is the public wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SYMBOLS = {torch.float32: "gram_xtx_f32", torch.bfloat16: "gram_xtx_bf16"}


def gram_xtx_plain(x: torch.Tensor) -> torch.Tensor:
    """Xᵀ X with fp32 accumulation. x: (tokens, d) fp32 or bf16."""
    x32 = x.float()
    return x32.T @ x32


def _fn(dtype: torch.dtype):
    lib = build.load("gram")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """Run the kernel: out = XᵀX.

    x: (T, d) contiguous fp32/bf16 CUDA tensor; out: (d, d) contiguous fp32
    on the same device. The caller checks shapes and devices.
    """
    T, d = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(x.dtype)(x.data_ptr(), out.data_ptr(), T, d, stream)
    if err != 0:
        raise RuntimeError(f"gram_xtx kernel launch failed: CUDA error {err}")
