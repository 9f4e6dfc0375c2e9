"""Fused 1-swap search: the CUDA kernel's launcher and its plain PyTorch
version.

The kernel (``csrc/swap_argmin.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/swap_argmin.py::_kernel``.
``repro_torch.kernels.ops.swap_argmin`` is the public wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import swap_math as sm

from . import build


def swap_argmin_plain(w, m, c, G, *, chunk: int = 512):
    """``swap_math.best_swap_chunked``: ties to the smallest u·d + p, the
    tie-break of ``ref.swap_argmin_ref``. Returns (best, u, p), each (R,)."""
    return sm.best_swap_chunked(w, m, c, G, chunk=chunk)


def _fn():
    fn = build.load("swap_argmin").swap_argmin_search
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(a, b, w, G, best, u, p) -> None:
    """Run the kernel on contiguous fp32 CUDA tensors a, b, w (R, d) and
    G (d, d) into best (R,) fp32 and u, p (R,) int32."""
    R, d = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(a.data_ptr(), b.data_ptr(), w.data_ptr(), G.data_ptr(),
                    best.data_ptr(), u.data_ptr(), p.data_ptr(), R, d, stream)
    if err != 0:
        raise RuntimeError(f"swap_argmin kernel launch failed: CUDA error {err}")
