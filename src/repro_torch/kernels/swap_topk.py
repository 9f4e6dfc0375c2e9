"""Fused k-best swap search: the CUDA kernel's launcher and its plain
PyTorch version.

The kernel (``csrc/swap_topk.cu``) replaces the search kernel of the
Pallas module ``src/repro/kernels/swap_topk.py`` (``_topk_kernel``); the
in-kernel commit (``_commit_kernel``) is not ported yet.
``repro_torch.kernels.ops.swap_topk`` is the public wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import swap_math as sm

from . import build

MAX_K = 32  # one warp lane per list slot


def swap_topk_plain(w, m, c, G, *, k: int, chunk: int = 512):
    """``swap_math.topk_swaps_chunked`` plus the wrapper's index clamp.

    Returns (vals (R, k) fp32, u (R, k) int64, p (R, k) int64).
    """
    d = w.shape[1]
    vals, u, p = sm.topk_swaps_chunked(w, m, c, G, k=k, chunk=chunk)
    return vals, u.clamp_max(d - 1), p.clamp_max(d - 1)


def _fn():
    fn = build.load("swap_topk").swap_topk_search
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(a, b, w, G, vals, u, p, *, k: int) -> None:
    """Run the kernel on contiguous fp32 CUDA tensors a, b, w (R, d) and
    G (d, d) into vals (R, k) fp32 and u, p (R, k) int32."""
    R, d = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(a.data_ptr(), b.data_ptr(), w.data_ptr(), G.data_ptr(),
                    vals.data_ptr(), u.data_ptr(), p.data_ptr(), R, d, k,
                    stream)
    if err != 0:
        raise RuntimeError(f"swap_topk kernel launch failed: CUDA error {err}")
