"""Fused 1-swap search: the CUDA kernels' launcher and its plain PyTorch
version.

``swap_argmin_search`` in ``csrc/swap_topk.cu`` replaces the Pallas TPU
kernel ``src/repro/kernels/swap_argmin.py::_kernel``: swap_topk's
preparation and partial walk, then a selection kernel of its own.
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


def _fns():
    lib = build.load("swap_topk")
    fn = lib.swap_argmin_search
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.swap_argmin_scratch_bytes
    size.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    size.restype = ctypes.c_size_t
    return fn, size


def launch(a, b, w, G, best, u, p) -> None:
    """Run the kernels on contiguous fp32 CUDA tensors a, b, w (R, d) and
    G (d, d) into best (R,) fp32 and u, p (R,) int32. The search runs in
    p-tiles whose partial lists a selection kernel of the same call reads;
    their scratch is allocated here."""
    R, d = a.shape
    fn, size = _fns()
    scratch = torch.empty(size(R, d, G.data_ptr()), dtype=torch.uint8,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), w.data_ptr(), G.data_ptr(),
                 best.data_ptr(), u.data_ptr(), p.data_ptr(),
                 scratch.data_ptr(), R, d, stream)
    if err != 0:
        raise RuntimeError(f"swap_argmin kernel launch failed: CUDA error {err}")
