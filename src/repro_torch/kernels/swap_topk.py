"""Fused k-best swap search and the candidate-space commit: the CUDA
kernels' launchers and their plain PyTorch versions.

Two kernels replace the two of the Pallas module
``src/repro/kernels/swap_topk.py``: ``csrc/swap_topk.cu`` its search
(``_topk_kernel``) and ``csrc/swap_commit.cu`` its commit
(``_commit_kernel``, the greedy accept/reject of
``swap_math.commit_decisions``). ``repro_torch.kernels.ops.swap_topk``,
``ops.swap_commit`` and ``ops.swap_topk_commit`` are the public wrappers.
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


def _fns():
    lib = build.load("swap_topk")
    fn = lib.swap_topk_search
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.swap_topk_scratch_bytes
    size.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    size.restype = ctypes.c_size_t
    return fn, size


def launch(a, b, w, G, vals, u, p, *, k: int) -> None:
    """Run the kernel on contiguous fp32 CUDA tensors a, b, w (R, d) and
    G (d, d) into vals (R, k) fp32 and u, p (R, k) int32. The search runs
    in p-tiles whose partial lists a second kernel of the same call merges;
    their scratch is allocated here."""
    R, d = a.shape
    fn, size = _fns()
    scratch = torch.empty(size(R, d, k, G.data_ptr()), dtype=torch.uint8,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), w.data_ptr(), G.data_ptr(),
                 vals.data_ptr(), u.data_ptr(), p.data_ptr(),
                 scratch.data_ptr(), R, d, k, stream)
    if err != 0:
        raise RuntimeError(f"swap_topk kernel launch failed: CUDA error {err}")


def swap_commit_plain(wu, wp, cu, cp, Suu, Sup, Spp, u, p, valid, *,
                      eps: float, k: int):
    """``swap_math.commit_decisions``: (acc (R, k) 0/1 fp32, dl (R, k)
    re-scored ΔL, 0 where rejected)."""
    return sm.commit_decisions(wu, wp, cu, cp, Suu, Sup, Spp, u, p, valid,
                               eps=eps, k=k)


def _commit_fn():
    fn = build.load("swap_commit").swap_commit_decide
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_commit(wu, wp, cu, cp, Suu, Sup, Spp, u, p, valid, acc, dl, *,
                  eps: float) -> None:
    """Run the commit kernel on contiguous CUDA tensors: fp32 (R, k)
    wu, wp, cu, cp, valid; fp32 (R, k, k) Suu, Sup, Spp; int32 (R, k) u, p;
    into fp32 (R, k) acc and dl."""
    R, k = wu.shape
    with torch.cuda.device(wu.device):
        stream = torch.cuda.current_stream(wu.device).cuda_stream
        err = _commit_fn()(
            wu.data_ptr(), wp.data_ptr(), cu.data_ptr(), cp.data_ptr(),
            Suu.data_ptr(), Sup.data_ptr(), Spp.data_ptr(), u.data_ptr(),
            p.data_ptr(), valid.data_ptr(), acc.data_ptr(), dl.data_ptr(),
            R, k, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"swap_commit kernel launch failed: CUDA error {err}")
