"""Fused k-best swap search and the candidate-space commit: the CUDA
kernels' launchers and their plain PyTorch versions.

Two sources replace the two kernels of the Pallas module
``src/repro/kernels/swap_topk.py``: ``csrc/swap_topk.cu`` its search
(``_topk_kernel``) and ``csrc/swap_commit.cu`` its commit
(``_commit_kernel``) together with what the reference runs around that
kernel: one call of two CUDA kernels, the decisions (the sub-Gram gather
of ``swap_math.gather_candidate_stats`` read straight from G, then the
greedy accept/reject of ``commit_decisions``) and the apply (the mask
flips and full-width Eq. 6 update of ``apply_commits``).
``repro_torch.kernels.ops.swap_topk``, ``ops.swap_commit`` and
``ops.swap_topk_commit`` are the public wrappers.
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


def swap_commit_decide_plain(w, c, G, dl, u, p, *, eps: float):
    """The decide kernel's function: ``swap_math.gather_candidate_stats``
    then ``commit_decisions`` on candidates (dl, u, p) (R, k), valid where
    dl is finite. Returns (acc, dls) as ``swap_commit_plain``."""
    u, p = u.long(), p.long()
    valid = torch.isfinite(dl).float()
    stats = sm.gather_candidate_stats(w, c.float(), G, u, p)
    return swap_commit_plain(*stats, u, p, valid, eps=eps, k=dl.shape[1])


def swap_commit_apply_plain(w, m, c, G, acc, u, p):
    """The apply kernel's function: the mask flips and full-width Eq. 6
    update of ``swap_math.apply_commits``, (m', c'); the row sums it also
    returns are the wrapper's."""
    m2, c2, _, _ = sm.apply_commits(w, m, c.float(), G, acc,
                                    torch.zeros_like(acc), u.long(), p.long())
    return m2, c2


def _commit_fn():
    fn = build.load("swap_commit").swap_commit
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_commit(w, m, c, G, u, p, dl, acc, dls, m_out, c_out, *,
                  eps: float, g_rows: bool, gmax: float) -> None:
    """Run the decide and apply kernels on contiguous CUDA tensors: fp32
    w, m, c (R, d) and G (d, d); int32 u, p and fp32 dl (R, k); into fp32
    acc, dls (R, k) and m_out, c_out (R, d). ``g_rows``: G equals Gᵀ
    bitwise; ``gmax``: max|G|."""
    R, d = w.shape
    k = u.shape[1]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = _commit_fn()(
            w.data_ptr(), m.data_ptr(), c.data_ptr(), G.data_ptr(),
            u.data_ptr(), p.data_ptr(), dl.data_ptr(), acc.data_ptr(),
            dls.data_ptr(), m_out.data_ptr(), c_out.data_ptr(), R, d, k,
            float(eps), int(g_rows), float(gmax), stream)
    if err != 0:
        raise RuntimeError(f"swap_commit kernel launch failed: CUDA error {err}")
