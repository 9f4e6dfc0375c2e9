#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (any
sm_90a card), the CUDA toolkit and PyTorch. It imports nothing of JAX and
nothing of the JAX package ``repro``. Phases, each printing what it found
and its time:

1. device — fail without CUDA; print the card's name and power limit;
   turn TF32 off (fp32 matmuls and convolutions run in full fp32).
2. build — compile the five CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, all at once); print registers, shared memory and
   spills per kernel.
3. kernel checks — each kernel against its plain PyTorch version at the
   main path's shapes: ``gram_xtx`` at 512 tokens, d = 4096 and 14336,
   with bf16 activations (the tensor-core path the main path takes) and
   fp32 ones (the CUDA-core path): within 1e-5 of max|G| (fp32 sums in
   another order; products of bf16 values are exact in fp32) and G == Gᵀ
   exactly. Each dtype timed at both shapes by device time with a cold L2
   (as spmm below): the kernel, the plain version, the dtype's one
   PyTorch call (``torch.mm(x.T, x, out_dtype=torch.float32)`` for bf16,
   ``torch.matmul(x.T, x)`` for fp32; ``library_ms``), and the bound
   (bf16: bytes 2·T·d + 4·d² against T·d·(d+1) operations at the bf16
   tensor-core peak; fp32: 4·(T·d + d²) bytes against the fp32 peak).
   ``swap_topk`` (k = 8) on a Wanda 0.6 mask over a correlated Gram at
   the four (R, d) of the main path's sites — (1024, 4096) wk / wv,
   (4096, 4096) wq / wo, (14336, 4096) w_gate / w_up and (4096, 14336)
   w_down — bitwise on feasible entries, with the same +inf positions and
   in-range indices, each timed with CUDA events (3 calls) beside its
   plain version, the bound (5 operations per feasible pair at the fp32
   peak) and the issue floor (6 unfused fp32 instructions per feasible
   pair on every SM's 128 lanes at the card's maximum SM clock, read from
   nvidia-smi). ``swap_argmin`` likewise at the four shapes, bitwise on
   every row (value bits, u and p, the (+inf, 0, 0) of rows with no
   feasible pair included), timed at each beside ``swap_topk``;
   ``swap_commit`` on ``swap_topk``'s k = 8 candidates at the same four
   shapes: its decisions kernel bitwise against the sub-Gram gather +
   ``commit_decisions`` and its apply kernel against ``apply_commits``'
   flips and Eq. 6 update, with accepts and rejects; each kernel's device
   time beside its bytes bound (the decisions' scattered reads counted as
   32-byte sectors; the apply's c and m read and written plus two Gram
   rows per candidate it reads in full), the launches per call, and the
   device time and launches of the whole step after the search as
   ``profile_swap --commit`` times it (two commit kernels, no gather);
   the apply's column reads (an asymmetric G's path) forced on the same
   G, bitwise equal to its row reads, and their time.
   ``spmm`` at every shape of the serve path — w_gate / w_up (14336 x
   4096, silu), w_down (4096 x 14336), wq / wo (4096 x 4096) and wk / wv
   (1024 x 4096), T = 4 (decode) and 128 (prefill), nm24 on a 2:4 mask
   and gathered on a PerRow(0.6) mask and on the same 2:4 mask, and at
   w_gate also T = 1 and 64 (untimed; the continuous scheduler's one-row
   decode bucket and its chunked-prefill window) — in fp32
   (within 1e-5 of max|y|: fp32 sums in another order) and bf16 (within
   one bf16 ulp of the plain element, or 1e-5 of max|y|: the two fp32
   sums round to neighbouring bf16 values), nm24 and gathered bitwise
   equal on the 2:4 mask. Times, at w_gate and w_down, in bf16 with
   a cold L2 (a 128 MB rewrite before each call), by device time alone:
   torch.profiler sums the kernels of each call (spmm: the product kernel
   and its split reduction; the library call: every kernel it launched;
   the flush's kernel excluded by name), so the host's work in the
   wrapper is never counted; the median and min-max of 20 calls of the
   kernel, of ``torch.matmul(x, (W*mask).T)`` on the dense masked weight
   (``library_ms``, the masked format's cost) and of the plain version,
   and the bound max(2*T*d_out*K at the bf16 tensor-core peak, bytes at
   the HBM rate).
4. main path — ``prune_model`` (the recipe -> plan -> executor shim) on
   llama31-8b at full width (d_model 4096, 32 heads / 8 KV heads, d_ff
   14336, vocab 128256) with the depth cut to 2 layers, bf16, random
   weights from seed 0: 16 calibration samples x 128 tokens in batches of
   4, Wanda warmstart, PerRow(0.6), k-swap with k = 8, t_max = 4 search
   passes; then dense vs pruned perplexity on 4 validation batches of
   8 x 128. Asserts that all 7 taps x 2 layers x 4 batches = 56 Gram
   launches took the bf16 tensor-core path (none the fp32 one), that
   swap_topk ran once per site, layer and pass (7 x 2 x 4 = 56; taps and
   sites counted by ``pruning.sites``), exact per-row
   sparsity at every site, monotone row losses, a positive mean error
   reduction over Wanda, finite perplexities; prints a digest of the
   masks (to compare runs and commits bit for bit).
5. second path — on layer 0's w_down with its calibration Gram:
   ``refine(k_swaps=1, t_max=2)``, so ``swap_argmin`` runs (its wall
   time and a digest of its masks, swaps and losses printed); then
   ``refine(k_swaps=8, commit_mode="candidates", t_max=4)`` without and
   with ``compact_every=2``, so ``swap_commit`` runs, and the same at an
   ``eps`` that leaves ~70% of the rows without an accepted swap in the
   first pass, without and with ``compact_every=1``, so later passes run
   on a gathered working set (each run's wall time and a digest of its
   masks, swaps and losses printed). Asserts the kernels launched
   (``swap_commit`` once per search pass), monotone losses, exact
   sparsity, tracked losses within 1e-3 of loss_init of recomputed ones,
   masks, swaps and losses bitwise equal with and without compaction, no
   more rows scored with it and fewer at that ``eps``; and on 256 rows
   the kernel path's masks equal the plain chunked search and commit on
   the card.
6. serve path — the same model and params: PerRow(0.6) masks from phase
   4 and Wanda 2:4 masks (``prune_model(method="none")``, same
   calibration). ``ServeEngine`` for dense, masked (both mask sets),
   nm24 (2:4) and gathered (both mask sets), each ``generate``-ing
   batch 4 x prompt 32 + 16 new tokens of a synthetic validation prompt.
   Asserts: every packed generate launched spmm 7 sites x 2 layers x
   (1 prefill + 15 decode steps) = 224 times; nm24 and gathered give
   bitwise equal tokens and logits for the 2:4 masks; packed vs masked
   logits within SERVE_TOL of max|logits| at the prefill and at every
   decode step, the packed model fed the masked model's greedy tokens
   (teacher-forced: greedy tokens of near-tied logits part ways), since
   the masked path rounds each linear's pre-activation to bf16 before
   the bias and activation and the kernel keeps it in fp32; nm24 holds
   fewer weight bytes than masked. Prints per format the prefill ms, decode tok/s,
   weight bytes and ``kernel_used`` (best of 3 warm runs), and per packed
   engine the device time of its spmm kernels in one more warm
   ``generate`` (torch.profiler; the trace must hold every launch).
6c. continuous serving (run after phase 8, on the params of phase 4 made
   again from seed 0) — phase 4's PerRow(0.6) masks and phase 6's Wanda
   2:4 masks, dense / masked PerRow(0.6) / nm24 (2:4) /
   gathered PerRow(0.6) engines, each through ``ContinuousScheduler``
   (8 slots of 1024 tokens, 16-token pages, decode chunks of 8):
   (a) the reference test's four mixed greedy and sampled requests at
   the pinned width give each request's solo tokens bitwise, and the
   pools end empty; (b) across shapes, where the card's matmuls may
   round a row otherwise: chunked prefill (64-token windows) vs one-shot
   of 100-, 300- and 500-token prompts, and a batch of four 32-token
   prompts prefilled together (the fixed path) vs each alone, both
   teacher-forced for 8 and 16 decode steps — logits within SERVE_TOL
   of max|logits|, with the largest |dK|, |dV| over valid positions and
   the greedy tokens that flip (at near ties) printed; then the
   scheduler's greedy tokens, chunked vs one-shot and against
   ``generate``, equal up to the first near-tie (a step whose top-2
   logit gap is within twice the forced pair's largest logits error);
   (c) disaggregated (two pools, page shipping) == interleaved bitwise,
   with shipped bytes = shipped pages x page bytes; (d) ``run_chaos``
   under ``FaultPlan.chaos(0)``: no leaked bytes, no stream mismatches,
   faults fired; (e) in every scheduler run spmm launched sites x layers
   x (prefill dispatches + decode steps) times, counted from the
   scheduler's ``dispatches`` (0 for dense and masked). One profiled
   run per packed engine splits its wall time into device kernels
   (spmm's share) and the rest. (f) ``bench_load_rows``, one pass
   each (no warm-up pass), prompts 32-512 and outputs 16-128 tokens:
   continuous for masked, nm24 and gathered at 8 arrivals/s (below the
   continuous path's saturation, 13-19/s by host) and at 32/s (above
   it: requests queue for one of the 8 slots), the rates from
   ``launch/profile_serve.py``'s sweep, each over a window of 100 /
   rate seconds (the same 89 requests at both rates from seed 0); and
   nm24 continuous vs fixed over the first 2 s at 8/s (15 requests; the
   fixed path, each prompt length alone, saturates by 2/s). Offered and
   delivered tok/s, TTFT, queue wait and per-token p50 / p99, wasted
   tokens: printed, not gated.
7. recipe path — ``repro_torch.launch.prune.prune`` on the same model
   (its own params from seed 0) with a recipe of every rule kind: 2:4
   sparseswaps on wq/wo, sparsegpt PerRow(0.6) on wk, skip on wv, dsnot
   PerRow(0.6) on w_down (moments only, ``calib_stats="minimal"``),
   sparseswaps PerRow(0.6) with ``compact_every=2`` on the rest, t_max =
   4, into a temporary out dir with calibration checkpoints every 2
   batches. Asserts exact sparsity per resolved pattern, the skipped site
   dense and its tap absent, no Gram for the dsnot site, finite
   perplexities; a second run into the same directory restores every
   group (counted by a ``PruneCallback``) with bitwise equal masks; a
   third run, resumed again under cProfile, prints where its host time
   goes (checkpoint hashing and reads, the data fingerprint, calibration
   restore, evaluation, the out dir's writes); ``plan_only`` prints the
   plan and allocates no CUDA memory.
3b. the other dense configs' shapes (chatglm3-6b, granite-34b,
   minitron-4b, internlm2-20b), each kernel held as in phase 3: the Gram
   (bf16, T = 512) at d = 3072, 6144, 9216, 13696, 16384, 24576, timed at
   13696 and 24576; swap_topk, swap_argmin and the commit (k = 8) at
   (6144, 24576) granite w_down (a 2.42 GB G), (4096, 13696) chatglm
   w_down (a 128-column last p-tile), (256, 4096) chatglm wk / wv, (128,
   6144) granite's MQA wk / wv, (3072, 9216) and (9216, 3072) minitron
   w_down / w_up, each on all rows with the searches held bitwise on the
   first 128 rows and the last 32-row block and the commit on every row,
   swap_topk and the commit step timed at the first two; spmm at chatglm
   wq and wk with a bias, granite w_up (gelu), w_down and wk (d_out =
   128), minitron w_up (relu2) and w_down, the granite pair timed in
   bf16.
4b / 6b. for each of those four configs, at full width with the depth
   cut to 2 layers, bf16, random weights from seed 0 (chatglm3's qkv
   biases, zero at init, drawn from N(0, 0.02²)): phase 4's prune_model
   and gates, the Gram and swap_topk launch counts from the config's taps
   and sites (``pruning.sites``: 7 for a gated MLP, 6 for a plain one),
   its time, peak memory and mask digest; then phase 6's serving without
   the dense engine and the timed runs (masked, nm24 and gathered on the
   PerRow(0.6) masks and on Wanda 2:4 ones), spmm launches = sites x
   layers x 16 per packed generate, nm24 == gathered bitwise, packed vs
   masked logits within SERVE_TOL. Each config's state is freed before
   the next.
8. full depth, shapes only: every dense config's ``plan_pruning`` on the
   meta device (nothing allocated), its weight, Gram and calibration
   bytes, and whether the bf16 model and its calibration state fit the
   card.
9. the kernels line (``spmm``: the nm24 kernel at w_gate T = 128, its
   launches the nm24 engines'; ``spmm_gather``: the gathered kernel at
   w_gate T = 4 on PerRow(0.6), its launches the gathered engines'; the
   Gram's, swap_topk's and spmm's launches those of phases 4, 6 and 6c
   and of every 4b / 6b run), the card line, and last {"ok": true,
   "device": ...}.

Where the main path's device time goes is measured apart from this
script, by ``python -m repro_torch.launch.profile_prune``.

Exits non-zero, printing no result, when CUDA is unavailable or the
script is not inside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

KERNELS = {
    "gram_xtx": ("gram", "src/repro_torch/csrc/gram.cu",
                 "src/repro/kernels/gram.py:22"),
    "swap_topk": ("swap_topk", "src/repro_torch/csrc/swap_topk.cu",
                  "src/repro/kernels/swap_topk.py:78"),
    "swap_argmin": ("swap_topk", "src/repro_torch/csrc/swap_topk.cu",
                    "src/repro/kernels/swap_argmin.py:33"),
    "swap_commit": ("swap_commit", "src/repro_torch/csrc/swap_commit.cu",
                    "src/repro/kernels/swap_topk.py:200"),
    "spmm": ("spmm", "src/repro_torch/csrc/spmm.cu",
             "src/repro/kernels/spmm.py:220"),
    "spmm_gather": ("spmm", "src/repro_torch/csrc/spmm.cu",
                    "src/repro/kernels/spmm.py:220"),
}
PEAK_FP32 = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
T_MAX = 4                # search passes of the main path (k = 8)
SERVE_TOL = 0.05         # packed vs masked prefill logits, of max|logits|
SERVE_GEN = 16           # new tokens per request on the serve path
# the other dense configs (phases 3b, 4b, 6b) and their shapes new to the
# kernels
OTHER_DENSE = ("chatglm3-6b", "granite-34b", "minitron-4b", "internlm2-20b")
GRAM_DS = (3072, 6144, 9216, 13696, 16384, 24576)
GRAM_TIMED = (13696, 24576)
SWAP_SHAPES = [                  # (R, d, site); the first two timed
    (6144, 24576, "granite-34b w_down"),
    (4096, 13696, "chatglm3-6b w_down: a 128-column last p-tile"),
    (256, 4096, "chatglm3-6b wk/wv"),
    (128, 6144, "granite-34b wk/wv: MQA"),
    (3072, 9216, "minitron-4b w_down"),
    (9216, 3072, "minitron-4b w_up"),
]
SPMM_SHAPES = [                  # (d_out, d_in, act, bias, site, timed)
    (4096, 4096, None, True, "chatglm3-6b wq", False),
    (256, 4096, None, True, "chatglm3-6b wk", False),
    (24576, 6144, "gelu", False, "granite-34b w_up", True),
    (6144, 24576, None, False, "granite-34b w_down", True),
    (128, 6144, None, False, "granite-34b wk", False),
    (9216, 3072, "relu2", False, "minitron-4b w_up", False),
    (3072, 9216, None, False, "minitron-4b w_down", False),
]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    """A check of the run that fails the script (kept under python -O)."""
    if not cond:
        raise AssertionError(msg)


class Phase:
    """Times a phase and prints its name and wall time."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.s = time.perf_counter() - self.t0
        if exc[0] is None:
            log(f"   {self.name}: {self.s:.2f} s")


def cuda_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, *, reps: int, tries: int = 5) -> float:
    """Mean device time in ms of the CUDA kernels whose name contains
    ``kernel``, per call of ``fn()``, by torch.profiler: the kernel alone,
    without the host time of its wrapper between launches. A trace that
    lost records (the profiler drops some late in a long process) is
    taken again, up to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_spmm import profiler_preroll

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) == reps:
            return sum(us) / 1e3 / reps
    raise AssertionError(f"the profiler saw {len(us)} {kernel} launches, "
                         f"want {reps} ({tries} tries)")


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32
          ) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def digest(tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes, in
    order: masks, swaps and losses compared bit for bit across runs."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mask_leaves(tree):
    """A mask tree's leaves in key order, as bool tensors."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in mask_leaves(tree[k])]
    return [tree > 0.5]


def by_rows(fn, w, m, c, G, rows: int = 64):
    """A plain swap search over row blocks, so its (rows, d, chunk)
    intermediates fit in device memory."""
    import torch

    outs = [fn(w[i:i + rows], m[i:i + rows], c[i:i + rows], G)
            for i in range(0, w.shape[0], rows)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def check_swaps(w, m, c, G, k: int, tag: str, *, names, timed,
                clock_mhz: float, rows=None) -> dict:
    """The swap searches in ``names`` against their plain versions on one
    problem: swap_topk bitwise on feasible entries, swap_argmin on every
    row. The kernel runs on all rows; with ``rows`` (an index tensor) the
    plain version runs on those rows only, and they are compared (a row's
    result depends on that row and G alone). Times those in ``timed``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import swap_argmin as argmin_mod
    from repro_torch.kernels import swap_topk as topk_mod

    out = {}
    R, d = w.shape
    pairs = float(((m > 0.5).sum(1).double() * (m < 0.5).sum(1).double()).sum())
    searches = {
        "swap_topk": (lambda: ops.swap_topk(w, m, c, G, k=k),
                      lambda *a: topk_mod.swap_topk_plain(*a, k=k), k),
        "swap_argmin": (lambda: ops.swap_argmin(w, m, c, G),
                        argmin_mod.swap_argmin_plain, 1)}
    for name in names:
        kern, plain, kk = searches[name]
        got = kern()
        sub = (w, m, c)
        if rows is not None:
            got = tuple(g[rows] for g in got)
            sub = tuple(t[rows] for t in sub)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = by_rows(plain, *sub, G)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        fin = torch.isfinite(want[0])
        same_inf = torch.equal(torch.isfinite(got[0]), fin)
        if name == "swap_argmin":        # every row, the value's bits too
            equal = (torch.equal(got[0].view(torch.int32),
                                 want[0].view(torch.int32))
                     and all(torch.equal(g, t)
                             for g, t in zip(got[1:], want[1:])))
        else:
            equal = all(torch.equal(g[fin], t[fin])
                        for g, t in zip(got, want))
        in_range = all(bool(((g >= 0) & (g < d)).all()) for g in got[1:])
        err = float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() else 0.0
        log(f"   {name} {tag}: feasible {int(fin.sum())}/{fin.numel()} "
            f"bitwise-equal={equal} inf-tail-equal={same_inf} "
            f"indices-in-range={in_range} max_abs_err={err}")
        require(equal and same_inf and in_range,
                f"{name} {tag} disagrees with its plain version")
        if name in timed:
            ms = cuda_ms(kern, reps=3)
            out_bytes = R * kk * 12
            b_ms, b_by = bound(5.0 * pairs, 4.0 * (3 * R * d + d * d) + out_bytes)
            out[name] = {"max_abs_err": err, "ms": ms,
                         "plain_ms": 1e3 * plain_s, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None,
                         "shape": f"R={R} d={d}" + (f" k={k}" if kk > 1 else "")}
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            floor = 1e3 * 6.0 * pairs / (sms * 128 * clock_mhz * 1e6)
            n_plain = R if rows is None else len(rows)
            log(f"   {name} {tag}: kernel {ms:.2f} ms, plain "
                f"{1e3*plain_s:.1f} ms on {n_plain} rows, bound "
                f"{b_ms:.3f} ms ({b_by}; "
                f"{pairs:.3e} feasible pairs; kernel at "
                f"{100 * b_ms / ms:.1f}% of the bound), issue floor "
                f"{floor:.3f} ms (6 instructions per feasible pair, {sms} "
                f"SMs x 128 lanes at {clock_mhz:.0f} MHz; kernel at "
                f"{100 * floor / ms:.1f}% of it)")
    return out


def bitwise(a, b) -> bool:
    """Equal bit for bit (fp32 compared as int32, so NaNs too)."""
    import torch

    view = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return a.shape == b.shape and torch.equal(view(a), view(b))


def check_commit(w, m, c, G, k: int, tag: str, *,
                 time_it: bool = True) -> dict:
    """The commit kernels on swap_topk's candidates against their plain
    versions, bitwise: the decisions (sub-Gram gather + commit_decisions)
    and the apply (apply_commits' flips and Eq. 6). Each kernel's device
    time, bytes bound and share of it; the device time and launches of the
    whole step after the search (``profile_swap.commit_split``, as it
    times a parent tree), which must hold the two kernels once each and
    no gather or index kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import swap_topk as topk_mod
    from repro_torch.launch import profile_swap

    R, d = w.shape
    dl, u, p = ops._swap_topk(w, m, c, G, k=k)     # int32, as the step uses
    gram = ops.gram_facts(G)
    run = lambda: ops.swap_commit(w, m, c, G, dl, u, p, gram=gram)
    decide = lambda: topk_mod.swap_commit_decide_plain(w, c, G, dl, u, p,
                                                       eps=0.0)
    m2, c2, acc, dls = run()
    want_acc, want_dls = decide()
    want_m, want_c = topk_mod.swap_commit_apply_plain(w, m, c, G, acc, u, p)
    eq_decide = bitwise(acc, want_acc) and bitwise(dls, want_dls)
    eq_apply = bitwise(m2, want_m) and bitwise(c2, want_c)
    err = float((c2 - want_c).abs().max())
    n_valid = int(torch.isfinite(dl).sum())
    n_acc = int(acc.sum())
    log(f"   swap_commit {tag} k={k}: decisions bitwise-equal={eq_decide}, "
        f"apply bitwise-equal={eq_apply}, max_abs_err {err}; accepted "
        f"{n_acc}, rejected {n_valid - n_acc} of {n_valid} valid "
        f"candidates ({acc.numel()} slots); G symmetric={gram.symmetric} "
        f"max|G|={gram.amax:.6g}")
    require(eq_decide and eq_apply,
            f"swap_commit {tag} disagrees with its plain versions")
    require(0 < n_acc < n_valid,
            f"swap_commit {tag}: want accepts and rejects in the batch")
    # the column reads an asymmetric G takes, forced on this G: the same
    # bits as the row reads
    cols = ops.GramFacts(False, gram.amax)
    run_cols = lambda: ops.swap_commit(w, m, c, G, dl, u, p, gram=cols)
    eq_cols = all(bitwise(x, y) for x, y in zip(run_cols(), (m2, c2, acc,
                                                             dls)))
    require(eq_cols, f"swap_commit {tag}: column and row reads disagree")
    if not time_it:
        log(f"   swap_commit {tag}: apply by Gram columns (forced) bitwise "
            f"equal to the row reads: {eq_cols}")
        return {}
    # the apply reads both Gram rows of every candidate it cannot skip
    wu, wp = w.gather(1, u.long()), w.gather(1, p.long())
    n_full = int(((acc != 0)
                  | ~((wu.abs() + wp.abs()) * gram.amax <= 1e38)).sum())
    dec_ms = kernel_ms(run, "swap_commit_decide_kernel", reps=20)
    app_ms = kernel_ms(run, "swap_commit_apply_kernel", reps=20)
    plain_ms = cuda_ms(lambda: topk_mod.swap_commit_apply_plain(
        w, m, c, G, decide()[0], u, p), reps=3)
    # decisions: each scattered read of G, w or c costs its 32-byte sector
    dec_bytes = 32.0 * (3 * R * k * k + 4 * R * k) + 4.0 * 5 * R * k
    dec_b, dec_by = bound(16.0 * R * k * k, dec_bytes)
    # apply: c and m read and written, two Gram rows per full candidate
    app_bytes = 16.0 * R * d + 8.0 * d * n_full + 4.0 * 3 * R * k
    app_b, app_by = bound(5.0 * d * n_full, app_bytes)
    cols_ms = kernel_ms(run_cols, "swap_commit_apply_kernel", reps=3)
    log(f"   swap_commit {tag}: apply by Gram columns (forced) "
        f"{cols_ms:.4f} ms (device), bitwise equal to the row reads: "
        f"{eq_cols}")
    before = ops.LAUNCHES["swap_commit"]
    run()
    launches = ops.LAUNCHES["swap_commit"] - before
    split, _ = profile_swap.commit_split(w, m, c, G)
    step_ms = sum(ms for _, ms in split.values())
    step_n = sum(n for n, _ in split.values())
    kinds = {profile_swap._kind(name) for _, name in split}
    log(f"   swap_commit {tag}: decisions {dec_ms:.4f} ms (device), bound "
        f"{dec_b:.5f} ms ({dec_by}, {dec_bytes / 1e6:.2f} MB counted in "
        f"32-byte sectors; {100 * dec_b / dec_ms:.1f}% of it); apply "
        f"{app_ms:.4f} ms, bound {app_b:.5f} ms ({app_by}, "
        f"{app_bytes / 1e6:.1f} MB: {n_full} of {acc.numel()} candidates "
        f"read in full, {2 * n_full} Gram rows; "
        f"{100 * app_b / app_ms:.1f}% of it); plain decisions + apply "
        f"{plain_ms:.3f} ms (events); {launches} swap_commit launch count per "
        f"call (two CUDA kernels)")
    log(f"   swap_commit {tag}: the step after the search "
        f"{step_ms:.4f} ms device, {step_n:g} launches per call: " + ", ".join(
            f"{ph} {name} {ms:.4f} ms / {n:g}"
            for (ph, name), (n, ms) in sorted(split.items(),
                                              key=lambda x: -x[1][1])))
    require(split.get(("decisions", "swap_commit_decide_kernel"), [0])[0] == 1
            and split.get(("apply", "swap_commit_apply_kernel"), [0])[0] == 1
            and "gathers" not in kinds,
            f"swap_commit {tag}: the step after the search did not run as "
            f"the two commit kernels without gathers: {sorted(split)}")
    return {"max_abs_err": err, "ms": dec_ms + app_ms, "plain_ms": plain_ms,
            "bound_ms": dec_b + app_b, "bound_by": app_by,
            "library_ms": None, "shape": f"{tag} k={k}"}


def check_refined(W, G, res, pattern, tag: str) -> None:
    """Gates of a ``refine`` result: monotone row losses, exact sparsity,
    tracked losses within 1e-3 of loss_init of recomputed ones."""
    from repro_torch.core import masks, swap_math as sm

    direct = sm.row_loss(W.float(), res.mask, G)
    gap = float(((direct - res.loss_final).abs()
                 / res.loss_init.clamp(min=1e-30)).max())
    log(f"   {tag}: tracked-vs-recomputed loss gap {gap:.2e} (of loss_init)")
    require(bool((res.loss_final <= res.loss_init).all()),
            f"{tag}: a row loss rose")
    require(masks.validate_mask(res.mask, pattern),
            f"{tag}: per-row sparsity not exact")
    require(gap < 1e-3, f"{tag}: tracked losses drift from recomputed ones")


def check_gram(T: int, d: int, *, dtypes=("bf16", "fp32"),
               time_it: bool = True) -> dict:
    """gram_xtx in ``dtypes`` against its plain version (within 1e-5 of
    max|G|, exactly symmetric), then, if asked, device times with a cold
    L2. Returns {dtype tag: timings}."""
    import torch
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_spmm import cold_device_ms

    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(T, d, generator=gen, device="cuda")
    flops = float(T) * d * (d + 1)           # the symmetric half
    out = {}
    for xx, tag in ((x.to(torch.bfloat16), "bf16"), (x, "fp32")):
        if tag not in dtypes:
            continue
        Gk = ops.gram_xtx(xx)
        Gp = gram_mod.gram_xtx_plain(xx)
        err = float((Gk - Gp).abs().max())
        scale = float(Gp.abs().max())
        sym = torch.equal(Gk, Gk.T)
        log(f"   gram_xtx T={T} d={d} {tag}: max_abs_err {err:.3e} "
            f"(max|G| {scale:.3e}, {err / scale:.2e} of it) symmetric={sym}")
        require(err <= 1e-5 * scale and sym,
                f"gram_xtx T={T} d={d} {tag} out of tolerance")
        del Gk, Gp
        if not time_it:
            continue
        if tag == "bf16":
            lib_name = "torch.mm(x.T, x, out_dtype=torch.float32)"
            lib = lambda: torch.mm(xx.T, xx, out_dtype=torch.float32)
            b_ms, b_by = bound(flops, 2.0 * T * d + 4.0 * d * d, PEAK_BF16)
        else:
            lib_name = "torch.matmul(x.T, x)"
            lib = lambda: torch.matmul(xx.T, xx)
            b_ms, b_by = bound(flops, 4.0 * (T * d + d * d))
        ms, ms_lo, ms_hi = cold_device_ms(lambda: ops.gram_xtx(xx))
        plain_ms, _, _ = cold_device_ms(lambda: gram_mod.gram_xtx_plain(xx))
        lib_ms, lib_lo, lib_hi = cold_device_ms(lib)
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "shape": f"T={T} d={d} {tag}"}
        log(f"   gram_xtx T={T} d={d} {tag}: device time, median [min-max] "
            f"of 20 calls, L2 flushed: kernel {ms:.4f} [{ms_lo:.4f}-"
            f"{ms_hi:.4f}] ms ({flops / ms / 1e9:.1f} TFLOP/s on the half "
            f"it computes), plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} "
            f"[{lib_lo:.4f}-{lib_hi:.4f}] ms, bound {b_ms:.4f} ms ({b_by}; "
            f"kernel at {100 * b_ms / ms:.1f}% of the bound)")
    return out


def spmm_tol(want):
    """Elementwise bound for the spmm checks: 1e-5 of max|y|, and for a
    bf16 result one bf16 ulp of the plain element as well."""
    import torch

    w32 = want.float()
    tol = torch.full_like(w32, 1e-5 * float(w32.abs().max()))
    if want.dtype == torch.bfloat16:
        mag = w32.abs().clamp_min(torch.finfo(torch.float32).tiny)
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(mag)) - 7))
    return tol


def check_spmm(d_out: int, d_in: int, act, tag: str, *,
               time_it: bool = True, bias: bool = False,
               extra_T: tuple = ()) -> dict:
    """spmm against its plain version at one weight shape, T = 4 and 128
    (and the untimed ``extra_T``),
    nm24 (2:4) and gathered (PerRow 0.6 and 2:4), fp32 and bf16, with
    nm24 == gathered bitwise on the 2:4 mask; bf16 times when asked.
    With ``bias`` a random (d_out,) bias goes to both, which add it to the
    fp32 sum before the epilogue. Returns {(T, "nm24" | "gathered" |
    "gathered 2:4"): timings}."""
    import torch
    from repro_torch.core import masks, packed
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmm as spmm_mod
    from repro_torch.launch.profile_spmm import cold_device_ms

    gen = torch.Generator(device="cuda").manual_seed(d_out + d_in)
    w = torch.randn(d_out, d_in, generator=gen, device="cuda") * d_in ** -0.5
    scores = torch.rand(d_out, d_in, generator=gen, device="cuda")
    m24 = masks.make_mask(scores, masks.NM(2, 4))
    runs = {"nm24": ("nm24", m24),
            "gathered": ("gathered", masks.make_mask(scores,
                                                     masks.PerRow(0.6))),
            "gathered 2:4": ("gathered", m24)}
    del scores
    b = torch.randn(d_out, generator=gen, device="cuda") if bias else None
    tag = tag + (" +bias" if bias else "")
    out = {}
    for T in (4, 128) + tuple(extra_T):
        x32 = torch.randn(T, d_in, generator=gen, device="cuda")
        y24 = {}
        for name, (fmt, mask) in runs.items():
            errs = {}
            for dt in (torch.float32, torch.bfloat16):
                pw = packed.pack(w.to(dt), mask, fmt)
                x = x32.to(dt)
                got = ops.spmm(x, pw, bias=b, act=act)
                want = spmm_mod.spmm_plain(x, pw, b, act)
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= spmm_tol(want)).all())
                errs[str(dt).split(".")[1]] = float(diff.max())
                require(ok and got.dtype == dt,
                        f"spmm {tag} T={T} {name} {dt} out of tolerance")
                if mask is m24:
                    y24.setdefault(dt, []).append(got)
            if not time_it or T in extra_T:
                log(f"   spmm {tag} ({d_out}x{d_in}, act={act}) T={T} {name} "
                    f"K={pw.k}: max_abs_err fp32 {errs['float32']:.3e} "
                    f"bf16 {errs['bfloat16']:.3e}")
                continue
            wm = (w * mask).to(torch.bfloat16)
            ms, ms_lo, ms_hi = cold_device_ms(
                lambda: ops.spmm(x, pw, bias=b, act=act))
            plain_ms, _, _ = cold_device_ms(
                lambda: spmm_mod.spmm_plain(x, pw, b, act))
            lib_ms, lib_lo, lib_hi = cold_device_ms(
                lambda: torch.matmul(x, wm.T))
            del wm
            K = pw.k
            nbytes = (2 * T * d_in + pw.nbytes + 2 * T * d_out)
            b_ms, b_by = bound(2.0 * T * d_out * K, nbytes, PEAK_BF16)
            out[(T, name)] = {"max_abs_err": errs["bfloat16"], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms,
                              "shape": f"{tag} T={T} {name} bf16"}
            log(f"   spmm {tag} ({d_out}x{d_in}, act={act}) T={T} {name} "
                f"K={K}: max_abs_err fp32 {errs['float32']:.3e} bf16 "
                f"{errs['bfloat16']:.3e}; bf16 device time, median [min-max] "
                f"of 20 cold calls: kernel {ms:.4f} [{ms_lo:.4f}-{ms_hi:.4f}] "
                f"ms, plain {plain_ms:.4f} ms, torch.matmul on masked dense "
                f"{lib_ms:.4f} [{lib_lo:.4f}-{lib_hi:.4f}] ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB; kernel at "
                f"{100 * b_ms / ms:.1f}% of the bound)")
        for dt, (y_nm, y_ga) in y24.items():
            require(torch.equal(y_nm, y_ga),
                    f"spmm {tag} T={T} {dt}: nm24 and gathered differ on "
                    "the 2:4 mask")
    return out


def forced_logits(eng, prompt: dict, tokens):
    """(n_new, B, vocab) fp32 logits of ``eng``'s model at the prefill and
    at each decode step, fed ``tokens`` (B, n_new) in place of its own
    greedy choices; the cache is sized as ``generate`` sizes it."""
    import torch
    from repro_torch.serve.engine import next_pow2

    api = eng.api
    B, S = prompt["tokens"].shape
    n_new = tokens.shape[1]
    with torch.no_grad():
        cache = api.init_cache(eng.params, B, next_pow2(S + n_new))
        logits, cache = api.prefill(eng.params, prompt, cache,
                                    masks=eng.masks)
        out = [logits[:, -1].float()]
        for i in range(n_new - 1):
            logits, cache = api.decode_step(eng.params, tokens[:, i:i + 1],
                                            cache, masks=eng.masks)
            out.append(logits[:, -1].float())
    return torch.stack(out)


def spmm_device_ms(eng, prompt: dict, launches: int,
                   tries: int = 5) -> tuple[float, float]:
    """Device time in ms of the spmm kernels (product and split reduction)
    of one warm ``generate`` by torch.profiler, and the generate's wall
    ms. The profiler must see all ``launches`` product kernels: a trace
    that lost records is taken again, up to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_spmm import profiler_preroll

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()
            t0 = time.perf_counter()
            eng.generate(prompt, SERVE_GEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ms, n = 0.0, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "spmm_" in e.name or "splitk_reduce" in e.name:
                ms += e.time_range.elapsed_us() / 1e3
                n += "spmm_" in e.name
        if n == launches:
            return ms, 1e3 * wall
    raise AssertionError(f"the profiler saw {n} spmm product kernels of a "
                         f"generate, want {launches} ({tries} tries)")


def serve_bench(engines: dict, prompt: dict, launches: dict) -> dict:
    """Phase 6's timings: 3 warm ``generate``s per engine (prefill ms,
    decode tok/s, weight bytes; best of 3), then each packed engine's spmm
    device time in one more. Returns the warm results per engine."""
    warm = {name: [] for name in engines}
    for _ in range(3):
        for name, eng in engines.items():
            warm[name].append(eng.generate(prompt, SERVE_GEN))
    B, S = prompt["tokens"].shape
    for name, eng in engines.items():
        pre = min(r.prefill_s for r in warm[name])
        dec = max(r.tok_s for r in warm[name])
        log(f"   {name:13s} prefill {1e3 * pre:8.3f} ms "
            f"({B * S / pre:9.1f} tok/s)  decode {dec:8.1f} tok/s "
            f"({1e3 / (dec / B):7.3f} ms/step)  weights "
            f"{eng.weight_bytes():>11d} B  kernel_used {eng.kernel_used}")
    for name, eng in engines.items():
        if launches[name]:
            ms, wall = spmm_device_ms(eng, prompt, launches[name])
            log(f"   {name:13s} one warm generate: spmm device time "
                f"{ms:.4f} ms (all {launches[name]} product kernels "
                f"and their split reductions), generate {wall:.3f} ms wall")
    return warm


def serve_path(api, params, masks60: dict, masks24: dict, prompt: dict, *,
               bench: bool = True):
    """Phase 6 (and 6b with ``bench=False``: no dense engine, no timed
    runs or profiles). Returns the spmm launches of each engine's first
    generate."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.pruning import sites
    from repro_torch.serve import ServeEngine

    specs = {"dense": (None, "dense"), "masked_0.6": (masks60, "masked"),
             "gathered_0.6": (masks60, "gathered"),
             "masked_2:4": (masks24, "masked"), "nm24_2:4": (masks24, "nm24"),
             "gathered_2:4": (masks24, "gathered")}
    if not bench:
        del specs["dense"]
    n_sites = len(sites.site_specs(api.cfg, params))
    engines = {name: ServeEngine(api, params, masks=m, fmt=fmt)
               for name, (m, fmt) in specs.items()}
    for name, eng in engines.items():
        log(f"   {name}: packed in {eng.pack_s:.2f} s, "
            f"{eng.weight_bytes() / 2**30:.3f} GiB of weights")
    ops.reset_launches()
    cold, serve_launches = {}, {}
    for name, eng in engines.items():
        before = ops.LAUNCHES["spmm"]
        cold[name] = eng.generate(prompt, SERVE_GEN)
        n = serve_launches[name] = ops.LAUNCHES["spmm"] - before
        packed = specs[name][1] in ("nm24", "gathered")
        want = n_sites * api.cfg.n_layers * SERVE_GEN if packed else 0
        require(n == want, f"{name}: {n} spmm launches, want {want}")
    warm = (serve_bench(engines, prompt, serve_launches) if bench
            else {name: [] for name in engines})
    traces = {name: eng.logits_trace(prompt, SERVE_GEN)
              for name, eng in engines.items()}
    toks = {name: [r.tokens for r in warm[name]] + [cold[name].tokens]
            for name in engines}
    for name in engines:                      # greedy decode is repeatable
        require(all(torch.equal(t, toks[name][0]) for t in toks[name]),
                 f"{name}: tokens differ between runs")
    require(torch.equal(traces["nm24_2:4"], traces["gathered_2:4"])
            and torch.equal(toks["nm24_2:4"][0], toks["gathered_2:4"][0]),
            "nm24 and gathered disagree on the 2:4 masks")
    log("   nm24 == gathered (2:4 masks): tokens and logits bitwise equal")
    for packed_name, masked_name in (("nm24_2:4", "masked_2:4"),
                                     ("gathered_2:4", "masked_2:4"),
                                     ("gathered_0.6", "masked_0.6")):
        ref = traces[masked_name]
        forced = forced_logits(engines[packed_name], prompt,
                               toks[masked_name][0])
        scale = float(ref.abs().max())
        errs = (forced - ref).abs().amax(dim=(1, 2))      # per position
        err = float(errs.max())
        prune_gap = (f"; dense vs masked prefill "
                     f"{float((traces['dense'][0] - ref[0]).abs().max()):.4e}"
                     if bench else "")
        agree = float((toks[packed_name][0] == toks[masked_name][0])
                      .float().mean())
        log(f"   {packed_name} vs {masked_name} (fed the masked tokens): "
            f"logits max_abs_err prefill {float(errs[0]):.4e}, decode steps "
            f"{float(errs[1:].max()):.4e} ({err / scale:.2e} of "
            f"max|logits| {scale:.3f}{prune_gap}); free-running greedy "
            f"tokens agree {100 * agree:.1f}%")
        require(math.isfinite(err) and err <= SERVE_TOL * scale,
                f"{packed_name} vs {masked_name} beyond {SERVE_TOL} of "
                "max|logits|")
    require(engines["nm24_2:4"].weight_bytes()
            < engines["masked_2:4"].weight_bytes(),
            "nm24 holds no fewer weight bytes than masked")
    return serve_launches


# continuous serving (phase 6c): the chunked-prefill window, the prompt
# lengths held chunked vs one-shot; the load rows' arrival rates, below
# and above the continuous path's saturation (~18 requests/s on an H100
# in ``launch/profile_serve.py``'s sweep: goodput follows the rate to
# 16/s and makespans pass 1.6x the window at 24 and 32/s), the expected
# requests a rate (the window is this / rate), and those of the fixed
# path's row (it saturates by 2/s).
# The scheduler's shape and the traffic (CONT, LOAD_PROMPT, LOAD_OUTPUT)
# are profile_serve's.
CHUNK_W = 64
CHUNK_PROMPTS = (100, 300, 500)
LOAD_RATES = (8.0, 32.0)
LOAD_REQUESTS = 100
FIXED_REQUESTS = 16


def token_ids(n: int, seed: int, vocab: int):
    import numpy as np

    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(
        np.int32)


def sched_run(eng, reqs, n_sites: int, **kw):
    """Serve ``reqs`` — (prompt, max_new, SamplingParams) — through one
    ``ContinuousScheduler`` (``CONT``, plus ``kw``) until idle. Checks that
    the pools end empty and, phase 6c (e), that the engine launched spmm
    sites x layers x (prefill dispatches + decode steps) times, counted
    from the scheduler's own dispatches (none for dense and masked).
    Returns (tokens per request, scheduler, spmm launches)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import CONT
    from repro_torch.serve import ContinuousScheduler

    before = ops.LAUNCHES["spmm"]
    sch = ContinuousScheduler(eng, **CONT, **kw)
    rids = [sch.submit(p, n, sampling=s) for p, n, s in reqs]
    done = sch.run_until_idle()
    n = ops.LAUNCHES["spmm"] - before
    d = sch.dispatches
    want = (n_sites * eng.cfg.n_layers * (d["prefill"] + d["decode_steps"])
            if eng.fmt in ("nm24", "gathered") else 0)
    require(n == want, f"{eng.fmt}: {n} spmm launches for {d}, want {want}")
    require(sch.pool.used_bytes == 0 and (
        sch.prefill_pool is None or sch.prefill_pool.used_bytes == 0),
        f"{eng.fmt}: pages leaked")
    return [done[r].tokens for r in rids], sch, n


def forced_run(eng, tokens, n_valid: int, cap: int, feed, window=None):
    """Prefill ``tokens`` (B, S_pad; right-padded past ``n_valid``) into a
    cache of ``cap`` slots, in one shot (``window`` None) or in
    ``window``-token ``prefill_window`` calls, then one decode step per
    column of ``feed`` (B, n) on the same cache, or, for an int ``feed``,
    that many steps fed their own greedy tokens. Returns the (n + 1, B, V)
    fp32 logits, the K, V of the valid prompt positions and the tokens
    fed."""
    import torch

    api, dev = eng.api, eng.device
    nv = torch.tensor(n_valid, device=dev)
    with torch.no_grad():
        cache = api.init_cache(eng.params, tokens.shape[0], cap)
        if window is None:
            logits, cache = api.prefill(eng.params, {"tokens": tokens,
                                                     "n_valid": nv},
                                        cache, masks=eng.masks)
        else:
            for off in range(0, n_valid, window):
                logits, cache = api.prefill_window(
                    eng.params, {"tokens": tokens[:, off:off + window],
                                 "offset": torch.tensor(off, device=dev),
                                 "n_valid": nv}, cache, masks=eng.masks)
        kv = (cache.kv.k[:, :, :n_valid].clone(),
              cache.kv.v[:, :, :n_valid].clone())
        out, fed = [logits[:, -1].float()], []
        n = feed if isinstance(feed, int) else feed.shape[1]
        for i in range(n):
            tok = (out[-1].argmax(-1)[:, None] if isinstance(feed, int)
                   else feed[:, i:i + 1])
            fed.append(tok)
            logits, cache = api.decode_step(eng.params, tok, cache,
                                            masks=eng.masks)
            out.append(logits[:, -1].float())
    return torch.stack(out), kv, torch.cat(fed, dim=1)


def cross_shape(a, b) -> dict:
    """Two forced runs of the same tokens along different shapes: the
    largest |dK|, |dV| over valid positions, the logits' largest error and
    scale, and the greedy tokens that flip. In a teacher-forced pair a
    flip sits at a top-2 gap within twice that step's logits error, so
    the logits' bound is what holds the flips."""
    import torch

    (la, (ka, va), _), (lb, (kb, vb), _) = a, b
    diff = lambda x, y: float((x.float() - y.float()).abs().max())
    flips = la.argmax(-1) != lb.argmax(-1)
    gaps = top2_gap(la)[flips]
    return {"dk": diff(ka, kb), "dv": diff(va, vb), "err": diff(la, lb),
            "scale": float(la.abs().max()), "flips": int(flips.sum()),
            "n": flips.numel(),
            "gap": float(gaps.max()) if gaps.numel() else None}


def top2_gap(logits):
    """(..., V) logits -> (...) gap between the two largest."""
    import torch

    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def check_cross(name: str, what: str, r: dict) -> None:
    """Prints a cross-shape comparison and gates its logits at SERVE_TOL
    of max|logits| (the serving tolerance of phase 6)."""
    rel = r["err"] / r["scale"]
    flips = (f"{r['flips']} of {r['n']} greedy tokens flip, at top-2 gaps "
             f"<= {r['gap']:.4e}" if r["flips"] else
             f"all {r['n']} greedy tokens agree")
    log(f"   6c (b) {name} {what}: max |dK| {r['dk']:.3e} |dV| "
        f"{r['dv']:.3e} over valid positions; teacher-forced logits "
        f"max_abs_err {r['err']:.4e} ({rel:.2e} of max|logits| "
        f"{r['scale']:.3f}); {flips}")
    require(math.isfinite(r["err"]) and r["err"] <= SERVE_TOL * r["scale"],
            f"6c (b) {name} {what}: logits beyond {SERVE_TOL} of max|logits|")


def check_streams(name: str, what: str, got, want, ref, err: float) -> str:
    """Phase 6c (b)'s token gate across shapes: the greedy streams ``got``
    and ``want`` (n tokens each) must agree up to the first near-tie, a
    step whose reference logits ``ref`` (n, V; fed ``want``'s tokens)
    have a top-2 gap within twice ``err``. The scheduler decodes at still
    other shapes (8 rows over 1024 slots) than the forced pair that
    measured ``err``, so ``err`` is that pair's largest logits error, not
    its error at the step. Returns a summary."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    n = len(want)
    differ = np.flatnonzero(got[:n] != want)
    first_diff = int(differ[0]) if differ.size else n
    near = np.flatnonzero((top2_gap(ref[:n]) <= 2 * err).cpu().numpy())
    first_near = int(near[0]) if near.size else n
    require(first_diff >= first_near,
            f"6c (b) {name} {what}: greedy tokens differ at step "
            f"{first_diff}, before the first near-tie (step {first_near}, "
            f"top-2 gap <= {2 * err:.4e})")
    return f"{first_diff}/{n} (near-tie at {first_near})"


def cross_shape_checks(eng, name: str, longs: dict, short: list,
                       n_sites: int) -> int:
    """Phase 6c (b): comparisons across shapes, where the card's matmuls
    (cuBLAS, spmm's split plan) may round a row otherwise: chunked
    (CHUNK_W-token windows) vs one-shot prefill of each long prompt into
    its pow2 bucket, and the fixed path's batch-4 prefill of the short
    prompts vs each alone, teacher-forced (logits within SERVE_TOL).
    Then the same prompts' greedy tokens through the scheduler, chunked
    vs one-shot, and the scheduler (B = 1 prefill) vs ``generate``
    (B = 4): each pair equal up to the first near-tie, judged on the
    one-shot (batch) path's logits fed the stream and the largest logits
    error of the forced pair (``check_streams``). Returns the spmm
    launches of its scheduler runs."""
    import numpy as np
    import torch
    from repro_torch.serve import GREEDY
    from repro_torch.serve.engine import next_pow2

    dev = eng.device
    n_new = 8
    reqs = [(p, n_new, GREEDY) for p in longs.values()]
    sch_one, _, n1 = sched_run(eng, reqs, n_sites, bucket_batch=False)
    sch_chunk, _, n2 = sched_run(eng, reqs, n_sites, bucket_batch=False,
                                 prefill_chunk=CHUNK_W)
    agree = []
    for (S, p), got, want in zip(longs.items(), sch_chunk, sch_one):
        sb = next_pow2(S)
        toks = torch.zeros((1, sb), dtype=torch.int64)
        toks[0, :S] = torch.from_numpy(p.astype(np.int64))
        toks = toks.to(dev)
        one = forced_run(eng, toks, S, sb, n_new)
        r = cross_shape(one, forced_run(eng, toks, S, sb, one[2],
                                        window=CHUNK_W))
        check_cross(name, f"S={S} chunked W={CHUNK_W} vs one-shot", r)
        feed = torch.as_tensor(np.asarray(want[:n_new - 1]),
                               device=dev)[None]
        ref = forced_run(eng, toks, S, sb, feed)[0][:, 0]
        agree.append(check_streams(name, f"S={S} scheduler chunked vs "
                                   f"one-shot", got, want, ref, r["err"]))
    S = len(short[0])
    toks = torch.from_numpy(np.stack(short).astype(np.int64)).to(dev)
    cap = next_pow2(S + SERVE_GEN)
    fixed = eng.generate({"tokens": toks}, SERVE_GEN).tokens
    feed = fixed[:, :SERVE_GEN - 1]
    batch = forced_run(eng, toks, S, cap, feed)
    solo = [forced_run(eng, toks[i:i + 1], S, cap, feed[i:i + 1])
            for i in range(len(short))]
    solo = (torch.cat([r[0] for r in solo], dim=1),
            tuple(torch.cat([r[1][j] for r in solo], dim=1)
                  for j in range(2)), feed)
    r = cross_shape(batch, solo)
    check_cross(name, f"batch {len(short)} x S={S} prefill vs each alone", r)
    sched, _, n3 = sched_run(eng, [(p, SERVE_GEN, GREEDY) for p in short],
                             n_sites, bucket_batch=False)
    vs_gen = [check_streams(name, f"request {i} scheduler vs generate",
                            got, want.cpu(), batch[0][:, i], r["err"])
              for i, (got, want) in enumerate(zip(sched, fixed))]
    log(f"   6c (b) {name}: scheduler greedy tokens equal before the first "
        f"difference, chunked vs one-shot {agree}; scheduler vs generate "
        f"{vs_gen}")
    return n1 + n2 + n3


def continuous_path(api, params, masks60: dict, masks24: dict) -> dict:
    """Phase 6c: the continuous scheduler on the card, dense / masked
    PerRow(0.6) / nm24 (Wanda 2:4) / gathered PerRow(0.6), checks (a)-(e)
    in every format, then the load rows (f). Returns the spmm launches
    of the phase per kernel ({"spmm": nm24's, "spmm_gather": gathered's})."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import CONT, LOAD_OUTPUT, LOAD_PROMPT
    from repro_torch.pruning import sites
    from repro_torch.serve import (GREEDY, FaultPlan, SamplingParams,
                                   ServeEngine, loadgen)

    vocab = api.cfg.vocab_size
    n_sites = len(sites.site_specs(api.cfg, params))
    specs = {"dense": (None, "dense"), "masked": (masks60, "masked"),
             "nm24": (masks24, "nm24"), "gathered": (masks60, "gathered")}
    engines = {name: ServeEngine(api, params, masks=m, fmt=fmt)
               for name, (m, fmt) in specs.items()}
    ids = lambda n, seed: token_ids(n, seed, vocab)
    # (a): the reference test's four mixed requests
    mixed = [(ids(7, 1), 6, GREEDY),
             (ids(12, 2), 9, SamplingParams(temperature=0.8, seed=4)),
             (ids(5, 3), 3, SamplingParams(temperature=1.2, top_p=0.9,
                                           top_k=32, seed=5)),
             (ids(9, 4), 7, GREEDY)]
    longs = {S: ids(S, 10 + S) for S in CHUNK_PROMPTS}
    short = [ids(32, 20 + i) for i in range(4)]    # phase 6's prompt shape
    # (c): the mixed requests, a long sampled one and a one-token one
    disagg = mixed + [(longs[300], 8, SamplingParams(temperature=0.9,
                                                     top_p=0.95, seed=9)),
                      (ids(20, 5), 1, GREEDY)]
    launches = {name: 0 for name in engines}
    ops.reset_launches()
    for name, eng in engines.items():
        t0 = time.perf_counter()
        # (a) batched == solo, bitwise, at the pinned width
        toks, _, n = sched_run(eng, mixed, n_sites, bucket_batch=False)
        launches[name] += n
        for i, req in enumerate(mixed):
            solo, _, n = sched_run(eng, [req], n_sites, bucket_batch=False)
            launches[name] += n
            require(np.array_equal(toks[i], solo[0]),
                    f"6c (a) {name}: request {i} batched != solo")
        # (b) across shapes: chunked vs one-shot, batch 4 vs alone
        launches[name] += cross_shape_checks(eng, name, longs, short,
                                             n_sites)
        # (c) disaggregated == interleaved, bitwise, same width
        inter, _, n1 = sched_run(eng, disagg, n_sites, bucket_batch=False)
        dis, sch, n2 = sched_run(eng, disagg, n_sites, bucket_batch=False,
                                 disaggregate=True)
        launches[name] += n1 + n2
        require(all(np.array_equal(a, b) for a, b in zip(inter, dis)),
                f"6c (c) {name}: disaggregated tokens differ")
        pages = sum(sch.pool.pages_for(len(p)) for p, n, _ in disagg
                    if n > 1)
        require(sch.shipped_bytes == pages * sch.pool.page_bytes
                == sch.prefill_pool.shipped_bytes_out,
                f"6c (c) {name}: shipped {sch.shipped_bytes} B, want "
                f"{pages} pages")
        # (d) chaos
        work = loadgen.make_workload(loadgen.LoadConfig(
            arrival_rate=64.0, duration_s=0.5, prompt_len=(16, 128),
            output_len=(8, 48), vocab_size=vocab))
        before = ops.LAUNCHES["spmm"]
        res = loadgen.run_chaos(eng, work, FaultPlan.chaos(0), **CONT)
        launches[name] += ops.LAUNCHES["spmm"] - before
        require(res["leaked_bytes"] == 0 and res["stream_mismatches"] == 0
                and res["ok"] and res["faults_fired"],
                f"6c (d) {name}: chaos verdict {res}")
        torch.cuda.synchronize()
        log(f"   6c {name}: (a) 4 requests batched == solo bitwise; (c) "
            f"disaggregated == interleaved bitwise, {pages} pages x "
            f"{sch.pool.page_bytes} B shipped; (d) chaos "
            f"[{res['plan']}] {res['completed_faulted']}/"
            f"{res['n_requests']} completed, leaked 0 B, 0 mismatches, "
            f"fired {res['faults_fired']}, counters {res['counters']}; "
            f"(e) spmm launches {launches[name]} = sites x layers x "
            f"dispatches; {time.perf_counter() - t0:.2f} s")
    # where a scheduler step's time goes: host vs device, spmm's share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name in ("nm24", "gathered"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, sch, n = sched_run(engines[name], mixed, n_sites,
                                  bucket_batch=False)
            wall = time.perf_counter() - t0
        launches[name] += n
        dev_ms = spmm = 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                dev_ms += ms
                if "spmm_" in e.name or "splitk_reduce" in e.name:
                    spmm += ms
        log(f"   6c {name}: one run of the 4 mixed requests ({sch._step_no} "
            f"steps, {sch.dispatches}): wall {1e3 * wall:.2f} ms, device "
            f"kernels {dev_ms:.2f} ms (spmm {spmm:.2f} ms), host or idle "
            f"{1e3 * wall - dev_ms:.2f} ms")
    del engines
    # (f) the load rows: one pass each, no warm-up pass (the kernels are
    # built and (a)-(e) ran them; each run first dispatches every decode
    # shape once, ``ContinuousScheduler.warm``)
    base = loadgen.LoadConfig(prompt_len=LOAD_PROMPT, output_len=LOAD_OUTPUT,
                              seed=0)
    runs = [(rate, LOAD_REQUESTS, ("continuous",), (masks60, ("masked",
                                                              "gathered")))
            for rate in LOAD_RATES]
    runs += [(rate, LOAD_REQUESTS, ("continuous",), (masks24, ("nm24",)))
             for rate in LOAD_RATES]
    runs.append((LOAD_RATES[0], FIXED_REQUESTS, ("continuous", "fixed"),
                 (masks24, ("nm24",))))
    rows = []
    for rate, n_req, modes, (masks, formats) in runs:
        t0 = time.perf_counter()
        before = ops.LAUNCHES["spmm"]
        got = loadgen.bench_load_rows(
            api, params, masks, formats=formats, rates=(rate,),
            load=dataclasses.replace(base, duration_s=n_req / rate),
            modes=modes, warmup=False, **CONT)
        launches["gathered" if masks is masks60 else "nm24"] += \
            ops.LAUNCHES["spmm"] - before
        for r in got:
            require("error" not in r, f"6c (f): {r}")
        rows += got
        log(f"   6c (f) {'/'.join(formats)} {'/'.join(modes)} rate {rate}/s "
            f"over {n_req / rate} s: {time.perf_counter() - t0:.2f} s")
    for r in rows:
        window = r["duration_s"]
        log(f"   6c (f) {r['variant']:8s} {r['mode']:10s} rate "
            f"{r['arrival_rate']:5.1f}/s window {window:.3f} s: "
            f"{r['completed']}/{r['n_requests']} done, makespan "
            f"{r['makespan_s']:.3f} s ({r['makespan_s'] / window:.2f}x the "
            f"window), tokens asked at "
            f"{r['offered_tok_s'] * r['makespan_s'] / window:.1f} tok/s over "
            f"the window, goodput {r['goodput_tok_s']:.1f} tok/s over the "
            f"makespan, TTFT p50 {1e3 * r['p50_ttft_s']:.1f} p99 "
            f"{1e3 * r['p99_ttft_s']:.1f} ms, queue wait p50 "
            f"{1e3 * r['p50_queue_wait_s']:.1f} p99 "
            f"{1e3 * r['p99_queue_wait_s']:.1f} ms, per-token p50 "
            f"{1e3 * r['p50_tok_latency_s']:.2f} p99 "
            f"{1e3 * r['p99_tok_latency_s']:.2f} ms, wasted "
            f"{r['wasted_decode_tokens']} tokens [{r['kernel_used']}]")
    return {"spmm": launches["nm24"], "spmm_gather": launches["gathered"]}


def other_shapes(clock_mhz: float) -> None:
    """Phase 3b: every kernel at the other dense configs' shapes, held
    against its plain version as phase 3 holds it. The Gram (bf16, T =
    512) at each d of GRAM_DS, timed at GRAM_TIMED; the three swap kernels
    (k = 8) at SWAP_SHAPES, on all rows, swap_topk and swap_argmin held
    bitwise on the first 128 rows and the last 32-row block, the commit on
    every row, swap_topk and the commit step timed at the two largest;
    spmm at SPMM_SHAPES, the granite pair timed in bf16."""
    import torch
    from repro_torch.launch import profile_swap

    for d in GRAM_DS:
        check_gram(512, d, dtypes=("bf16",), time_it=d in GRAM_TIMED)
    for i, (R, d, site) in enumerate(SWAP_SHAPES):
        w, m, c, G = profile_swap.problem(R, d, i)
        tag = f"R={R} d={d} ({site})"
        last = (R - 1) // 32 * 32
        rows = torch.unique(torch.cat([torch.arange(min(R, 128)),
                                       torch.arange(last, R)])).cuda()
        timed = ("swap_topk",) if i < 2 else ()
        check_swaps(w, m, c, G, 8, tag, names=("swap_topk", "swap_argmin"),
                    timed=timed, clock_mhz=clock_mhz, rows=rows)
        check_commit(w, m, c, G, 8, tag, time_it=i < 2)
        del w, m, c, G
        torch.cuda.empty_cache()
    for d_out, d_in, act, bias, site, timed in SPMM_SHAPES:
        check_spmm(d_out, d_in, act, site, time_it=timed, bias=bias)
    torch.cuda.empty_cache()


def full_depth_plans() -> None:
    """Each dense config's ``plan_pruning`` at full depth on the meta
    device (nothing allocated): weight, Gram and calibration bytes, and
    whether calibration — the bf16 model and the skip-aware full
    accumulator — fits this card's memory."""
    import torch
    from repro_torch import configs, models
    from repro_torch.core import masks
    from repro_torch.pruning import plan as plan_lib, recipe as recipe_lib

    card = torch.cuda.get_device_properties(0).total_memory
    before = torch.cuda.memory_allocated()
    for name, cfg in configs.ARCHS.items():
        api = models.build(cfg)
        params = api.init(device="meta")
        plan = plan_lib.plan_pruning(
            api, params, recipe_lib.PruneRecipe.single(masks.PerRow(0.6)))
        weights = 2 * cfg.n_params()
        calib = plan.total_calib_bytes(minimal=False)
        fits = weights + calib <= card
        log(f"   {name}: {cfg.n_layers} layers, {cfg.n_params()} params "
            f"({weights / 1e9:.2f} GB bf16); prunable weights "
            f"{plan.total_weight_bytes() / 1e9:.2f} GB fp32, Grams "
            f"{plan.total_gram_bytes() / 1e9:.2f} GB, calibration state "
            f"{calib / 1e9:.2f} GB ({calib / cfg.n_layers / 1e9:.3f} GB a "
            f"layer); model + calibration {(weights + calib) / 1e9:.2f} GB "
            f"{'fits' if fits else 'does NOT fit'} one card "
            f"({card / 1e9:.2f} GB)")
    require(torch.cuda.memory_allocated() == before,
            "the full-depth plans allocated CUDA memory")


def other_config(name: str) -> dict:
    """Phases 4b and 6b for one dense config at full width, 2 layers, bf16,
    random weights from seed 0 (chatglm3's qkv biases, zero at init, drawn
    from N(0, 0.02²) so the bias path carries values): prune_model as in
    phase 4 with its gates, then serving as phase 6 without the dense
    engine and the timed runs. Returns the launches of both paths."""
    import torch
    from repro_torch import configs, models, pruning
    from repro_torch.core import masks
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    cfg = configs.get(name).replace(n_layers=2)
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    if cfg.qkv_bias:
        gen = torch.Generator(device=dev).manual_seed(0)
        for b in ("bq", "bk", "bv"):
            t = params["layers"]["attn"][b]
            t.copy_(0.02 * torch.randn(t.shape, generator=gen, device=dev))
    pattern = masks.PerRow(0.6)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    with Phase(f"4b {name}: prune_model + perplexity"):
        log(f"   config: {name} full width (d_model {cfg.d_model}, "
            f"{cfg.n_heads} / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff} "
            f"{cfg.mlp} {cfg.act}, vocab {cfg.vocab_size}, qkv_bias "
            f"{cfg.qkv_bias}, rope_pct {cfg.rope_pct}), n_layers 2 (reduced "
            f"from {configs.get(name).n_layers}), {cfg.dtype}")
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = pruning.prune_model(api, params, batches, pattern,
                                     warmstart="wanda", method="sparseswaps",
                                     t_max=T_MAX)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        prune_launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        dense = pruning.evaluate(api, params, seed=0, device=dev)
        pruned = pruning.evaluate(api, params, masks=report.masks, seed=0,
                                  device=dev)
        log(report.summary())
        log(f"   {name}: prune_model {t_prune:.2f} s, max memory "
            f"{peak / 2**30:.2f} GiB; dense ppl {dense['perplexity']:.4f}, "
            f"pruned ppl {pruned['perplexity']:.4f}; mean error reduction "
            f"{100 * report.mean_error_reduction():.3f}%")
        log(f"   {name}: launches {prune_launches}")
        log(f"   {name}: masks digest {digest(mask_leaves(report.masks))}")
        check_pruned(api, params, report, prune_launches, len(batches),
                     pattern, dense, pruned)
    with Phase(f"6b {name}: serve masked / nm24 / gathered"):
        rep24 = pruning.prune_model(api, params, batches, masks.NM(2, 4),
                                    warmstart="wanda", method="none")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 32, split="val", device=dev)
        serve_launches = serve_path(api, params, report.masks, rep24.masks,
                                    pipe.get(0), bench=False)
        log(f"   {name}: spmm launches {serve_launches}")
    del params, report, rep24, batches
    torch.cuda.empty_cache()
    return {"prune": prune_launches, "serve": serve_launches}


def check_pruned(api, params, report, launches: dict, n_batches: int,
                 pattern, dense: dict, pruned: dict) -> None:
    """Phases 4 and 4b: every Gram launch on the bf16 path, one per tap,
    layer and batch; swap_topk once per site, layer and pass (taps and
    sites from ``pruning.sites``); exact per-row sparsity, monotone row
    losses, a positive mean error reduction, finite perplexities."""
    from repro_torch.core import masks
    from repro_torch.pruning import sites

    cfg = api.cfg
    specs = sites.site_specs(cfg, params)
    n_gram = len(sites.tap_specs(cfg, specs)) * cfg.n_layers * n_batches
    require(launches["gram_xtx_bf16"] == n_gram and launches["gram_xtx"] == 0,
            f"{cfg.name}: the Gram launches were not all {n_gram} on the "
            "bf16 path")
    n_topk = len(specs) * cfg.n_layers * T_MAX
    require(launches["swap_topk"] == n_topk,
            f"{cfg.name}: swap_topk launched {launches['swap_topk']} times, "
            f"want {n_topk}")
    for s in report.sites:
        node = report.masks
        for k in s.name.split("."):
            node = node[k]
        require(masks.validate_mask(node, pattern),
                f"{cfg.name} {s.name}: per-row sparsity not exact")
        require(bool((s.row_loss_final <= s.row_loss_init).all()),
                f"{cfg.name} {s.name}: a row loss rose")
    require(report.mean_error_reduction() > 0,
            f"{cfg.name}: no error reduction over the warmstart")
    require(math.isfinite(dense["perplexity"])
            and math.isfinite(pruned["perplexity"]),
            f"{cfg.name}: perplexity not finite")


RECIPE = {
    "defaults": {"pattern": "0.6", "t_max": T_MAX},
    "rules": [
        {"select": "*.attn.wq", "pattern": "2:4"},
        {"select": "*.attn.wo", "pattern": "2:4"},
        {"select": "*.attn.wk", "method": "sparsegpt"},
        {"select": "*.attn.wv", "skip": True},
        {"select": "*.mlp.w_down", "method": "dsnot"},
        {"select": "*"},
    ],
}


# where the host time of a resumed recipe run goes: (label, file, function,
# caller or None) of the port, by cumulative time under cProfile
RESUME_SPLIT = [
    ("launch.prune.prune", "launch/prune.py", "prune", None),
    ("  PruneExecutor.run", "pruning/executor.py", "run", None),
    ("    accumulate_stats (calibration restore)", "pruning/stats.py",
     "accumulate_stats", None),
    ("    _data_fingerprint (to host, sha256)", "pruning/executor.py",
     "_data_fingerprint", None),
    ("    _restore_group", "pruning/executor.py", "_restore_group", None),
    ("      ckpt.restore_latest (read, hash check)", "ckpt/store.py",
     "restore_latest", "_restore_group"),
    ("  evaluate (dense + pruned)", "pruning/evaluate.py", "evaluate", None),
    ("  write_out_dir", "launch/prune.py", "write_out_dir", None),
]


def host_split(prof, top: int = 12) -> list[str]:
    """RESUME_SPLIT's cumulative times, then the ``top`` functions by self
    time (C calls included: hashing, copies, file reads and writes)."""
    import pstats

    st = pstats.Stats(prof).stats
    lines = []
    for label, path, func, caller in RESUME_SPLIT:
        ct = 0.0
        for (f, _, fn), (_, _, _, cum, callers) in st.items():
            if fn != func or not f.endswith(path):
                continue
            ct += cum if caller is None else sum(
                v[3] for (_, _, cfn), v in callers.items() if cfn == caller)
        lines.append(f"     {ct:8.3f} s  {label}")
    lines.append("     by self time:")
    for (f, ln, fn), v in sorted(st.items(), key=lambda kv: -kv[1][2])[:top]:
        where = fn if f == "~" else f"{Path(f).name}:{ln} {fn}"
        lines.append(f"     {v[2]:8.3f} s {v[1]:7d}x  {where[:90]}")
    return lines


def recipe_path(cfg) -> None:
    """Phase 7: the launcher with a recipe of every rule kind, run twice
    into one out dir (the second resumes every group), a third time
    under cProfile (the host-time split of a resume), and plan_only."""
    import cProfile
    import tempfile

    import torch
    from repro_torch import pruning
    from repro_torch.core import masks
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    class Count(pruning.PruneCallback):
        """Restored and computed groups, and each group's wall time."""

        def __init__(self):
            self.restored, self.computed, self.secs = [], [], {}

        def on_group_start(self, planned, index, total):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_group_done(self, planned, report, *, restored):
            torch.cuda.synchronize()
            self.secs[f"{planned.name} [{report.pattern} {report.method}]"] \
                = time.perf_counter() - self.t0
            (self.restored if restored else self.computed).append(
                planned.name)

    with tempfile.TemporaryDirectory() as tmp:
        recipe_file = Path(tmp) / "recipe.json"
        recipe_file.write_text(json.dumps(RECIPE))
        kw = dict(tiny=False, n_layers=cfg.n_layers, recipe=str(recipe_file),
                  out_dir=str(Path(tmp) / "out"), calib_ckpt_every=2,
                  calib_stats="minimal", compact_every=2, device="cuda",
                  verbose=False)
        outs, counts = [], []
        for run in (1, 2):
            counts.append(Count())
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = launch_prune.prune(cfg.name, callback=counts[-1], **kw)
            torch.cuda.synchronize()
            outs.append(out)
            rep = out["report"]
            log(f"   run {run}: {time.perf_counter() - t0:.2f} s "
                f"(executor {rep.wall_time_s:.2f} s), computed "
                f"{len(counts[-1].computed)} groups, restored "
                f"{len(counts[-1].restored)}, calibration batches "
                f"{out['stats'].batches}, launches {dict(ops.LAUNCHES)}")
            log(f"   run {run}: dense ppl {out['dense']['perplexity']:.4f}, "
                f"pruned ppl {out['pruned']['perplexity']:.4f}")
            log("   group wall times: " + ", ".join(
                f"{k} {v:.2f} s" for k, v in counts[-1].secs.items()))
            if run == 1:
                log(rep.summary())
        rep, stats = outs[0]["report"], outs[0]["stats"]
        for s in rep.sites:
            node = rep.masks
            for k in s.name.split("."):
                node = node[k]
            require(masks.validate_mask(node, masks.parse_pattern(s.pattern)),
                    f"{s.name}: sparsity not exact for {s.pattern}")
        require("wv" not in rep.masks["layers"]["attn"]
                and "wv" not in stats.taps,
                "the skipped site has a mask or a tap")
        require(set(stats.taps["w_down"]) == {"d", "s", "n"},
                "the dsnot site accumulated a Gram")
        require(sorted({s.method for s in rep.sites})
                == ["dsnot", "sparsegpt", "sparseswaps"],
                "the recipe did not run every method")
        for out in outs:
            require(math.isfinite(out["dense"]["perplexity"])
                    and math.isfinite(out["pruned"]["perplexity"]),
                    "perplexity not finite")
        n_active = len(rep.sites)
        require(len(counts[0].computed) == n_active and not counts[0].restored,
                "the first run did not compute every group")
        require(len(counts[1].restored) == n_active
                and not counts[1].computed,
                "the second run recomputed a group")
        again = outs[1]["report"]
        for s in rep.sites:
            a, b = rep.masks, again.masks
            for k in s.name.split("."):
                a, b = a[k], b[k]
            require(torch.equal(a, b), f"{s.name}: resumed masks differ")
        log(f"   resume: {n_active}/{n_active} groups restored, masks "
            "bitwise equal")
        del outs, rep, again, stats
        count = Count()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        launch_prune.prune(cfg.name, callback=count, **kw)
        torch.cuda.synchronize()
        prof.disable()
        log(f"   run 3 (resumed again, under cProfile): "
            f"{time.perf_counter() - t0:.2f} s, restored "
            f"{len(count.restored)} groups; host time split:")
        require(len(count.restored) == n_active and not count.computed,
                "the third run recomputed a group")
        for line in host_split(prof):
            log(line)
        del prof
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        launch_prune.prune(cfg.name, plan_only=True,
                           **{k: v for k, v in kw.items()
                              if k not in ("out_dir", "calib_ckpt_every",
                                           "calib_stats", "verbose")})
        after = torch.cuda.memory_allocated()
        log(f"   plan_only: cuda memory allocated {before} -> {after} B")
        require(after == before, "plan_only allocated CUDA memory")


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import configs, models, pruning
    from repro_torch.core import masks, sparseswaps, swap_math as sm
    from repro_torch.core.warmstart import warmstart_mask
    from repro_torch.kernels import build, ops
    from repro_torch.launch import profile_swap

    t_start = time.perf_counter()
    with Phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        log(f"   torch {torch.__version__} cuda {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("   TF32 off for matmuls and cuDNN")

    with Phase("2 build"):
        libs = sorted({v[0] for v in KERNELS.values()})
        build.build(libs)
        for lib in libs:
            log(f"   {lib} ({build.lib_path(lib).name}):")
            for line in build.ptxas_report(lib).splitlines():
                log(f"     {line}")

    results = {}
    with Phase("3 kernel checks at main-path shapes"):
        check_gram(512, 4096)
        results["gram_xtx"] = check_gram(512, 14336)["bf16"]
        clock = profile_swap.sm_clock_mhz()
        for R, d, seed in profile_swap.SHAPES:
            w, m, c, G = profile_swap.problem(R, d, seed)
            tag = f"R={R} d={d}"
            w_down = (R, d) == profile_swap.SHAPES[-1][:2]
            names = ("swap_topk", "swap_argmin")
            res = check_swaps(w, m, c, G, 8, tag, names=names, timed=names,
                              clock_mhz=clock)
            ratio = res["swap_argmin"]["ms"] / res["swap_topk"]["ms"]
            log(f"   swap_argmin {tag}: {ratio:.3f}x swap_topk's time")
            commit = check_commit(w, m, c, G, 8, tag)
            if w_down:
                results.update(res)
                results["swap_commit"] = commit
            del w, m, c, G
        # T = 1 and 64: a one-row decode bucket and a chunked-prefill
        # window of the continuous scheduler (phase 6c)
        spmm_res = check_spmm(14336, 4096, "silu", "w_gate", extra_T=(1, 64))
        spmm_res.update({(T, f"{fmt} w_down"): r for (T, fmt), r in
                         check_spmm(4096, 14336, None, "w_down").items()})
        check_spmm(4096, 4096, None, "wq/wo", time_it=False)
        check_spmm(1024, 4096, None, "wk/wv", time_it=False)
        results["spmm"] = spmm_res[(128, "nm24")]
        results["spmm_gather"] = spmm_res[(4, "gathered")]
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    cfg = configs.get("llama31-8b").replace(n_layers=2)
    log(f"   config: {cfg.name} full width, n_layers {cfg.n_layers} "
        f"(reduced from 32), {cfg.dtype}")
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    pattern = masks.PerRow(0.6)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))

    with Phase("4 main path: prune_model + perplexity"):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = pruning.prune_model(api, params, batches, pattern,
                                     warmstart="wanda", method="sparseswaps",
                                     t_max=T_MAX)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = pruning.evaluate(api, params, seed=0, device=dev)
        pruned = pruning.evaluate(api, params, masks=report.masks, seed=0,
                                  device=dev)
        t_eval = time.perf_counter() - t0
        main_launches = dict(ops.LAUNCHES)
        log(report.summary())
        log(f"   prune_model {t_prune:.2f} s, evaluation {t_eval:.2f} s, "
            f"max memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"   dense  ppl {dense['perplexity']:.4f} acc {dense['accuracy']:.4f}")
        log(f"   pruned ppl {pruned['perplexity']:.4f} acc {pruned['accuracy']:.4f}")
        log(f"   launches {main_launches}")
        log(f"   masks digest {digest(mask_leaves(report.masks))}")
        check_pruned(api, params, report, main_launches, len(batches),
                     pattern, dense, pruned)

    with Phase("5 second path: refine on layer 0 w_down (k=1, candidates)"):
        taps = pruning.accumulate(api, params, batches)
        G = taps["w_down"]["g"][0]
        W = params["layers"]["mlp"]["w_down"][0]
        m0 = warmstart_mask(W.float(), G, pattern, "wanda")
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sparseswaps.count_search_passes() as cnt:
            res = sparseswaps.refine(W, G, m0, pattern, k_swaps=1, t_max=2)
        torch.cuda.synchronize()
        t_k1 = time.perf_counter() - t0
        argmin_launches = ops.LAUNCHES["swap_argmin"]
        check_refined(W, G, res, pattern, "k=1")
        log(f"   k=1: passes {cnt.passes}, swaps {int(res.swaps.sum())}, "
            f"error reduction {100*float(res.error_reduction.mean()):.3f}%, "
            f"swap_argmin launches {argmin_launches}, {t_k1:.3f} s; "
            f"digest of masks, swaps, losses "
            f"{digest([res.mask > 0.5, res.swaps, res.loss_final])}")
        require(argmin_launches > 0, "the k=1 path did not launch swap_argmin")

        # eps = 0 keeps every row searching through t_max = 4 passes at
        # this width, so compaction gathers nothing; at eps = -(30th
        # percentile of the rows' best first-pass ΔL) ~70% of the rows
        # accept nothing in pass 1 and sit at a fixed point from then on,
        # so compact_every=1 runs later passes on a gathered working set
        # with pad slots.
        c0, _ = sparseswaps._init_carry(W.float(), m0, G)
        best = ops.swap_topk(W.float(), m0, c0, G, k=1)[0][:, 0]
        eps_fix = float(-torch.quantile(best, 0.3))
        del c0, best
        require(eps_fix > 0, "the rows' best first-pass swaps do not improve")
        log(f"   the calibration Gram's {ops.gram_facts(G)}")
        runs = {}
        commit_launches = 0
        for eps, every in ((0.0, 0), (0.0, 2), (eps_fix, 0), (eps_fix, 1)):
            tag = f"candidates eps={eps:.6g} compact_every={every}"
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sparseswaps.count_search_passes() as cnt:
                r = sparseswaps.refine(W, G, m0, pattern, k_swaps=8,
                                       commit_mode="candidates", t_max=T_MAX,
                                       eps=eps, compact_every=every)
            torch.cuda.synchronize()
            runs[eps, every] = (r, cnt, time.perf_counter() - t0,
                                dict(ops.LAUNCHES))
            check_refined(W, G, r, pattern, tag)
            log(f"   {tag}: passes {cnt.passes}, rows scored "
                f"{cnt.rows_scored}, swaps {int(r.swaps.sum())}, error "
                f"reduction {100*float(r.error_reduction.mean()):.3f}%, "
                f"{runs[eps, every][2]:.3f} s, launches "
                f"{runs[eps, every][3]}; digest of masks, swaps, losses "
                f"{digest([r.mask > 0.5, r.swaps, r.loss_final])}")
            require(runs[eps, every][3]["swap_commit"] == cnt.passes > 0,
                    "swap_commit did not launch once per search pass")
            commit_launches += runs[eps, every][3]["swap_commit"]
        for eps, every in ((0.0, 2), (eps_fix, 1)):
            (a, ca, _, _), (b, cb, _, _) = runs[eps, 0], runs[eps, every]
            require(torch.equal(a.mask, b.mask)
                    and torch.equal(a.swaps, b.swaps)
                    and torch.equal(a.loss_final, b.loss_final),
                    f"compaction changed the masks, swaps or losses "
                    f"(eps={eps:.6g})")
            require(cb.rows_scored <= ca.rows_scored,
                    "compaction scored more rows")
            log(f"   compaction eps={eps:.6g} compact_every={every}: masks, "
                f"swaps and losses bitwise equal; rows scored "
                f"{ca.rows_scored} -> {cb.rows_scored}")
        require(runs[eps_fix, 1][1].rows_scored
                < runs[eps_fix, 0][1].rows_scored,
                "no row left the working set at eps > 0")
        kern = sparseswaps.refine(W[:256], G, m0[:256], pattern, k_swaps=8,
                                  commit_mode="candidates", t_max=T_MAX,
                                  method="kernel")
        plain = sparseswaps.refine(W[:256], G, m0[:256], pattern, k_swaps=8,
                                   commit_mode="candidates", t_max=T_MAX,
                                   method="chunked", chunk=128)
        require(torch.equal(kern.mask, plain.mask)
                and torch.equal(kern.swaps, plain.swaps),
                "kernel and plain candidate refinement disagree (256 rows)")
        log(f"   256 rows: kernel path == plain chunked path "
            f"({int(kern.swaps.sum())} swaps, {kern.iters} passes)")
        del taps, G, W

    with Phase("6 serve path: dense / masked / nm24 / gathered"):
        from repro_torch.data import synthetic

        rep24 = pruning.prune_model(api, params, batches, masks.NM(2, 4),
                                    warmstart="wanda", method="none")
        pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                      4, 32, split="val", device=dev)
        serve_launches = serve_path(api, params, report.masks, rep24.masks,
                                    pipe.get(0))
        log(f"   spmm launches {serve_launches}")
        # phase 6c runs last, on these masks (kept on the host meanwhile)
        masks_6c = [_tree_to(m, "cpu") for m in (report.masks, rep24.masks)]

    with Phase("7 recipe path: launch.prune with a mixed recipe, resume"):
        recipe_path(cfg)
    del params, report, rep24, batches, api
    torch.cuda.empty_cache()

    with Phase("3b kernel checks at the other dense configs' shapes"):
        other_shapes(clock)
    other = {name: other_config(name) for name in OTHER_DENSE}
    with Phase("8 full depth, shapes only: plan_pruning on the meta device"):
        full_depth_plans()
    with Phase("6c continuous serving: scheduler, chunked prefill, "
               "disaggregation, chaos, load"):
        api = models.build(cfg)
        params = api.init(seed=0, device=dev)      # phase 4's params
        cont_launches = continuous_path(api, params, *masks_6c)
        log(f"   spmm launches {cont_launches}")
        del api, params, masks_6c

    runs = [(main_launches, serve_launches)] + [
        (o["prune"], o["serve"]) for o in other.values()]
    launches = {"gram_xtx": sum(p["gram_xtx_bf16"] + p["gram_xtx"]
                                for p, _ in runs),
                "swap_topk": sum(p["swap_topk"] for p, _ in runs),
                "swap_argmin": argmin_launches,
                "swap_commit": commit_launches,
                "spmm": sum(s["nm24_2:4"] for _, s in runs)
                + cont_launches["spmm"],
                "spmm_gather": sum(s["gathered_0.6"] + s["gathered_2:4"]
                                   for _, s in runs)
                + cont_launches["spmm_gather"]}
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    log(f"   total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
