"""Time of the swap searches (``ops.swap_topk`` and ``ops.swap_argmin``)
at the main path's shapes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_swap [--variants a,b]
    PYTHONPATH=src python -m repro_torch.launch.profile_swap --commit [--refine]

For each (R, d) of llama31-8b's pruning sites — (1024, 4096) wk / wv,
(4096, 4096) wq / wo, (14336, 4096) w_gate / w_up, (4096, 14336) w_down —
it builds the problem ``chip_smoke.py`` phase 3 checks (rows ~ N(0, 1/d),
a Wanda PerRow(0.6) mask over a correlated Gram, the same seeds) and
prints the feasible pairs (kept u x pruned p, summed over rows), the
bound (5 operations per feasible pair at the 67 TFLOP/s fp32 peak) and
the issue floor (6 unfused fp32 instructions per feasible pair on every
SM's 128 lanes at the card's maximum SM clock, from nvidia-smi); then,
for ``swap_topk`` at k = 8 and for ``swap_argmin``, the time of one call
by CUDA events over 3 calls (the wrapper's host work included, as phase
3 times it) and the device time of each CUDA kernel the calls launched,
by torch.profiler, per call. It runs as it is inside a ``git archive`` of
an earlier commit's tree, so two versions can be timed in one call, in
turns.

``--variants a,b+c`` also builds copies of ``csrc/swap_topk.cu`` with the
edits of ``VARIANTS`` (``+`` joins several in one copy) and, at each
shape, checks each copy's ``swap_topk`` output against the shipped
kernel's bit for bit and prints its kernels' device time.

``--commit`` times the candidate commit step instead: at each shape,
``ops.swap_topk_commit`` at k = 8, each of ``REPS`` calls in its own
torch.profiler trace; every CUDA kernel (and memset or copy) that starts
after the search's last kernel (``swap_topk_merge_kernel``) is counted,
and the script prints per call each kernel's device ms and launches by
name, their sums by phase (the sub-Gram gather before the first
``swap_commit*`` kernel, the decisions, the apply after them) and kind
(gathers and index ops, elementwise, copies, row sums, the commit
kernels), and the CUDA-event time of the whole call beside the search
alone. Where the tree has
``ops.gram_facts``, the facts of G are taken once per shape, as
``refine`` does, and timed apart.

``--refine`` runs the candidate refinement end to end on the w_down
problem: ``refine(k_swaps=8, commit_mode="candidates", t_max=4)``
without and with ``compact_every=2``, printing the wall time of each
(host clock to a synchronize), its passes and swaps, and a digest of its
masks, swaps and losses, to compare two trees' runs bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import subprocess
import time

import torch

from repro_torch.device import disable_tf32, resolve_device

# (R, d, seed) of the problems; chip_smoke.py phase 3 checks the same
SHAPES = [(1024, 4096, 3), (4096, 4096, 4), (14336, 4096, 1),
          (4096, 14336, 2)]
PEAK_FP32 = 67e12
K = 8            # candidates a row, as on the main path
REPS = 3         # calls timed, as chip_smoke.py phase 3
# copies of csrc/swap_topk.cu: name -> [(text, replacement)]
VARIANTS = {
    # every u of a chunk in the row's list, kept or not: the dense u walk
    "dense_u": [("const bool keep = na[j][h] < INFINITY;",
                 "const bool keep = true;")],
    # the exact path throughout: ΔL's five operations on the Gram as it is
    "nofold": [("const bool fold = (*flags & UNSAFE) == 0;",
                "const bool fold = false;")],
    # the list walk not unrolled
    "unroll1": [("#pragma unroll 2\n      for (int i = 0;",
                 "      for (int i = 0;")],
    # 8 consumer warps of 4 rows (the same 32 rows a block)
    "warps8": [("constexpr int CW = 16;", "constexpr int CW = 8;"),
               ("constexpr int RPW = 2;", "constexpr int RPW = 4;")],
    # chunks of 32 u in a ring of four stages
    "uc32": [("constexpr int UC = 64;", "constexpr int UC = 32;"),
             ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    # 24 consumer warps of 2 rows: 48 rows a block
    "warps24": [("constexpr int CW = 16;", "constexpr int CW = 24;")],
    # a ring of three stages
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}


def problem(R: int, d: int, seed: int):
    """Rows w, a Wanda 0.6 mask, the correlation c and a correlated Gram
    (``chip_smoke.swap_problem``)."""
    from repro_torch.core import masks, swap_math as sm
    from repro_torch.core.warmstart import warmstart_mask

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(1024, d, generator=gen, device="cuda")
    lo = torch.randn(1024, 64, generator=gen, device="cuda")
    mix = torch.randn(64, d, generator=gen, device="cuda")
    x = z + 0.5 * (lo @ mix)
    G = x.T @ x
    w = torch.randn(R, d, generator=gen, device="cuda") * d ** -0.5
    m = warmstart_mask(w, G, masks.PerRow(0.6), "wanda")
    return w, m, sm.correlation_vector(w, m, G), G


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out)


def kernel_device_ms(fn, reps: int) -> dict[str, float]:
    """Per call, the device ms of each CUDA kernel ``fn()`` launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_spmm import profiler_preroll

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_preroll()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "swap_" in e.name:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us()
    return {name: us / 1e3 / reps for name, us in per.items()}


def variant_libs(names) -> dict[str, ctypes.CDLL]:
    """The edited copies of csrc/swap_topk.cu in ``names``, built in
    parallel into build/repro_torch/profile_swap/."""
    from repro_torch.kernels import build

    src = (build.CSRC / "swap_topk.cu").read_text()
    out = build.BUILD_DIR / "profile_swap"
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name in names:
        text = src
        for old, new in (e for part in name.split("+")
                         for e in VARIANTS[part]):
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/swap_topk.cu")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = out / f"swap_topk_{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.nvcc_flags("swap_topk"), "-I",
               str(build.CSRC), "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"variant {name}: " + " | ".join(regs[-2:]), flush=True)
        lib = ctypes.CDLL(str(out / f"swap_topk_{name}.so"))
        lib.swap_topk_search.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
        lib.swap_topk_search.restype = ctypes.c_int
        lib.swap_topk_scratch_bytes.argtypes = ([ctypes.c_int] * 3
                                                + [ctypes.c_void_p])
        lib.swap_topk_scratch_bytes.restype = ctypes.c_size_t
        libs[name] = lib
    return libs


def variant_runner(lib, w, m, c, G, k: int):
    """(run, outputs): ``run()`` launches ``lib``'s search on the
    problem's operands into ``outputs`` (vals, u, p)."""
    from repro_torch.kernels import ops

    a, b, w32, G32 = ops._swap_inputs(w, m, c, G)
    R, d = w.shape
    outs = (torch.empty((R, k), device="cuda"),
            torch.empty((R, k), dtype=torch.int32, device="cuda"),
            torch.empty((R, k), dtype=torch.int32, device="cuda"))
    scratch = torch.empty(lib.swap_topk_scratch_bytes(R, d, k,
                                                      G32.data_ptr()),
                          dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.swap_topk_search(
            a.data_ptr(), b.data_ptr(), w32.data_ptr(), G32.data_ptr(),
            *(t.data_ptr() for t in outs), scratch.data_ptr(), R, d, k,
            stream)
        if err:
            raise RuntimeError(f"swap_topk launch failed: CUDA error {err}")
    return run, outs


def profile_swap(variants=()):
    """Yields the lines to print, one shape at a time."""
    from repro_torch.kernels import ops

    resolve_device("cuda")
    disable_tf32()
    libs = variant_libs(variants)
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    yield (f"{torch.cuda.get_device_name(0)}, {sms} SMs, max SM clock "
           f"{clock:.0f} MHz; k = {K}, CUDA events over {REPS} calls")
    for R, d, seed in SHAPES:
        w, m, c, G = problem(R, d, seed)
        pairs = float(((m > 0.5).sum(1).double()
                       * (m < 0.5).sum(1).double()).sum())
        bound = 1e3 * 5.0 * pairs / PEAK_FP32
        floor = 1e3 * 6.0 * pairs / (sms * 128 * clock * 1e6)
        yield (f"R={R} d={d}: feasible pairs {pairs:.4e}; bound "
               f"{bound:.3f} ms, issue floor {floor:.3f} ms")
        run = lambda: ops.swap_topk(w, m, c, G, k=K)
        times = {}
        for name, fn in (("swap_topk", run),
                         ("swap_argmin", lambda: ops.swap_argmin(w, m, c, G))):
            ms, wall = times[name] = _events_ms(fn)
            yield (f"  {name}: {ms:.3f} ms (events; host {wall:.3f} ms; "
                   f"{ms / times['swap_topk'][0]:.3f}x swap_topk's), device "
                   f"ms per call: {_kernels(kernel_device_ms(fn, REPS))}")
        vals, u, p = run()
        want = (vals, u.int(), p.int())
        for name, lib in libs.items():
            vrun, outs = variant_runner(lib, w, m, c, G, K)
            vrun()
            same = all(torch.equal(g, t) for g, t in zip(outs, want))
            yield (f"  variant {name}: equal to the shipped kernel {same}; "
                   f"device ms per call: "
                   f"{_kernels(kernel_device_ms(vrun, REPS))}")
        del w, m, c, G
        torch.cuda.empty_cache()


# (kind, name fragments) in order: a kernel takes the first kind it matches
KINDS = [("gathers", ("gather", "index", "Index")),
         ("row sums", ("reduce_kernel",)),
         ("copies", ("copy", "Memcpy", "Memset", "fill")),
         ("elementwise", ("elementwise",))]


def _short(name: str) -> str:
    """A CUDA kernel's name without its arguments and namespaces; an
    elementwise kernel's with its innermost functor."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    base = base.removeprefix("void ").split("<")[0].split("::")[-1].strip()
    functor = re.findall(r"(\w*Functor\w*)", name)
    return f"{base}[{functor[-1]}]" if functor else base


def _kind(name: str) -> str:
    if "swap_commit" in name:
        return "kernel"
    for kind, parts in KINDS:
        if any(part in name for part in parts):
            return kind
    return "other"


def commit_split(w, m, c, G, *, reps: int = REPS, tries: int = 3):
    """Per call of ``ops.swap_topk_commit`` (k = K): {(phase, kernel):
    [launches, device ms]} of what runs after the search, each call in its
    own trace, and the keyword arguments the calls took. Phases: "gather"
    (before the first ``swap_commit*`` kernel), "decisions" (that kernel),
    "apply" (``swap_commit_apply*`` and everything after the decisions).
    The profiler can lose a trace's last kernel records (seen after a
    330 ms search on an H100); a call launches the same kernels every
    time, so only the traces with the most records after the search are
    kept, taken again up to ``tries`` times per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.profile_spmm import profiler_preroll

    kw = {"gram": ops.gram_facts(G)} if hasattr(ops, "gram_facts") else {}
    fn = lambda: ops.swap_topk_commit(w, m, c, G, k=K, **kw)
    fn()
    torch.cuda.synchronize()
    tails: list[list] = []
    for _ in range(reps * tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        merges = [i for i, e in enumerate(ev) if "swap_topk_merge" in e.name]
        if not merges:
            raise RuntimeError("the trace holds no swap_topk_merge_kernel")
        tails.append(ev[merges[-1] + 1:])
        most = max(map(len, tails))
        if sum(len(t) == most for t in tails) == reps:
            break
    per: dict[tuple[str, str], list] = {}
    for tail in [t for t in tails if len(t) == most][:reps]:
        phase = "gather"
        for e in tail:
            if "swap_commit_apply" in e.name:
                phase = "apply"
            elif "swap_commit" in e.name:
                phase = "decisions"
            acc = per.setdefault((phase, _short(e.name)), [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e3
            if phase == "decisions":
                phase = "apply"
    for acc in per.values():
        acc[0] /= reps
        acc[1] /= reps
    return per, kw


def profile_commit():
    """Yields the lines of ``--commit``, one shape at a time."""
    from repro_torch.kernels import ops

    resolve_device("cuda")
    disable_tf32()
    yield (f"{torch.cuda.get_device_name(0)}: ops.swap_topk_commit, k = {K}; "
           f"device ms and launches per call after the search ({REPS} "
           f"traces), CUDA events over {REPS} calls")
    for R, d, seed in SHAPES:
        w, m, c, G = problem(R, d, seed)
        split, kw = commit_split(w, m, c, G)
        total = sum(ms for _, ms in split.values())
        launches = sum(n for n, _ in split.values())
        yield (f"R={R} d={d}: after the search {total:.4f} ms device, "
               f"{launches:g} launches per call")
        for phase in ("gather", "decisions", "apply"):
            kinds: dict[str, list] = {}
            for (ph, name), (n, ms) in split.items():
                if ph == phase:
                    acc = kinds.setdefault(_kind(name), [0, 0.0])
                    acc[0] += n
                    acc[1] += ms
            if kinds:
                yield (f"  {phase} {sum(v[1] for v in kinds.values()):.4f} "
                       f"ms / {sum(v[0] for v in kinds.values()):g}: "
                       + ", ".join(f"{kind} {ms:.4f} ms / {n:g}" for kind,
                                   (n, ms) in sorted(kinds.items(),
                                                     key=lambda x: -x[1][1])))
        for (phase, name), (n, ms) in sorted(split.items(),
                                             key=lambda x: -x[1][1]):
            yield f"    {phase} {name}: {ms:.4f} ms, {n:g} launches"
        if kw:
            facts_ms, _ = _events_ms(lambda: ops.gram_facts(G))
            yield (f"  gram_facts (once per refine call): {facts_ms:.4f} ms "
                   f"(events), {kw['gram']}")
        step, _ = _events_ms(lambda: ops.swap_topk_commit(w, m, c, G, k=K,
                                                          **kw))
        search, _ = _events_ms(lambda: ops.swap_topk(w, m, c, G, k=K))
        yield (f"  events: swap_topk_commit {step:.4f} ms, swap_topk alone "
               f"{search:.4f} ms, difference {step - search:.4f} ms")
        del w, m, c, G
        torch.cuda.empty_cache()


def profile_refine():
    """Yields the lines of ``--refine``."""
    import hashlib

    from repro_torch.core import masks, sparseswaps

    resolve_device("cuda")
    disable_tf32()
    R, d, seed = SHAPES[-1]
    w, m, _, G = problem(R, d, seed)
    yield (f"{torch.cuda.get_device_name(0)}: refine(k_swaps={K}, "
           f"commit_mode='candidates', t_max=4) at R={R} d={d}")
    for every in (0, 2, 0, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sparseswaps.refine(w, G, m, masks.PerRow(0.6), k_swaps=K,
                               commit_mode="candidates", t_max=4,
                               compact_every=every)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = hashlib.sha256()
        for t in (r.mask > 0.5, r.swaps, r.loss_final):
            h.update(t.contiguous().cpu().numpy().tobytes())
        yield (f"  compact_every={every}: {wall:.4f} s, passes {r.iters}, "
               f"swaps {int(r.swaps.sum())}; digest of masks, swaps, losses "
               f"{h.hexdigest()[:16]}")


def _events_ms(fn) -> tuple[float, float]:
    """ms per call of ``fn()`` over REPS calls after one: by CUDA events,
    and by the host's clock to the end of the last."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / REPS,
            1e3 * (time.perf_counter() - t0) / REPS)


def _kernels(dev: dict[str, float]) -> str:
    parts = [f"{n} {v:.3f}" for n, v in sorted(dev.items())]
    return ", ".join(parts) + f" (sum {sum(dev.values()):.3f})"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--commit", action="store_true",
                    help="time the candidate commit step after the search")
    ap.add_argument("--refine", action="store_true",
                    help="time the candidate refinement of w_down")
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    modes = [gen() for flag, gen in ((args.commit, profile_commit),
                                     (args.refine, profile_refine)) if flag]
    lines = itertools.chain(*modes) if modes else profile_swap(names)
    for line in lines:
        print(line, flush=True)


if __name__ == "__main__":
    main()
