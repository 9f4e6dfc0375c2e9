"""Where the device time of the bf16 spmm kernels goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_spmm \
        [--variants shipped,no_mma,...]

Builds ``csrc/spmm.cu`` as shipped and cut-down copies of it, then times
each kernel of each copy at the serving path's MLP shapes (w_gate 14336
x 4096, w_down 4096 x 14336; T = 4 and 128) by device time with a cold
L2: median [min-max] of 20 calls, as ``chip_smoke.py`` times spmm. nm24
runs on a 2:4 mask; gathered on a PerRow(0.6) mask and on the 2:4 mask
(the ``gathered_2:4`` engine's weights).

nm24's copies (``CUTS``) leave out, one at a time, the tensor-core MMAs
(``no_mma``: a cheap add keeps the fragments live), the A fragments'
build from (value, position) pairs (``no_build``: the staged values are
the fragments), and every 16-column step (``stream``: the ring of tiles
alone); the fourth (``mma_only``) keeps the steps' shared-memory reads
and MMAs but copies nothing, waits for nothing and builds nothing: the
multiply's own pace. The gathered kernel's copies (``GATHER_CUTS``):
``copies`` streams every slot through the rings (each row's cursor jumps
to what has landed) and x through its stages, with no scatter and no
MMA; ``no_scatter`` reads and checks the slots but writes none into the
A tiles; ``no_mma`` as nm24's; ``mma_only`` runs the MMAs with no
copies, scatter or waits. Their outputs are wrong by design and the
port never loads them; the shipped kernel is checked against the plain
version first. One more copy of the gathered kernel, ``phases``, adds
clock64 counters (``PHASES``); it is not timed, but prints, per shape on
PerRow(0.6), where the scatter warps and the multiplying (and copying)
warps spend their clocks. ``--variants shipped`` builds no copies, so
the script also runs on an older tree of the repository (copied into
it) to time that tree's kernels. ``--events`` also times each call by
CUDA events behind its flush, the fallback ``cold_device_ms`` takes
where the profiler loses records. Needs the card, nvcc and the CUDA toolkit; writes
only under ``build/repro_torch/``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

from repro_torch.core import masks, packed
from repro_torch.device import disable_tf32
from repro_torch.kernels import build
from repro_torch.kernels import spmm as spmm_mod

SHAPES = {"w_gate": (14336, 4096), "w_down": (4096, 14336)}
REPS = 20
FLUSH = "bitwise_not"        # the L2 flush's kernel, by name: no spmm,
                             # plain spmm or matmul launches one

# (variant, [(text in csrc/spmm.cu, its replacement)]); each text must
# occur in the source, so a change there fails here loudly
CUTS = {
    "no_mma": [("for (int n8 = 0; n8 < NTL; ++n8) mma16816(acc[mt][n8], "
                "a[mt], b[n8]);",
                "for (int n8 = 0; n8 < NTL; ++n8) acc[mt][n8][0] += "
                "__int_as_float(a[mt][0] ^ a[mt][3] ^ b[n8][0] ^ b[n8][1]);")],
    "no_build": [("a[mt][hf] = dense_pair(ld32(vr), p0, p1, o16);",
                  "a[mt][hf] = ld32(vr) ^ X;"),
                 ("a[mt][hf + 2] = dense_pair(ld32(vr + 8), q0, q1, o16);",
                  "a[mt][hf + 2] = ld32(vr + 8);")],
    "stream": [("const int jn = min(NM_BK, d_in - (kt0 + i) * NM_BK) / 16;",
                "const int jn = 0;")],
    "mma_only": [("if (warp == CW) {", "if (warp == CW) {\n    return;"),
                 ("mbar_wait(smem_addr(&full[s]), (i / S) & 1);", ""),
                 ("a[mt][hf] = dense_pair(ld32(vr), p0, p1, o16);",
                  "a[mt][hf] = ld32(vr) ^ X;"),
                 ("a[mt][hf + 2] = dense_pair(ld32(vr + 8), q0, q1, o16);",
                  "a[mt][hf + 2] = ld32(vr + 8);")],
}

# the gathered kernel's copies, in the same form
_G_MMA = "mma16816(acc[mt][n8], a[mt], bfr[n8]);"
_G_NO_MMA = ("acc[mt][n8][0] += "
             "__int_as_float(a[mt][0] ^ a[mt][3] ^ bfr[n8][0] ^ bfr[n8][1]);")
GATHER_CUTS = {
    "copies": [("        int c[G_RUN];\n",
                "        {\n          const int n = max(0, lim - cur);\n"
                "          cur += n;\n          pi = (pi + 4 * n) % Sm::IR;\n"
                "          pv = (pv + 2 * n) % Sm::VR;\n          break;\n"
                "        }\n        int c[G_RUN];\n"),
               (_G_MMA, _G_NO_MMA)],
    "no_scatter": [("*reinterpret_cast<uint16_t*>(\n                arow + "
                    "(((c[u] << 1) & 255) ^ rsw)) = v[u];", "(void)v[u];")],
    "no_mma": [(_G_MMA, _G_NO_MMA)],
    "mma_only": [("if (warp == G_SW + G_MW) {",
                  "if (warp == G_SW + G_MW) {\n    return;"),
                 ("const int kcut = min(k0 + NM_BK, d_in);   // the tile's "
                  "columns end", "const int kcut = min(k0 + NM_BK, d_in);\n"
                  "      break;"),
                 ("        mbar_wait(qb, served & 1);", "        break;"),
                 ("mbar_wait(smem_addr(&afull[b]), (j / G_NA) & 1);", ""),
                 ("mbar_wait(smem_addr(&full[s]), (j / S) & 1);\n      const "
                  "uint8_t* at", "const uint8_t* at")],
}

# clock64 counters of the gathered kernel's phases (variant ``phases``):
# per scatter warp, its waits for refills, for a free A tile, its walk (the
# slow path's waits inside it) and its handoffs; per multiplying warp, its
# waits for a handoff, the refills it issues, its waits for the A tile and
# for x, and its MMAs; summed over warps into g_dbg, which gather_phases()
# reads back
PHASES = {"phases": [
    ("namespace {\n\nconstexpr int NT = 256;",
     "namespace {\n__device__ unsigned long long g_dbg[16];\n\n"
     "constexpr int NT = 256;"),
    ("    bool fault = false;\n    const uint8_t* vr",
     "    bool fault = false;\n    unsigned long long tw = 0, tz = 0, tk = 0, "
     "ts = 0, th = 0;\n    long long t_a;\n"
     "    const long long t_b = clock64();\n    const uint8_t* vr"),
    ("      const int want = nref - G_D > 0 ? nref - G_D : 0;",
     "      t_a = clock64();\n"
     "      const int want = nref - G_D > 0 ? nref - G_D : 0;"),
    ("      lim = max(lim, glim[want % G_D][rl]);",
     "      lim = max(lim, glim[want % G_D][rl]);\n"
     "      tw += clock64() - t_a;\n      t_a = clock64();"),
    ("      if (j >= G_NA) mbar_wait(smem_addr(&aempty[b]), "
     "(j / G_NA - 1) & 1);",
     "      if (j >= G_NA) mbar_wait(smem_addr(&aempty[b]), "
     "(j / G_NA - 1) & 1);\n      tz += clock64() - t_a;"),
    ("#pragma unroll 1\n      for (;;) {\n        const uint8_t* ic",
     "      t_a = clock64();\n#pragma unroll 1\n      for (;;) {\n"
     "        const uint8_t* ic"),
    ("        if (waited + 1 >= nref)\n",
     "        const long long t_s = clock64();\n"
     "        if (waited + 1 >= nref)\n"),
    ("        lim = max(lim, glim[waited % G_D][rl]);\n      }",
     "        lim = max(lim, glim[waited % G_D][rl]);\n"
     "        ts += clock64() - t_s;\n      }\n"
     "      tk += clock64() - t_a;\n      t_a = clock64();"),
    ("      g_handoff(j + 1 < nt ? 0 : DONE, cur, nref, qb, kb, &gcur[rl],\n"
     "                &gkind[warp], hf, lane);",
     "      g_handoff(j + 1 < nt ? 0 : DONE, cur, nref, qb, kb, &gcur[rl],\n"
     "                &gkind[warp], hf, lane);\n      th += clock64() - t_a;"),
    ("    if (!hf) bad[rl] = fault || cur != hi;",
     "    if (!hf) bad[rl] = fault || cur != hi;\n    if (lane == 0) {\n"
     "      atomicAdd(&g_dbg[0], tw);\n      atomicAdd(&g_dbg[1], tz);\n"
     "      atomicAdd(&g_dbg[2], tk);\n      atomicAdd(&g_dbg[3], ts);\n"
     "      atomicAdd(&g_dbg[4], th);\n      atomicAdd(&g_dbg[5], 1ull);\n"
     "      atomicAdd(&g_dbg[6], (unsigned long long)(clock64() - t_b));\n"
     "    }"),
    ("    for (int j = -1; j < nt; ++j) {\n      for (;;) {\n"
     "        mbar_wait(qb, served & 1);",
     "    unsigned long long cs = 0, cq = 0, ca = 0, cx = 0, cm = 0;\n"
     "    long long c_a;\n    for (int j = -1; j < nt; ++j) {\n"
     "      for (;;) {\n        c_a = clock64();\n"
     "        mbar_wait(qb, served & 1);\n"
     "        cq += clock64() - c_a;\n        c_a = clock64();"),
    ("        if (lane == 0) mbar_arrive(kb);\n        ++served;",
     "        if (lane == 0) mbar_arrive(kb);\n"
     "        cs += clock64() - c_a;\n        ++served;"),
    ("      mbar_wait(smem_addr(&afull[b]), (j / G_NA) & 1);\n"
     "      mbar_wait(smem_addr(&full[s]), (j / S) & 1);",
     "      c_a = clock64();\n"
     "      mbar_wait(smem_addr(&afull[b]), (j / G_NA) & 1);\n"
     "      ca += clock64() - c_a;\n      c_a = clock64();\n"
     "      mbar_wait(smem_addr(&full[s]), (j / S) & 1);\n"
     "      cx += clock64() - c_a;\n      c_a = clock64();"),
    ("        mbar_arrive(smem_addr(&aempty[b]));\n"
     "        mbar_arrive(smem_addr(&empty[s]));\n      }\n    }\n  }",
     "        mbar_arrive(smem_addr(&aempty[b]));\n"
     "        mbar_arrive(smem_addr(&empty[s]));\n      }\n"
     "      cm += clock64() - c_a;\n    }\n    if (lane == 0) {\n"
     "      atomicAdd(&g_dbg[7], cq);\n      atomicAdd(&g_dbg[8], cs);\n"
     "      atomicAdd(&g_dbg[9], ca);\n      atomicAdd(&g_dbg[10], cx);\n"
     "      atomicAdd(&g_dbg[11], cm);\n    }\n  }"),
]}
PHASE_NAMES = (("refill wait", 0), ("tile wait", 1), ("walk", 2),
               ("  of it, slow path", 3), ("handoff", 4),
               ("copier: handoff wait", 7), ("copier: refills", 8),
               ("copier: A-tile wait", 9), ("copier: x wait", 10),
               ("copier: MMA", 11))
_PHASE_READ = """
extern "C" {
void gather_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_dbg, sizeof(unsigned long long) * 16);
}
void gather_phases_reset() {
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_dbg, z, sizeof(z));
}
}
"""


def _variant_libs(names) -> dict[str, ctypes.CDLL]:
    """The shipped library and the copies in ``names`` (keys of CUTS,
    ``nm24:``-prefixed, or of GATHER_CUTS and PHASES, ``gathered:``-
    prefixed), built in parallel."""
    src = (build.CSRC / "spmm.cu").read_text()
    out = build.BUILD_DIR / "profile_spmm"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        fmt, cut = name.split(":")
        text = src
        edits = CUTS if fmt == "nm24" else {**GATHER_CUTS, **PHASES}
        for old, new in edits[cut]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/spmm.cu "
                                   "once")
            text = text.replace(old, new)
        cu = out / f"spmm_{fmt}_{cut}.cu"
        cu.write_text(text + (_PHASE_READ if cut in PHASES else ""))
        cmd = [build.nvcc_path(), *build.nvcc_flags("spmm"), "-I",
               str(build.CSRC), "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {"shipped": build.load("spmm")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fmt, cut = name.split(":")
        libs[name] = ctypes.CDLL(str(out / f"spmm_{fmt}_{cut}.so"))
    for lib in libs.values():
        lib.spmm_run_stacked.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.spmm_run_stacked.restype = ctypes.c_int
        lib.spmm_workspace_stacked.argtypes = [ctypes.c_int] * 8
        lib.spmm_workspace_stacked.restype = ctypes.c_longlong
    return libs


def print_phases(lib, tag: str, T: int, x, pw, y, calls: int = 10) -> None:
    """Where a gathered call's warps spend their clocks: kilo-cycles per
    warp and call, summed over ``calls`` warm calls."""
    run = _runner(lib, x, pw, y)
    run()
    torch.cuda.synchronize()
    lib.gather_phases_reset()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    d = (ctypes.c_ulonglong * 16)()
    lib.gather_phases(d)
    n = max(d[5], 1)                   # scatter warps x calls
    print(f"{tag} T={T} gathered K={pw.k} phases, k-cycles a warp and call: "
          f"scatter warp {d[6] / n / 1e3:.1f} = " + ", ".join(
              f"{name} {d[i] / n / 1e3:.1f}" for name, i in PHASE_NAMES),
          flush=True)


def _runner(lib, x: torch.Tensor, pw, y: torch.Tensor):
    T, d_in = x.shape
    d_out, k = pw.values.shape
    kind = 0 if pw.fmt == "nm24" else 1
    n, m = (2, 4) if kind == 0 else (0, 0)
    n_ws = lib.spmm_workspace_stacked(1, T, d_in, d_out, n, m, kind, 1)
    ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        err = lib.spmm_run_stacked(x.data_ptr(), pw.values.data_ptr(),
                                   pw.idx.data_ptr(), None, y.data_ptr(),
                                   ws.data_ptr() if n_ws else None, 1, T,
                                   d_in, d_out, k, n, m, 0, kind, 1, stream)
        if err:
            raise RuntimeError(f"spmm launch failed: CUDA error {err}")
    return run


def profiler_preroll(n: int = 16) -> None:
    """Inside a torch.profiler trace, before the launches it measures:
    ``n`` small fill kernels, then a synchronize. Late in a long process
    the profiler drops the first few kernel records of a trace (1-3 seen
    on an H100), and these are the ones it drops."""
    pad = torch.empty(256, device="cuda")
    for _ in range(n):
        pad.zero_()
    torch.cuda.synchronize()


def cold_device_ms(fn, reps: int = REPS,
                   tries: int = 5) -> tuple[float, float, float]:
    """Device time of ``fn()`` in ms with a cold L2, as (median, min, max)
    over ``reps`` calls: a 128 MB buffer is rewritten before each call
    (the serving loop meets each weight after ~300 MB of others), and
    torch.profiler sums the device time of every kernel the call launched
    (for spmm the product kernel and its split reduction) — the flush's
    kernel excluded by name, the host's work between launches never
    counted. A trace that lost kernel records (fewer flushes than calls)
    is measured again, up to ``tries`` times; past that the calls are
    timed by CUDA events (``events_cold_ms``) and a line on stderr says
    so. ``chip_smoke.py`` times spmm and the Gram with it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(128 * 2**20 // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    calls: list[float] = []
    seen = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()          # before the first flush: not counted
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        calls, seen = [], 0
        for e in sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            seen += 1
            if FLUSH in e.name:
                calls.append(0.0)
            elif calls:
                calls[-1] += e.time_range.elapsed_us() / 1e3
        if len(calls) == reps and all(c > 0 for c in calls):
            return statistics.median(calls), min(calls), max(calls)
    print(f"cold_device_ms: the profiler saw {len(calls)} of {reps} flushed "
          f"calls ({seen} device records in its last trace, {tries} tries);"
          f" timed by CUDA events instead", file=sys.stderr, flush=True)
    calls = events_cold_ms(fn, reps, flush)
    return statistics.median(calls), min(calls), max(calls)


def events_cold_ms(fn, reps: int, flush: torch.Tensor) -> list[float]:
    """Each of ``reps`` calls of ``fn()`` in ms, by a pair of CUDA events
    around it, with ``flush`` rewritten before each: the device's time
    from the flush's end to the call's last kernel. The host queues the
    call while the flush runs (it moves 256 MB), so a call whose
    launches take less host time than that is timed as device work; a
    longer one counts the device's wait for the host too."""
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        flush.bitwise_not_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="all",
                    help="comma list of shipped, cut names and phases, or "
                         "all")
    ap.add_argument("--events", action="store_true",
                    help="also time each call by CUDA events, as "
                         "cold_device_ms does where the profiler loses "
                         "records")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_spmm: needs a CUDA device")
    disable_tf32()
    cuts = {"nm24": CUTS, "gathered": {**GATHER_CUTS, **PHASES}}
    want = None if args.variants == "all" else set(args.variants.split(","))
    names = [f"{fmt}:{cut}" for fmt in cuts for cut in cuts[fmt]
             if want is None or cut in want]
    libs = _variant_libs(names)
    phase_lib = libs.pop("gathered:phases", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tag, (d_out, d_in) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(d_out + d_in)
        w = (torch.randn(d_out, d_in, generator=gen, device="cuda")
             * d_in ** -0.5).to(torch.bfloat16)
        scores = torch.rand(d_out, d_in, generator=gen, device="cuda")
        m24 = masks.make_mask(scores, masks.NM(2, 4))
        m60 = masks.make_mask(scores, masks.PerRow(0.6))
        weights = [("nm24", "2:4", packed.pack(w, m24, "nm24")),
                   ("gathered", "0.6", packed.pack(w, m60, "gathered")),
                   ("gathered", "2:4", packed.pack(w, m24, "gathered"))]
        del scores
        for T in (4, 128):
            x = torch.randn(T, d_in, generator=gen, device="cuda").to(
                torch.bfloat16)
            y = torch.empty(T, d_out, dtype=torch.bfloat16, device="cuda")
            for fmt, mask_tag, pw in weights:
                _runner(libs["shipped"], x, pw, y)()
                want_y = spmm_mod.spmm_plain(x, pw).float()
                tol = torch.maximum(   # one bf16 ulp, or 1e-5 of max|y|
                    torch.exp2(torch.floor(torch.log2(
                        want_y.abs().clamp_min(1e-30))) - 7),
                    1e-5 * want_y.abs().max())
                if not bool(((y.float() - want_y).abs() <= tol).all()):
                    raise RuntimeError(f"{tag} T={T} {fmt} {mask_tag}: the "
                                       "shipped kernel is off")
                runs = [("shipped", libs["shipped"])] + [
                    (name.split(":")[1], lib) for name, lib in libs.items()
                    if name.startswith(fmt + ":")]
                if want is not None and "shipped" not in want:
                    runs = runs[1:]
                for name, lib in runs:
                    med, lo, hi = cold_device_ms(_runner(lib, x, pw, y))
                    ev = (cold_device_ms(_runner(lib, x, pw, y), tries=0)
                          if args.events else None)
                    print(f"{tag} ({d_out}x{d_in}) T={T} {fmt} {mask_tag} "
                          f"K={pw.k} {name:10s} {med:.4f} [{lo:.4f}-{hi:.4f}] "
                          "ms" + ("" if ev is None else
                                  f", CUDA events {ev[0]:.4f} "
                                  f"[{ev[1]:.4f}-{ev[2]:.4f}] ms"),
                          flush=True)
                if phase_lib is not None and fmt == "gathered" \
                        and mask_tag == "0.6":
                    print_phases(phase_lib, tag, T, x, pw, y)


if __name__ == "__main__":
    main()
