"""Where the device time of the nm24 spmm kernel goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_spmm

Builds ``csrc/spmm.cu`` as shipped and four cut-down copies of it, then
times the nm24 bf16 kernel of each at the serving path's MLP shapes
(w_gate 14336 x 4096, w_down 4096 x 14336; T = 4 and 128) by device time
with a cold L2: median [min-max] of 20 calls, as ``chip_smoke.py`` times
spmm. The copies leave out, one at a time, the tensor-core MMAs
(``no_mma``: a cheap add keeps the fragments live), the A fragments'
build from (value, position) pairs (``no_build``: the staged values are
the fragments), and every 16-column step (``stream``: the ring of tiles
alone); the fourth (``mma_only``) keeps the steps' shared-memory reads
and MMAs but copies nothing, waits for nothing and builds nothing: the
multiply's own pace. Their outputs are wrong by design and the port
never loads them; the shipped kernel is checked against the plain
version first. Needs the card, nvcc and the CUDA toolkit; writes only
under ``build/repro_torch/``.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess

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


def _variant_libs() -> dict[str, ctypes.CDLL]:
    """The shipped library and the cut-down copies, built in parallel."""
    src = (build.CSRC / "spmm.cu").read_text()
    out = build.BUILD_DIR / "profile_spmm"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/spmm.cu")
            text = text.replace(old, new)
        cu = out / f"spmm_{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.nvcc_flags("spmm"), "-I",
               str(build.CSRC), "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {"shipped": build.load("spmm")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"spmm_{name}.so"))
    for lib in libs.values():
        lib.spmm_run.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        lib.spmm_run.restype = ctypes.c_int
        lib.spmm_workspace.argtypes = [ctypes.c_int] * 7
        lib.spmm_workspace.restype = ctypes.c_longlong
    return libs


def _runner(lib, x: torch.Tensor, pw, y: torch.Tensor):
    T, d_in = x.shape
    d_out, k = pw.values.shape
    n_ws = lib.spmm_workspace(T, d_in, d_out, 2, 4, 0, 1)
    ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        err = lib.spmm_run(x.data_ptr(), pw.values.data_ptr(),
                           pw.idx.data_ptr(), None, y.data_ptr(),
                           ws.data_ptr() if n_ws else None, T, d_in, d_out,
                           k, 2, 4, 0, 0, 1, stream)
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
                   tries: int = 3) -> tuple[float, float, float]:
    """Device time of ``fn()`` in ms with a cold L2, as (median, min, max)
    over ``reps`` calls: a 128 MB buffer is rewritten before each call
    (the serving loop meets each weight after ~300 MB of others), and
    torch.profiler sums the device time of every kernel the call launched
    (for spmm the product kernel and its split reduction) — the flush's
    kernel excluded by name, the host's work between launches never
    counted. A trace that lost kernel records (fewer flushes than calls)
    is measured again, up to ``tries`` times. ``chip_smoke.py`` times
    spmm and the Gram with it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(128 * 2**20 // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_preroll()          # before the first flush: not counted
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        calls: list[float] = []
        for e in sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            if FLUSH in e.name:
                calls.append(0.0)
            elif calls:
                calls[-1] += e.time_range.elapsed_us() / 1e3
        if len(calls) == reps and all(c > 0 for c in calls):
            return statistics.median(calls), min(calls), max(calls)
    raise RuntimeError(f"the profiler saw {len(calls)} flushed calls, want "
                       f"{reps}, each with a kernel ({tries} tries)")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_spmm: needs a CUDA device")
    disable_tf32()
    libs = _variant_libs()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tag, (d_out, d_in) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(d_out + d_in)
        w = (torch.randn(d_out, d_in, generator=gen, device="cuda")
             * d_in ** -0.5).to(torch.bfloat16)
        mask = masks.make_mask(torch.rand(d_out, d_in, generator=gen,
                                          device="cuda"), masks.NM(2, 4))
        pw = packed.pack(w, mask, "nm24")
        for T in (4, 128):
            x = torch.randn(T, d_in, generator=gen, device="cuda").to(
                torch.bfloat16)
            y = torch.empty(T, d_out, dtype=torch.bfloat16, device="cuda")
            _runner(libs["shipped"], x, pw, y)()
            want = spmm_mod.spmm_plain(x, pw).float()
            tol = torch.maximum(   # one bf16 ulp, or 1e-5 of max|y|
                torch.exp2(torch.floor(torch.log2(
                    want.abs().clamp_min(1e-30))) - 7),
                1e-5 * want.abs().max())
            if not bool(((y.float() - want).abs() <= tol).all()):
                raise RuntimeError(f"{tag} T={T}: the shipped kernel is off")
            for name, lib in libs.items():
                med, lo, hi = cold_device_ms(_runner(lib, x, pw, y))
                print(f"{tag} ({d_out}x{d_in}) T={T} nm24 {name:8s} "
                      f"{med:.4f} [{lo:.4f}-{hi:.4f}] ms", flush=True)


if __name__ == "__main__":
    main()
