"""Serving timings on the card: the fixed path's decode step, and a sweep
of the continuous path under load.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --decode
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --load-rates 4,8,16,32 --load-requests 60 --formats nm24 \
        [--modes continuous,fixed]

Both build llama31-8b at full width, 2 layers, bf16, params from seed 0,
with Wanda PerRow(0.6) and 2:4 masks (``prune_model(method="none")`` on
16 calibration samples of 128 tokens), as ``chip_smoke.py`` phase 6.
TF32 is off.

``--decode`` times phase 6's ``generate`` (batch 4 x prompt 32, 16 new
tokens) for dense, masked, nm24 and gathered: prefill ms and decode ms a
step, each the best of ``--reps`` warm calls, as phase 6 prints them;
a digest of each format's tokens and greedy logits (``logits_trace``),
to compare two trees bit for bit; then one more call of each under
torch.profiler: the device kernels a decode step launches and their
device time. It needs nothing of the
continuous path, so it also runs in an older tree of the repository
(copied into it): run it there and here in turns to compare two trees in
one call.

``--load-rates`` runs ``serve.loadgen.bench_load_rows`` at each rate
over a window of ``--load-requests / rate`` simulated seconds, with the
traffic of ``chip_smoke.py`` phase 6c (f) (``LOAD_PROMPT``,
``LOAD_OUTPUT``, greedy; the scheduler as ``CONT``), one pass after a
short warm-up run, and prints each row with its wall time: where the
continuous path saturates (its goodput stops following the rate and
requests queue for a slot).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import subprocess
import time

import torch

from repro_torch import configs, models, pruning
from repro_torch.core import masks as masks_lib
from repro_torch.device import disable_tf32

ARCH = "llama31-8b"
N_LAYERS = 2
BATCH, PROMPT, GEN = 4, 32, 16         # phase 6's generate
# phase 6c's scheduler and load traffic (chip_smoke.py imports these)
CONT = dict(max_batch=8, capacity=1024, page_size=16, decode_chunk=8)
LOAD_PROMPT, LOAD_OUTPUT = (32, 512), (16, 128)


def build(dev):
    """(api, params, PerRow(0.6) masks, 2:4 masks, phase 6's prompt)."""
    from repro_torch.data import synthetic

    cfg = configs.get(ARCH).replace(n_layers=N_LAYERS)
    api = models.build(cfg)
    params = api.init(seed=0, device=dev)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=0, device=dev))
    m60, m24 = (pruning.prune_model(api, params, batches, pat,
                                    warmstart="wanda", method="none").masks
                for pat in (masks_lib.PerRow(0.6), masks_lib.NM(2, 4)))
    pipe = synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size),
                                  BATCH, PROMPT, split="val", device=dev)
    return api, params, m60, m24, pipe.get(0)


def decode_report(api, params, m60, m24, prompt, reps: int) -> None:
    """Phase 6's prefill ms and decode ms a step per format, best of
    ``reps`` warm calls; then the kernels of one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    specs = {"dense": (None, "dense"), "masked": (m60, "masked"),
             "nm24": (m24, "nm24"), "gathered": (m60, "gathered")}
    engines = {n: ServeEngine(api, params, masks=m, fmt=f)
               for n, (m, f) in specs.items()}
    runs = {n: [] for n in engines}
    for n, eng in engines.items():
        eng.generate(prompt, GEN)                      # warm
    for _ in range(reps):
        for n, eng in engines.items():
            runs[n].append(eng.generate(prompt, GEN))
    for n, eng in engines.items():
        pre = min(r.prefill_s for r in runs[n])
        steps = [1e3 * r.decode_s / (GEN - 1) for r in runs[n]]
        print(f"{n:9s} prefill {1e3 * pre:8.3f} ms  decode "
              f"{min(steps):7.3f} ms/step (best of {reps}; median "
              f"{sorted(steps)[len(steps) // 2]:.3f})", flush=True)
    for n, eng in engines.items():
        h = hashlib.sha256()
        for t in (runs[n][-1].tokens, eng.logits_trace(prompt, GEN)):
            h.update(t.contiguous().cpu().numpy().tobytes())
        print(f"{n:9s} digest of tokens and logits {h.hexdigest()[:16]}",
              flush=True)
    for n, eng in engines.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(prompt, GEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        print(f"{n:9s} profiled generate: {len(kern)} device kernels "
              f"({len(kern) / GEN:.1f} a token), device {busy:.3f} ms of "
              f"{1e3 * wall:.3f} ms wall", flush=True)


def load_sweep(api, params, m60, m24, rates, n_req: int, formats,
               modes) -> None:
    """``bench_load_rows`` per format and rate, ~``n_req`` requests each."""
    from repro_torch.serve import loadgen

    src = {"masked": m60, "gathered": m60, "nm24": m24, "dense": None}
    base = loadgen.LoadConfig(prompt_len=LOAD_PROMPT, output_len=LOAD_OUTPUT)
    # warm-up: every prefill bucket and decode shape of the traffic once
    for fmt in formats:
        loadgen.bench_load_rows(
            api, params, src[fmt], formats=(fmt,), rates=(64.0,),
            load=dataclasses.replace(base, duration_s=0.25), modes=modes,
            warmup=False, **CONT)
    for fmt in formats:
        for rate in rates:
            t0 = time.perf_counter()
            rows = loadgen.bench_load_rows(
                api, params, src[fmt], formats=(fmt,), rates=(rate,),
                load=dataclasses.replace(base, duration_s=n_req / rate),
                modes=modes, warmup=False, **CONT)
            for r in rows:
                if "error" in r:
                    raise RuntimeError(r["error"])
                over = r["makespan_s"] * rate / max(r["n_requests"], 1)
                print(f"{fmt:8s} {r['mode']:10s} rate {rate:6.1f}/s: "
                      f"{r['completed']}/{r['n_requests']} done, makespan "
                      f"{r['makespan_s']:.3f} s ({over:.2f}x the window), "
                      f"goodput "
                      f"{r['goodput_tok_s']:.1f} tok/s, TTFT p50 "
                      f"{1e3 * r['p50_ttft_s']:.1f} p99 "
                      f"{1e3 * r['p99_ttft_s']:.1f} ms, queue wait p99 "
                      f"{1e3 * r['p99_queue_wait_s']:.1f} ms, per-token "
                      f"p50 {1e3 * r['p50_tok_latency_s']:.2f} p99 "
                      f"{1e3 * r['p99_tok_latency_s']:.2f} ms", flush=True)
            print(f"{fmt:8s} rate {rate:6.1f}/s: {time.perf_counter() - t0:.2f}"
                  f" s wall", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--decode", action="store_true",
                    help="time phase 6's generate per format")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--load-rates", default=None,
                    help="comma-separated arrival rates (requests/s)")
    ap.add_argument("--load-requests", type=int, default=60,
                    help="requests per rate (the window is this / rate)")
    ap.add_argument("--formats", default="masked,nm24,gathered")
    ap.add_argument("--modes", default="continuous")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    disable_tf32()
    dev = torch.device("cuda")
    world = build(dev)
    if args.decode:
        decode_report(*world, reps=args.reps)
    if args.load_rates:
        load_sweep(*world[:4], [float(r) for r in args.load_rates.split(",")],
                   args.load_requests, args.formats.split(","),
                   tuple(args.modes.split(",")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
