"""Serving launcher: batched prefill + decode on dense or packed weights,
on the card by default; continuous-batching load sweeps and chaos runs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \
        --tiny --batch 4 --prompt-len 32 --gen 16 --device cpu

Sparse serving loads a pruning run's masks and packs them once at
startup (``repro_torch.serve.ServeEngine``):

    python -m repro_torch.launch.prune --arch llama31-8b --tiny \
        --sparsity 2:4 --out-dir out --device cpu
    python -m repro_torch.launch.serve --arch llama31-8b --tiny \
        --masks-from out --format nm24 --device cpu

``--masks-from`` takes a masks-tree checkpoint or a launcher ``--out-dir``
root, written by this package or by the reference's. ``--format`` picks
the weight representation (dense / masked / nm24 / gathered). ``--bench``
times dense vs masked vs packed and prints one prefill and one decode row
per format (with the kernel each phase launched and the resident weight
bytes); it writes them as JSON only to ``--bench-out``. ``--sample
TEMP[,TOP_P[,TOP_K]]`` samples instead of greedy decoding.

``--load-bench`` drives the continuous scheduler against the fixed-batch
path under Poisson traffic (``serve.loadgen``; ``--load-rates``,
``--load-duration``, ``--load-prompt-len``, ``--load-output-len``,
``--load-deadline``, ``--load-queue-ttl``, ``--load-shed``,
``--load-max-queue``; ``--disaggregate`` adds the disaggregated mode,
``--prefill-chunk`` its window) and prints one row per (format, mode,
rate); it merges them into ``--bench-out`` only. ``--chaos`` replays one
workload fault-free and then under ``FaultPlan.chaos(--chaos-seed)`` and
exits non-zero on leaked pages or token streams that differ:

    python -m repro_torch.launch.serve --arch llama31-8b --tiny \
        --device cpu --load-bench --load-rates 16,128 --bench-out b.json
    python -m repro_torch.launch.serve --arch llama31-8b --tiny \
        --device cpu --chaos --chaos-seed 0

It runs on ``--device cuda`` unless asked for the CPU, and raises when
the card is missing; TF32 is off. ``--mesh`` and the reference's
``--kernel`` have no counterpart: the device decides what runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch import configs, models
from repro_torch.core import packed as packed_lib
from repro_torch.data import synthetic
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.serve import FaultPlan, ServeEngine, bench_rows, loadgen
from repro_torch.serve.sampling import GREEDY, parse_sample_flag


def serve(arch: str, *, tiny: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, masks=None,
          masks_from: str | None = None, fmt: str | None = None,
          seed: int = 0, bench: bool = False,
          bench_out: Path | None = None, device="cuda", sample=None,
          load_bench: bool = False, load_rates=(16.0, 128.0),
          load_duration: float = 2.0, load_seed: int = 0,
          load_prompt_len=(8, 24), load_output_len=(4, 16),
          load_deadline: float | None = None,
          load_queue_ttl: float | None = None, load_shed: bool = False,
          load_max_queue: int | None = None, disaggregate: bool = False,
          prefill_chunk: int | None = None, chaos: bool = False,
          chaos_seed: int = 0, verbose: bool = True) -> dict:
    """Serve a batch of prompts; returns tokens + timing (+ bench rows).

    ``masks``/``masks_from`` feed the sparse formats. ``fmt=None`` picks
    "masked" when a mask source is given, "dense" otherwise. ``sample``
    is a ``SamplingParams`` (greedy when None).

    ``load_bench`` runs the continuous-vs-fixed load sweep over
    ``load_rates`` arrivals/s (``serve.loadgen``), with the disaggregated
    mode added when ``disaggregate`` (``prefill_chunk`` its window);
    ``load_deadline`` / ``load_queue_ttl`` bound each request's lifetime
    and queue wait on the simulated clock, ``load_shed`` sheds instead of
    raising on a full queue of ``load_max_queue``. The rows merge into
    ``bench_out`` when given. ``chaos`` runs ``loadgen.run_chaos`` with
    ``FaultPlan.chaos(chaos_seed)`` and exits non-zero when a fault path
    leaks pages or changes a completed token stream.
    """
    dev = resolve_device(device)
    disable_tf32()
    cfg = configs.get_tiny(arch) if tiny else configs.get(arch)
    api = models.build(cfg)
    params = api.init(seed=seed, device=dev)
    corpus = synthetic.CorpusConfig(cfg.vocab_size, seed=seed)
    pipe = synthetic.DataPipeline(corpus, batch, prompt_len, split="val",
                                  device=dev)
    prompt = pipe.get(0)
    mask_src = masks_from if masks_from is not None else masks
    if fmt is None:
        fmt = "masked" if mask_src is not None else "dense"
    if isinstance(mask_src, (str, Path)):       # resolve the directory once
        mask_src = packed_lib.load_mask_tree(cfg, params, mask_src)

    engine = ServeEngine(api, params, masks=mask_src, fmt=fmt, device=dev)
    res = engine.generate(prompt, gen, sampling=sample)
    out = {"tokens": res.tokens, "wall_s": res.prefill_s + res.decode_s,
           "tok_s": res.tok_s, "weight_bytes": engine.weight_bytes(),
           "format": fmt, "kernel_used": dict(engine.kernel_used)}
    if verbose:
        print(f"{arch}: served {res.batch} requests, {gen} new tokens each in "
              f"{out['wall_s']:.2f}s ({res.tok_s:.1f} decode tok/s, "
              f"format={fmt}, {out['weight_bytes'] / 2**20:.1f} MiB weights, "
              f"kernels {engine.kernel_used})")
        print("sample output ids:", res.tokens[0][:12].tolist())

    if bench:
        formats = ["dense"]
        if mask_src is not None:
            masks_tree = getattr(mask_src, "masks", mask_src)
            formats += [f for f in ("masked", "nm24", "gathered")
                        if f == "masked"
                        or packed_lib.representable(cfg, masks_tree, f)]
        rows = bench_rows(api, params, mask_src, prompt, gen,
                          formats=formats, device=dev)
        out["bench"] = rows
        if verbose:
            for r in rows:
                extra = (f"prefill {r['prefill_s'] * 1e3:7.2f} ms"
                         if r["phase"] == "prefill" else
                         f"cold {r['cold_tok_s']:8.1f} tok/s")
                print(f"  {r['variant']:8s} {r['phase']:7s} "
                      f"{r['tok_s']:9.1f} tok/s  {extra}  "
                      f"[{r['kernel_used']}]  "
                      f"{r['weight_bytes'] / 2**20:8.2f} MiB")
        if bench_out is not None:
            doc = {"arch": arch, "batch": batch, "prompt_len": prompt_len,
                   "gen": gen, "device": _device_name(dev), "rows": rows}
            Path(bench_out).write_text(json.dumps(doc, indent=1))
            if verbose:
                print(f"wrote {bench_out}")

    if load_bench:
        formats = ["dense"]
        if mask_src is not None:
            masks_tree = getattr(mask_src, "masks", mask_src)
            formats = [f for f in ("masked", "nm24", "gathered")
                       if f == "masked"
                       or packed_lib.representable(cfg, masks_tree, f)]
        load_cfg = loadgen.LoadConfig(
            duration_s=load_duration, seed=load_seed,
            prompt_len=tuple(load_prompt_len),
            output_len=tuple(load_output_len),
            sampling=sample if sample is not None else GREEDY,
            deadline_s=load_deadline, queue_ttl_s=load_queue_ttl)
        modes = ("continuous", "fixed")
        if disaggregate:
            modes += ("disaggregated",)
        sched_kw = {}
        if load_shed:
            sched_kw["admission"] = "shed"
        if load_max_queue is not None:
            sched_kw["max_queue"] = load_max_queue
        load_rows = loadgen.bench_load_rows(
            api, params, mask_src, formats=formats, rates=tuple(load_rates),
            load=load_cfg, device=dev, max_batch=batch, modes=modes,
            prefill_chunk=prefill_chunk, **sched_kw)
        out["load_bench"] = load_rows
        if verbose:
            for r in load_rows:
                if "error" in r:
                    print(f"  {r['variant']:8s} {r['mode']:13s} rate "
                          f"{r['arrival_rate']:5.1f}/s  ERROR {r['error']}")
                    continue
                print(f"  {r['variant']:8s} {r['mode']:13s} "
                      f"rate {r['arrival_rate']:5.1f}/s  goodput "
                      f"{r['goodput_tok_s']:8.1f} tok/s  p99 TTFT "
                      f"{r['p99_ttft_s'] * 1e3:7.1f} ms (wait "
                      f"{r['p99_queue_wait_s'] * 1e3:7.1f} + prefill "
                      f"{r['p99_prefill_s'] * 1e3:6.1f})  waste "
                      f"{r['wasted_decode_tokens']:5d}  "
                      f"[{r['kernel_used']}]")
        if bench_out is not None:
            path = Path(bench_out)
            doc = json.loads(path.read_text()) if path.exists() else {
                "arch": arch, "batch": batch, "prompt_len": prompt_len,
                "gen": gen, "device": _device_name(dev), "rows": []}
            loadgen.merge_load_rows(doc, load_rows)
            path.write_text(json.dumps(doc, indent=1))
            if verbose:
                print(f"wrote {path}")

    if chaos:
        chaos_cfg = loadgen.LoadConfig(
            arrival_rate=float(load_rates[0]), duration_s=load_duration,
            seed=load_seed, prompt_len=tuple(load_prompt_len),
            output_len=tuple(load_output_len),
            sampling=sample if sample is not None else GREEDY)
        workload = loadgen.make_workload(
            dataclasses.replace(chaos_cfg, vocab_size=cfg.vocab_size))
        verdict = loadgen.run_chaos(engine, workload,
                                    FaultPlan.chaos(chaos_seed),
                                    max_batch=batch)
        out["chaos"] = verdict
        if verbose:
            print(f"chaos [{verdict['plan']}]: "
                  f"{verdict['completed_faulted']}/{verdict['n_requests']} "
                  f"completed, leaked {verdict['leaked_bytes']} B, "
                  f"{verdict['stream_mismatches']} stream mismatches, "
                  f"fired {verdict['faults_fired']}, "
                  f"counters {verdict['counters']}")
            print("chaos verdict:", "OK" if verdict["ok"] else "FAILED")
        if not verdict["ok"]:
            raise SystemExit(1)
    return out


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--masks-from", default=None,
                    help="pruning artifact dir: masks-tree checkpoint or "
                         "--out-dir root")
    ap.add_argument("--format", default=None,
                    choices=["dense", "masked", "nm24", "gathered"],
                    help="weight representation (default: masked when "
                         "--masks-from is given, dense otherwise)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench", action="store_true",
                    help="time dense vs masked vs packed, per phase")
    ap.add_argument("--bench-out", default=None,
                    help="write the --bench rows here as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--sample", default=None, metavar="TEMP[,TOP_P[,TOP_K]]",
                    help="sample instead of greedy decode, e.g. "
                         "'0.8,0.95,40' (temperature, nucleus mass, top-k)")
    ap.add_argument("--load-bench", action="store_true",
                    help="run the continuous-vs-fixed load sweep; its rows "
                         "merge into --bench-out when given")
    ap.add_argument("--load-rates", default="16,128",
                    help="comma-separated arrival rates (requests/s)")
    ap.add_argument("--load-duration", type=float, default=2.0,
                    help="simulated arrival window in seconds")
    ap.add_argument("--load-seed", type=int, default=0)
    ap.add_argument("--load-prompt-len", default="8:24", metavar="MIN:MAX",
                    help="uniform prompt-length bounds for the workload")
    ap.add_argument("--load-output-len", default="4:16", metavar="MIN:MAX",
                    help="uniform output-length bounds for the workload")
    ap.add_argument("--load-deadline", type=float, default=None,
                    help="per-request total-lifetime deadline (simulated "
                         "seconds); expiries are counted, not served late")
    ap.add_argument("--load-queue-ttl", type=float, default=None,
                    help="per-request queue-wait bound (simulated seconds)")
    ap.add_argument("--load-shed", action="store_true",
                    help="shed (typed Rejected) instead of raising when "
                         "the admission queue is full")
    ap.add_argument("--load-max-queue", type=int, default=None,
                    help="admission queue cap for the load sweep")
    ap.add_argument("--disaggregate", action="store_true",
                    help="add the disaggregated prefill/decode mode to "
                         "the load sweep (separate pools, page shipping)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill window width (power of two) for "
                         "the disaggregated mode")
    ap.add_argument("--chaos", action="store_true",
                    help="run the deterministic fault-injection harness "
                         "(fault-free vs faulted pass) and exit non-zero "
                         "on leaked pages or stream mismatches")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for FaultPlan.chaos")
    args = ap.parse_args(argv)
    span = lambda s: tuple(int(x) for x in s.split(":", 1))
    serve(args.arch, tiny=args.tiny, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen,
          masks_from=args.masks_from, fmt=args.format, seed=args.seed,
          bench=args.bench,
          bench_out=Path(args.bench_out) if args.bench_out else None,
          device=args.device,
          sample=parse_sample_flag(args.sample) if args.sample else None,
          load_bench=args.load_bench,
          load_rates=tuple(float(r) for r in args.load_rates.split(",")),
          load_duration=args.load_duration, load_seed=args.load_seed,
          load_prompt_len=span(args.load_prompt_len),
          load_output_len=span(args.load_output_len),
          load_deadline=args.load_deadline,
          load_queue_ttl=args.load_queue_ttl, load_shed=args.load_shed,
          load_max_queue=args.load_max_queue,
          disaggregate=args.disaggregate, prefill_chunk=args.prefill_chunk,
          chaos=args.chaos, chaos_seed=args.chaos_seed)


if __name__ == "__main__":
    main()
