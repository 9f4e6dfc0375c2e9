"""Serving launcher: batched prefill + greedy decode on dense or packed
weights, on the card by default.

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
bytes); it writes them as JSON only to ``--bench-out``. It runs on
``--device cuda`` unless asked for the CPU, and raises when the card is
missing; TF32 is off.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch import configs, models
from repro_torch.core import packed as packed_lib
from repro_torch.data import synthetic
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.serve import ServeEngine, bench_rows


def serve(arch: str, *, tiny: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, masks=None,
          masks_from: str | None = None, fmt: str | None = None,
          seed: int = 0, bench: bool = False,
          bench_out: Path | None = None, device="cuda",
          verbose: bool = True) -> dict:
    """Serve a batch of prompts; returns tokens + timing (+ bench rows).

    ``masks``/``masks_from`` feed the sparse formats. ``fmt=None`` picks
    "masked" when a mask source is given, "dense" otherwise.
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
    res = engine.generate(prompt, gen)
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
    args = ap.parse_args(argv)
    serve(args.arch, tiny=args.tiny, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen,
          masks_from=args.masks_from, fmt=args.format, seed=args.seed,
          bench=args.bench,
          bench_out=Path(args.bench_out) if args.bench_out else None,
          device=args.device)


if __name__ == "__main__":
    main()
