"""Pruning launcher: the paper's pipeline as a job, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.prune --arch llama31-8b \
        --tiny --sparsity 0.6 --method sparseswaps --t-max 50 --device cpu

Initialises the model from ``--seed``, calibrates on the synthetic corpus,
prunes every prunable linear with one global rule, and prints the
per-site error reductions and the dense vs pruned perplexity. It runs on
``--device cuda`` unless asked for the CPU, and raises when the card is
missing. TF32 is turned off for matmuls and cuDNN, so fp32 products run
in full fp32.

``--out-dir D`` writes ``D/masks`` (a step-0 masks-tree checkpoint in the
reference's format) and ``D/report.json``, so that

    python -m repro_torch.launch.serve --masks-from D --format nm24 ...

serves the pruned model, as the reference's launchers do.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import ckpt, configs, models, pruning
from repro_torch.core import masks as masks_lib
from repro_torch.device import disable_tf32, resolve_device


def prune(arch: str, *, tiny: bool = False, pattern="0.6",
          warmstart: str = "wanda", method: str = "sparseswaps",
          t_max: int = 50, k_swaps: int | None = None, n_calib: int = 16,
          calib_seq: int = 128, calib_batch: int = 4, seed: int = 0,
          out_dir: str | None = None, device="cuda",
          verbose: bool = True) -> dict:
    dev = resolve_device(device)
    disable_tf32()
    cfg = configs.get_tiny(arch) if tiny else configs.get(arch)
    api = models.build(cfg)
    params = api.init(seed=seed, device=dev)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=n_calib, seq_len=calib_seq, batch_size=calib_batch,
        seed=seed, device=dev))
    report = pruning.prune_model(
        api, params, batches, masks_lib.parse_pattern(pattern),
        method=method, warmstart=warmstart, t_max=t_max, k_swaps=k_swaps,
        progress=verbose)
    dense_eval = pruning.evaluate(api, params, seed=seed, device=dev)
    sparse_eval = pruning.evaluate(api, params, masks=report.masks,
                                   seed=seed, device=dev)
    if verbose:
        print(report.summary())
        print(f"dense : ppl {dense_eval['perplexity']:.2f}  "
              f"acc {100*dense_eval['accuracy']:.2f}%")
        print(f"pruned: ppl {sparse_eval['perplexity']:.2f}  "
              f"acc {100*sparse_eval['accuracy']:.2f}%")
    if out_dir:
        write_out_dir(Path(out_dir), arch, report, dense_eval, sparse_eval)
    return {"report": report, "dense": dense_eval, "pruned": sparse_eval}


def write_out_dir(out: Path, arch: str, report, dense_eval: dict,
                  sparse_eval: dict) -> None:
    """``out/masks`` (masks-tree checkpoint, step 0) and ``out/report.json``
    with the reference's keys that apply to this launcher."""
    out.mkdir(parents=True, exist_ok=True)
    ckpt.save(out / "masks", 0, report.masks)
    doc = {
        "arch": arch, "method": report.method,
        "warmstart": report.warmstart, "pattern": report.pattern,
        "mean_error_reduction": report.mean_error_reduction(),
        "dense": dense_eval, "pruned": sparse_eval,
        "wall_time_s": report.wall_time_s,
        "sites": [{"name": s.name, "pattern": s.pattern, "method": s.method,
                   "err_red": [float(x) for x in s.error_reduction]}
                  for s in report.sites],
    }
    (out / "report.json").write_text(json.dumps(doc, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--sparsity", default="0.6", help="fraction or N:M")
    ap.add_argument("--warmstart", default="wanda",
                    choices=["magnitude", "wanda", "ria"])
    ap.add_argument("--method", default="sparseswaps",
                    choices=["none", "sparseswaps"])
    ap.add_argument("--t-max", type=int, default=50)
    ap.add_argument("--k-swaps", type=int, default=None,
                    help="swaps committed per search pass (default: auto)")
    ap.add_argument("--n-calib", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="write masks/ (checkpoint) and report.json here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    prune(args.arch, tiny=args.tiny, pattern=args.sparsity,
          warmstart=args.warmstart, method=args.method, t_max=args.t_max,
          k_swaps=args.k_swaps, n_calib=args.n_calib, seed=args.seed,
          out_dir=args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
