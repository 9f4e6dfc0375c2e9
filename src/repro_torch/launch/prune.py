"""Pruning launcher: the paper's pipeline as a job, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.prune --arch llama31-8b \
        --tiny --sparsity 0.6 --method sparseswaps --t-max 50 --device cpu

Initialises the model from ``--seed``, plans the run (``--plan-only``
prints the resolved per-site table — engine paths, weight/Gram bytes and
the calibration cost block — and exits without spending a FLOP: the
params then live on ``device="meta"``), calibrates, executes the plan
group by group, and prints the per-site error reductions and the dense vs
pruned perplexity. A cross-attention architecture's calibration and
evaluation batches carry its stub frontend states (``img`` /
``src``, ``data.synthetic.with_modality``). It runs on ``--device cuda`` unless asked for the CPU,
and raises when the card is missing. TF32 is turned off for matmuls and
cuDNN, so fp32 products run in full fp32.

``--recipe recipe.json`` swaps the single global rule for a per-site
recipe (mixed N:M + unstructured, skip lists, per-rule t_max; the
reference's JSON). Calibration streams through ``pruning.stats``:
skip-rule sites accumulate nothing, and ``--calib-stats minimal`` drops
dsnot-only sites to O(d) moments. ``--compact-every S`` gathers converged
rows out of the swap search every S passes.

``--out-dir D`` writes ``D/masks`` (a step-0 masks-tree checkpoint in the
reference's format), ``D/recipe.json``, ``D/report.json`` and, for
sparsegpt, ``D/weights`` (the updated weights); group checkpoints go under
``D/prune_ckpt/groups/`` and, with ``--calib-ckpt-every k``, calibration
checkpoints under ``D/prune_ckpt/calib/``, so a rerun into the same
directory resumes. Then

    python -m repro_torch.launch.serve --masks-from D --format nm24 ...

serves the pruned model, as the reference's launchers do.

``--from-ckpt DIR`` prunes the params of the newest TrainState checkpoint
under DIR (``launch.train``'s, or the reference's) instead of the seeded
init. ``--recover norms_biases [--recover-steps N --recover-lr LR]``
appends PERP post-prune recovery (``pruning.recover``): masked-gradient
AdamW on the selected params over the calibration stream (the run's own
batch, sequence length and seed; the flag overrides a recipe's
``recover``), resumable under ``D/prune_ckpt/recover`` with
``--calib-ckpt-every k`` as its checkpoint period. The recovered model
is evaluated, ``report.json`` gains ``recovered`` and ``recovery``, and
its changed leaves go to ``D/weights``, so ``launch.serve --masks-from
D`` serves the recovered model.

``--mesh host`` (every rank of the world) or ``--mesh production``
(16 x 16, 256 ranks) runs under ``torchrun``:

    torchrun --standalone --nproc-per-node N -m repro_torch.launch.prune \
        --arch llama31-8b --mesh host ...

Calibration batches split over the data axes where they divide, the
sparseswaps groups refine over the mesh (``pruning.distributed``: rows
split, or G's columns past the replication budget, each rank on its
column block), ``--recover`` trains its selection sharded over the mesh
(``pruning.recover``: the state by ``state_pspecs``, the batches over the
data axes, checkpoints in the sharded layout), and only rank 0 evaluates,
prints the report and writes ``--out-dir``. One process per card runs
NCCL; ``--device cpu`` runs gloo; two ranks sharing one card pass
``backend="gloo"`` to ``launch.mesh.init_distributed`` before calling
``prune``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch import ckpt, configs, models, pruning
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.dist import groups as groups_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.pruning.executor import changed_leaves
from repro_torch.train import steps as steps_lib


def _build_recipe(pattern, *, recipe: str | None, warmstart: str,
                  method: str, t_max: int,
                  k_swaps: int | None = None) -> pruning.PruneRecipe:
    if recipe is not None:
        return pruning.PruneRecipe.from_json(Path(recipe).read_text())
    return pruning.PruneRecipe.single(
        pattern, method=method, warmstart=warmstart, t_max=t_max,
        k_swaps=k_swaps)


def prune(arch: str, *, tiny: bool = False, pattern="0.6",
          warmstart: str = "wanda", method: str = "sparseswaps",
          t_max: int = 50, k_swaps: int | None = None,
          compact_every: int | None = None, n_calib: int = 16,
          calib_seq: int = 128, calib_batch: int = 4, seed: int = 0,
          out_dir: str | None = None, calib_ckpt_every: int = 0,
          recipe: str | None = None, plan_only: bool = False,
          calib_stats: str = "full", device="cuda", n_layers: int | None = None,
          from_ckpt: str | None = None, recover: str | None = None,
          recover_steps: int = 50, recover_lr: float = 1e-3,
          mesh: str | None = None,
          callback: pruning.PruneCallback | None = None,
          verbose: bool = True) -> dict:
    """The launcher as a function. ``n_layers`` cuts the depth (the
    widths stay); ``from_ckpt`` prunes a trained TrainState checkpoint's
    params; ``callback`` receives the executor's progress (default: one
    printed line per group when ``verbose``).

    ``recover``: a PERP selection name ("norms", "biases",
    "norms_biases", "all_masked", "lora") runs post-prune recovery for
    ``recover_steps`` steps at ``recover_lr`` on the calibration stream,
    checkpointed every ``calib_ckpt_every`` steps; it overrides a recipe's
    ``recover``. ``mesh``: None (one device), "host" (every rank of the
    world) or "production" (16 x 16); the process group comes from
    torchrun's environment unless one exists already (and is then left
    for its owner to destroy). Returns the report, the evaluations (None
    on a mesh's other ranks: rank 0 alone evaluates), the plan, the
    calibration statistics and the executor (for ``export_packed``), and
    with recovery its result and evaluation."""
    dev = resolve_device(device)
    disable_tf32()
    with mesh_lib.launcher_mesh(mesh, dev) as mesh_obj:
        if not groups_lib.is_main(mesh_obj):      # rank 0 alone prints
            verbose, callback = False, None
        cfg = configs.get_tiny(arch) if tiny else configs.get(arch)
        if n_layers is not None:
            cfg = cfg.replace(n_layers=n_layers)
        api = models.build(cfg)
        rec = _build_recipe(pattern, recipe=recipe, warmstart=warmstart,
                            method=method, t_max=t_max, k_swaps=k_swaps)
        if recover is not None:
            # the flag wins over a recipe's spec; the calibration stream's
            # geometry and seed are the pruning run's own
            rec = dataclasses.replace(rec, recover=pruning.RecoverSpec(
                select=recover, steps=recover_steps, lr=recover_lr,
                batch_size=calib_batch, seq_len=calib_seq, seed=seed))

        if plan_only:
            # shapes only: no weight materialized, no FLOP spent
            plan = pruning.plan_pruning(
                api, api.init(seed=seed, device="meta"), rec, mesh=mesh_obj,
                compact_every=compact_every)
            print(plan.describe())
            return {"plan": plan}

        params = (steps_lib.restore_params(api, from_ckpt, device=dev)
                  if from_ckpt else api.init(seed=seed, device=dev))
        plan = pruning.plan_pruning(api, params, rec, mesh=mesh_obj,
                                    compact_every=compact_every)
        if verbose:
            print(plan.describe())
        batches = list(pruning.calibration_batches(
            cfg, n_samples=n_calib, seq_len=calib_seq,
            batch_size=calib_batch, seed=seed, device=dev))
        # recipe-aware calibration driven by the executor: skip-rule taps
        # never accumulate; "minimal" drops dsnot-only sites to moments;
        # on a mesh, batches split over its data axes
        executor = pruning.PruneExecutor(
            api, params, plan,
            calib_spec=plan.calib_spec(minimal=(calib_stats == "minimal")),
            calib_ckpt_every=calib_ckpt_every,
            ckpt_dir=Path(out_dir) / "prune_ckpt" if out_dir else None,
            callback=callback if callback is not None
            else (pruning.PrintProgress() if verbose else None))
        report = executor.run(batches)
        main = groups_lib.is_main(mesh_obj)
        eval_params = (report.updated_params
                       if report.updated_params is not None else params)
        dense_eval = sparse_eval = None
        if main:
            dense_eval = pruning.evaluate(api, params, seed=seed, device=dev)
            sparse_eval = pruning.evaluate(api, eval_params,
                                           masks=report.masks, seed=seed,
                                           device=dev)
        if verbose:
            print(report.summary())
            print(f"dense : ppl {dense_eval['perplexity']:.2f}  "
                  f"acc {100*dense_eval['accuracy']:.2f}%")
            print(f"pruned: ppl {sparse_eval['perplexity']:.2f}  "
                  f"acc {100*sparse_eval['accuracy']:.2f}%")
        result = {"report": report, "dense": dense_eval,
                  "pruned": sparse_eval, "plan": plan,
                  "stats": executor.stats, "executor": executor}
        if plan.recover is not None:
            rec_res = executor.recover(checkpoint_every=calib_ckpt_every,
                                       verbose=verbose)
            result["recover_result"] = rec_res
            result["recovered"] = pruning.evaluate(
                api, report.updated_params, masks=report.masks, seed=seed,
                device=dev) if main else None
            if verbose:
                rv = result["recovered"]
                print(f"recovered ({plan.recover.select}, "
                      f"{rec_res.steps_run + rec_res.start_step} steps, "
                      f"{100*rec_res.trainable_frac:.2f}% of params): "
                      f"ppl {rv['perplexity']:.2f}  "
                      f"acc {100*rv['accuracy']:.2f}%")
        if out_dir:
            if main:
                write_out_dir(Path(out_dir), arch, rec, params, report,
                              dense_eval, sparse_eval,
                              recovered=result.get("recovered"),
                              recover_result=result.get("recover_result"))
            if mesh_obj is not None:
                groups_lib.axis_group(mesh_obj,
                                      groups_lib.all_axes(mesh_obj)).barrier()
        return result


def write_out_dir(out: Path, arch: str, recipe, params, report,
                  dense_eval: dict, sparse_eval: dict, *,
                  recovered: dict | None = None,
                  recover_result=None) -> None:
    """``out/masks`` (masks-tree checkpoint, step 0), ``out/weights`` (the
    leaves sparsegpt or recovery changed), ``out/recipe.json`` and
    ``out/report.json`` with the reference's keys that apply to this
    launcher (``recovered`` and ``recovery`` after a recovery pass)."""
    out.mkdir(parents=True, exist_ok=True)
    ckpt.save(out / "masks", 0, report.masks)
    if report.updated_params is not None:
        upd = changed_leaves(params, report.updated_params)
        if upd:
            ckpt.save(out / "weights", 0, upd)
    (out / "recipe.json").write_text(recipe.to_json())
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
    if recovered is not None:
        r = recover_result
        doc["recovered"] = recovered
        doc["recovery"] = {
            "spec": r.spec.to_json_dict(),
            "trainable_count": r.trainable_count,
            "trainable_frac": r.trainable_frac,
            "steps_run": r.steps_run, "start_step": r.start_step,
            "diverged": r.diverged,
            "ce_start": r.ce_history[0] if r.ce_history else None,
            "ce_end": r.ce_history[-1] if r.ce_history else None,
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
                    choices=["none", "sparseswaps", "dsnot", "sparsegpt"])
    ap.add_argument("--t-max", type=int, default=50)
    ap.add_argument("--k-swaps", type=int, default=None,
                    help="swaps committed per search pass (default: auto)")
    ap.add_argument("--compact-every", type=int, default=None,
                    help="gather converged rows out every S passes")
    ap.add_argument("--n-calib", type=int, default=16)
    ap.add_argument("--from-ckpt", default=None,
                    help="prune the newest TrainState checkpoint here "
                         "(launch.train) instead of the seeded init")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="write masks/, recipe.json and report.json here; "
                         "group checkpoints under <out>/prune_ckpt")
    ap.add_argument("--recipe", default=None, metavar="recipe.json",
                    help="per-site rules (overrides --sparsity/--method/...)")
    ap.add_argument("--plan-only", action="store_true",
                    help="print the resolved plan table and exit")
    ap.add_argument("--calib-stats", default="full",
                    choices=["full", "minimal"],
                    help="full: skip-aware Gram for every refined site; "
                         "minimal: dsnot-only sites drop to O(d) moments "
                         "(their reported losses become diagonal proxies)")
    ap.add_argument("--calib-ckpt-every", type=int, default=0,
                    help="checkpoint the calibration accumulator every k "
                         "batches (under <out>/prune_ckpt/calib)")
    ap.add_argument("--recover", default=None,
                    choices=["norms", "biases", "norms_biases",
                             "all_masked", "lora"],
                    help="run PERP post-prune recovery on this param "
                         "selection (overrides a recipe-attached spec)")
    ap.add_argument("--recover-steps", type=int, default=50,
                    help="recovery AdamW steps over the calibration stream")
    ap.add_argument("--recover-lr", type=float, default=1e-3,
                    help="recovery peak learning rate (warmup-cosine)")
    ap.add_argument("--mesh", default=None, choices=["host", "production"],
                    help="prune (and recover) over a mesh of the "
                         "torchrun world (host: every rank; production: "
                         "16 x 16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    prune(args.arch, tiny=args.tiny, pattern=args.sparsity,
          warmstart=args.warmstart, method=args.method, t_max=args.t_max,
          k_swaps=args.k_swaps, compact_every=args.compact_every,
          n_calib=args.n_calib, seed=args.seed, out_dir=args.out_dir,
          recipe=args.recipe, plan_only=args.plan_only,
          calib_stats=args.calib_stats,
          calib_ckpt_every=args.calib_ckpt_every, device=args.device,
          from_ckpt=args.from_ckpt, recover=args.recover,
          recover_steps=args.recover_steps, recover_lr=args.recover_lr,
          mesh=args.mesh)


if __name__ == "__main__":
    main()
