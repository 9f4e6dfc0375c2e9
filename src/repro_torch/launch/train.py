"""Training launcher: checkpointed and restartable, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama31-8b \
        --tiny --steps 200 --ckpt-dir /tmp/run1 --device cpu

Initialises the model from ``--seed`` and trains it with AdamW
(warmup-cosine, global-norm clipping) on the synthetic corpus's train
split. A ``TrainState`` checkpoint (the reference's format and leaf
paths, so each package resumes the other's) is written every
``--ckpt-every`` steps, at the last step and on SIGTERM / SIGINT. Rerun
the same command after a kill and it resumes from the newest valid
checkpoint (a corrupt or partial one is skipped by its hashes) and
replays the same batches: batches are keyed by (seed, split, step). A
heartbeat file under ``<ckpt-dir>/hb`` is pinged while it runs.

    python -m repro_torch.launch.prune --from-ckpt /tmp/run1 ...

prunes the trained model. It runs on ``--device cuda`` unless asked for
the CPU, and raises when the card is missing; TF32 is off.

``--mesh host`` (every rank of the world) or ``--mesh production``
(16 x 16, 256 ranks) trains over a mesh under ``torchrun``:

    torchrun --standalone --nproc-per-node N -m repro_torch.launch.train \
        --arch llama31-8b --tiny --mesh host --device cpu ...

The TrainState lives sharded by ``dist.specs.state_pspecs``, every rank
draws the same batch and runs its slice of it over the data axes
(``train.steps.train_step_fn(mesh=)``), checkpoints are written in the
sharded layout (each rank its blocks, rank 0 the manifest) and a restart
restores each rank's block, whatever mesh wrote them. A SIGTERM on any
rank saves and stops every rank at the same step; the straggler monitor
records each rank's step time; each rank pings its own heartbeat file;
rank 0 alone prints. One process per card runs NCCL; ``--device cpu``
runs gloo.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch import ckpt, configs, models
from repro_torch.data import synthetic
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.dist import groups as groups_lib
from repro_torch.dist import placement
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (Heartbeat, PreemptionGuard,
                                                 StragglerMonitor, retry)
from repro_torch.train import steps as steps_lib


def train(arch: str, *, tiny: bool = False, n_steps: int = 100,
          batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 50, lr: float = 3e-4, seed: int = 0,
          masks=None, log_every: int = 10, device="cuda",
          n_layers: int | None = None, batches=None, mesh: str | None = None,
          verbose: bool = True) -> dict:
    """The launcher as a function. ``n_layers`` cuts the depth (the widths
    stay); ``batches`` (a list, cycled by step) replaces the synthetic
    train stream; ``masks`` trains sparsely (the optimizer keeps the mask
    invariant). ``mesh``: None (one device), "host" or "production"; the
    process group comes from torchrun's environment unless one exists
    already (and is then left for its owner to destroy). Returns the
    final state (this rank's shard on a mesh), the params whole, the
    per-step losses and the step count reached."""
    dev = resolve_device(device)
    disable_tf32()
    with mesh_lib.launcher_mesh(mesh, dev) as mesh_obj:
        return _train(arch, tiny=tiny, n_steps=n_steps, batch=batch,
                      seq=seq, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      lr=lr, seed=seed, masks=masks, log_every=log_every,
                      dev=dev, n_layers=n_layers, batches=batches,
                      mesh=mesh_obj, verbose=verbose)


def _train(arch, *, tiny, n_steps, batch, seq, ckpt_dir, ckpt_every, lr,
           seed, masks, log_every, dev, n_layers, batches, mesh,
           verbose) -> dict:
    main = groups_lib.is_main(mesh)
    verbose = verbose and main
    cfg = configs.get_tiny(arch) if tiny else configs.get(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    api = models.build(cfg)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=min(20, n_steps // 10 + 1),
                                total_steps=n_steps)
    if batches is not None:
        pool = list(batches)
        get_batch = lambda i: pool[i % len(pool)]  # noqa: E731
    else:
        pipe = synthetic.DataPipeline(
            synthetic.CorpusConfig(cfg.vocab_size, seed=seed), batch, seq,
            split="train", device=dev)
        # the frontend states a cross-attention family reads, keyed as
        # calibration's and recovery's are
        get_batch = lambda i: synthetic.with_modality(  # noqa: E731
            pipe.get(i), cfg, seed, i)

    state = steps_lib.init_state(api, seed=seed, device=dev)
    layout = None
    if mesh is not None:
        layout = steps_lib.state_layout(api, mesh)
        state = steps_lib.shard_state(state, layout)
    start_step = 0
    if ckpt_dir:
        # the newest checkpoint whose every leaf reads back and passes its
        # hash check (what latest_valid then restore find, read once); on a
        # mesh each rank's block of the step every rank could read
        if layout is None:
            found = retry(ckpt.restore_latest_like, ckpt_dir, state)
        else:
            found = ckpt.restore_latest_like(
                ckpt_dir, steps_lib.abstract_state(api), device=dev,
                shardings=layout)
        if found is not None:
            start_step, state, _ = found
            if verbose:
                print(f"resumed from step {start_step}")
    step_fn = (steps_lib.make_train_step(api, opt_cfg, masks=masks)
               if mesh is None else steps_lib.make_train_step(
                   api, opt_cfg, masks=masks, mesh=mesh))
    rank = 0 if mesh is None else torch.distributed.get_rank()

    def save(step_no: int):
        # every write and the publishing rename retry inside the store; on
        # a mesh the save is collective
        ckpt.save(ckpt_dir, step_no, state, shardings=layout)
        if main:
            ckpt.gc(ckpt_dir, keep=3)

    hb = Heartbeat(dir=Path(ckpt_dir) / "hb", host=rank) if ckpt_dir else None
    if hb:
        hb.start()
    strag = StragglerMonitor()
    losses = []
    step = start_step - 1
    try:
        with PreemptionGuard() as guard:
            for step in range(start_step, n_steps):
                t0 = time.perf_counter()
                state, m = step_fn(state, get_batch(step))
                loss = float(m["loss"])          # waits for the step
                dt = time.perf_counter() - t0
                preempted = guard.should_save
                if mesh is None:
                    strag.record(0, dt)
                else:
                    # every rank's step time, and a signal on any rank
                    # stops every rank at this step
                    times = placement.all_values([dt, preempted], mesh)
                    for r, t in enumerate(times[:, 0].tolist()):
                        strag.record(r, t)
                    preempted = bool(times[:, 1].max() > 0)
                if verbose and (step % log_every == 0 or step == n_steps - 1):
                    print(f"step {step:5d}  loss {loss:.4f}  "
                          f"lr {float(m['lr']):.2e}  {dt*1000:.0f}ms")
                losses.append(loss)
                if ckpt_dir and ((step + 1) % ckpt_every == 0
                                 or step == n_steps - 1 or preempted):
                    save(step + 1)
                if preempted:
                    if verbose:
                        print(f"preempted at step {step}; checkpoint saved, "
                              "exiting")
                    break
    finally:
        if hb:
            hb.stop()
    params = state.params
    if layout is not None:
        params = placement.gather(params, layout.specs.params, mesh)
    return {"state": state, "params": params, "losses": losses,
            "final_step": step + 1, "start_step": start_step,
            "stragglers": strag, "main": main}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, choices=["host", "production"],
                    help="train over a mesh of the torchrun world (host: "
                         "every rank; production: 16 x 16)")
    args = ap.parse_args(argv)
    out = train(args.arch, tiny=args.tiny, n_steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, lr=args.lr, seed=args.seed,
                device=args.device, mesh=args.mesh)
    if out["losses"] and out["main"]:
        print(f"final loss: {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
