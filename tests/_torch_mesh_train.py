"""The ranks of ``tests/test_torch_mesh_train.py``: four gloo CPU ranks,
started with the spawn start method, at one torch thread each.

Stage 1 is one world of the four ranks: the sharded train step on (2, 2)
(1 and 3 steps, ``grad_accum`` 2), the state's bytes against the
reckoning, a (2, 2) checkpoint written, the parent's one-device
checkpoint restored onto (2, 2), ``recover(mesh=)`` with a resume, and
``launch.train --mesh host`` ((4, 1)) uninterrupted, stopped by a
SIGTERM on one rank, and resumed. Stage 2 splits them: ranks 0 and 1 form
a world of two for (1, 2) and (2, 1) (the step, a batch whose halves
hold different valid-token counts, ``launch.prune --mesh host --recover``
with a restart); rank 2 a world of one for (1, 1) (the step, the train
and prune launchers). Each rank saves what it found to ``rank<r>.pt`` (a
failure its traceback to ``rank<r>.err``); the parent holds it against
one device and the reference.
"""
from __future__ import annotations

import os
import shutil
import signal
import time
import traceback
from pathlib import Path

WORLD = 4
JOIN_S = 240
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
STEPS = 3                 # train steps; results after steps 1 and 3
RECOVER = dict(select="all_masked", steps=4, lr=5e-3, batch_size=2,
               seq_len=32)
TRAIN_ARGS = dict(arch="llama31-8b", tiny=True, n_steps=4, batch=4, seq=16,
                  ckpt_every=2, seed=0, device="cpu", verbose=False)
PRUNE_ARGS = dict(arch="llama31-8b", tiny=True, device="cpu", t_max=4,
                  n_calib=4, recover="norms", recover_steps=4,
                  calib_ckpt_every=2, verbose=False)


def _np(tree):
    from repro_torch import convert

    return convert.to_numpy(tree)


def _steps(api, params, batches, mesh, *, n=STEPS):
    """[(loss, params whole)] after each of ``n`` mesh steps from
    ``params`` on ``batches``."""
    from repro_torch.dist import placement
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    layout = steps.state_layout(api, mesh)
    state = steps.shard_state(steps.TrainState(params, adamw.init(params)),
                              layout)
    fn = steps.train_step_fn(api, adamw.AdamWConfig(**OPT), mesh=mesh)
    out = []
    for b in batches[:n]:
        state, m = fn(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    _np(placement.gather(state.params, layout.specs.params,
                                         mesh))))
    return out, state, layout


def _train_launches(root: Path, tag: str):
    """launch.train on the host mesh: uninterrupted, then with checkpoints
    stopped by a SIGTERM on the last rank after step 2, then resumed."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch
    from repro_torch.train import steps

    out = {"full": launch.train(**TRAIN_ARGS, mesh="host")}
    out["full"] = (out["full"]["losses"], _np(out["full"]["params"]))
    kw = dict(TRAIN_ARGS, mesh="host", ckpt_dir=str(root / f"train_{tag}"))
    real = steps.make_train_step

    def make(*a, **k):
        step, calls = real(*a, **k), [0]

        def wrapped(state, batch):
            res = step(state, batch)
            calls[0] += 1
            if calls[0] == 2 and (dist.get_rank()
                                  == dist.get_world_size() - 1):
                os.kill(os.getpid(), signal.SIGTERM)
            return res

        return wrapped

    steps.make_train_step = make
    try:
        cut = launch.train(**kw)
    finally:
        steps.make_train_step = real
    resumed = launch.train(**kw)
    out["cut"] = (cut["final_step"], cut["losses"],
                  sorted(cut["stragglers"].ewma))
    out["resumed"] = (resumed["start_step"], resumed["losses"],
                      _np(resumed["params"]))
    return out


def _prune_launch(root: Path, tag: str):
    """launch.prune --mesh host --recover into an out dir, then again
    after the last recovery checkpoint is deleted (resumed)."""
    import torch.distributed as dist

    from repro_torch import ckpt
    from repro_torch.launch import prune as launch

    out_dir = root / f"prune_{tag}"
    kw = dict(PRUNE_ARGS, mesh="host", out_dir=str(out_dir))
    first = launch.prune(**kw)
    rdir = out_dir / "prune_ckpt" / "recover"
    steps_before = ckpt.steps(rdir)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(rdir / f"step_{steps_before[-1]:08d}")
    dist.barrier()
    again = launch.prune(**kw)
    rr, rr2 = first["recover_result"], again["recover_result"]
    return {"masks": _np(first["report"].masks),
            "trainable": _np(rr.trainable), "ce": rr.ce_history,
            "steps": steps_before, "resumed": (rr2.start_step, rr2.steps_run),
            "trainable2": _np(rr2.trainable), "ce2": rr2.ce_history,
            "recovered": first["recovered"]}


def _stage1(rank, root, inputs):
    import torch

    from repro_torch import ckpt, configs, convert, models, pruning
    from repro_torch.dist import placement
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    mesh_lib.init_distributed("cpu", init_method=f"file://{root}/store1",
                              rank=rank, world_size=WORLD)
    mesh = mesh_lib.make_host_mesh(data=2, model=2)
    cfg = configs.get_tiny("llama31-8b")
    api = models.build(cfg)
    params = convert.from_numpy(inputs["params"])
    batches = [convert.from_numpy(b) for b in inputs["batches"]]
    res = {}
    res["steps22"], state, layout = _steps(api, params, batches, mesh)
    actual = sum(t.numel() * t.element_size()
                 for t in adamw.tree_leaves(state.params)
                 + adamw.tree_leaves(state.opt.m)
                 + adamw.tree_leaves(state.opt.v)) \
        + state.opt.step.numel() * state.opt.step.element_size()
    res["bytes22"] = (actual, placement.bytes_per_rank(
        steps.abstract_state(api), layout.specs, mesh))
    ckpt.save(Path(root) / "ckpt22", STEPS, state, shardings=layout)
    acc = models.build(cfg.replace(grad_accum=2))
    res["accum22"] = _steps(acc, params, batches, mesh, n=1)[0]
    # the parent's one-device checkpoint onto (2, 2): this rank's blocks
    found = ckpt.restore_latest_like(Path(root) / "one",
                                     steps.abstract_state(api),
                                     device="cpu", shardings=layout)
    res["onto22"] = (found[0], {p: t.numpy() for p, t in
                                ckpt.store._flatten(found[1])},
                     {p: [(s.start, s.stop) for s in placement.block_index(
                         leaf.shape, sp, mesh)]
                      for p, leaf, sp in ckpt.store._flat_specs(
                          steps.abstract_state(api), layout.specs)})
    # recover(mesh=) with a resume
    rp = convert.from_numpy(inputs["rec_params"])
    rmasks = convert.from_numpy(inputs["rec_masks"])
    pool = [convert.from_numpy(b) for b in inputs["rec_pool"]]
    spec = pruning.RecoverSpec(**RECOVER)
    rdir = Path(root) / "rec22"
    r1 = pruning.recover(api, rp, rmasks, spec, mesh=mesh, batches=pool,
                         ckpt_dir=rdir, checkpoint_every=2)
    torch.distributed.barrier()
    if rank == 0:
        shutil.rmtree(rdir / "recover" / f"step_{4:08d}")
    torch.distributed.barrier()
    r2 = pruning.recover(api, rp, rmasks, spec, mesh=mesh, batches=pool,
                         ckpt_dir=rdir, checkpoint_every=2)
    res["rec22"] = (_np(r1.trainable), r1.ce_history, r2.start_step,
                    _np(r2.trainable), r2.ce_history)
    res["launch41"] = _train_launches(Path(root), "41")
    torch.distributed.destroy_process_group()
    return res


def _stage2(rank, root, inputs):
    import torch

    from repro_torch import configs, convert, models
    from repro_torch.launch import mesh as mesh_lib

    cfg = configs.get_tiny("llama31-8b")
    api = models.build(cfg)
    params = convert.from_numpy(inputs["params"])
    batches = [convert.from_numpy(b) for b in inputs["batches"]]
    res = {}
    if rank in (0, 1):
        mesh_lib.init_distributed("cpu", init_method=f"file://{root}/store2",
                                  rank=rank, world_size=2)
        res["steps12"] = _steps(api, params, batches,
                                mesh_lib.make_host_mesh(data=1, model=2))[0]
        mesh21 = mesh_lib.make_host_mesh(data=2, model=1)
        res["steps21"] = _steps(api, params, batches, mesh21)[0]
        uneven = convert.from_numpy(inputs["uneven"])
        res["uneven21"] = _steps(api, params, [uneven], mesh21, n=1)[0]
        res["prune21"] = _prune_launch(Path(root), "21")
    elif rank == 2:
        mesh_lib.init_distributed("cpu", init_method=f"file://{root}/store3",
                                  rank=0, world_size=1)
        res["steps11"] = _steps(api, params, batches,
                                mesh_lib.make_host_mesh())[0]
        res["launch11"] = _train_launches(Path(root), "11")
        res["prune11"] = _prune_launch(Path(root), "11")
    else:
        return res
    torch.distributed.destroy_process_group()
    return res


def run(rank: int, root: str, inputs: dict) -> None:
    import torch

    torch.set_num_threads(1)
    try:
        out = _stage1(rank, root, inputs)
        out.update(_stage2(rank, root, inputs))
        torch.save(out, Path(root) / f"rank{rank}.pt")
    except Exception:
        (Path(root) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class World:
    """The spawned ranks; ``results()`` waits for them (bounded) once."""

    def __init__(self, root: Path, inputs: dict):
        import torch.multiprocessing as mp

        self.root = root
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=run, args=(r, str(root), inputs))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self.t0 = time.monotonic()
        self._results = None

    def results(self) -> list[dict]:
        if self._results is None:
            import torch

            for p in self.procs:
                p.join(max(1.0, JOIN_S - (time.monotonic() - self.t0)))
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.kill()
            errs = {r: (self.root / f"rank{r}.err").read_text()
                    for r in range(WORLD)
                    if (self.root / f"rank{r}.err").exists()}
            codes = [p.exitcode for p in self.procs]
            assert not alive and not errs and codes == [0] * WORLD, (
                f"ranks alive {len(alive)}, exit codes {codes}, errors {errs}")
            self._results = [torch.load(self.root / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(WORLD)]
        return self._results

    def close(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(5)
