"""The ranks of ``tests/test_torch_distributed.py``: one gloo world of four
CPU ranks, started with the spawn start method.

Each rank joins the world on a ``file://`` store under the test's
temporary directory, at one torch thread, and runs every check of the
module on the port alone (no JAX here): the mesh's process groups, the
refiners, ``psum_gram``, ``prune_model``, ``accumulate_stats`` and the
launcher on the host mesh (4, 1) and on (2, 2). The parent hands it the
reference's params, taps and calibration batches (through numpy). It
saves what it found to ``rank<r>.pt``; a failure saves its traceback to
``rank<r>.err``. The parent holds every rank's results against the
single-device paths and the reference.
"""
from __future__ import annotations

import time
import traceback
from pathlib import Path

import numpy as np

WORLD = 4
JOIN_S = 240          # the whole world, checks included
PSUM_ROWS = (5, 3, 0, 8)


def refine_problems():
    """The refiners' inputs, as ``tests/test_distributed.py`` draws them:
    {name: (W, G)} in numpy."""
    out = {}
    for name, seed, d_in, d_out in (("rows", 0, 48, 32), ("gram", 1, 64, 16)):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(d_in, 300)).astype(np.float32)
        W = rng.normal(size=(d_out, d_in)).astype(np.float32)
        out[name] = (W, X @ X.T)
    return out


# (case, problem, rows, pattern, t_max, k, mesh)
ROWS_CASES = [
    ("rows_k1", "rows", 32, "0.5", 15, 1, "host"),
    ("rows_k8", "rows", 32, "0.5", 15, 8, "host"),
    ("rows_nm24", "rows", 32, "2:4", 10, 8, "host"),
    ("rows_R30_k8", "rows", 30, "0.5", 15, 8, "host"),
    ("rows_square_k8", "rows", 32, "0.5", 15, 8, "square"),
]
# (case, k, mesh, row_axes, col_axes), on the "gram" problem at PerRow(0.5)
GRAM_CASES = [
    ("gram_host_k1", 1, "host", (), None),
    ("gram_host_k8", 8, "host", (), None),
    ("gram_square_k1", 1, "square", (), None),
    ("gram_square_k8", 8, "square", (), None),
    ("gram_rows_data_k8", 8, "square", ("data",), ("model",)),
    ("gram_rows_data_k1", 1, "square", ("data",), ("model",)),
]
GRAM_T_MAX = 12
# (case, pattern, t_max, mesh, gram_budget_bytes)
PRUNE_CASES = [
    ("prune_0.6", "0.6", 8, "square", None),
    ("prune_2:4", "2:4", 8, "host", None),
    ("prune_0.5_gram", "0.5", 6, "host", 0),
]
# (case, data, model) of the Gram-sharded prune: prune_model(mesh=)
# calibrating the "split" batches on the mesh past GRAM_BUDGET, which
# holds the 64-wide fp32 Grams (16 KiB) but not w_down's 96-wide one
GRAM_PRUNE_CASES = [("gram_prune_2x2", 2, 2), ("gram_prune_1x4", 1, 4)]
GRAM_BUDGET = 20000
GRAM_PRUNE_T_MAX = 6
# (case, n_samples, batch_size) of accumulate_stats(mesh=) on (2, 2), at
# sequence length CALIB_SEQ: "split" divides over "data", "whole" does not
CALIB_CASES = [("split", 8, 4), ("whole", 6, 3)]
CALIB_SEQ = 24
LAUNCH_ARGS = ["--arch", "llama31-8b", "--tiny", "--device", "cpu",
               "--t-max", "4", "--n-calib", "4", "--calib-ckpt-every", "1"]
LAUNCH_CALIB = dict(n_samples=4, seq_len=128, batch_size=4, seed=0)


def psum_rows(rank: int, X: np.ndarray) -> np.ndarray:
    lo = sum(PSUM_ROWS[:rank])
    return X[lo:lo + PSUM_ROWS[rank]]


def _masks_np(tree, prefix=""):
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_masks_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (v.detach().cpu().numpy() > 0.5)
    return out


def _refines(meshes):
    import torch

    from repro_torch.core import masks as masks_lib
    from repro_torch.core.warmstart import warmstart_mask
    from repro_torch.pruning import distributed

    probs = {k: (torch.as_tensor(W), torch.as_tensor(G))
             for k, (W, G) in refine_problems().items()}
    out = {}
    for case, prob, R, pat, t_max, k, mesh in ROWS_CASES:
        W, G = probs[prob]
        W = W[:R]
        p = masks_lib.parse_pattern(pat)
        m0 = warmstart_mask(W, G, p, "wanda")
        m, l0, l1 = distributed.refine_rows_sharded(
            W, G, m0, p, meshes[mesh], t_max=t_max, k_swaps=k)
        out[case] = (m.numpy(), l0.numpy(), l1.numpy())
    W, G = probs["gram"]
    p = masks_lib.PerRow(0.5)
    m0 = warmstart_mask(W, G, p, "wanda")
    for case, k, mesh, row_axes, col_axes in GRAM_CASES:
        m, l0, l1 = distributed.refine_g_sharded(
            W, G, m0, p, meshes[mesh], t_max=GRAM_T_MAX, k_swaps=k,
            row_axes=row_axes, col_axes=col_axes)
        out[case] = (m.numpy(), l0.numpy(), l1.numpy())
    return out


def _psum(rank, mesh, inputs):
    import torch

    from repro_torch.core import gram as gram_lib
    from repro_torch.dist import groups

    X = psum_rows(rank, inputs["psum_x"])
    st = gram_lib.GramState.create(X.shape[1])
    if X.shape[0]:
        st = st.update(torch.as_tensor(X))
    st = gram_lib.psum_gram(st, groups.axis_group(mesh,
                                                  groups.all_axes(mesh)))
    return {k: getattr(st, k).numpy() for k in ("G", "count", "mean", "m2")}


def _prunes(meshes, inputs):
    from repro_torch import configs, convert, models, pruning
    from repro_torch.core import masks as masks_lib

    api = models.build(configs.get_tiny("llama31-8b"))
    params = convert.from_numpy(inputs["params"])
    taps = convert.from_numpy(inputs["taps"])
    out = {}
    for case, pat, t_max, mesh, budget in PRUNE_CASES:
        kw = {} if budget is None else {"gram_budget_bytes": budget}
        rep = pruning.prune_model(api, params, None,
                                  masks_lib.parse_pattern(pat), t_max=t_max,
                                  taps=taps, mesh=meshes[mesh], **kw)
        out[case] = (_masks_np(rep.masks),
                     [g.engine_path for g in rep.plan.groups])
    return out


def _gram_prunes(inputs):
    """``PruneExecutor.run`` on each GRAM_PRUNE_CASES mesh, calibrating on
    it, with every ``CalibStats.entry`` path, every Gram leaf ``_whole``
    gathers and every G ``refine_g_sharded`` receives recorded: (masks,
    engine paths, entry paths, gathered shapes, refiner G shapes, the
    plan's w_down reckoning, the whole calibrated taps)."""
    from repro_torch import configs, convert, models, pruning
    from repro_torch.core import masks as masks_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.pruning import distributed, stats

    api = models.build(configs.get_tiny("llama31-8b"))
    params = convert.from_numpy(inputs["params"])
    batches = [convert.from_numpy(b) for b in inputs["calib"]["split"]]
    seen = {"entry": [], "whole": [], "refine": []}
    entry, whole, refine = (stats.CalibStats.entry, stats._whole,
                            distributed.refine_g_sharded)

    def rec_entry(self, path):
        seen["entry"].append(tuple(path))
        return entry(self, path)

    def rec_whole(tree, specs, grp):
        if not isinstance(tree, dict) and specs[-1:] == ("model",):
            seen["whole"].append(tuple(tree.shape))
        return whole(tree, specs, grp)

    def rec_refine(W, G, *a, **kw):
        seen["refine"].append(tuple(G.shape))
        return refine(W, G, *a, **kw)

    out = {}
    for case, data, model in GRAM_PRUNE_CASES:
        mesh = mesh_lib.make_host_mesh(data=data, model=model)
        recipe = pruning.PruneRecipe.single(masks_lib.PerRow(0.6),
                                            t_max=GRAM_PRUNE_T_MAX)
        plan = pruning.plan_pruning(api, params, recipe, mesh=mesh,
                                    gram_budget_bytes=GRAM_BUDGET)
        ex = pruning.PruneExecutor(api, params, plan)
        for v in seen.values():
            v.clear()
        stats.CalibStats.entry, stats._whole = rec_entry, rec_whole
        distributed.refine_g_sharded = rec_refine
        try:
            rep = ex.run(batches)
        finally:
            stats.CalibStats.entry, stats._whole = entry, whole
            distributed.refine_g_sharded = refine
        out[case] = (_masks_np(rep.masks),
                     {g.name: g.engine_path for g in plan.groups},
                     list(seen["entry"]), list(seen["whole"]),
                     list(seen["refine"]),
                     plan.refine_costs()["layers.mlp.w_down"],
                     convert.to_numpy(ex.stats.full_taps()))
    return out


def _groups(meshes):
    """Collectives on a second mesh equal to a dropped first one, and a
    set of axes whose groups are made when first asked for."""
    import gc

    import torch

    from repro_torch.dist import groups
    from repro_torch.launch import mesh as mesh_lib

    me = torch.tensor([float(torch.distributed.get_rank())])
    first = mesh_lib.make_host_mesh(data=2, model=2)
    again = mesh_lib.make_host_mesh(data=2, model=2)
    del first
    gc.collect()
    out = {"again": groups.axis_group(again, ("data", "model")
                                      ).all_gather(me).numpy().ravel()}
    cube = groups.build_mesh((2, 2, 1), ("pod", "data", "model"),
                             device_type="cpu")
    made = len(getattr(cube, groups._GROUPS))
    g = groups.axis_group(cube, ("data", "pod"))
    out["lazy"] = (made, len(getattr(cube, groups._GROUPS)), g.index,
                   g.all_gather(me).numpy().ravel())
    return out


def _stats(meshes, root, saves, inputs):
    import warnings

    from repro_torch import configs, convert, models, pruning

    api = models.build(configs.get_tiny("llama31-8b"))
    params = convert.from_numpy(inputs["params"])
    out = {}
    for case, _, _ in CALIB_CASES:
        batches = [convert.from_numpy(b) for b in inputs["calib"][case]]
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            st = pruning.accumulate_stats(api, params, batches,
                                          mesh=meshes["square"])
        out[case] = (convert.to_numpy(st.full_taps()),
                     [str(w.message) for w in seen],
                     st.tap_bytes())
    # calibration checkpoints: rank 0 writes, every rank resumes
    batches = [convert.from_numpy(b) for b in inputs["calib"]["split"]]
    before = saves["n"]
    first = pruning.accumulate_stats(api, params, batches,
                                     mesh=meshes["square"],
                                     ckpt_dir=Path(root) / "calib",
                                     checkpoint_every=1)
    wrote = saves["n"] - before
    again = pruning.accumulate_stats(api, params, batches,
                                     mesh=meshes["square"],
                                     ckpt_dir=Path(root) / "calib",
                                     checkpoint_every=1)
    out["ckpt"] = (wrote, saves["n"] - before - wrote,
                   convert.to_numpy(first.full_taps()),
                   convert.to_numpy(again.full_taps()), again.batches)
    return out


def _launch(root, saves, writes):
    from repro_torch.launch import prune as launch

    before = saves["n"]
    launch.main([*LAUNCH_ARGS, "--mesh", "host",
                 "--out-dir", str(Path(root) / "out")])
    return {"saves": saves["n"] - before, "writes": writes["n"]}


def run(rank: int, root: str, inputs: dict) -> None:
    """One rank of the world: every check, results to ``rank<r>.pt``."""
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch import ckpt
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import prune as launch

    # count this rank's checkpoint writes and out-dir writes
    saves, writes = {"n": 0}, {"n": 0}
    save, write_out = ckpt.save, launch.write_out_dir

    def counted_save(*a, **kw):
        saves["n"] += 1
        return save(*a, **kw)

    def counted_write(*a, **kw):
        writes["n"] += 1
        return write_out(*a, **kw)

    ckpt.save = counted_save
    launch.write_out_dir = counted_write
    try:
        mesh_lib.init_distributed("cpu", init_method=f"file://{root}/store",
                                  rank=rank, world_size=WORLD)
        meshes = {"host": mesh_lib.make_host_mesh(),
                  "square": mesh_lib.make_host_mesh(data=2, model=2)}
        out = {"groups": _groups(meshes),
               "refine": _refines(meshes),
               "psum": _psum(rank, meshes["host"], inputs),
               "prune": _prunes(meshes, inputs),
               "stats": _stats(meshes, root, saves, inputs),
               "gram_prune": _gram_prunes(inputs)}
        out["launch"] = _launch(root, saves, writes)
        torch.save(out, Path(root) / f"rank{rank}.pt")
        dist.destroy_process_group()
    except Exception:
        # recorded for the parent's assertion message, then raised
        (Path(root) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class World:
    """The spawned world; ``results()`` waits for it (bounded) once."""

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
            bad = [p.exitcode for p in self.procs]
            assert not alive and not errs and bad == [0] * WORLD, (
                f"ranks alive {len(alive)}, exit codes {bad}, errors {errs}")
            self._results = [torch.load(self.root / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(WORLD)]
        return self._results

    def close(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(5)
