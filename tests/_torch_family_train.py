"""Training and post-prune recovery of a port family against the
reference, on its TINY (fp32): one world a module, then the checks
``test_torch_zamba_train.py``, ``test_torch_rwkv_train.py`` and
``test_torch_xattn_train.py`` share.

``build_world(arch)`` initialises the reference's params from
``jax.random.key(0)`` (a VLM's cross gates set to ``_torch_xattn.GATES``
first: at their init of 0 the cross layers add nothing, and their
weights take no gradient), samples three train batches and two recovery
batches with the reference's pipeline and ``with_modality`` (a VLM's
``img``, an encoder-decoder's ``src``), and runs the reference's jitted
train step three times at the config's own ``grad_accum``. The masks are
Wanda 2:4 on every site from the port's calibration (``method="none"``).
Everything reaches the other package through numpy
(``repro_torch.convert``). Tolerances: losses and metrics within rtol
1e-5; params after a step from the same state within 1e-6 + 1e-5·|want|
but at 1 in 1000 coordinates a leaf (``test_torch_moe_train.py``'s), and
after n free steps everywhere within lr·n; ``m`` and ``v`` within
``M_TOL`` / ``V_TOL`` of each leaf's max (see ``check_train_step``).
"""
import importlib
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import packed as jpacked  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.launch import prune as tprune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

jrecover = importlib.import_module("repro.pruning.recover")
trecover = importlib.import_module("repro_torch.pruning.recover")
RTOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LR = 5e-3
STEPS = 3
# m and v of a step, of each leaf's max: from the same params the two
# packages' gradients agree within ~4e-5 of a leaf's max (fp32 sums in
# other orders through the scans), and v is quadratic in them
M_TOL, V_TOL = 1e-4, 2e-4
SELECTIONS = trecover.SELECTIONS
GATES = (0.5, -0.5)           # a VLM's tanh-gates (``_torch_xattn.GATES``)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def close(got, want, what, *, of_max):
    """Each leaf within ``of_max`` of its max|want|."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        b = _np(w[name])
        np.testing.assert_allclose(_np(g[name]), b, rtol=0,
                                   atol=of_max * np.abs(b).max(),
                                   err_msg=f"{what}: {name}")


def close_trained(got, want, what, *, lr, steps):
    """Within 1e-6 + RTOL·|want| but at 1 in 1000 coordinates a leaf (at
    one, in a leaf of fewer than 1000), and everywhere within lr·steps
    (``test_torch_train._close_trained``). The one: AdamW's first steps
    scale a gradient element g by 1 / (|g| + eps), so where a leaf's sum
    over the batch cancels to ~eps (zamba's ``conv_b``: 4.3e-8 against a
    grad norm of 9) the two packages' fp32 rounding of g moves that
    coordinate by up to ~lr·1e-3."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        a, b = _np(g[name]), _np(w[name])
        d = np.abs(a - b)
        assert d.max() <= lr * steps, f"{what}: {name} {d.max()}"
        n_off = int(np.sum(d > 1e-6 + RTOL * np.abs(b)))
        assert n_off <= max(1, 1e-3 * d.size), f"{what}: {name} {n_off}"


def bitwise(a, b, what):
    fa, fb = list(leaves(convert.to_numpy(a))), list(leaves(
        convert.to_numpy(b)))
    assert [n for n, _ in fa] == [n for n, _ in fb], what
    for (n, x), (_, y) in zip(fa, fb):
        assert np.array_equal(x, y), f"{what}: {n}"


def modality_key(cfg):
    if cfg.is_encdec:
        return "src"
    return "img" if cfg.cross_attn_every else None


def _masked(tree_np, masks_np):
    out = jax.tree.map(lambda x: x, tree_np)
    flat_m = dict(leaves(masks_np))
    for name, leaf in leaves(tree_np):
        if name in flat_m:
            node = out
            *path, last = name.split(".")
            for k in path:
                node = node[k]
            node[last] = leaf * flat_m[name].astype(leaf.dtype)
    return out


def build_world(arch: str) -> dict:
    jcfg, tcfg = jconfigs.get_tiny(arch), tconfigs.get_tiny(arch)
    japi, tapi = jmodels.build(jcfg), tmodels.build(tcfg)
    params_np = np_tree(japi.init(jax.random.key(0)))
    if jcfg.cross_attn_every:
        G = jcfg.n_layers // jcfg.cross_attn_every
        for name, g in zip(("gate_attn", "gate_mlp"), GATES):
            params_np["cross_layers"][name] = np.full((G,), g, np.float32)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = convert.from_numpy(params_np)
    key = jax.random.key(0)
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   4, 16, split="train")
    batches = [np_tree(jsynthetic.with_modality(
        pipe.get(i), jcfg, jax.random.fold_in(key, i))) for i in range(STEPS)]
    rpipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                    2, 32, split="calib")
    pool = [np_tree(jsynthetic.with_modality(
        rpipe.get(i), jcfg, jax.random.fold_in(key, 100 + i)))
        for i in range(2)]
    calib = list(tpruning.calibration_batches(
        tcfg, n_samples=2, seq_len=16, batch_size=2, device="cpu"))
    rep = tpruning.prune_model(tapi, tparams, calib, tmasks.NM(2, 4),
                               method="none")
    nmasks = convert.to_numpy(rep.masks)
    jmasked = _masked(params_np, nmasks)
    # the reference's trajectory: STEPS steps at the config's grad_accum
    jstep = jsteps.make_train_step(japi, jadamw.AdamWConfig(**OPT),
                                   donate=False)
    js = jsteps.TrainState(jparams, jadamw.init(jparams))
    traj = []
    for b in batches:
        js, jm = jstep(js, b)
        traj.append((js, {k: float(v) for k, v in jm.items()}))
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, japi=japi, tapi=tapi,
                jparams=jparams, tparams=tparams, jstep=jstep, traj=traj,
                nmasks=nmasks, tmasks=rep.masks, jmasked=jmasked,
                tmasked=convert.from_numpy(jmasked), batches=batches,
                tbatches=[convert.from_numpy(b) for b in batches],
                pool=pool, tpool=[convert.from_numpy(b) for b in pool])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def check_train_step(world, steps: int) -> None:
    """The port's step on the reference's state before each of the first
    ``steps`` steps (at the config's own ``grad_accum``): the same metric
    keys, each within rtol 1e-5, and the state after it (params, m, v,
    the step count) within the bounds above. Then ``steps`` steps run
    free from the same params: each step's loss and CE within rtol 1e-5,
    the params everywhere within lr·steps. A free run is not held
    coordinate by coordinate past its first step: AdamW's first steps
    scale a gradient element g by 1 / (|g| + eps), so where g cancels to
    near eps the two packages' fp32 roundings move a coordinate apart,
    and the next gradient follows (zamba: grad_norm 2.9e-5 apart at the
    free run's second step, 5.1e-6 at its first; from the same params
    the gradients agree within 4e-5 of each leaf's max)."""
    tstep = tsteps.make_train_step(world["tapi"], tadamw.AdamWConfig(**OPT))
    prev = tsteps.TrainState(world["tparams"], tadamw.init(world["tparams"]))
    for i in range(steps):
        ts, tm = tstep(prev, world["tbatches"][i])
        js, jm = world["traj"][i]
        assert sorted(tm) == sorted(jm)
        assert {"loss", "ce", "grad_norm", "lr"} <= set(tm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(jm[k], rel=RTOL,
                                                 abs=1e-12), (i, k)
        close_trained(ts.params, np_tree(js.params), f"step {i}",
                      lr=OPT["lr"], steps=1)
        close(ts.opt.m, np_tree(js.opt.m), f"m, step {i}", of_max=M_TOL)
        close(ts.opt.v, np_tree(js.opt.v), f"v, step {i}", of_max=V_TOL)
        assert int(ts.opt.step) == int(js.opt.step) == i + 1
        prev = convert.from_numpy(np_tree(js))
    ts = tsteps.TrainState(world["tparams"], tadamw.init(world["tparams"]))
    for i in range(steps):
        ts, tm = tstep(ts, world["tbatches"][i])
        for k in ("loss", "ce"):
            assert float(tm[k]) == pytest.approx(world["traj"][i][1][k],
                                                 rel=RTOL), (i, k)
    want = dict(leaves(np_tree(world["traj"][steps - 1][0].params)))
    for name, a in leaves(ts.params):
        d = float(np.abs(_np(a) - want[name]).max())
        assert d <= OPT["lr"] * steps, f"free run: {name} {d}"


def check_grad_accum(world) -> None:
    """``grad_accum`` 2 against the full batch (frontend states split
    with the tokens): the same metric keys, the loss within rtol 1e-5,
    the params after one step within ``close_trained``'s bounds."""
    b = world["tbatches"][0]
    out = {}
    for accum in (1, 2):
        api = tmodels.build(world["tcfg"].replace(grad_accum=accum))
        step = tsteps.make_train_step(api, tadamw.AdamWConfig(**OPT))
        st, m = step(tsteps.TrainState(world["tparams"],
                                       tadamw.init(world["tparams"])), b)
        out[accum] = st, m
    (s1, m1), (s2, m2) = out[1], out[2]
    assert sorted(m1) == sorted(m2)
    for k in ("loss", "ce", "grad_norm"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=RTOL), k
    close_trained(s2.params, convert.to_numpy(s1.params), "accum 2",
                  lr=OPT["lr"], steps=1)
    key = modality_key(world["tcfg"])
    if key is not None:
        assert b[key].shape[0] == 4


def check_remat(world, monkeypatch, n_checkpointed: int) -> None:
    """``remat`` runs ``n_checkpointed`` layers under
    ``torch.utils.checkpoint`` and leaves every gradient bitwise what it is
    without it."""
    real = torch.utils.checkpoint.checkpoint
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    grads = {}
    b = world["tbatches"][0]
    for remat in (True, False):
        calls[0] = 0
        api = tmodels.build(world["tcfg"].replace(remat=remat))
        (_, _), grads[remat] = tsteps.value_and_grad(
            lambda p: api.loss(p, b), world["tparams"])
        assert calls[0] == (n_checkpointed if remat else 0), remat
    for (name, a), (_, g) in zip(leaves(grads[True]), leaves(grads[False])):
        assert torch.equal(a, g), name


def check_fp32_leaves(world, fp32_names) -> None:
    """At bf16 every leaf of the port's params keeps the reference's
    dtype through a train step (the fp32 leaves named in
    ``fp32_names`` among them), m and v are fp32, and the fp32 leaves
    move."""
    jcfg = world["jcfg"].replace(dtype="bfloat16")
    want = {n: str(a.dtype) for n, a in leaves(jax.eval_shape(
        lambda: jmodels.build(jcfg).init(jax.random.key(0))))}
    assert {want[n] for n in fp32_names} == {"float32"}
    api = tmodels.build(world["tcfg"].replace(dtype="bfloat16"))
    params = api.init(seed=0, device="cpu")
    if world["tcfg"].cross_attn_every:
        for name, g in zip(("gate_attn", "gate_mlp"), GATES):
            params["cross_layers"][name].fill_(g)
    b = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
         for k, v in world["tbatches"][0].items()}
    step = tsteps.make_train_step(api, tadamw.AdamWConfig(**OPT))
    st, m = step(tsteps.TrainState(params, tadamw.init(params)), b)
    assert bool(torch.isfinite(m["loss"]))
    got = dict(leaves(st.params))
    assert {n: str(a.dtype).removeprefix("torch.") for n, a in got.items()} \
        == want
    before = dict(leaves(params))
    for n in fp32_names:
        assert not torch.equal(got[n], before[n]), n
    for tree in (st.opt.m, st.opt.v):
        assert {a.dtype for _, a in leaves(tree)} == {torch.float32}


# ---------------------------------------------------------------------------
# the launcher and TrainState checkpoints across packages
# ---------------------------------------------------------------------------

def check_launcher_stream(world, monkeypatch) -> None:
    """The launcher's synthetic stream: batch i is ``with_modality(
    pipe.get(i), cfg, seed, i)``, frontend states included."""
    seen = []
    real = tsteps.make_train_step

    def make(api, opt_cfg, *, masks=None):
        step = real(api, opt_cfg, masks=masks)

        def wrapped(state, batch):
            seen.append(batch)
            return step(state, batch)

        return wrapped

    monkeypatch.setattr(tlaunch.steps_lib, "make_train_step", make)
    cfg = world["tcfg"]
    out = tlaunch.train(world["arch"], tiny=True, n_steps=2, batch=2,
                        seq=16, seed=3, device="cpu", verbose=False)
    assert len(out["losses"]) == 2
    assert all(np.isfinite(x) for x in out["losses"])
    pipe = tsynthetic.DataPipeline(tsynthetic.CorpusConfig(cfg.vocab_size,
                                                           seed=3),
                                   2, 16, split="train")
    key = modality_key(cfg)
    for i, b in enumerate(seen):
        want = tsynthetic.with_modality(pipe.get(i), cfg, 3, i)
        assert sorted(b) == sorted(want)
        assert (key in b) == (key is not None)
        for k in want:
            assert torch.equal(b[k], want[k]), (i, k)


def _run(world, path, n_steps):
    return tlaunch.train(world["arch"], tiny=True, n_steps=n_steps,
                         ckpt_dir=str(path), ckpt_every=2, device="cpu",
                         batches=world["tbatches"], verbose=False)


def check_preempt_resume(world, tmp_path, monkeypatch) -> None:
    full = _run(world, tmp_path / "a", 4)
    real = tsteps.make_train_step

    def make(api, opt_cfg, *, masks=None):
        step, calls = real(api, opt_cfg, masks=masks), [0]

        def wrapped(state, batch):
            out = step(state, batch)
            calls[0] += 1
            if calls[0] == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    with monkeypatch.context() as mp:
        mp.setattr(tlaunch.steps_lib, "make_train_step", make)
        cut = _run(world, tmp_path / "b", 4)
    assert cut["final_step"] == 1 and tckpt.steps(tmp_path / "b") == [1]
    resumed = _run(world, tmp_path / "b", 4)
    assert resumed["start_step"] == 1 and resumed["final_step"] == 4
    assert cut["losses"] + resumed["losses"] == full["losses"]
    bitwise(full["state"], resumed["state"], "resumed")


def check_trainstate_across_packages(world, tmp_path, paths) -> None:
    """The reference's TrainState one step in (``jckpt.save``) restores
    bitwise in the port (its leaf paths include ``paths``) and trains on
    to the reference's next step; ``convert`` carries it both ways; the
    port's checkpoint restores bitwise in the reference."""
    js = world["traj"][0][0]
    jckpt.save(tmp_path / "j", 1, js)
    like = tsteps.init_state(world["tapi"], device="cpu")
    ts, man = tckpt.restore_like(tmp_path / "j", 1, like)
    assert set(paths) <= {e["path"] for e in man["leaves"]}
    want = convert.from_numpy(np_tree(js))
    assert isinstance(want, tsteps.TrainState)
    bitwise(ts, want, "restored")
    back = convert.to_numpy(ts)
    for (n, a), (_, b) in zip(leaves(back["params"]),
                              leaves(np_tree(js.params))):
        assert np.array_equal(a, b), n
    tstep = tsteps.make_train_step(world["tapi"], tadamw.AdamWConfig(**OPT))
    ts2, tm = tstep(ts, world["tbatches"][1])
    js2, jm = world["traj"][1]
    assert float(tm["loss"]) == pytest.approx(jm["loss"], rel=RTOL)
    close_trained(ts2.params, np_tree(js2.params), "resumed step",
                  lr=OPT["lr"], steps=2)
    tckpt.save(tmp_path / "t", 2, ts2)
    target = jax.eval_shape(lambda: jsteps.init_state(world["japi"],
                                                      jax.random.key(0)))
    jback, _ = jckpt.restore(tmp_path / "t", 2, target)
    bitwise(convert.from_numpy(np_tree(jback)), ts2, "back in the reference")


# ---------------------------------------------------------------------------
# recovery, export, the CLI
# ---------------------------------------------------------------------------

def spec(select, steps=STEPS, **kw):
    kw = dict(select=select, steps=steps, lr=LR, batch_size=2, seq_len=32,
              lora_rank=2, **kw)
    return jrecover.RecoverSpec(**kw), trecover.RecoverSpec(**kw)


def check_selections(world, *, raises=(), never=()) -> None:
    """``raises``: both packages refuse those selections; no selection
    holds a leaf whose last key starts with one of ``never``; the norm
    and bias selections pick the reference's leaves (``check_recover``
    holds every selection's trainable names against the reference's)."""
    for select in SELECTIONS:
        js, ts = spec(select)
        if select in raises:
            for mod, params, masks, s in (
                    (jrecover, world["jmasked"], world["nmasks"], js),
                    (trecover, world["tmasked"], world["tmasks"], ts)):
                with pytest.raises(ValueError, match="matched no params"):
                    mod.build_selection(params, masks, s)
            continue
        tsel = trecover.build_selection(world["tmasked"], world["tmasks"],
                                        ts)
        if select not in ("all_masked", "lora"):
            jsel = jrecover.build_selection(world["jmasked"],
                                            world["nmasks"], js)
            assert sorted(tsel.trainable) == sorted(jsel.trainable), select
        last = {n.rsplit(".", 1)[-1] for n in tsel.trainable}
        assert not any(k.startswith(tuple(never)) for k in last), select


def _selection_key(world, select):
    """A selection's trainable leaves: with no checkpoint directory a
    selection acts on ``recover`` only through the leaves it picks (the
    VLM's ``norms_biases`` picks ``norms``'s)."""
    if select in ("all_masked", "lora"):
        return select
    return tuple(sorted(jrecover.build_selection(
        world["jmasked"], world["nmasks"], spec(select)[0]).trainable))


def _reference_recover(world, select):
    """The reference's ``recover`` on the world's batches, once for each
    set of trainable leaves."""
    key = _selection_key(world, select)
    memo = world.setdefault("recovered", {})
    if key not in memo:
        memo[key] = jrecover.recover(world["japi"], world["jmasked"],
                                     world["nmasks"], spec(select)[0],
                                     batches=world["pool"])
    return memo[key]


def check_recover(world, select, *, per_coordinate: bool = True) -> None:
    """``recover`` against the reference's on the same batches: counts,
    trainable names, CE history within rtol 1e-5, the params within
    ``close_trained``'s bounds, pruned coordinates exactly 0.0; a LoRA
    adapter carries its weight's stack dims. Without ``per_coordinate``
    the params are held within lr·steps everywhere only: a free run of
    AdamW steps (see ``check_train_step``)."""
    _, ts = spec(select)
    want = _reference_recover(world, select)
    got = tpruning.recover(world["tapi"], world["tmasked"], world["tmasks"],
                           ts, batches=world["tpool"])
    assert (got.trainable_count, got.total_count) == (
        want.trainable_count, want.total_count)
    assert sorted(dict(leaves(got.trainable))) == sorted(
        dict(leaves(np_tree(want.trainable))))
    assert got.steps_run == want.steps_run == STEPS and not got.diverged
    np.testing.assert_allclose(got.ce_history, want.ce_history, rtol=RTOL)
    if per_coordinate:
        close_trained(got.params, np_tree(want.params), f"recover({select})",
                      lr=LR, steps=STEPS)
    else:
        wp = dict(leaves(np_tree(want.params)))
        for name, a in leaves(got.params):
            d = float(np.abs(_np(a) - wp[name]).max())
            assert d <= LR * STEPS, f"recover({select}): {name} {d}"
    flat = dict(leaves(got.params))
    if select in ("all_masked", "lora"):
        for name, m in leaves(world["tmasks"]):
            assert not bool(flat[name][m == 0].any()), name
    if select == "lora":
        for name, ab in got.trainable.items():
            stack = flat[name].shape[:-2]
            assert ab["a"].shape[:-2] == ab["b"].shape[:-2] == stack, name


def check_recover_refused(world, select) -> None:
    """Both packages' ``recover`` refuse a selection that picks nothing."""
    js, ts = spec(select)
    with pytest.raises(ValueError, match="matched no params"):
        jrecover.recover(world["japi"], world["jmasked"], world["nmasks"],
                         js, batches=world["pool"])
    with pytest.raises(ValueError, match="matched no params"):
        tpruning.recover(world["tapi"], world["tmasked"], world["tmasks"],
                         ts, batches=world["tpool"])


def prompt(cfg, batch=2, n=8):
    pipe = tsynthetic.DataPipeline(tsynthetic.CorpusConfig(cfg.vocab_size),
                                   batch, n, split="val")
    return tsynthetic.with_modality(pipe.get(0), cfg, 0, 0)


def check_export(world, fmt, tmp_path) -> None:
    """all_masked recovery at 2:4, then ``export_packed``: the export
    (read back by ``load_masks_and_weights`` and by ``load_packed_tree``)
    serves the in-process recovered model's greedy tokens; the reference
    reads the same export: its masks, weights and packed values / idx
    bitwise the port's (``check_reference_export`` reads the other way)."""
    api, cfg = world["tapi"], world["tcfg"]
    plan = tpruning.plan_pruning(api, world["tparams"],
                                 tpruning.PruneRecipe.single(
                                     tmasks.NM(2, 4), method="none",
                                     recover=spec("all_masked")[1]))
    ex = tpruning.PruneExecutor(api, world["tparams"], plan)
    rep = ex.run(world["tpool"])
    ex.recover(batches=world["tpool"])
    out = ex.export_packed(tmp_path / fmt, fmt)
    p = prompt(cfg)
    want = ServeEngine(api, rep.updated_params, masks=rep.masks, fmt=fmt,
                       device="cpu").generate(p, 5).tokens
    masks, params = tpacked.load_masks_and_weights(cfg, world["tparams"], out)
    bitwise(masks, rep.masks, "masks")
    bitwise(params, rep.updated_params, "weights")
    via = ServeEngine(api, params, masks=masks, fmt=fmt,
                      device="cpu").generate(p, 5).tokens
    assert torch.equal(via, want)
    tree = tpacked.load_packed_tree(world["tparams"], out)
    assert torch.equal(tsteps.greedy_decode(api, tree, p, 5), want)
    jmasks, jweights = jpacked.load_masks_and_weights(
        world["jcfg"], world["jparams"], out)
    bitwise(convert.from_numpy(np_tree(jmasks)), rep.masks, "reference masks")
    bitwise(convert.from_numpy(np_tree(jweights)), rep.updated_params,
            "reference weights")
    jtree = jpacked.load_packed_tree(world["jparams"], out)
    for name, leaf in leaves(tree):
        if isinstance(leaf, tpacked.PackedWeight):
            node = jtree
            for k in name.split("."):
                node = node[k]
            assert np.array_equal(np.asarray(node.values, np.float32),
                                  _np(leaf.values)), name
            assert np.array_equal(np.asarray(node.idx), leaf.idx.numpy()), \
                name


def check_reference_export(world, tmp_path) -> None:
    """The reference's ``PruneExecutor`` (Wanda 2:4 on the port's
    calibration Grams) exports nm24; the port reads it: its masks bitwise
    the reference's, and the packed tree it loads serves the greedy tokens
    of the port's own engine on the masks it read."""
    api, cfg = world["tapi"], world["tcfg"]
    taps = convert.to_numpy(tpruning.accumulate(api, world["tparams"],
                                                world["tpool"]))
    if cfg.family == "hybrid":
        # the reference sums a stack of the shared block's taps (zeros at
        # the layers it skips); the port hands over the sum: a stack of one
        taps["shared"] = jax.tree.map(lambda a: a[None], taps["shared"])
    plan = jpruning.plan_pruning(world["japi"], world["jparams"],
                                 jpruning.PruneRecipe.single(
                                     jmasks.NM(2, 4), method="none"))
    ex = jpruning.PruneExecutor(world["japi"], world["jparams"], plan,
                                taps=jax.tree.map(jnp.asarray, taps))
    rep = ex.run()
    out = ex.export_packed(tmp_path / "reference", "nm24")
    masks, params = tpacked.load_masks_and_weights(cfg, world["tparams"],
                                                   out)
    bitwise(masks, convert.from_numpy(np_tree(rep.masks)), "masks")
    p = prompt(cfg)
    want = ServeEngine(api, params, masks=masks, fmt="nm24",
                       device="cpu").generate(p, 5).tokens
    tree = tpacked.load_packed_tree(world["tparams"], out)
    assert torch.equal(tsteps.greedy_decode(api, tree, p, 5), want)


def check_cli(world, tmp_path, capsys, select) -> None:
    """``launch.train`` -> ``launch.prune --from-ckpt --recover`` (resumed
    on a rerun) -> ``launch.serve --masks-from --from-ckpt``: the served
    tokens are the export's in-process ones."""
    arch = world["arch"]
    run = tmp_path / "train"
    tlaunch.main(["--arch", arch, "--tiny", "--device", "cpu", "--steps",
                  "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
                  str(run), "--ckpt-every", "1"])
    out = tmp_path / "prune"
    argv = ["--arch", arch, "--tiny", "--device", "cpu", "--sparsity", "2:4",
            "--t-max", "2", "--n-calib", "4", "--out-dir", str(out),
            "--from-ckpt", str(run), "--recover", select,
            "--recover-steps", "4", "--calib-ckpt-every", "2"]
    tprune.main(argv)
    text = capsys.readouterr().out
    assert f"recovery (PERP): select={select} steps=4" in text
    doc = json.loads((out / "report.json").read_text())
    assert doc["recovery"]["steps_run"] == 4
    tprune.main(argv)
    assert "recover: resumed at step 4" in capsys.readouterr().out
    assert json.loads((out / "report.json").read_text())["recovered"] == \
        doc["recovered"]
    api = world["tapi"]
    trained = tsteps.restore_params(api, run, device="cpu")
    masks, params = tpacked.load_masks_and_weights(api.cfg, trained, out)
    changed = [n for (n, a), (_, b) in zip(leaves(params), leaves(trained))
               if not torch.equal(a, b)]
    assert changed
    served = tserve.serve(arch, tiny=True, batch=2, prompt_len=8, gen=4,
                          masks_from=str(out), fmt="gathered",
                          from_ckpt=str(run), device="cpu", verbose=False)
    want = ServeEngine(api, params, masks=masks, fmt="gathered",
                       device="cpu").generate(prompt(api.cfg), 4).tokens
    assert torch.equal(served["tokens"], want)
