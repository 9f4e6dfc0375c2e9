"""The port's post-prune recovery (PERP), export and serving splice vs the
reference's, on tiny llama31-8b (fp32, 2 layers, d_model 64).

The reference initialises the params, samples the batches and prunes
(Wanda 2:4); params, masks and batches reach the port through numpy.
Checked:

* ``recover`` for every selection — ``norms``, ``all_masked`` and
  ``lora`` on llama31-8b; ``biases`` and ``norms_biases`` on a layernorm
  variant of it (the five dense configs are rmsnorm and their only biases
  are chatglm3's ``bq`` / ``bk`` / ``bv``, so ``biases`` raises
  ``ValueError`` there, in both packages): the trainable leaves and
  counts equal, per-step CE within rtol 1e-5, recovered leaves within
  1e-6 + 1e-5 of their size but at 1 in 1000 coordinates, which stay
  within lr per step (Adam's step direction at a gradient within a few
  eps of zero follows its rounding). LoRA's adapters are drawn as the
  reference draws them (threefry2x32 bitwise, erfinv to a few ulps);
* the mask invariant bitwise: pruned coordinates are exactly 0 in the
  recovered weights and in ``m`` / ``v`` of the recovery checkpoint;
* resume: a finished run restores and runs nothing, a run cut after
  step 4 resumes there bitwise, another spec never restores; the port
  resumes the reference's recovery checkpoint; both divergence paths;
* the plan's recovery block reads as the reference's;
* ``export_packed`` -> ``--masks-from``: the ``weights/`` splice, the
  executor's ``groups/`` root and the ``packed/`` tree serve the
  in-process recovered model's greedy tokens; each package reads the
  other's export bitwise; the CLI's ``--from-ckpt``, ``--recover`` and
  resume, then ``launch.serve --masks-from``.
"""
import importlib
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import packed as jpacked  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.launch import prune as tprune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

# the package re-exports the function ``recover`` under the submodule's name
jrecover_mod = importlib.import_module("repro.pruning.recover")
trecover_mod = importlib.import_module("repro_torch.pruning.recover")
ARCH = "llama31-8b"
RTOL = 1e-5
LR = 5e-3


def _world(jcfg, tcfg):
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    calib = list(jpruning.calibration_batches(jcfg, n_samples=2, seq_len=16,
                                              batch_size=2, seed=0))
    rep = jpruning.prune_model(japi, jparams, calib, jmasks.NM(2, 4),
                               method="none", t_max=3)
    jmp = jadamw.apply_masks(jparams, rep.masks)
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   2, 32, split="calib")
    pool = [jax.tree.map(np.asarray, pipe.get(i)) for i in range(2)]
    return dict(japi=japi, jparams=jmp, jmasks=rep.masks, pool=pool,
                tapi=tmodels.build(tcfg), tparams=_t(jmp),
                tmasks=_t(rep.masks),
                tpool=[convert.from_numpy(b) for b in pool])


def _t(tree):
    return convert.from_numpy(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def world():
    return _world(jconfigs.get_tiny(ARCH), tconfigs.get_tiny(ARCH))


@pytest.fixture(scope="module")
def ln_world():
    """llama31-8b with layernorm: norm scales and biases to select."""
    return _world(jconfigs.get_tiny(ARCH).replace(norm="layernorm"),
                  tconfigs.get_tiny(ARCH).replace(norm="layernorm"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_trained(got, want, what, *, steps, lr=LR):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        a, b = _np(g[name]), _np(w[name])
        d = np.abs(a - b)
        assert d.max() <= lr * steps, f"{what}: {name} {d.max()}"
        assert np.mean(d > 1e-6 + RTOL * np.abs(b)) <= 1e-3, f"{what}: {name}"


def _spec(select, steps=4, **kw):
    kw = dict(select=select, steps=steps, lr=LR, batch_size=2, seq_len=32,
              lora_rank=2, **kw)
    return jrecover_mod.RecoverSpec(**kw), tpruning.RecoverSpec(**kw)


def _assert_pruned_zero(tree, masks, what):
    flat = dict(_leaves(tree))
    for name, m in _leaves(masks):
        leaf = flat[name]
        assert not bool(leaf[m == 0].any()), f"{what}: {name}"


# ---------------------------------------------------------------------------
# recover() against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select,which", [
    ("norms", "world"), ("all_masked", "world"), ("lora", "world"),
    ("biases", "ln_world"), ("norms_biases", "ln_world")])
def test_recover_matches_reference(select, which, request):
    w = request.getfixturevalue(which)
    js, ts = _spec(select)
    want = jrecover_mod.recover(w["japi"], w["jparams"], w["jmasks"], js,
                                batches=w["pool"])
    got = tpruning.recover(w["tapi"], w["tparams"], w["tmasks"], ts,
                           batches=w["tpool"])
    assert js.fingerprint() == ts.fingerprint()
    assert (got.trainable_count, got.total_count) == (
        want.trainable_count, want.total_count)
    assert sorted(dict(_leaves(got.trainable))) == sorted(
        dict(_leaves(jax.tree.map(np.asarray, want.trainable))))
    assert got.steps_run == want.steps_run == 4 and not got.diverged
    np.testing.assert_allclose(got.ce_history, want.ce_history, rtol=RTOL)
    _close_trained(got.params, jax.tree.map(np.asarray, want.params),
                   f"recover({select})", steps=4)
    if select == "lora":
        # the draw: a is 0.01 · N(0, 1) from fold_in(key(seed), i)
        sel = trecover_mod.build_selection(w["tparams"], w["tmasks"], ts)
        jsel = jrecover_mod.build_selection(w["jparams"], w["jmasks"], js)
        for name, ab in sel.trainable.items():
            np.testing.assert_allclose(
                ab["a"].numpy(), np.asarray(jsel.trainable[name]["a"]),
                rtol=1e-5, atol=1e-9, err_msg=name)
    if select in ("all_masked", "lora"):
        _assert_pruned_zero(got.params, w["tmasks"], select)


def test_biases_on_rmsnorm_raises_like_reference():
    jcfg, tcfg = jconfigs.get_tiny("chatglm3-6b"), tconfigs.get_tiny(
        "chatglm3-6b")
    jparams = jmodels.build(jcfg).init(jax.random.key(0))
    js, ts = _spec("biases")
    with pytest.raises(ValueError, match="matched no params"):
        jrecover_mod.build_selection(jparams, {}, js)
    with pytest.raises(ValueError, match="matched no params"):
        trecover_mod.build_selection(_t(jparams), {}, ts)
    # on a mesh too, before any sharding or collective
    with pytest.raises(ValueError, match="matched no params"):
        tpruning.recover(tmodels.build(tcfg), _t(jparams), {}, ts,
                         mesh=object())


def test_mask_invariant_in_weights_and_moments(world, tmp_path):
    """all_masked from UNmasked weights with weight decay: pruned
    coordinates exactly 0 in the recovered weights and in the saved m
    and v."""
    _, ts = _spec("all_masked", steps=3, weight_decay=0.1)
    params = _t(world["japi"].init(jax.random.key(0)))
    res = tpruning.recover(world["tapi"], params, world["tmasks"], ts,
                           batches=world["tpool"], ckpt_dir=tmp_path,
                           checkpoint_every=3)
    _assert_pruned_zero(res.params, world["tmasks"], "params")
    state = tckpt.unflatten(tckpt.restore(tmp_path / "recover", 3)[0])
    flat_masks = dict(_leaves(world["tmasks"]))
    for part in ("m", "v"):
        for name, leaf in state[".opt"][f".{part}"].items():
            assert not bool(leaf[flat_masks[name] == 0].any()), (part, name)
    # the masked train step keeps it too (weight decay on, unmasked start)
    step = tsteps.make_train_step(world["tapi"], tadamw.AdamWConfig(
        lr=1e-3, weight_decay=0.1), masks=world["tmasks"])
    st = tsteps.TrainState(params, tadamw.init(params))
    for b in world["tpool"]:
        st, m = step(st, b)
        assert bool(torch.isfinite(m["loss"]))
    for tree in (st.params, st.opt.m, st.opt.v):
        _assert_pruned_zero(tree, world["tmasks"], "train step")


# ---------------------------------------------------------------------------
# checkpoint / resume / divergence
# ---------------------------------------------------------------------------

def _run(world, spec, tmp_path):
    return tpruning.recover(world["tapi"], world["tparams"], world["tmasks"],
                            spec, ckpt_dir=tmp_path, checkpoint_every=2)


def _assert_same(a, b, what):
    for (n, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), f"{what}: {n}"


def test_recover_resume_bitwise(world, tmp_path, capsys):
    _, ts = _spec("norms", steps=6)
    r1 = _run(world, ts, tmp_path)
    assert r1.start_step == 0 and r1.steps_run == 6
    assert tckpt.steps(tmp_path / "recover") == [4, 6]      # gc keeps 2
    r2 = _run(world, ts, tmp_path)
    assert r2.start_step == 6 and r2.steps_run == 0
    shutil.rmtree(tmp_path / "recover" / "step_00000006")
    r3 = tpruning.recover(world["tapi"], world["tparams"], world["tmasks"],
                          ts, ckpt_dir=tmp_path, checkpoint_every=2,
                          verbose=True)
    assert "recover: resumed at step 4" in capsys.readouterr().out
    assert r3.start_step == 4 and r3.steps_run == 2
    _assert_same(r1.params, r2.params, "restore-only")
    _assert_same(r1.params, r3.params, "mid-run resume")
    _, other = _spec("norms", steps=6, seed=1)
    r4 = _run(world, other, tmp_path)
    assert r4.start_step == 0 and r4.steps_run == 6


def test_port_resumes_reference_recovery(world, tmp_path):
    js, ts = _spec("norms", steps=6)
    want = jrecover_mod.recover(world["japi"], world["jparams"],
                                world["jmasks"], js, ckpt_dir=tmp_path,
                                checkpoint_every=2, batches=world["pool"])
    shutil.rmtree(tmp_path / "recover" / "step_00000006")
    got = tpruning.recover(world["tapi"], world["tparams"], world["tmasks"],
                           ts, ckpt_dir=tmp_path, checkpoint_every=2,
                           batches=world["tpool"])
    assert got.start_step == 4 and got.steps_run == 2
    np.testing.assert_allclose(got.ce_history, want.ce_history[4:],
                               rtol=RTOL)
    _close_trained(got.params, jax.tree.map(np.asarray, want.params),
                   "resumed from the reference", steps=2)


def _nan_after(n_calls: int):
    real = trecover_mod._make_step

    def make(api, masks, sel, opt_cfg):
        step, calls = real(api, masks, sel, opt_cfg), [0]

        def wrapped(base, state, batch):
            state, m = step(base, state, batch)
            calls[0] += 1
            if calls[0] >= n_calls:
                state = steps_nan(state)
                m = {**m, "ce": torch.tensor(float("nan"))}
            return state, m

        return wrapped

    return make


def steps_nan(state):
    nan = lambda t: t * float("nan")  # noqa: E731
    return tsteps.TrainState(
        tadamw.tree_map(nan, state.params),
        tadamw.AdamWState(tadamw.tree_map(nan, state.opt.m),
                          tadamw.tree_map(nan, state.opt.v), state.opt.step))


def test_divergence_restores_checkpoint_or_returns_base(world, tmp_path,
                                                       monkeypatch):
    _, ts = _spec("norms", steps=6)
    monkeypatch.setattr(trecover_mod, "_make_step", _nan_after(5))
    res = _run(world, ts, tmp_path)
    assert res.diverged and res.steps_run == 4 and len(res.ce_history) == 4
    for tree in (res.params, res.trainable):
        for name, leaf in _leaves(tree):
            assert bool(torch.isfinite(leaf).all()), name
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(world["tparams"]), _leaves(res.params)))
    # no checkpoint to fall back to: the base tree, untouched
    monkeypatch.setattr(trecover_mod, "_make_step", _nan_after(2))
    res = tpruning.recover(world["tapi"], world["tparams"], world["tmasks"],
                           _spec("norms", steps=4)[1])
    assert res.diverged and res.trainable == {} and res.steps_run == 1
    _assert_same(world["tparams"], res.params, "base")


def test_plan_describes_recovery_like_reference(world):
    js, ts = _spec("lora")
    jplan = jpruning.plan_pruning(world["japi"], world["jparams"],
                                  jpruning.PruneRecipe.single(
                                      jmasks.NM(2, 4), recover=js))
    tplan = tpruning.plan_pruning(world["tapi"], world["tparams"],
                                  tpruning.PruneRecipe.single(
                                      tmasks.NM(2, 4), recover=ts))
    assert tplan.recover == ts
    tail = lambda text: text.splitlines()[-2:]  # noqa: E731
    assert tail(tplan.describe()) == tail(jplan.describe())
    assert tail(tplan.describe())[0].startswith("recovery (PERP): select=lora")


# ---------------------------------------------------------------------------
# export -> serve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Port-native tiny run: sparsegpt 2:4 + norms recovery, exported in
    both formats; the pre-recovery weights kept for the groups/ check."""
    d = tmp_path_factory.mktemp("export")
    cfg = tconfigs.get_tiny(ARCH)
    api = tmodels.build(cfg)
    params = api.init(seed=0, device="cpu")
    batches = list(tpruning.calibration_batches(
        cfg, n_samples=4, seq_len=32, batch_size=2, device="cpu"))
    plan = tpruning.plan_pruning(api, params, tpruning.PruneRecipe.single(
        tmasks.NM(2, 4), method="sparsegpt", t_max=3,
        recover=_spec("norms")[1]))
    ex = tpruning.PruneExecutor(api, params, plan, ckpt_dir=d / "ck")
    rep = ex.run(batches)
    refined = rep.updated_params
    ex.recover()
    outs = {fmt: ex.export_packed(d / fmt, fmt) for fmt in ("nm24",
                                                            "gathered")}
    return dict(api=api, cfg=cfg, params=params, rep=rep, refined=refined,
                outs=outs, ck=d / "ck")


def _prompt(cfg, seed=0):
    from repro_torch.data import synthetic
    return synthetic.DataPipeline(synthetic.CorpusConfig(cfg.vocab_size,
                                                         seed=seed),
                                  2, 8, split="val").get(0)


@pytest.mark.parametrize("source", ["weights", "groups", "packed"])
def test_export_serves_recovered_tokens(exported, source):
    e = exported
    api, cfg, params, rep = e["api"], e["cfg"], e["params"], e["rep"]
    prompt = _prompt(cfg)
    for fmt, out in e["outs"].items():
        if source == "groups":
            # the executor's own checkpoints: masks + sparsegpt's weights
            want_params = e["refined"]
            masks, spliced = tpacked.load_masks_and_weights(cfg, params,
                                                            e["ck"])
        else:
            want_params = rep.updated_params
            masks, spliced = tpacked.load_masks_and_weights(cfg, params, out)
        _assert_same(masks, rep.masks, f"{source} masks")
        _assert_same(spliced, want_params, f"{source} weights")
        direct = ServeEngine(api, want_params, masks=rep.masks, fmt=fmt,
                             device="cpu").generate(prompt, 6).tokens
        if source == "packed":
            # the packed sites over the spliced tree: no re-pack
            tree = tpacked.load_packed_tree(spliced, out)
            mem = tpacked.pack_tree(cfg, rep.updated_params, rep.masks, fmt)
            for (n, a), (_, b) in zip(_leaves(tree), _leaves(mem)):
                if isinstance(b, tpacked.PackedWeight):
                    assert (a.fmt, a.d_in, a.n, a.m) == (b.fmt, b.d_in, b.n,
                                                         b.m), n
                    assert torch.equal(a.values, b.values) and torch.equal(
                        a.idx, b.idx), n
                else:
                    assert torch.equal(a, b), n
            via = tsteps.greedy_decode(api, tree, prompt, 6)
        else:
            src = out if source == "weights" else e["ck"]
            via = ServeEngine(api, params, masks=src, fmt=fmt,
                              device="cpu").generate(prompt, 6).tokens
        assert torch.equal(direct, via), (source, fmt)


def test_exports_read_across_packages(world, tmp_path):
    """Each package's export, read by the other's loader, gives the
    writer's recovered tree and masks bitwise."""
    js, ts = _spec("norms")
    jplan = jpruning.plan_pruning(world["japi"], world["jparams"],
                                  jpruning.PruneRecipe.single(
                                      jmasks.NM(2, 4), method="none",
                                      recover=js))
    calib = world["pool"]
    jex = jpruning.PruneExecutor(world["japi"], world["jparams"], jplan)
    jex.run(calib)
    jex.recover(batches=calib)
    jex.export_packed(tmp_path / "j", "nm24")
    tplan = tpruning.plan_pruning(world["tapi"], world["tparams"],
                                  tpruning.PruneRecipe.single(
                                      tmasks.NM(2, 4), method="none",
                                      recover=ts))
    tex = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan)
    trep = tex.run(world["tpool"])
    tex.recover(batches=world["tpool"])
    tex.export_packed(tmp_path / "t", "nm24")
    cfg, jcfg = world["tapi"].cfg, world["japi"].cfg
    masks, params = tpacked.load_masks_and_weights(cfg, world["tparams"],
                                                   tmp_path / "j")
    _assert_same(params, _t(jex._last_report.updated_params), "port reads")
    _assert_same(masks, _t(jex._last_report.masks), "port reads masks")
    jm, jp = jpacked.load_masks_and_weights(jcfg, world["jparams"],
                                            tmp_path / "t")
    _assert_same(_t(jp), trep.updated_params, "reference reads")
    jtree = jpacked.load_packed_tree(world["jparams"], tmp_path / "t")
    ttree = tpacked.pack_tree(cfg, trep.updated_params, trep.masks, "nm24")
    for (n, a), (_, b) in zip(_leaves(jtree), _leaves(ttree)):
        if isinstance(b, tpacked.PackedWeight):
            assert np.array_equal(np.asarray(a.values), b.values.numpy())
            assert np.array_equal(np.asarray(a.idx), b.idx.numpy()), n


def test_cli_train_prune_recover_resume_serve(tmp_path, capsys):
    run = tmp_path / "train"
    tlaunch.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--steps",
                  "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
                  str(run), "--ckpt-every", "1"])
    out = tmp_path / "prune"
    argv = ["--arch", ARCH, "--tiny", "--device", "cpu", "--sparsity", "2:4",
            "--t-max", "2", "--n-calib", "4", "--out-dir", str(out),
            "--from-ckpt", str(run), "--recover", "norms",
            "--recover-steps", "4", "--calib-ckpt-every", "2"]
    tprune.main(argv)
    text = capsys.readouterr().out
    assert "recovery (PERP): select=norms steps=4" in text
    assert "recovered (norms, 4 steps" in text
    doc = json.loads((out / "report.json").read_text())
    assert {"recovered", "recovery"} <= set(doc)
    assert doc["recovery"]["steps_run"] == 4 and not doc["recovery"][
        "diverged"]
    assert doc["recovery"]["spec"]["batch_size"] == 4      # calib batch
    assert tckpt.steps(out / "weights") == [0]
    # the trained params were pruned, not the seeded init
    api = tmodels.build(tconfigs.get_tiny(ARCH))
    trained = tsteps.restore_params(api, run, device="cpu")
    fresh = api.init(seed=0, device="cpu")
    assert not torch.equal(trained["embed"], fresh["embed"])
    tprune.main(argv)
    text = capsys.readouterr().out
    assert "recover: resumed at step 4" in text
    doc2 = json.loads((out / "report.json").read_text())
    assert doc2["recovered"] == doc["recovered"]
    served = tserve.serve(ARCH, tiny=True, batch=2, prompt_len=8, gen=4,
                          masks_from=str(out), fmt="nm24",
                          from_ckpt=str(run), device="cpu", verbose=False)
    masks, params = tpacked.load_masks_and_weights(api.cfg, trained, out)
    prompt = _prompt(api.cfg)
    want = ServeEngine(api, params, masks=masks, fmt="nm24",
                       device="cpu").generate(prompt, 4).tokens
    assert torch.equal(served["tokens"], want)
    assert not torch.equal(params["ln_f"]["scale"], trained["ln_f"]["scale"])
    tserve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--masks-from",
                 str(out), "--from-ckpt", str(run), "--format", "gathered",
                 "--gen", "3"])
    assert "format=gathered" in capsys.readouterr().out
