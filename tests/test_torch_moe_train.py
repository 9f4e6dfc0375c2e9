"""Training and post-prune recovery of the port's MoE family (mixtral-8x7b,
granite-moe-3b-a800m) against the reference, on their TINYs (fp32).

The reference initialises the params and samples the batches; the masks
are Wanda 2:4 on every site (attention and each expert of w_gate, w_up,
w_down; the router is never a site), from the port's calibration. All of
it reaches the other package through numpy. Checked:

* the train step against the reference's at ``grad_accum`` 1 and 2 (the
  TINYs' own is 2): the loss is ce + aux, the metric keys are the same in
  both packages and at both accumulations, ``aux`` among them (the mean
  over microbatches); losses within rtol 1e-5, params, ``m`` and ``v`` as
  ``test_torch_train.py`` bounds them; ``remat`` leaves the gradients
  bitwise unchanged;
* the MoE backward's dispatch is a broadcast (no ``index_select`` by
  token, whose backward is an atomic ``index_add`` on the card);
* masked AdamW with weight decay from unmasked params (the counterpart
  of ``tests/test_recover.py``'s mixtral case): pruned coordinates of the
  (L, E, f, d) expert leaves are exactly 0.0 in params, ``m`` and ``v``;
  the fp32 router moves and is never masked;
* the train launcher: SIGTERM, then a resume bitwise; a TrainState with
  expert stacks and an fp32 router written by either package resumes in
  the other;
* ``recover`` with ``norms``, ``all_masked`` and ``lora`` (adapters per
  expert over the (L, E) stacked leaves) against the reference; the
  selections of ``biases`` (raises: rmsnorm, no biases) and
  ``norms_biases`` as the reference builds them;
* ``export_packed`` holds packed (L, E, ...) expert leaves and serves the
  recovered model's greedy tokens in nm24 and gathered; the CLI trains,
  prunes ``--from-ckpt`` with ``--recover lora``, resumes and serves.
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

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

jrecover_mod = importlib.import_module("repro.pruning.recover")
MOE = ["mixtral-8x7b", "granite-moe-3b-a800m"]
RTOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LR = 5e-3


def _t(tree):
    return convert.from_numpy(jax.tree.map(np.asarray, tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what, *, atol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        np.testing.assert_allclose(_np(g[name]), _np(w[name]), rtol=RTOL,
                                   atol=atol, err_msg=f"{what}: {name}")


def _close_trained(got, want, what, *, lr, steps):
    """Within 1e-6 + RTOL·|want| but at 1 in 1000 coordinates a leaf, and
    everywhere within lr·steps (``test_torch_train._close_trained``)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        a, b = _np(g[name]), _np(w[name])
        d = np.abs(a - b)
        assert d.max() <= lr * steps, f"{what}: {name} {d.max()}"
        assert np.mean(d > 1e-6 + RTOL * np.abs(b)) <= 1e-3, f"{what}: {name}"


def _assert_pruned_zero(tree, masks, what):
    flat = dict(_leaves(tree))
    for name, m in _leaves(masks):
        assert not bool(flat[name][m == 0].any()), f"{what}: {name}"


@pytest.fixture(scope="module", params=MOE)
def world(request):
    arch = request.param
    jcfg, tcfg = jconfigs.get_tiny(arch), tconfigs.get_tiny(arch)
    japi, tapi = jmodels.build(jcfg), tmodels.build(tcfg)
    jparams = japi.init(jax.random.key(0))
    tparams = _t(jparams)
    calib = list(tpruning.calibration_batches(
        tcfg, n_samples=2, seq_len=16, batch_size=2, device="cpu"))
    rep = tpruning.prune_model(tapi, tparams, calib, tmasks.NM(2, 4),
                               method="none")
    tmasks_ = rep.masks
    nmasks = convert.to_numpy(tmasks_)
    flat_m = dict(_leaves(nmasks))
    jmasked = jax.tree.map(np.asarray, jparams)
    for name, leaf in _leaves(jmasked):
        if name in flat_m:
            node = jmasked
            *path, last = name.split(".")
            for k in path:
                node = node[k]
            node[last] = leaf * flat_m[name].astype(leaf.dtype)
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   4, 16, split="train")
    batches = [jax.tree.map(np.asarray, pipe.get(i)) for i in range(2)]
    rpipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                    2, 32, split="calib")
    pool = [jax.tree.map(np.asarray, rpipe.get(i)) for i in range(2)]
    return dict(arch=arch, jcfg=jcfg, japi=japi, jparams=jparams,
                tapi=tapi, tparams=tparams, nmasks=nmasks, tmasks=tmasks_,
                jmasked=jmasked, tmasked=convert.from_numpy(jmasked),
                batches=batches,
                tbatches=[convert.from_numpy(b) for b in batches],
                pool=pool, tpool=[convert.from_numpy(b) for b in pool])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jstep2(world):
    """The reference's step at the TINYs' grad_accum (2), jitted once."""
    assert world["jcfg"].grad_accum == 2
    return jsteps.make_train_step(world["japi"], jadamw.AdamWConfig(**OPT),
                                  donate=False)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(world, jstep2, accum):
    jcfg = world["jcfg"].replace(grad_accum=accum)
    tcfg = world["tapi"].cfg.replace(grad_accum=accum)
    jstep = jstep2 if accum == 2 else jsteps.make_train_step(
        jmodels.build(jcfg), jadamw.AdamWConfig(**OPT), donate=False)
    tstep = tsteps.make_train_step(tmodels.build(tcfg),
                                   tadamw.AdamWConfig(**OPT))
    js = jsteps.TrainState(world["jparams"], jadamw.init(world["jparams"]))
    ts = tsteps.TrainState(world["tparams"], tadamw.init(world["tparams"]))
    for i in range(2):
        js, jm = jstep(js, world["batches"][i])
        ts, tm = tstep(ts, world["tbatches"][i])
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss",
                                            "lr"]
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=RTOL), k
        assert float(tm["loss"]) == pytest.approx(
            float(tm["ce"]) + float(tm["aux"]), rel=1e-6)
        assert float(tm["aux"]) > 0
    _close_trained(ts.params, js.params, f"accum {accum}", lr=OPT["lr"],
                   steps=2)
    _close(ts.opt.m, js.opt.m, "m", atol=1e-7)
    _close(ts.opt.v, js.opt.v, "v", atol=1e-9)


def test_remat_leaves_gradients_unchanged(world):
    grads = {}
    for remat in (True, False):
        api = tmodels.build(world["tapi"].cfg.replace(remat=remat))
        b = world["tbatches"][0]
        _, grads[remat] = tsteps.value_and_grad(lambda p: api.loss(p, b),
                                                world["tparams"])
    for (name, a), (_, b) in zip(_leaves(grads[True]), _leaves(grads[False])):
        assert torch.equal(a, b), name


def test_dispatch_backward_has_no_token_gather(world):
    """The capacity buffer is filled from a broadcast of the tokens: its
    backward sums each token's k rows in a fixed order. No
    ``index_select`` / ``index_add`` node lies between x and the buffer
    (the combine's gather, whose kept rows have one reader each, is
    after it)."""
    cfg = world["tapi"].cfg
    x = torch.randn(12, cfg.d_model, requires_grad=True)
    ids = torch.randint(0, cfg.n_experts, (2, 6, 1)).expand(2, 6, cfg.top_k)
    ids = (ids + torch.arange(cfg.top_k)) % cfg.n_experts
    dest = tmoe._dispatch_group(ids, n_experts=cfg.n_experts, cap=2)
    buf, rows = tmoe._dispatch(x, dest, n_experts=cfg.n_experts, cap=2)
    names, todo = set(), [buf.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None:
            continue
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    assert not any(n.startswith(("IndexSelect", "IndexAdd")) for n in names)
    g = torch.randn_like(buf)
    (gx,) = torch.autograd.grad(buf, x, g)
    flat = torch.cat([g.reshape(-1, cfg.d_model),
                      torch.zeros(1, cfg.d_model)])
    want = flat[rows].reshape(12, cfg.top_k, -1).sum(1)
    assert torch.equal(gx, want)


def test_masked_adamw_keeps_expert_coordinates_zero(world):
    """3 masked steps with weight decay 0.1 from UNmasked params: the
    pruned coordinates of every site, the (L, E, f, d) expert leaves
    among them, are 0.0 in params, m and v; the router trains."""
    masks = world["tmasks"]
    assert set(masks["layers"]["moe"]) == {"w_gate", "w_up", "w_down"}
    cfg = world["tapi"].cfg
    assert masks["layers"]["moe"]["w_up"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)
    step = tsteps.make_train_step(world["tapi"], tadamw.AdamWConfig(
        lr=1e-3, weight_decay=0.1), masks=masks)
    st = tsteps.TrainState(world["tparams"], tadamw.init(world["tparams"]))
    for b in world["tbatches"] + world["tbatches"][:1]:
        st, m = step(st, b)
        assert bool(torch.isfinite(m["loss"])) and "aux" in m
    for tree, what in ((st.params, "params"), (st.opt.m, "m"),
                       (st.opt.v, "v")):
        _assert_pruned_zero(tree, masks, what)
    router = st.params["layers"]["moe"]["router"]
    assert router.dtype == torch.float32
    assert not torch.equal(router, world["tparams"]["layers"]["moe"]["router"])


# ---------------------------------------------------------------------------
# the launcher and TrainState checkpoints across packages
# ---------------------------------------------------------------------------

def _run(world, path, n_steps):
    return tlaunch.train(world["arch"], tiny=True, n_steps=n_steps,
                         ckpt_dir=str(path), ckpt_every=2, device="cpu",
                         batches=world["tbatches"], verbose=False)


def test_train_launcher_preempt_resume_bitwise(world, tmp_path, monkeypatch):
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
    for (n, a), (_, b) in zip(_leaves(convert.to_numpy(full["state"])),
                              _leaves(convert.to_numpy(resumed["state"]))):
        assert np.array_equal(a, b), n


def test_trainstate_resumes_across_packages(world, jstep2, tmp_path):
    """The reference's TrainState (expert stacks, fp32 router, one step
    in) restores bitwise in the port and trains on in both packages to
    the same step; the port's checkpoint restores bitwise in the
    reference."""
    js = jsteps.TrainState(world["jparams"], jadamw.init(world["jparams"]))
    js, _ = jstep2(js, world["batches"][0])
    jckpt.save(tmp_path / "j", 1, js)
    like = tsteps.init_state(world["tapi"], device="cpu")
    ts, man = tckpt.restore_like(tmp_path / "j", 1, like)
    paths = {e["path"] for e in man["leaves"]}
    assert {".params/layers/moe/router", ".opt/.m/layers/moe/w_gate",
            ".opt/.v/layers/moe/w_down"} <= paths
    want = _t(js)
    for (n, a), (_, b) in zip(_leaves(convert.to_numpy(ts)),
                              _leaves(convert.to_numpy(want))):
        assert np.array_equal(a, b), n
    assert ts.params["layers"]["moe"]["router"].dtype == torch.float32
    tstep = tsteps.make_train_step(world["tapi"], tadamw.AdamWConfig(**OPT))
    ts2, tm = tstep(ts, world["tbatches"][1])
    js2, jm = jstep2(js, world["batches"][1])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    _close_trained(ts2.params, js2.params, "resumed step", lr=OPT["lr"],
                   steps=2)
    tckpt.save(tmp_path / "t", 2, ts2)
    target = jax.eval_shape(lambda: jsteps.init_state(world["japi"],
                                                      jax.random.key(0)))
    back, _ = jckpt.restore(tmp_path / "t", 2, target)
    for (n, a), (_, b) in zip(_leaves(convert.to_numpy(_t(back))),
                              _leaves(convert.to_numpy(ts2))):
        assert np.array_equal(a, b), n


# ---------------------------------------------------------------------------
# recovery, export, the CLI
# ---------------------------------------------------------------------------

def _spec(select, steps=3, **kw):
    kw = dict(select=select, steps=steps, lr=LR, batch_size=2, seq_len=32,
              lora_rank=2, **kw)
    return jrecover_mod.RecoverSpec(**kw), tpruning.RecoverSpec(**kw)


@pytest.mark.parametrize("select", ["norms", "all_masked", "lora"])
def test_recover_matches_reference(world, select):
    js, ts = _spec(select)
    want = jrecover_mod.recover(world["japi"], world["jmasked"],
                                world["nmasks"], js, batches=world["pool"])
    got = tpruning.recover(world["tapi"], world["tmasked"], world["tmasks"],
                           ts, batches=world["tpool"])
    assert (got.trainable_count, got.total_count) == (
        want.trainable_count, want.total_count)
    assert sorted(dict(_leaves(got.trainable))) == sorted(
        dict(_leaves(jax.tree.map(np.asarray, want.trainable))))
    assert got.steps_run == want.steps_run == 3 and not got.diverged
    np.testing.assert_allclose(got.ce_history, want.ce_history, rtol=RTOL)
    _close_trained(got.params, jax.tree.map(np.asarray, want.params),
                   f"recover({select})", lr=LR, steps=3)
    if select == "lora":
        cfg = world["tapi"].cfg
        a = got.trainable["layers.moe.w_down"]["a"]
        assert a.shape == (cfg.n_layers, cfg.n_experts, 2, cfg.d_ff)
    if select != "norms":
        _assert_pruned_zero(got.params, world["tmasks"], select)


def test_bias_selections_like_reference(world):
    trec = importlib.import_module("repro_torch.pruning.recover")
    for select in ("biases", "norms_biases"):
        js, ts = _spec(select)
        if select == "biases":
            for mod, params, masks, spec in (
                    (jrecover_mod, world["jmasked"], world["nmasks"], js),
                    (trec, world["tmasked"], world["tmasks"], ts)):
                with pytest.raises(ValueError, match="matched no params"):
                    mod.build_selection(params, masks, spec)
            continue
        jsel = jrecover_mod.build_selection(world["jmasked"],
                                            world["nmasks"], js)
        tsel = trec.build_selection(world["tmasked"], world["tmasks"], ts)
        assert sorted(tsel.trainable) == sorted(jsel.trainable)
        assert all(n.endswith(".scale") for n in tsel.trainable)


def _prompt(cfg):
    return tsynthetic.DataPipeline(tsynthetic.CorpusConfig(cfg.vocab_size),
                                   2, 8, split="val").get(0)


def test_export_serves_recovered_tokens(world, tmp_path):
    """all_masked recovery, then ``export_packed``: the packed expert
    leaves are (L, E, ...) stacks and the export serves the in-process
    recovered model's greedy tokens in both packed formats."""
    api, cfg = world["tapi"], world["tapi"].cfg
    plan = tpruning.plan_pruning(api, world["tparams"],
                                 tpruning.PruneRecipe.single(
                                     tmasks.NM(2, 4), method="none",
                                     recover=_spec("all_masked")[1]))
    ex = tpruning.PruneExecutor(api, world["tparams"], plan)
    rep = ex.run(world["tpool"])
    ex.recover(batches=world["tpool"])
    prompt = _prompt(cfg)
    for fmt in ("nm24", "gathered"):
        out = ex.export_packed(tmp_path / fmt, fmt)
        tree = tpacked.load_packed_tree(world["tparams"], out)
        pw = tree["layers"]["moe"]["w_gate"]
        assert isinstance(pw, tpacked.PackedWeight)
        assert pw.values.shape[:2] == (cfg.n_layers, cfg.n_experts)
        want = ServeEngine(api, rep.updated_params, masks=rep.masks, fmt=fmt,
                           device="cpu").generate(prompt, 5).tokens
        via = ServeEngine(api, world["tparams"], masks=out, fmt=fmt,
                          device="cpu").generate(prompt, 5).tokens
        assert torch.equal(via, want), fmt
        assert torch.equal(tsteps.greedy_decode(api, tree, prompt, 5), want)


def test_cli_train_prune_recover_resume_serve(world, tmp_path, capsys):
    arch = world["arch"]
    run = tmp_path / "train"
    tlaunch.main(["--arch", arch, "--tiny", "--device", "cpu", "--steps",
                  "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
                  str(run), "--ckpt-every", "1"])
    out = tmp_path / "prune"
    argv = ["--arch", arch, "--tiny", "--device", "cpu", "--sparsity", "2:4",
            "--t-max", "2", "--n-calib", "4", "--out-dir", str(out),
            "--from-ckpt", str(run), "--recover", "lora",
            "--recover-steps", "4", "--calib-ckpt-every", "2"]
    tprune.main(argv)
    text = capsys.readouterr().out
    assert "recovery (PERP): select=lora steps=4" in text
    doc = json.loads((out / "report.json").read_text())
    assert doc["recovery"]["steps_run"] == 4
    tprune.main(argv)
    assert "recover: resumed at step 4" in capsys.readouterr().out
    assert json.loads((out / "report.json").read_text())["recovered"] == \
        doc["recovered"]
    api = world["tapi"]
    trained = tsteps.restore_params(api, run, device="cpu")
    masks, params = tpacked.load_masks_and_weights(api.cfg, trained, out)
    assert not torch.equal(params["layers"]["moe"]["w_up"],
                           trained["layers"]["moe"]["w_up"])
    served = tserve.serve(arch, tiny=True, batch=2, prompt_len=8, gen=4,
                          masks_from=str(out), fmt="nm24",
                          from_ckpt=str(run), device="cpu", verbose=False)
    want = ServeEngine(api, params, masks=masks, fmt="nm24",
                       device="cpu").generate(_prompt(api.cfg), 4).tokens
    assert torch.equal(served["tokens"], want)
