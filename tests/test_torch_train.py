"""The port's training slice vs the reference's, on tiny llama31-8b (fp32,
2 layers, d_model 64).

The reference initialises the params and samples the token batches; both
reach the port through numpy (``repro_torch.convert``), so each package
trains on the same numbers. Checked:

* ``optim.adamw``: ``schedule`` and three ``update`` calls, with and
  without masks, against the reference's: params within 1e-6 + 1e-5 of
  their size, ``m`` / ``v`` / ``grad_norm`` / ``lr`` within rtol 1e-5
  (fp32 sums in another order; XLA's CPU backend contracts FMAs); with
  masks the pruned coordinates are exactly 0.0 in params, ``m`` and ``v``;
* ``train_step`` (one and three steps): losses within rtol 1e-5, ``m``
  and ``v`` within the same bounds, params too but at 1 in 1000
  coordinates, which stay within lr per step (a gradient within a few eps
  of zero makes Adam's step direction sensitive to its rounding);
  ``grad_accum = 2`` gives the full batch's step within those bounds,
  with the same metric keys, in both packages; ``remat`` leaves the
  gradients bitwise unchanged;
* ``perplexity`` weighs each batch by its valid tokens, as the
  reference's does;
* the train launcher saves on SIGTERM and resumes bitwise (losses and
  final params), and writes TrainState checkpoints under the reference's leaf paths; the
  port reads a JAX-written TrainState and a bf16 checkpoint bitwise and
  resumes training from the former; ``convert`` carries a TrainState
  both ways;
* ``Heartbeat`` and ``StragglerMonitor`` behave as the reference's.
"""
import json
import os
import shutil
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
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "llama31-8b"
RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   4, 16, split="train")
    batches = [jax.tree.map(np.asarray, pipe.get(i)) for i in range(3)]
    return dict(jcfg=jcfg, japi=japi, jparams=jparams, batches=batches,
                tapi=tmodels.build(tconfigs.get_tiny(ARCH)),
                tparams=_t(jparams),
                tbatches=[convert.from_numpy(b) for b in batches])


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


def _close(got, want, what, *, atol=1e-6):
    """Every leaf within atol + RTOL·|want| (fp32 rounding), same names."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        np.testing.assert_allclose(_np(g[name]), _np(w[name]), rtol=RTOL,
                                   atol=atol, err_msg=f"{what}: {name}")


def _close_trained(got, want, what, *, lr, steps):
    """Params after ``steps`` Adam steps: within 1e-6 + RTOL·|want| but at
    1 in 1000 coordinates per leaf, and everywhere within lr·steps. Where
    a gradient sits within a few eps (1e-8) of zero, m / (√v + eps) turns
    its fp32 rounding into up to a whole step of lr (measured: 1 of 8192
    weights of wq moved 7.0e-6 apart after one step at lr 1e-3)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for name in w:
        a, b = _np(g[name]), _np(w[name])
        d = np.abs(a - b)
        assert d.max() <= lr * steps, f"{what}: {name} {d.max()}"
        assert np.mean(d > 1e-6 + RTOL * np.abs(b)) <= 1e-3, \
            f"{what}: {name}"


def _masks(params, rng):
    """Random 0/1 masks of every layer weight (a sub-tree of params)."""
    out = {}
    for name, leaf in _leaves(params):
        if name.startswith("layers.") and "ln" not in name:
            node = out
            *path, last = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = (rng.random(np.shape(leaf)) < 0.5).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        want = float(jadamw.schedule(jc, jnp.asarray(s, jnp.int32)))
        got = float(tadamw.schedule(tc, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL), s


@pytest.mark.parametrize("masked", [False, True])
def test_adamw_update_matches_reference(world, masked):
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, world["jparams"])
    masks = _masks(params, rng) if masked else None
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=0.5)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jp, js = params, jadamw.init(params)
    tp = convert.from_numpy(params)
    ts = tadamw.init(tp)
    tm = convert.from_numpy(masks) if masked else None
    for i in range(3):
        grads = jax.tree.map(
            lambda x: rng.normal(size=np.shape(x)).astype(np.float32), params)
        jp, js, jm = jadamw.update(jc, jax.tree.map(jnp.asarray, grads), js,
                                   jp, masks=masks)
        tp, ts, tm_ = tadamw.update(tc, convert.from_numpy(grads), ts, tp,
                                    masks=tm)
        assert float(tm_["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=RTOL)
        assert float(tm_["lr"]) == pytest.approx(float(jm["lr"]), rel=RTOL)
    assert int(ts.step) == int(js.step) == 3
    _close(tp, jp, "params")
    _close(ts.m, js.m, "m", atol=1e-7)
    _close(ts.v, js.v, "v", atol=1e-9)
    if masked:
        for tree in (tp, ts.m, ts.v):
            t = dict(_leaves(tree))
            for name, m in _leaves(masks):
                assert not t[name][torch.from_numpy(m) == 0].any(), name


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(world, n_steps):
    jstep = jsteps.make_train_step(world["japi"],
                                   jadamw.AdamWConfig(**OPT), donate=False)
    tstep = tsteps.make_train_step(world["tapi"], tadamw.AdamWConfig(**OPT))
    js = jsteps.TrainState(world["jparams"], jadamw.init(world["jparams"]))
    ts = tsteps.TrainState(world["tparams"], tadamw.init(world["tparams"]))
    for i in range(n_steps):
        js, jm = jstep(js, world["batches"][i])
        ts, tm = tstep(ts, world["tbatches"][i])
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=RTOL), k
    _close_trained(ts.params, js.params, "params", lr=OPT["lr"],
                   steps=n_steps)
    _close(ts.opt.m, js.opt.m, "m", atol=1e-7)
    _close(ts.opt.v, js.opt.v, "v", atol=1e-9)


def test_grad_accum_matches_full_batch(world):
    """grad_accum = 2 splits the batch of 4 in two and sums fp32 grads:
    the full batch's step within fp32 rounding, the same metric keys, and
    the reference's accumulated step."""
    states, metrics = {}, {}
    for accum in (1, 2):
        jcfg = world["jcfg"].replace(grad_accum=accum)
        tcfg = world["tapi"].cfg.replace(grad_accum=accum)
        jst = jsteps.make_train_step(jmodels.build(jcfg),
                                     jadamw.AdamWConfig(**OPT), donate=False)
        tst = tsteps.make_train_step(tmodels.build(tcfg),
                                     tadamw.AdamWConfig(**OPT))
        js, jm = jst(jsteps.TrainState(world["jparams"],
                                       jadamw.init(world["jparams"])),
                     world["batches"][0])
        ts, tm = tst(tsteps.TrainState(world["tparams"],
                                       tadamw.init(world["tparams"])),
                     world["tbatches"][0])
        states[accum], metrics[accum] = ts, tm
        assert sorted(tm) == sorted(jm)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
        _close_trained(ts.params, js.params, f"accum {accum} vs reference",
                       lr=OPT["lr"], steps=1)
    assert sorted(metrics[1]) == sorted(metrics[2])
    assert float(metrics[2]["loss"]) == pytest.approx(
        float(metrics[1]["loss"]), rel=RTOL)
    _close_trained(states[2].params, states[1].params, "accum 2 vs 1",
                   lr=OPT["lr"], steps=1)


def test_remat_leaves_gradients_unchanged(world):
    grads = {}
    for remat in (True, False):
        api = tmodels.build(world["tapi"].cfg.replace(remat=remat))
        b = world["tbatches"][0]
        (loss, _), grads[remat] = tsteps.value_and_grad(
            lambda p: api.loss(p, b), world["tparams"])
    for (name, a), (_, b) in zip(_leaves(grads[True]), _leaves(grads[False])):
        assert torch.equal(a, b), name


def test_perplexity_weighs_by_token_count(world):
    """A ragged batch (most labels masked to -1) weighs by its few valid
    tokens, as in the reference; not an unweighted mean of batch CEs."""
    b0, b1 = world["batches"][:2]
    b1 = dict(b1, labels=np.where(np.arange(16) < 3, b1["labels"], -1))
    want = jsteps.perplexity(world["japi"], world["jparams"], [b0, b1])
    batches = [convert.from_numpy(b) for b in (b0, b1)]
    got = tsteps.perplexity(world["tapi"], world["tparams"], batches)
    assert got == pytest.approx(want, rel=RTOL)
    ev = tsteps.make_eval_step(world["tapi"])
    (c0, n0), (c1, n1) = (ev(world["tparams"], b) for b in batches)
    assert (float(n0), float(n1)) == (64.0, 12.0)
    weighted = (float(c0) * 64 + float(c1) * 12) / 76
    assert np.log(got) == pytest.approx(weighted, rel=1e-6)
    assert np.log(got) != pytest.approx((float(c0) + float(c1)) / 2,
                                        rel=1e-3)


# ---------------------------------------------------------------------------
# the launcher and its checkpoints
# ---------------------------------------------------------------------------

def _run(tmp_path, name, n_steps, world):
    return tlaunch.train(ARCH, tiny=True, n_steps=n_steps,
                         ckpt_dir=str(tmp_path / name), ckpt_every=2,
                         device="cpu", batches=world["tbatches"],
                         verbose=False)


def test_train_launcher_preempt_resume_bitwise(world, tmp_path,
                                               monkeypatch):
    """SIGTERM after step 1 saves a checkpoint at step 2 and exits; the
    rerun skips a newer corrupt checkpoint, resumes at step 2 and ends
    with the uninterrupted run's losses and params, bit for bit."""
    full = _run(tmp_path, "a", 4, world)
    assert tckpt.steps(tmp_path / "a") == [2, 4]
    real = tsteps.make_train_step

    def make(api, opt_cfg, *, masks=None):
        step, calls = real(api, opt_cfg, masks=masks), [0]

        def wrapped(state, batch):
            out = step(state, batch)
            calls[0] += 1
            if calls[0] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    with monkeypatch.context() as mp:
        mp.setattr(tlaunch.steps_lib, "make_train_step", make)
        cut = _run(tmp_path, "b", 4, world)
    assert cut["final_step"] == 2 and tckpt.steps(tmp_path / "b") == [2]
    bad = tmp_path / "b" / "step_00000003"        # a newer, corrupt one
    bad.mkdir()
    (bad / "MANIFEST.json").write_text("{not json")
    resumed = _run(tmp_path, "b", 4, world)
    assert resumed["start_step"] == 2 and resumed["final_step"] == 4
    assert cut["losses"] + resumed["losses"] == full["losses"]
    for (n, a), (_, b) in zip(_leaves(full["state"].params),
                              _leaves(resumed["state"].params)):
        assert torch.equal(a, b), n
    # a finished run resumes at its end and runs nothing
    again = _run(tmp_path, "b", 4, world)
    assert again["losses"] == [] and again["final_step"] == 4
    # the reference's leaf paths, and the reference reads the checkpoint
    man = json.loads((tmp_path / "a" / "step_00000004" / "MANIFEST.json")
                     .read_text())
    paths = {e["path"] for e in man["leaves"]}
    assert {".params/embed", ".opt/.m/embed", ".opt/.v/layers/attn/wq",
            ".opt/.step"} <= paths
    target = jax.eval_shape(lambda: jsteps.init_state(world["japi"],
                                                      jax.random.key(0)))
    jstate, _ = jckpt.restore(tmp_path / "a", 4, target)
    assert int(jstate.opt.step) == 4
    back = convert.from_numpy(jax.tree.map(np.asarray, jstate))
    for (n, a), (_, b) in zip(_leaves(back.params),
                              _leaves(full["state"].params)):
        assert torch.equal(a, b), n


def test_port_reads_jax_trainstate_and_resumes(world, tmp_path):
    """A TrainState the reference trained two steps and saved restores
    bitwise in the port (``restore_like``, ``convert``), and the port's
    launcher resumes from it: its third step matches the reference's."""
    jstep = jsteps.make_train_step(
        world["japi"], jadamw.AdamWConfig(lr=3e-4, warmup_steps=1,
                                          total_steps=3), donate=False)
    js = jsteps.TrainState(world["jparams"], jadamw.init(world["jparams"]))
    for i in range(2):
        js, _ = jstep(js, world["batches"][i])
    jckpt.save(tmp_path, 2, js)
    like = tsteps.init_state(world["tapi"], device="cpu")
    got, man = tckpt.restore_like(tmp_path, 2, like)
    want = convert.from_numpy(jax.tree.map(np.asarray, js))
    assert isinstance(got, tsteps.TrainState) and man["step"] == 2
    g, w = convert.to_numpy(got), convert.to_numpy(want)
    assert sorted(dict(_leaves(g))) == sorted(dict(_leaves(w)))
    for (n, a), (_, b) in zip(_leaves(g), _leaves(w)):
        assert np.array_equal(a, b), n
    params = tsteps.restore_params(world["tapi"], tmp_path, device="cpu")
    for (n, a), (_, b) in zip(_leaves(params), _leaves(want.params)):
        assert torch.equal(a, b), n
    assert sorted(w) == ["opt", "params"]
    assert sorted(w["opt"]) == ["m", "step", "v"] and int(w["opt"]["step"]) == 2
    # the launcher resumes the reference's run (the schedule of 3 steps)
    out = tlaunch.train(ARCH, tiny=True, n_steps=3, lr=3e-4,
                        ckpt_dir=str(tmp_path), device="cpu",
                        batches=world["tbatches"], verbose=False)
    js3, jm = jstep(js, world["batches"][2])
    assert out["start_step"] == 2 and len(out["losses"]) == 1
    assert out["losses"][0] == pytest.approx(float(jm["loss"]), rel=RTOL)
    _close_trained(out["state"].params, js3.params, "resumed step",
                   lr=3e-4, steps=3)


def test_bf16_checkpoints_read_bitwise(tmp_path):
    """bf16 leaves the reference writes (raw 2-byte records) and the port
    writes read back bitwise as torch.bfloat16, next to fp32 / int32."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    tree = {"w": jnp.asarray(x).astype(jnp.bfloat16),
            "f": jnp.asarray(x), "i": jnp.arange(4, dtype=jnp.int32)}
    jckpt.save(tmp_path / "ref", 1, tree)
    bits = np.asarray(tree["w"]).view(np.int16)
    got, man = tckpt.restore(tmp_path / "ref", 1)
    assert {e["dtype"] for e in man["leaves"]} == {"bfloat16", "float32",
                                                   "int32"}
    w = tckpt.to_tensor(got["w"])
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.int16).numpy(), bits)
    assert np.array_equal(tckpt.to_tensor(got["f"]).numpy(), x)
    port = {"w": w, "nested": {"b": w * 2}}
    tckpt.save(tmp_path / "port", 0, port)
    back, _ = tckpt.restore_like(tmp_path / "port", 0, port)
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(back["nested"]["b"], port["nested"]["b"])
    assert tckpt.unflatten(tckpt.restore(tmp_path / "port", 0)[0]
                           )["nested"]["b"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# runtime helpers
# ---------------------------------------------------------------------------

def test_heartbeat_and_straggler_monitor_match_reference(tmp_path):
    for ft, d in ((jft, tmp_path / "j"), (tft, tmp_path / "t")):
        hb = ft.Heartbeat(dir=d, host=0, interval=0.01)
        hb.ping(step=3)
        assert json.loads((d / "heartbeat_0.json").read_text())["step"] == 3
        assert hb.dead_hosts([0, 1], timeout=30.0) == [1]
        assert hb.dead_hosts([0], timeout=-1.0) == [0]
        hb.start()
        hb.stop()
        assert not hb._thread.is_alive()
    times = [(0, 1.0), (1, 1.1), (2, 5.0), (0, 1.2), (2, 4.0), (1, 0.9)]
    mons = [ft.StragglerMonitor() for ft in (jft, tft)]
    for m in mons:
        for h, t in times:
            m.record(h, t)
    assert mons[0].ewma == pytest.approx(mons[1].ewma)
    assert mons[0].stragglers() == mons[1].stragglers() == [2]
    shutil.rmtree(tmp_path / "j")
