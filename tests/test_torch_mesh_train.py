"""Training and recovery on a mesh vs one device and the reference.

One spawned world of four gloo CPU ranks a module
(``tests/_torch_mesh_train.py``) runs the sharded paths while the parent
runs the reference and the port on one device, on the same numbers (the
reference's tiny llama31-8b params and batches, through numpy):

* ``train_step_fn(mesh=)`` (a TrainState sharded by ``state_pspecs``)
  after 1 and 3 steps on (1, 1), (1, 2), (2, 1) and (2, 2): bitwise the
  port's single-device step where the data axes are 1, within rtol 1e-5
  (loss, grad norm) and 1e-6 + 1e-5·|want| (params, but at 1 in 1000
  coordinates) where a data axis splits the batch, and within those of
  the reference's single-device step everywhere; ``grad_accum`` 2 splits
  each microbatch over "data"; a batch whose halves hold different
  valid-token counts gives one device's mean CE, not a mean of means;
* each rank's state bytes equal ``placement.bytes_per_rank``;
* a (2, 2) checkpoint is read by the reference's ``ckpt.restore`` and by
  the port on one device, bitwise; a one-device checkpoint restores onto
  (2, 2) as each rank's blocks;
* ``recover(mesh=)`` on (2, 2) within tolerance of one device and the
  reference, and resumed bitwise;
* ``launch.train --mesh host`` on (4, 1) and (1, 1): a SIGTERM on one
  rank stops every rank at one step with a checkpoint, the rerun resumes
  it, bitwise the uninterrupted run; (1, 1) bitwise one device's;
* ``launch.prune --mesh host --recover norms`` on (1, 1) bitwise the
  single-device command, on (2, 1) within tolerance of one device's
  recovery on its masks; both resume a deleted recovery step bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402

import _torch_mesh_train as mt  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.launch import prune as tlaunch_prune  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "llama31-8b"
RTOL = 1e-5
ONE_STEP = 7              # the step of the parent's one-device checkpoint
# mesh -> (result key, the ranks that hold it, bitwise one device's)
MESHES = {"11": ("steps11", [2], True), "12": ("steps12", [0, 1], True),
          "21": ("steps21", [0, 1], False),
          "22": ("steps22", [0, 1, 2, 3], False)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in sorted(tree.items()):
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree, np.float32)}


def _equal(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert np.array_equal(g[k], w[k]), f"{what}: {k}"


def _close(got, want, what, *, lr, steps):
    """Params after ``steps`` Adam steps: within 1e-6 + RTOL·|want| but at
    1 in 1000 coordinates per leaf, and everywhere within lr·steps
    (``tests/test_torch_train.py``'s bound)."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= lr * steps, f"{what}: {k} {d.max()}"
        assert np.mean(d > 1e-6 + RTOL * np.abs(w[k])) <= 1e-3, \
            f"{what}: {k}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   4, 16, split="train")
    batches = [jax.tree.map(np.asarray, pipe.get(i)) for i in range(3)]
    # the second half's rows keep 3 of 16 labels: 32 vs 6 valid tokens
    uneven = dict(batches[0], labels=np.where(
        (np.arange(4)[:, None] < 2) | (np.arange(16)[None] < 3),
        batches[0]["labels"], -1))
    calib = list(jpruning.calibration_batches(jcfg, n_samples=2, seq_len=16,
                                              batch_size=2, seed=0))
    rep = jpruning.prune_model(japi, jparams, calib, jmasks.NM(2, 4),
                               method="none", t_max=3)
    rec_params = jadamw.apply_masks(jparams, rep.masks)
    rpipe = jsynthetic.DataPipeline(
        jsynthetic.CorpusConfig(jcfg.vocab_size), 2, 32, split="calib")
    inputs = {"params": jax.tree.map(np.asarray, jparams),
              "batches": batches, "uneven": uneven,
              "rec_params": jax.tree.map(np.asarray, rec_params),
              "rec_masks": jax.tree.map(np.asarray, rep.masks),
              "rec_pool": [jax.tree.map(np.asarray, rpipe.get(i))
                           for i in range(2)]}
    root = tmp_path_factory.mktemp("mesh_train")
    # a one-device TrainState checkpoint for the ranks to restore onto
    # (2, 2): the params and moments after one step
    tcfg = tconfigs.get_tiny(ARCH)
    tapi = tmodels.build(tcfg)
    tparams = convert.from_numpy(inputs["params"])
    one = tsteps.train_step_fn(tapi, tadamw.AdamWConfig(**mt.OPT))(
        tsteps.TrainState(tparams, tadamw.init(tparams)),
        convert.from_numpy(batches[0]))[0]
    tckpt.save(root / "one", ONE_STEP, one)
    w = mt.World(root, inputs)
    yield dict(world=w, inputs=inputs, japi=japi, jparams=jparams,
               tapi=tapi, tparams=tparams, root=root, one=one,
               rep_masks=rep.masks, rec_params=rec_params)
    w.close()


def _on_ranks(world, key, ranks):
    """``key``'s results, the same on each of ``ranks``."""
    res = world["world"].results()
    first = res[ranks[0]][key]
    for r in ranks[1:]:
        other = res[r][key]
        a, b = jax.tree.leaves(first), jax.tree.leaves(other)
        assert len(a) == len(b) and all(
            np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(a, b)), (key, r)
    return first


def _one_device(world, n, cfg=None, batches=None):
    """The port's and the reference's single-device steps: [(loss, grad
    norm, params)] of each."""
    tcfg = cfg or tconfigs.get_tiny(ARCH)
    jcfg = jconfigs.get_tiny(ARCH).replace(grad_accum=tcfg.grad_accum)
    batches = batches or world["inputs"]["batches"]
    tstep = tsteps.train_step_fn(tmodels.build(tcfg),
                                 tadamw.AdamWConfig(**mt.OPT))
    jstep = jsteps.make_train_step(jmodels.build(jcfg),
                                   jadamw.AdamWConfig(**mt.OPT),
                                   donate=False)
    ts = tsteps.TrainState(world["tparams"], tadamw.init(world["tparams"]))
    js = jsteps.TrainState(world["jparams"], jadamw.init(world["jparams"]))
    tout, jout = [], []
    for b in batches[:n]:
        ts, tm = tstep(ts, convert.from_numpy(b))
        js, jm = jstep(js, b)
        tout.append((float(tm["loss"]), float(tm["grad_norm"]),
                     convert.to_numpy(ts.params)))
        jout.append((float(jm["loss"]), float(jm["grad_norm"]),
                     jax.tree.map(np.asarray, js.params)))
    return tout, jout


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_matches_one_device_and_reference(world, mesh, n):
    key, ranks, bitwise = MESHES[mesh]
    got = _on_ranks(world, key, ranks)[n - 1]
    one, ref = _one_device(world, n)
    loss, gnorm, params = got
    if bitwise:
        assert (loss, gnorm) == one[-1][:2]
        _equal(params, one[-1][2], f"({mesh}) vs one device")
    else:
        assert loss == pytest.approx(one[-1][0], rel=RTOL)
        assert gnorm == pytest.approx(one[-1][1], rel=RTOL)
        _close(params, one[-1][2], f"({mesh}) vs one device",
               lr=mt.OPT["lr"], steps=n)
    assert loss == pytest.approx(ref[-1][0], rel=RTOL)
    _close(params, ref[-1][2], f"({mesh}) vs the reference",
           lr=mt.OPT["lr"], steps=n)


def test_grad_accum_splits_each_microbatch_over_data(world):
    loss, gnorm, params = _on_ranks(world, "accum22", [0, 1, 2, 3])[0]
    cfg = tconfigs.get_tiny(ARCH).replace(grad_accum=2)
    one, ref = _one_device(world, 1, cfg=cfg)
    assert loss == pytest.approx(one[0][0], rel=RTOL)
    assert gnorm == pytest.approx(one[0][1], rel=RTOL)
    _close(params, one[0][2], "accum 2 on (2, 2) vs one device",
           lr=mt.OPT["lr"], steps=1)
    assert loss == pytest.approx(ref[0][0], rel=RTOL)
    _close(params, ref[0][2], "accum 2 on (2, 2) vs the reference",
           lr=mt.OPT["lr"], steps=1)


def test_global_mean_ce_over_uneven_halves(world):
    """The two ranks' halves hold 32 and 6 valid tokens: the loss is the
    CE over all 38, not the mean of the halves' means."""
    loss, _, params = _on_ranks(world, "uneven21", [0, 1])[0]
    b = world["inputs"]["uneven"]
    one, ref = _one_device(world, 1, batches=[b])
    assert loss == pytest.approx(one[0][0], rel=RTOL)
    assert loss == pytest.approx(ref[0][0], rel=RTOL)
    _close(params, one[0][2], "uneven halves vs one device",
           lr=mt.OPT["lr"], steps=1)
    ev = tsteps.make_eval_step(world["tapi"])
    halves = [ev(world["tparams"], convert.from_numpy(
        {k: v[h] for k, v in b.items()})) for h in (slice(0, 2),
                                                    slice(2, 4))]
    assert [float(n) for _, n in halves] == [32.0, 6.0]
    assert loss != pytest.approx(
        (float(halves[0][0]) + float(halves[1][0])) / 2, rel=1e-3)


def test_state_bytes_equal_the_reckoning(world):
    for r, out in enumerate(world["world"].results()):
        actual, reckoned = out["bytes22"]
        assert actual == reckoned, r
    full = sum(x.size * 4 for x in jax.tree.leaves(world["inputs"]["params"]))
    # params, m and v split four ways but for the replicated norm scales
    assert 3 * full / 4 < actual < 3 * full / 2


def test_mesh_checkpoint_read_by_reference_and_one_device(world):
    root = world["root"]
    *_, params = _on_ranks(world, "steps22", [0, 1, 2, 3])[-1]
    like = jax.eval_shape(lambda: jsteps.TrainState(
        world["jparams"], jadamw.init(world["jparams"])))
    ref, man = jckpt.restore(root / "ckpt22", mt.STEPS, like)
    _equal(jax.tree.map(np.asarray, ref.params), params,
           "the reference's restore")
    one, _ = tckpt.restore_like(root / "ckpt22", mt.STEPS,
                                tsteps.abstract_state(world["tapi"]),
                                device="cpu")
    _equal(convert.to_numpy(one.params), params, "the port on one device")
    _equal(convert.to_numpy(one.opt.m),
           jax.tree.map(np.asarray, ref.opt.m), "m")
    assert int(one.opt.step) == int(ref.opt.step) == mt.STEPS
    # each block written once: a (2, 2)-sharded weight has four shards, a
    # replicated leaf (the final norm's scale, the step) one
    shards = {e["path"]: len(e["shards"]) for e in man["leaves"]}
    assert shards[".params/layers/attn/wq"] == 4
    assert shards[".params/ln_f/scale"] == shards[".opt/.step"] == 1


def test_one_device_checkpoint_restored_onto_a_mesh(world):
    whole = dict(tckpt.store._flatten(world["one"]))
    for r, out in enumerate(world["world"].results()):
        step, blocks, index = out["onto22"]
        assert step == ONE_STEP and sorted(blocks) == sorted(whole)
        for path, block in blocks.items():
            sl = tuple(slice(a, b) for a, b in index[path])
            assert np.array_equal(block, whole[path].numpy()[sl]), (r, path)


def test_recover_mesh_matches_one_device_and_resumes(world):
    r1, ce1, start2, r2, ce2 = _on_ranks(world, "rec22", [0, 1, 2, 3])
    tapi = world["tapi"]
    params = convert.from_numpy(world["inputs"]["rec_params"])
    masks = convert.from_numpy(world["inputs"]["rec_masks"])
    pool = [convert.from_numpy(b) for b in world["inputs"]["rec_pool"]]
    one = tpruning.recover(tapi, params, masks,
                           tpruning.RecoverSpec(**mt.RECOVER), batches=pool)
    steps, lr = mt.RECOVER["steps"], mt.RECOVER["lr"]
    np.testing.assert_allclose(ce1, one.ce_history, rtol=RTOL)
    _close(r1, convert.to_numpy(one.trainable), "recover (2, 2) vs one "
           "device", lr=lr, steps=steps)
    jrec = __import__("repro.pruning.recover", fromlist=["recover"])
    ref = jrec.recover(world["japi"], world["rec_params"],
                       world["rep_masks"], jrec.RecoverSpec(**mt.RECOVER),
                       batches=world["inputs"]["rec_pool"])
    np.testing.assert_allclose(ce1, ref.ce_history, rtol=RTOL)
    _close(r1, jax.tree.map(np.asarray, ref.trainable),
           "recover (2, 2) vs the reference", lr=lr, steps=steps)
    assert start2 == 2
    _equal(r2, r1, "the resumed recovery")
    assert ce2 == ce1[2:]


@pytest.mark.parametrize("mesh,ranks", [("41", [0, 1, 2, 3]), ("11", [2])])
def test_train_launcher_on_a_mesh_resumes_after_a_kill(world, mesh, ranks):
    out = _on_ranks(world, f"launch{mesh}", ranks)
    losses, params = out["full"]
    (cut_step, cut_losses, seen), (start, tail, final) = \
        out["cut"], out["resumed"]
    assert cut_step == start == 2 and cut_losses == losses[:2]
    assert seen == list(range(len(ranks)))        # every rank's step time
    assert tail == losses[2:]
    _equal(final, params, f"({mesh}) resumed vs uninterrupted")
    one = tlaunch_train.train(**dict(mt.TRAIN_ARGS))
    if mesh == "11":
        assert losses == one["losses"]
        _equal(params, convert.to_numpy(one["state"].params),
               "(1, 1) vs one device")
    else:
        np.testing.assert_allclose(losses, one["losses"], rtol=RTOL)
        _close(params, convert.to_numpy(one["state"].params),
               "(4, 1) vs one device", lr=3e-4,
               steps=mt.TRAIN_ARGS["n_steps"])


@pytest.mark.parametrize("mesh,ranks", [("11", [2]), ("21", [0, 1])])
def test_prune_launcher_recovers_on_a_mesh_and_resumes(world, mesh, ranks,
                                                       tmp_path):
    out = _on_ranks(world, f"prune{mesh}", ranks[:1])
    assert out["steps"] == [2, 4]
    assert out["resumed"] == (2, 2)
    _equal(out["trainable2"], out["trainable"], "the resumed recovery")
    assert out["ce2"] == out["ce"][2:]
    tapi = world["tapi"]
    if mesh == "11":
        one = tlaunch_prune.prune(**dict(mt.PRUNE_ARGS,
                                         out_dir=str(tmp_path / "one")))
        _equal(out["masks"], convert.to_numpy(one["report"].masks),
               "(1, 1) masks")
        _equal(out["trainable"],
               convert.to_numpy(one["recover_result"].trainable),
               "(1, 1) recovered")
        assert out["ce"] == one["recover_result"].ce_history
        assert out["recovered"] == one["recovered"]
        return
    # (2, 1): one device's recovery on the masks the mesh pruned
    spec = tpruning.RecoverSpec(select="norms", steps=4, lr=1e-3,
                                batch_size=4, seq_len=128, seed=0)
    params = tapi.init(seed=0, device="cpu")
    one = tpruning.recover(tapi, params, convert.from_numpy(out["masks"]),
                           spec)
    np.testing.assert_allclose(out["ce"], one.ce_history, rtol=RTOL)
    _close(out["trainable"], convert.to_numpy(one.trainable),
           "(2, 1) recovered vs one device", lr=1e-3, steps=4)
