"""The port's prune path on a mesh vs one device and the reference.

One gloo world of four CPU ranks a module (``tests/_torch_dist.py``,
spawned while the parent runs the reference) runs every sharded path;
the parent holds each rank's results against the port's single-device
functions and the reference's (on the reference's own inputs, converted
through numpy):

* ``refine_rows_sharded`` and ``refine_g_sharded`` (meshes (4, 1) and
  (2, 2), rows over "data" with G's columns over "model", k = 1 and 8;
  N:M and a row count the mesh does not divide) give masks, and losses,
  bitwise the single-device ``refine``'s, and masks equal to the
  reference's chunked search;
* ``psum_gram`` over ranks holding 5 / 3 / 0 / 8 rows gives the
  reference's single-device statistics within fp32 tolerance;
* ``prune_model(mesh=...)`` at PerRow(0.6), 2:4 and, past a zero Gram
  budget, through the Gram-sharded refiner gives the single-device masks
  bitwise and the reference's masks;
* ``accumulate_stats(mesh=...)`` on (2, 2), from the reference's params
  and calibration batches: batches split over "data" give Grams within
  1e-5 of max|G| of the reference's ``accumulate`` (and of the port's on
  one device), a batch that does not split warns and is accumulated whole
  (bitwise the port's single device, within 1e-5 of the reference's),
  checkpoints are written by rank 0 and resumed by every rank;
* ``launch.prune --mesh host`` on the world writes its out dir once, with
  Grams within 1e-5 of max|G| of the reference's ``accumulate`` on the
  launcher's params and batches, and the masks of a single-device prune
  of the Grams it calibrated;
* a mesh equal to a dropped one keeps its groups, and a set of axes gets
  its groups when first asked for, ordered by linear index;
* a Gram-sharded group (w_down past a small Gram budget, on (2, 2) and
  (1, 4), calibrated on the mesh) refines each rank's column block of its
  calibration shard: it is never gathered, the refiner receives (d,
  d / model) blocks, the plan reckons the block, and the masks are
  bitwise a one-process run of the same split and equal to the port's
  and the reference's single device on the same Grams;
* every rank ends with the same results; a mesh without a process group
  raises, and a plan on a mesh plans a recipe's recovery.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import gram as jgram  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import sparseswaps as jss  # noqa: E402
from repro.core import warmstart as jwarm  # noqa: E402

from repro_torch import ckpt, configs, convert, models  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import sparseswaps as tss  # noqa: E402
from repro_torch.core.warmstart import warmstart_mask  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

ARCH = "llama31-8b"


def _leaves(tree, prefix=""):
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _reference_refines():
    """The reference's chunked refinement of each refiner case."""
    probs = _torch_dist.refine_problems()
    out, done = {}, {}
    for name, *problem, _ in _torch_dist.ROWS_CASES:
        if tuple(problem) not in done:         # meshes share a problem
            prob, R, pat, t_max, k = problem
            W, G = (jnp.asarray(x) for x in probs[prob])
            W = W[:R]
            jp = jmasks.parse_pattern(pat)
            m0 = jwarm.warmstart_mask(W, G, jp, "wanda")
            done[tuple(problem)] = (np.asarray(m0), np.asarray(jss.refine(
                W, G, m0, jp, t_max=t_max, method="chunked",
                k_swaps=k).mask))
        out[name] = done[tuple(problem)]
    W, G = (jnp.asarray(x) for x in probs["gram"])
    m0 = jwarm.warmstart_mask(W, G, jmasks.PerRow(0.5), "wanda")
    for k in (1, 8):
        out[f"gram_k{k}"] = np.asarray(jss.refine(
            W, G, m0, jmasks.PerRow(0.5), t_max=_torch_dist.GRAM_T_MAX,
            method="chunked", k_swaps=k).mask)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's tiny llama31-8b params and taps, the spawned world
    working on them (and on the refiners' numpy problems), and the
    reference's single-device results, computed while the world runs."""
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    batches = list(jpruning.calibration_batches(jcfg, n_samples=2,
                                                seq_len=24, batch_size=2))
    jtaps = jpruning.accumulate(japi, jparams, batches)
    calib = {case: [jax.tree.map(np.asarray, b)
                    for b in jpruning.calibration_batches(
                        jcfg, n_samples=n, seq_len=_torch_dist.CALIB_SEQ,
                        batch_size=bs, seed=0)]
             for case, n, bs in _torch_dist.CALIB_CASES}
    inputs = {"params": jax.tree.map(np.asarray, jparams),
              "taps": jax.tree.map(np.asarray, jtaps),
              "calib": calib,
              "psum_x": np.random.default_rng(3).normal(
                  size=(sum(_torch_dist.PSUM_ROWS), 24)).astype(np.float32)}
    w = _torch_dist.World(tmp_path_factory.mktemp("world"), inputs)
    # the reference's calibration on the ranks' inputs, and on the
    # launcher's (the port's seed-0 params and calibration batches)
    ref_stats = {case: _leaves(jpruning.accumulate(
                     japi, jparams, [jax.tree.map(jnp.asarray, b)
                                     for b in calib[case]]))
                 for case in calib}
    tcfg = configs.get_tiny(ARCH)
    tapi = models.build(tcfg)
    launch_params = convert.to_numpy(tapi.init(seed=0, device="cpu"))
    launch_batches = [convert.to_numpy(b) for b in
                      tpruning.calibration_batches(
                          tcfg, device="cpu", **_torch_dist.LAUNCH_CALIB)]
    ref_stats["launch"] = _leaves(jpruning.accumulate(
        japi, jax.tree.map(jnp.asarray, launch_params),
        [jax.tree.map(jnp.asarray, b) for b in launch_batches]))
    # the reference's batched engine (chunked search), which its own tests
    # hold bitwise to its per-instance reference loop
    prunes = {name: _leaves(jpruning.prune_model(
                  japi, jparams, None, jmasks.parse_pattern(pat),
                  t_max=t_max, taps=jtaps, swap_method="chunked").masks)
              for name, pat, t_max, _, _ in _torch_dist.PRUNE_CASES}
    yield types.SimpleNamespace(world=w, inputs=inputs,
                                refines=_reference_refines(), prunes=prunes,
                                stats=ref_stats)
    w.close()


def _same_on_every_rank(results, *path):
    def get(r):
        for k in path:
            r = r[k]
        return r

    first = get(results[0])
    for r in results[1:]:
        other = get(r)
        assert type(other) is type(first)
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(other)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), path
    return first


@pytest.mark.parametrize("case", _torch_dist.ROWS_CASES,
                         ids=[c[0] for c in _torch_dist.ROWS_CASES])
def test_rows_sharded_matches_single_device_and_reference(world, case):
    name, prob, R, pat, t_max, k, _ = case
    W, G = _torch_dist.refine_problems()[prob]
    W = W[:R]
    tW, tG = torch.as_tensor(W), torch.as_tensor(G)
    tp = tmasks.parse_pattern(pat)
    m0 = warmstart_mask(tW, tG, tp, "wanda")
    want = tss.refine(tW, tG, m0, tp, t_max=t_max, k_swaps=k)
    m, l0, l1 = _same_on_every_rank(world.world.results(), "refine", name)
    assert np.array_equal(m, want.mask.numpy())
    assert np.array_equal(l0, want.loss_init.numpy())
    assert np.array_equal(l1, want.loss_final.numpy())
    ref_m0, ref = world.refines[name]
    assert np.array_equal(ref_m0, m0.numpy())
    assert np.array_equal(m, ref)
    assert tmasks.validate_mask(torch.as_tensor(m), tp)


@pytest.mark.parametrize("case", _torch_dist.GRAM_CASES,
                         ids=[c[0] for c in _torch_dist.GRAM_CASES])
def test_g_sharded_matches_single_device_and_reference(world, case):
    name, k = case[0], case[1]
    W, G = _torch_dist.refine_problems()["gram"]
    tW, tG = torch.as_tensor(W), torch.as_tensor(G)
    tp = tmasks.PerRow(0.5)
    m0 = warmstart_mask(tW, tG, tp, "wanda")
    want = tss.refine(tW, tG, m0, tp, t_max=_torch_dist.GRAM_T_MAX,
                      k_swaps=k)
    m, l0, l1 = _same_on_every_rank(world.world.results(), "refine", name)
    assert np.array_equal(m, want.mask.numpy())
    assert np.array_equal(l1, want.loss_final.numpy())
    assert int(np.abs(m - m0.numpy()).sum()) > 0       # swaps were made
    assert np.array_equal(m, world.refines[f"gram_k{k}"])


def test_g_sharded_refuses_nm_and_uneven_columns():
    W, G = (torch.as_tensor(x) for x in _torch_dist.refine_problems()["gram"])
    from repro_torch.pruning import distributed

    # refused before any collective: mappings stand in for the meshes
    with pytest.raises(ValueError, match="does not divide"):
        distributed.refine_g_sharded(W, G, None, tmasks.PerRow(0.5),
                                     {"data": 3})
    with pytest.raises(NotImplementedError, match="N:M"):
        distributed.refine_g_sharded(W, G, None, tmasks.NM(2, 4),
                                     {"data": 4})


def test_psum_gram_uneven_splits(world):
    got = _same_on_every_rank(world.world.results(), "psum")
    X = world.inputs["psum_x"]
    want = jgram.GramState.create(X.shape[1]).update(jnp.asarray(X))
    for k in ("G", "count", "mean", "m2"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("case", _torch_dist.PRUNE_CASES,
                         ids=[c[0] for c in _torch_dist.PRUNE_CASES])
def test_prune_model_mesh_matches_single_device_and_reference(world, case):
    name, pat, t_max, _, budget = case
    masks, paths = _same_on_every_rank(world.world.results(), "prune", name)
    want_path = "rows-sharded" if budget is None else "gram-sharded"
    assert set(paths) == {want_path}
    tapi = models.build(configs.get_tiny(ARCH))
    single = tpruning.prune_model(
        tapi, convert.from_numpy(world.inputs["params"]), None,
        tmasks.parse_pattern(pat), t_max=t_max,
        taps=convert.from_numpy(world.inputs["taps"]))
    want = {k: v > 0.5 for k, v in _leaves(single.masks).items()}
    assert sorted(masks) == sorted(want)
    for k in want:
        assert np.array_equal(masks[k], want[k]), k
    for k, v in world.prunes[name].items():
        assert np.array_equal(masks[k], v > 0.5), k


@pytest.mark.parametrize("case", _torch_dist.GRAM_PRUNE_CASES,
                         ids=[c[0] for c in _torch_dist.GRAM_PRUNE_CASES])
def test_gram_sharded_group_refines_its_column_block(world, case):
    """Past the Gram budget w_down refines on each rank's (d, d / model)
    calibration shard: G is never gathered for it, the plan reckons the
    block, and the masks are bitwise a one-process run of the same split
    and equal to the port's and the reference's single device on the
    Grams the mesh calibrated."""
    name, data, model = case
    masks, paths, entries, gathered, blocks, cost, taps = \
        _same_on_every_rank(world.world.results(), "gram_prune", name)
    cfg = configs.get_tiny(ARCH)
    d = cfg.d_ff
    assert paths.pop("layers.mlp.w_down") == "gram-sharded"
    assert set(paths.values()) == {"rows-sharded"}
    assert ("w_down",) not in entries and entries     # the others gather
    assert all(shape[-2:] != (d, d // model) for shape in gathered)
    assert blocks == [(d, d // model)] * cfg.n_layers
    assert cost["gram"] == 4 * d * (d // model) < 4 * d * d
    # the same Grams through the port's and the reference's single device
    tapi = models.build(cfg)
    params = convert.from_numpy(world.inputs["params"])
    t_taps = convert.from_numpy(taps)
    single = _leaves(tpruning.prune_model(
        tapi, params, None, tmasks.PerRow(0.6),
        t_max=_torch_dist.GRAM_PRUNE_T_MAX, taps=t_taps).masks)
    japi = jmodels.build(jconfigs.get_tiny(ARCH))
    ref = _leaves(jpruning.prune_model(
        japi, jax.tree.map(jnp.asarray, world.inputs["params"]), None,
        jmasks.PerRow(0.6), t_max=_torch_dist.GRAM_PRUNE_T_MAX,
        taps=jax.tree.map(jnp.asarray, taps), swap_method="chunked").masks)
    assert sorted(masks) == sorted(single) == sorted(ref)
    for k in single:
        assert np.array_equal(masks[k], single[k] > 0.5), k
        assert np.array_equal(masks[k], ref[k] > 0.5), k
    # w_down bitwise a one-process run of the (data, model) split
    from repro_torch.pruning import distributed

    W = params["layers"]["mlp"]["w_down"]
    G = t_taps["w_down"]["g"]
    for i in range(cfg.n_layers):
        m0 = warmstart_mask(W[i].float(), G[i], tmasks.PerRow(0.6), "wanda")
        m, _, _ = distributed.refine_split_single(
            W[i], G[i], m0, tmasks.PerRow(0.6), n_cols=model, n_rows=data,
            t_max=_torch_dist.GRAM_PRUNE_T_MAX, k_swaps=8)
        assert np.array_equal(masks["layers/mlp/w_down"][i], m.numpy() > 0.5)


def _calib_single(params, batches):
    """The port's single-device calibration of ``params`` on ``batches``
    (numpy trees)."""
    api = models.build(configs.get_tiny(ARCH))
    params = convert.from_numpy(params)
    return _leaves(convert.to_numpy(tpruning.accumulate(
        api, params, [convert.from_numpy(b) for b in batches])))


def _close_grams(got, want, what):
    """Every leaf within 1e-5 of the leaf's max (fp32 sums in another
    order)."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{what}: {k}")


def test_mesh_groups_survive_an_equal_mesh_and_are_made_when_asked(world):
    res = world.world.results()
    for r, out in enumerate(res):
        g = out["groups"]
        assert np.array_equal(g["again"], np.arange(4.0)), r
        made, after, index, order = g["lazy"]
        # (pod, data, model) = (2, 2, 1): each axis and the whole mesh
        # at creation, ("data", "pod") on asking; linear index data·2 + pod
        assert (made, after) == (4, 5), r
        assert index == [0, 2, 1, 3][r]
        assert np.array_equal(order, [0.0, 2.0, 1.0, 3.0]), r


def test_accumulate_stats_mesh_matches_single_device(world):
    """Held to the reference's calibration and the port's single device,
    on the reference's params and batches."""
    res = world.world.results()
    got, warned, nbytes = _same_on_every_rank(res, "stats", "split")
    got = _leaves(got)
    assert not warned
    _close_grams(got, world.stats["split"], "split vs the reference")
    want = _calib_single(world.inputs["params"],
                         world.inputs["calib"]["split"])
    _close_grams(got, want, "split vs one device")
    # each rank holds half of every Gram's columns on the (2, 2) mesh
    full = sum(v.nbytes for v in want.values())
    grams = sum(v.nbytes for k, v in want.items() if k.endswith("/g"))
    assert nbytes == full - grams // 2
    whole, warned, _ = _same_on_every_rank(res, "stats", "whole")
    assert any("not sharded" in w for w in warned)
    whole = _leaves(whole)
    _close_grams(whole, world.stats["whole"], "whole vs the reference")
    want = _calib_single(world.inputs["params"],
                         world.inputs["calib"]["whole"])
    assert sorted(whole) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(whole[k], w), k


def test_calibration_checkpoint_written_once_resumed_everywhere(world):
    res = world.world.results()
    for r, out in enumerate(res):
        wrote, resumed_writes, first, again, batches = out["stats"]["ckpt"]
        assert wrote == (2 if r == 0 else 0), r
        assert resumed_writes == 0 and batches == 2
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(again)):
            assert np.array_equal(a, b)
        _close_grams(_leaves(first), world.stats["split"],
                     f"rank {r}'s checkpointed run vs the reference")


def test_launcher_mesh_writes_once_matches_single_device(world):
    res = world.world.results()
    counts = [out["launch"] for out in res]
    assert [c["writes"] for c in counts] == [1, 0, 0, 0]
    assert counts[0]["saves"] > 0 and all(c["saves"] == 0
                                          for c in counts[1:])
    out = world.world.root / "out"
    _, flat, _ = ckpt.restore_latest(out / "masks")
    got = _leaves(ckpt.unflatten(flat))
    # the Grams the run calibrated (rank 0 checkpointed them), within fp32
    # sums of the reference's calibration of the launcher's params and
    # batches, and the masks a single device gives them
    _, flat, _ = ckpt.restore_latest(out / "prune_ckpt" / "calib")
    taps = ckpt.unflatten(flat)
    _close_grams(_leaves(taps), world.stats["launch"],
                 "the launcher vs the reference")
    cfg = configs.get_tiny(ARCH)
    api = models.build(cfg)
    single = tpruning.prune_model(api, api.init(seed=0, device="cpu"), None,
                                  tmasks.PerRow(0.6), t_max=4, taps=taps)
    want = _leaves(single.masks)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k] > 0.5, want[k] > 0.5), k


def test_mesh_needs_a_process_group(monkeypatch):
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_host_mesh()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.init_distributed("cpu")


def test_plan_on_a_mesh_plans_recovery():
    api = models.build(configs.get_tiny(ARCH))
    meta = api.init(seed=0, device="meta")
    spec = tpruning.RecoverSpec(select="norms", steps=2)
    rec = tpruning.PruneRecipe.single("0.6", recover=spec)
    plan = tpruning.plan_pruning(api, meta, rec, mesh={"data": 4})
    assert plan.recover == spec
    assert {g.engine_path for g in plan.groups} == {"rows-sharded"}
    assert f"recovery (PERP): {spec.describe()}" in plan.describe()
