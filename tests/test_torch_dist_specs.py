"""The port's sharding rules and specs, and the plan's mesh columns, vs the
reference's, on stand-in meshes (no process group: the spec functions
and the plan read the mesh's axis sizes only).

* ``standard_rules``, ``logical_pspec``, ``use_rules`` / ``active_rules``;
* ``batch_pspecs`` and ``calib_pspecs``, entry by entry against the
  reference's ``PartitionSpec``;
* ``leaf_pspec`` (with and without FSDP) shape by shape, and
  ``param_pspecs`` / ``state_pspecs`` leaf by leaf over the full-width
  llama31-8b and granite-moe TrainStates (granite-moe's vocabulary 49155
  replicates);
* ``plan_pruning(mesh=...)``: every group's engine path (batched,
  rows-sharded, gram-sharded, single-device, skip) and the calibration
  bytes per device, on tiny llama31-8b under a mixed recipe at three Gram
  budgets and on full-width granite-34b (whose w_down Gram, 2.42 GB, is
  past the default budget).
"""
import itertools
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.dist import specs as jspecs  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.dist import specs as tspecs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

MESHES = [{"data": 4, "model": 2}, {"data": 8},
          {"pod": 2, "data": 2, "model": 2}]
IDS = ["data4_model2", "data8", "pod2_data2_model2"]
RECIPE = json.dumps({
    "defaults": {"pattern": "0.6", "t_max": 4},
    "rules": [{"select": "*.attn.wq", "pattern": "2:4"},
              {"select": "*.attn.wk", "method": "dsnot"},
              {"select": "*.attn.wv", "skip": True},
              {"select": "*.mlp.w_up", "method": "sparsegpt"},
              {"select": "*"}]})


def _ref_mesh(sizes):
    """The reference reads ``mesh.shape`` (a mapping) and ``mesh.size``."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 size=math.prod(sizes.values()))


def _entries(spec):
    return None if spec is None else tuple(spec)


def test_standard_rules_match():
    for mp, kv, moe, sp in itertools.product(
            (False, True), (False, True), ("tp", "ep", "local"),
            (False, True)):
        kw = dict(multi_pod=mp, kv_shardable=kv, moe_parallelism=moe,
                  seq_parallel=sp)
        assert tsharding.standard_rules(**kw) == \
            jsharding.standard_rules(**kw), kw


@pytest.mark.parametrize("sizes", MESHES, ids=IDS)
def test_logical_pspec_matches(sizes):
    cases = [((8, 128, 64), ("batch", "seq", None)),
             ((6, 128, 64), ("batch", "seq", "heads")),
             ((8, 16, 4, 32), ("batch", "seq", "kv_heads", None)),
             ((8, 4, 96), ("batch", "expert", "mlp")),
             ((256, 64), ("vocab", None)),
             ((3, 5), (None, None)),
             ((16, 16), ("seq", "heads"))]
    for mp, moe in itertools.product((False, True), ("tp", "ep")):
        rules = jsharding.standard_rules(multi_pod=mp, kv_shardable=True,
                                         moe_parallelism=moe)
        for shape, names in cases:
            want = jsharding.logical_pspec(shape, names, rules, sizes)
            got = tsharding.logical_pspec(shape, names, rules, sizes)
            assert got == _entries(want), (shape, names, mp, moe)


def test_use_rules_nests_and_activate_installs_the_mesh_rules():
    assert tsharding.active_rules() is None
    outer, inner = {"batch": ("data",)}, {"batch": None}
    with tsharding.use_rules(outer, "m1"):
        with tsharding.use_rules(inner, "m2"):
            assert tsharding.active_rules() == (inner, "m2")
        assert tsharding.active_rules() == (outer, "m1")
    assert tsharding.active_rules() is None
    cfg = tconfigs.get_tiny("llama31-8b")          # 2 KV heads
    sizes = {"pod": 2, "data": 2, "model": 2}
    with mesh_lib.activate(sizes, cfg) as m:
        rules, mesh = tsharding.active_rules()
        assert m is sizes and mesh is sizes
        assert rules == jsharding.standard_rules(
            multi_pod=True, kv_shardable=True, moe_parallelism="tp")
    assert tsharding.active_rules() is None


@pytest.mark.parametrize("sizes", MESHES, ids=IDS)
def test_batch_and_calib_pspecs_match(sizes):
    batch = {"tokens": (8, 128), "labels": (8, 128), "odd": (3, 5),
             "img": (16, 1600, 64), "scalar": ()}
    state = {"wq": {"g": (2, 64, 64), "s": (2, 64), "n": (2,)},
             "w_down": {"g": (2, 96, 96), "s": (2, 96), "n": (2,)},
             "odd": {"g": (2, 6, 6), "s": (2, 6), "n": (2,)},
             "shared": {"g": (64, 64), "d": (64,), "n": ()},
             "moe": {"g": (2, 4, 32, 32), "s": (2, 4, 32), "n": (2, 4)}}

    def jtree(tree):
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, "float32"),
                            tree, is_leaf=lambda x: isinstance(x, tuple))

    def ttree(tree):
        return {k: ttree(v) if isinstance(v, dict)
                else torch.empty(v, device="meta") for k, v in tree.items()}

    mesh = _ref_mesh(sizes)
    cfg = jconfigs.get_tiny("llama31-8b")
    for want_tree, got_tree in (
            (jspecs.batch_pspecs(cfg, jtree(batch), mesh),
             tspecs.batch_pspecs(cfg, ttree(batch), sizes)),
            (jspecs.calib_pspecs(jtree(state), mesh),
             tspecs.calib_pspecs(ttree(state), sizes))):
        want = jax.tree_util.tree_flatten_with_path(
            want_tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))[0]
        assert len(want) == sum(1 for _ in _walk(got_tree))
        for path, spec in want:
            node = got_tree
            for k in path:
                node = node[k.key]
            assert node == tuple(spec), (path, node, spec)


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v


def _plans(name, sizes, budget, *, tiny):
    jcfg = jconfigs.get_tiny(name) if tiny else jconfigs.get(name)
    tcfg = tconfigs.get_tiny(name) if tiny else tconfigs.get(name)
    japi, tapi = jmodels.build(jcfg), tmodels.build(tcfg)
    jshapes = jax.eval_shape(lambda: japi.init(jax.random.key(0)))
    kw = {} if budget is None else {"gram_budget_bytes": budget}
    jplan = jpruning.plan_pruning(
        japi, jshapes, jpruning.PruneRecipe.from_json(RECIPE),
        mesh=_ref_mesh(sizes), **kw)
    tplan = tpruning.plan_pruning(
        tapi, tapi.init(seed=0, device="meta"),
        tpruning.PruneRecipe.from_json(RECIPE), mesh=sizes, **kw)
    return jplan, tplan


@pytest.mark.parametrize("budget", [None, 0, 20000])
@pytest.mark.parametrize("sizes", MESHES, ids=IDS)
def test_plan_engine_paths_and_calib_bytes_match(sizes, budget):
    jplan, tplan = _plans("llama31-8b", sizes, budget, tiny=True)
    got = [(g.name, g.engine_path) for g in tplan.groups]
    assert got == [(g.name, g.engine_path) for g in jplan.groups]
    paths = {p for _, p in got}
    # 2:4 stays rows-sharded at any budget; 20000 B holds a 64-wide fp32
    # Gram (16 KiB) but not a 96-wide one
    assert {"skip", "single-device", "rows-sharded"} <= paths
    assert ("gram-sharded" in paths) == (budget is not None)
    assert tplan.single_device_groups() == jplan.single_device_groups()
    for minimal in (True, False):
        assert tplan.calib_bytes_per_device(minimal=minimal) == \
            jplan.calib_bytes_per_device(minimal=minimal)
    text = tplan.describe()
    assert f"({math.prod(sizes.values())} devices)" in text
    assert "refine single-device despite mesh=" in text
    assert "MiB/device" in text


def test_plan_full_width_gram_sharded_site_matches():
    sizes = {"data": 8}
    jplan, tplan = _plans("granite-34b", sizes, None, tiny=False)
    got = {g.name: g.engine_path for g in tplan.groups}
    assert got == {g.name: g.engine_path for g in jplan.groups}
    assert got["layers.mlp.w_down"] == "gram-sharded"
    assert tplan.calib_bytes_per_device() == jplan.calib_bytes_per_device()
    # no mesh: every refined group batched, the whole state on the device
    tapi = tmodels.build(tplan.cfg)
    tnone = tpruning.plan_pruning(tapi, tapi.init(seed=0, device="meta"),
                                  tpruning.PruneRecipe.from_json(RECIPE))
    assert {g.engine_path for g in tnone.groups} == {"batched", "skip"}
    assert tnone.calib_bytes_per_device() == tnone.total_calib_bytes()


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


LEAF_SHAPES = [(), (64,), (64, 64), (96, 64), (64, 96), (2, 64, 96),
               (49155, 1536), (1536, 49155), (40, 512, 1536), (3, 5),
               (8, 4, 4096, 14336)]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("sizes", MESHES + [{"data": 2, "model": 2}],
                         ids=IDS + ["data2_model2"])
def test_leaf_pspec_matches(sizes, fsdp):
    mesh = _ref_mesh(sizes)
    for shape in LEAF_SHAPES:
        want = jspecs.leaf_pspec(("w",), shape, None, mesh, fsdp=fsdp)
        got = tspecs.leaf_pspec(("w",), shape, None, sizes, fsdp=fsdp)
        assert got == _padded(want, len(shape)), (shape, got, want)


@pytest.mark.parametrize("name", ["llama31-8b", "granite-moe-3b-a800m"])
def test_param_and_state_pspecs_match(name):
    """Every leaf of the full-width params and TrainState (shapes only);
    granite-moe's vocabulary 49155 divides neither axis, so its embedding
    keeps "data" on d_model and replicates the vocabulary dim."""
    from repro.optim import adamw as jadamw
    from repro.train import steps as jsteps

    from repro_torch.train import steps as tsteps

    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    jparams = jax.eval_shape(lambda: jmodels.build(jcfg).init(
        jax.random.key(0)))
    jstate = jax.eval_shape(lambda: jsteps.TrainState(
        jparams, jadamw.init(jparams)))
    tstate = tsteps.abstract_state(tmodels.build(tcfg))
    sizes = {"data": 2, "model": 2}
    mesh = _ref_mesh(sizes)
    want = jax.tree_util.tree_flatten_with_path(
        jspecs.state_pspecs(jcfg, jstate, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    got = tspecs.state_pspecs(tcfg, tstate, sizes)
    from repro_torch.ckpt.store import _flatten

    flat = dict(_flatten(got))
    assert len(flat) == len(want)
    for path, spec in want:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", "")))
                       if not hasattr(k, "name") else f".{k.name}"
                       for k in path)
        assert flat[key] == _padded(spec, len(shapes[path].shape)), key
    emb = flat[".params/embed"]
    assert emb == ((None, "data") if tcfg.vocab_size == 49155
                   else ("model", "data"))
    assert tspecs.param_pspecs(tcfg, tstate.params, sizes) == got.params
