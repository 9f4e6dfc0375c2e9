"""The port's executor, plans and streaming statistics vs the reference's.

Tiny llama31-8b (2 layers). The reference initialises the params and
samples the calibration batches; both reach the port through numpy, and
both packages refine from the SAME taps unless a test accumulates its own.

* the ``prune_model`` shim and a mixed recipe (2:4 sparseswaps, sparsegpt,
  skip, dsnot, 0.6 sparseswaps with compaction) give the reference's masks
  and swap counts; losses within rtol 1e-5 (fp32, FMA contraction on
  XLA's CPU backend); SparseGPT's updated weights within 1e-3 of
  max|W'| and its losses, a quadratic form of them, within rtol 1e-3:
  the damped Hessian's fp32 inverse and Cholesky factor come from two
  libraries, and at condition numbers of 8e2-1.5e3 (96 calibration
  tokens, d = 64, 1% damping) fp32 rounding alone allows up to ~1e-4
  relative error in H⁻¹, which each column's OBS update then spreads
  (measured: 1.9e-4 of max|W'|);
* group checkpoints: kill-after-k resume is bitwise, other weights or a
  stale rule recompute, a bad refiner fails at its group, and each
  package resumes from the other's checkpoints without recomputing (the
  rule tag and the data fingerprint agree, bf16 and moments level too);
* streaming statistics within fp32 tolerance of the reference's
  ``accumulate_stats`` (rtol 1e-5: sums in another order); skip rules
  accumulate nothing; moments level; calibration-checkpoint resume, also
  from the reference's checkpoint; the spec fingerprints are equal.
"""
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
from repro.pruning import executor as jexecutor  # noqa: E402
from repro.pruning import sites as jsites  # noqa: E402
from repro.pruning import stats as jstats  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.pruning import executor as texecutor  # noqa: E402
from repro_torch.pruning import sites as tsites  # noqa: E402
from repro_torch.pruning import stats as tstats  # noqa: E402

ARCH = "llama31-8b"
MIXED = {"defaults": {"pattern": "0.6", "t_max": 6},
         "rules": [{"select": "*.attn.wq", "pattern": "2:4"},
                   {"select": "*.attn.wo", "pattern": "2:4"},
                   {"select": "*.attn.wk", "method": "sparsegpt"},
                   {"select": "*.attn.wv", "skip": True},
                   {"select": "*.mlp.w_down", "method": "dsnot"},
                   {"select": "*"}]}


@pytest.fixture(scope="module")
def world():
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    calib = [jax.tree.map(np.asarray, b) for b in jpruning.calibration_batches(
        jcfg, n_samples=4, seq_len=24, batch_size=2, seed=0)]
    jtaps = jpruning.accumulate(japi, jparams, calib)
    return dict(
        japi=japi, jparams=jparams, calib=calib, jtaps=jtaps,
        tapi=tmodels.build(tconfigs.get_tiny(ARCH)),
        tparams=convert.from_numpy(jax.tree.map(np.asarray, jparams)),
        tcalib=[convert.from_numpy(b) for b in calib],
        ttaps=convert.from_numpy(jax.tree.map(np.asarray, jtaps)))


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_masks_equal(got: dict, want: dict):
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(gl) == sorted(wl)
    for k in wl:
        assert np.array_equal(_np(gl[k]), _np(wl[k])), k


def _assert_sites_match(got, want):
    """Equal names, rules and swap counts; losses within rtol 1e-5, and
    1e-3 for sparsegpt (see the module docstring)."""
    assert [s.name for s in got.sites] == [s.name for s in want.sites]
    for gs, ws in zip(got.sites, want.sites):
        assert (gs.pattern, gs.method) == (ws.pattern, ws.method), gs.name
        assert np.array_equal(_np(gs.swaps), _np(ws.swaps)), gs.name
        np.testing.assert_allclose(
            _np(gs.loss_final), _np(ws.loss_final),
            rtol=1e-3 if gs.method == "sparsegpt" else 1e-5, err_msg=gs.name)


def _plans(world, recipe_doc, **kw):
    import json

    text = json.dumps(recipe_doc)
    jplan = jpruning.plan_pruning(world["japi"], world["jparams"],
                                  jpruning.PruneRecipe.from_json(text), **kw)
    tplan = tpruning.plan_pruning(world["tapi"], world["tparams"],
                                  tpruning.PruneRecipe.from_json(text), **kw)
    return jplan, tplan


class _Count(tpruning.PruneCallback):
    def __init__(self):
        self.restored, self.computed = [], []

    def on_group_done(self, planned, report, *, restored):
        (self.restored if restored else self.computed).append(planned.name)


class _KillAfter(tpruning.PruneCallback):
    def __init__(self, k):
        self.k, self.done = k, 0

    def on_group_done(self, planned, report, *, restored):
        self.done += 1
        if self.done == self.k:
            raise KeyboardInterrupt


# ---------------------------------------------------------------------------
# the shim and mixed recipes against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["none", "sparseswaps", "sparsegpt",
                                    "dsnot"])
def test_prune_model_shim_matches_reference(world, method):
    pat = "0.6"
    want = jpruning.prune_model(world["japi"], world["jparams"], None,
                                jmasks.parse_pattern(pat), method=method,
                                t_max=6, taps=world["jtaps"])
    got = tpruning.prune_model(world["tapi"], world["tparams"], None,
                               tmasks.parse_pattern(pat), method=method,
                               t_max=6, taps=world["ttaps"])
    _assert_masks_equal(got.masks, want.masks)
    _assert_sites_match(got, want)
    assert (got.method, got.pattern) == (want.method, want.pattern)
    # the shim is the staged path, bitwise
    plan = tpruning.plan_pruning(world["tapi"], world["tparams"],
                                 tpruning.PruneRecipe.single(
                                     pat, method=method, t_max=6))
    staged = tpruning.PruneExecutor(world["tapi"], world["tparams"], plan,
                                    taps=world["ttaps"]).run()
    _assert_masks_equal(staged.masks, got.masks)
    if method == "sparsegpt":
        gu, wu = dict(_leaves(got.updated_params)), dict(
            _leaves(jax.tree.map(np.asarray, want.updated_params)))
        for k in wu:
            scale = float(np.abs(wu[k]).max())
            np.testing.assert_allclose(_np(gu[k]), wu[k], rtol=0,
                                       atol=1e-3 * scale, err_msg=k)
    else:
        assert got.updated_params is None


def test_mixed_recipe_matches_reference(world):
    jplan, tplan = _plans(world, MIXED, compact_every=2)
    want = jpruning.PruneExecutor(world["japi"], world["jparams"], jplan,
                                  taps=world["jtaps"]).run()
    got = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                                 taps=world["ttaps"]).run()
    _assert_masks_equal(got.masks, want.masks)
    _assert_sites_match(got, want)
    assert "wv" not in got.masks["layers"]["attn"]            # skipped: dense
    assert got.method == got.pattern == "mixed"
    for s in got.sites:
        node = got.masks
        for k in s.name.split("."):
            node = node[k]
        assert tmasks.validate_mask(node, tmasks.parse_pattern(s.pattern))
    # the engine's per-instance reference loop agrees
    ref = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                                 taps=world["ttaps"],
                                 engine_mode="reference").run()
    _assert_masks_equal(ref.masks, got.masks)
    loss, _ = world["tapi"].loss(world["tparams"], world["tcalib"][0],
                                 masks=got.masks)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# group checkpoints
# ---------------------------------------------------------------------------

def test_kill_after_k_groups_resumes_bitwise(world, tmp_path):
    _, plan = _plans(world, MIXED)
    run = lambda cb=None: tpruning.PruneExecutor(
        world["tapi"], world["tparams"], plan, taps=world["ttaps"],
        ckpt_dir=tmp_path, callback=cb).run()
    clean = tpruning.PruneExecutor(world["tapi"], world["tparams"], plan,
                                   taps=world["ttaps"]).run()
    k = 3
    with pytest.raises(KeyboardInterrupt):
        run(_KillAfter(k))
    cnt = _Count()
    resumed = run(cnt)
    assert len(cnt.restored) == k
    assert len(cnt.computed) == len(plan.active_groups) - k
    _assert_masks_equal(resumed.masks, clean.masks)
    for a, b in zip(clean.sites, resumed.sites):
        for f in ("loss_init", "loss_final", "swaps"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (a.name, f)
    assert torch.equal(resumed.updated_params["layers"]["attn"]["wk"],
                       clean.updated_params["layers"]["attn"]["wk"])


def test_resume_rejects_other_weights_and_stale_rules(world, tmp_path):
    api, params, taps = world["tapi"], world["tparams"], world["ttaps"]
    recipe = tpruning.PruneRecipe.single(tmasks.PerRow(0.6), t_max=4)
    tpruning.PruneExecutor(api, params, tpruning.plan_pruning(
        api, params, recipe), taps=taps, ckpt_dir=tmp_path).run()
    params2 = {**params, "layers": {
        **params["layers"], "attn": {**params["layers"]["attn"],
                                     "wq": params["layers"]["attn"]["wq"]
                                     * 1.01}}}
    cnt = _Count()
    tpruning.PruneExecutor(api, params2, tpruning.plan_pruning(
        api, params2, recipe), taps=taps, ckpt_dir=tmp_path,
        callback=cnt).run()
    assert cnt.computed == ["layers.attn.wq"]     # only the changed weights
    cnt = _Count()
    stale = tpruning.PruneRecipe.single(tmasks.PerRow(0.6), t_max=5)
    tpruning.PruneExecutor(api, params, tpruning.plan_pruning(
        api, params, stale), taps=taps, ckpt_dir=tmp_path,
        callback=cnt).run()
    assert not cnt.restored                      # every group recomputed


def test_bad_refiner_fails_at_offending_group(world, tmp_path):
    api, params, taps = world["tapi"], world["tparams"], world["ttaps"]

    @tpruning.register("keep_all")
    def _keep_all(W, gram, pattern, ctx):
        loss = torch.zeros(W.shape[:2])
        return tpruning.GroupResult(masks=torch.ones(W.shape), loss_init=loss,
                                    loss_final=loss,
                                    swaps=torch.zeros(W.shape[:2]))

    try:
        recipe = tpruning.PruneRecipe(
            rules=(tpruning.SiteRule("*.mlp.w_up", method="keep_all"),),
            pattern=tmasks.PerRow(0.5), t_max=2)
        plan = tpruning.plan_pruning(api, params, recipe)
        with pytest.raises(ValueError, match=r"keep_all.*layers\.mlp\.w_up"):
            tpruning.PruneExecutor(api, params, plan, taps=taps,
                                   ckpt_dir=tmp_path).run()
        assert tckpt.latest_valid(tmp_path / "groups" / "layers.mlp.w_up") \
            is None
    finally:
        from repro_torch.pruning import engine

        del engine.REFINERS["keep_all"]


class _JCount(jpruning.PruneCallback):
    def __init__(self):
        self.restored, self.computed = [], []

    def on_group_done(self, planned, report, *, restored):
        (self.restored if restored else self.computed).append(planned.name)


def test_resume_across_packages(world, tmp_path):
    """The port restores every group the reference checkpointed (and the
    reference the port's) without recomputing, with the reference's masks."""
    jplan, tplan = _plans(world, MIXED)
    want = jpruning.PruneExecutor(world["japi"], world["jparams"], jplan,
                                  taps=world["jtaps"],
                                  ckpt_dir=tmp_path / "ref").run()
    cnt = _Count()
    got = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                                 taps=world["ttaps"], ckpt_dir=tmp_path / "ref",
                                 callback=cnt).run()
    assert not cnt.computed and len(cnt.restored) == len(tplan.active_groups)
    _assert_masks_equal(got.masks, want.masks)
    assert np.array_equal(
        _np(got.updated_params["layers"]["attn"]["wk"]),
        np.asarray(want.updated_params["layers"]["attn"]["wk"]))
    tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                           taps=world["ttaps"],
                           ckpt_dir=tmp_path / "port").run()
    jcnt = _JCount()
    jpruning.PruneExecutor(world["japi"], world["jparams"], jplan,
                           taps=world["jtaps"], ckpt_dir=tmp_path / "port",
                           callback=jcnt).run()
    assert not jcnt.computed and len(jcnt.restored) == len(jplan.active_groups)


@pytest.mark.parametrize("level", ["gram", "moments"])
def test_data_fingerprint_matches_reference(level):
    """bf16 weights hash as their 2-byte patterns, Grams as fp32; moments
    level hashes the diagonal and the means."""
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=(2, 6, 8)), jnp.bfloat16)
    g = rng.normal(size=(2, 8, 8)).astype(np.float32)
    s = rng.normal(size=(2, 8)).astype(np.float32)
    n = np.array([5.0, 5.0], np.float32)
    diag = np.abs(rng.normal(size=(2, 8))).astype(np.float32)
    entry = ({"g": g, "s": s, "n": n} if level == "gram"
             else {"d": diag, "s": s, "n": n})
    jg = jsites.SiteGroup(name="layers.attn.wq", weights=w,
                          gram=jsites._gram_batch(
                              {k: jnp.asarray(v) for k, v in entry.items()},
                              1),
                          mask_path=("layers", "attn", "wq"), stack_shape=(2,))
    tg = tsites.SiteGroup(name="layers.attn.wq",
                          weights=convert.from_numpy(np.asarray(w)),
                          gram=tsites._gram_batch(convert.from_numpy(entry)),
                          mask_path=("layers", "attn", "wq"), stack_shape=(2,))
    assert tg.weights.dtype == torch.bfloat16
    assert texecutor._data_fingerprint(tg) == jexecutor._data_fingerprint(jg)


# ---------------------------------------------------------------------------
# streaming statistics
# ---------------------------------------------------------------------------

def _assert_taps_close(got, want):
    gl, wl = dict(_leaves(got)), dict(_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(gl) == sorted(wl)
    for k, v in wl.items():
        np.testing.assert_allclose(_np(gl[k]), v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_streaming_stats_match_reference(world):
    got = tstats.accumulate_stats(world["tapi"], world["tparams"],
                                  world["tcalib"])
    assert got.batches == len(world["calib"])
    _assert_taps_close(got.taps, world["jtaps"])
    assert got.tap_bytes() == sum(
        np.asarray(x).nbytes for x in jax.tree.leaves(world["jtaps"]))


def test_skip_and_moments_levels_match_reference(world):
    doc = {"defaults": {"pattern": "0.6", "t_max": 5},
           "rules": [{"select": "*.mlp.w_down", "skip": True},
                     {"select": "*.attn.*", "method": "dsnot",
                      "pattern": "0.5"},
                     {"select": "*"}]}
    jplan, tplan = _plans(world, doc)
    for minimal in (True, False):
        jspec = jplan.calib_spec(minimal=minimal)
        tspec = tplan.calib_spec(minimal=minimal)
        assert tspec.levels == jspec.levels
        assert tspec.fingerprint() == jspec.fingerprint()
        got = tstats.accumulate_stats(world["tapi"], world["tparams"],
                                      world["tcalib"], spec=tspec)
        want = jstats.accumulate_stats(world["japi"], world["jparams"],
                                       world["calib"], spec=jspec)
        assert "w_down" not in got.taps                    # skipped: no state
        want_fields = {"d", "s", "n"} if minimal else {"g", "s", "n"}
        assert set(got.taps["wq"]) == want_fields
        assert set(got.taps["w_gate"]) == {"g", "s", "n"}
        _assert_taps_close(got.taps, want.taps)
    # moments-level stats refine to the full taps' masks (dsnot reads only
    # the diagonal and the moments); given the reference's moments, the
    # port gives its masks and diagonal-proxy losses
    rep_full = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                                      taps=world["ttaps"]).run()
    moments = tstats.accumulate_stats(world["tapi"], world["tparams"],
                                      world["tcalib"],
                                      spec=tplan.calib_spec(minimal=True))
    rep_mom = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                                     stats=moments).run()
    _assert_masks_equal(rep_mom.masks, rep_full.masks)
    jmom = jstats.accumulate_stats(world["japi"], world["jparams"],
                                   world["calib"],
                                   spec=jplan.calib_spec(minimal=True))
    jrep = jpruning.PruneExecutor(world["japi"], world["jparams"], jplan,
                                  stats=jmom).run()
    shared = tstats.CalibStats(
        taps=convert.from_numpy(jax.tree.map(np.asarray, jmom.taps)),
        spec=tplan.calib_spec(minimal=True))
    got = tpruning.PruneExecutor(world["tapi"], world["tparams"], tplan,
                                 stats=shared).run()
    _assert_masks_equal(got.masks, jrep.masks)
    _assert_sites_match(got, jrep)
    ss = tpruning.plan_pruning(world["tapi"], world["tparams"],
                               tpruning.PruneRecipe.single("0.5", t_max=2))
    with pytest.raises(ValueError, match="does not cover"):
        tpruning.PruneExecutor(world["tapi"], world["tparams"], ss,
                               stats=moments)


def test_calib_checkpoint_resume(world, tmp_path):
    """An interrupted accumulation resumes at the saved batch — from the
    port's checkpoint and from the reference's — and a different spec
    recomputes."""
    api, params, calib = world["tapi"], world["tparams"], world["tcalib"]
    spec = tstats.CalibSpec.full(api.cfg)
    full = tstats.accumulate_stats(api, params, calib, spec=spec)
    tstats.accumulate_stats(api, params, calib[:1], spec=spec,
                            ckpt_dir=tmp_path / "port", checkpoint_every=1)
    jstats.accumulate_stats(world["japi"], world["jparams"],
                            world["calib"][:1],
                            spec=jstats.CalibSpec.full(world["japi"].cfg),
                            ckpt_dir=tmp_path / "ref", checkpoint_every=1)
    for d in ("port", "ref"):
        resumed = tstats.accumulate_stats(api, params, calib, spec=spec,
                                          ckpt_dir=tmp_path / d,
                                          checkpoint_every=1)
        assert resumed.batches == len(calib)
        for (k, a), (_, b) in zip(_leaves(full.taps), _leaves(resumed.taps)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4, msg=k)
    other = tstats.CalibSpec(levels=(("wq", "moments"),))
    st = tstats.accumulate_stats(api, params, calib[:1], spec=other,
                                 ckpt_dir=tmp_path / "port")
    assert st.batches == 1 and set(st.taps) == {"wq"}
    assert set(st.taps["wq"]) == {"d", "s", "n"}


def test_spec_covers_fingerprint_and_errors():
    levels = [(("wq", "gram"), ("wk", "moments")), (("wq", "moments"),),
              (("w_down", "none"), ("wq", "gram"))]
    for lv in levels:
        assert tstats.CalibSpec(levels=lv).fingerprint() == \
            jstats.CalibSpec(levels=lv).fingerprint()
    a, b = tstats.CalibSpec(levels=levels[0]), tstats.CalibSpec(
        levels=levels[1])
    assert a.covers(b) and not b.covers(a)
    with pytest.raises(ValueError, match="unknown levels"):
        tstats.CalibSpec(levels=(("wq", "huge"),))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstats.accumulate_stats(None, None, [], mesh=object())
