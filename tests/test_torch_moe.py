"""The port's MoE family (mixtral-8x7b, granite-moe-3b-a800m) against the
reference, on the CPU.

Inputs are made with numpy from seeds (or by the reference and carried
over through numpy, ``repro_torch.convert``), fp32, TINY configs. What is
held, and at what tolerance:

* configs: every field equal to the reference's (CONFIG and TINY); at
  full width the meta-device param tree, ``param_count`` and the active
  count, the plan's sites and bytes equal the reference's;
* dispatch: ``dest`` (slots, drops, order) exactly, the capacity buffer
  and the combine bitwise (copies and one gate product per element);
* ``moe_block``'s output within 1e-5 of max|out| and aux within 1e-6
  relative, on both TINYs, at ``moe_group_size`` 8 and at a
  non-dividing 7 (the whole sequence): fp32 matmuls summed in another
  order; routing runs on fp32 router logits the reference's XLA CPU
  contracts into FMAs, so a near-tied pair of logits could pick another
  expert: the test then fails naming the token (no test data here has
  one: the smallest top-k gap is printed on failure);
* the per-expert tap entries g / d / s / n within 1e-5 of each max;
* params through numpy and back bitwise (fp32 router, expert stacks);
  whole-model loss, prefill and decode logits within 1e-5 of
  max|logits|, mixtral at S = 24 > its sliding window 16; a checkpointed
  calibration resumes over the per-expert tap shapes, bitwise;
* site names, labels and a mixed recipe (N:M experts, PerRow attention);
* ``prune_model`` given the reference's Grams: equal masks, swaps and
  pass counts (k = 1; PerRow(0.6) on mixtral, 2:4 on granite-moe);
* ``pack_tree`` of (L, E, f, d) leaves bitwise the reference's; packed
  (nm24, gathered) vs masked decode logits within 1e-5 of max|logits|,
  nm24 == gathered bitwise, greedy tokens the reference's;
* the plain stacked Gram and spmm bitwise their unstacked plain versions
  per slice.
"""
import dataclasses
import math

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
from repro.core import sparseswaps as jss  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.core import sparseswaps as tss  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spmm as tspmm  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.pruning import plan as tplan  # noqa: E402
from repro_torch.pruning import recipe as trecipe  # noqa: E402
from repro_torch.pruning import sites as tsites  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

MOE = ["mixtral-8x7b", "granite-moe-3b-a800m"]
TOL = 1e-5      # of the compared tensor's max: fp32 sums in another order


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# configs and full-width shapes
# ---------------------------------------------------------------------------

def test_registry_order_and_fields():
    ported = [n for n in jconfigs.ARCHS if n in tconfigs.ARCHS]
    assert list(tconfigs.ARCHS) == ported and set(MOE) <= set(ported)
    fields = {f.name for f in dataclasses.fields(tconfigs.ArchConfig)}
    for arch in MOE:
        for t, j in ((tconfigs.get(arch), jconfigs.get(arch)),
                     (tconfigs.get_tiny(arch), jconfigs.get_tiny(arch))):
            for f in sorted(fields):
                assert getattr(t, f) == getattr(j, f), (arch, f)
            assert t.is_moe and t.head_dim == j.head_dim
    # every family is ported: a config of no special family (no rwkv,
    # encoder or hybrid fields) runs the transformer in both packages
    odd = {"family": "ssm"}
    assert tmodels.build(tconfigs.get("llama31-8b").replace(**odd)).module \
        is tmodels.transformer
    assert jmodels.build(jconfigs.get("llama31-8b").replace(**odd)).module \
        is jmodels.transformer
    with pytest.raises(NotImplementedError, match="A5"):
        cfg = tconfigs.get_tiny("mixtral-8x7b").replace(moe_parallelism="ep")
        api = tmodels.build(cfg)
        api.loss(api.init(device="cpu"),
                 {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                  "labels": torch.zeros((1, 4), dtype=torch.int64)})


@pytest.mark.parametrize("arch", MOE)
def test_full_width_params_counts_and_plan(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    japi, tapi = jmodels.build(jcfg), tmodels.build(tcfg)
    jshapes = jax.eval_shape(japi.init, jax.random.key(0))
    tparams = tapi.init(device="meta")
    want = {k: tuple(v.shape) for k, v in _leaves(jshapes)}
    assert {k: tuple(v.shape) for k, v in _leaves(tparams)} == want
    assert tparams["layers"]["moe"]["router"].dtype == torch.float32
    assert tcfg.n_params() == jmodels.param_count(jcfg) == \
        sum(math.prod(s) for s in want.values())
    assert tcfg.n_active_params() == jmodels.param_count(jcfg,
                                                          active_only=True)
    assert tcfg.n_active_params() < tcfg.n_params()
    jplan = jpruning.plan_pruning(
        japi, jshapes, jpruning.PruneRecipe.single(jmasks.PerRow(0.6)))
    tp = tplan.plan_pruning(
        tapi, tparams, trecipe.PruneRecipe.single(tmasks.PerRow(0.6)))
    assert [(g.name, g.spec.n_instances, g.spec.d_out, g.spec.d_in,
             g.weight_bytes, g.gram_bytes) for g in tp.groups] == \
        [(g.name, g.spec.n_instances, g.spec.d_out, g.spec.d_in,
          g.weight_bytes, g.gram_bytes) for g in jplan.groups]
    assert tp.total_calib_bytes() == jplan.total_calib_bytes()
    specs = {s.name: s for s in tsites.site_specs(tcfg, tparams)}
    up = specs["layers.moe.w_up"]
    assert up.stack_shape == (tcfg.n_layers, tcfg.n_experts)
    assert up.labels()[1] == "layers.moe.w_up[0, 1]"
    assert [t.name for t in tsites.tap_specs(tcfg, list(specs.values()))] \
        == ["wq", "wk", "wv", "wo", "moe_w_up", "moe_w_down"]


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def test_dispatch_and_combine_match_reference():
    """Crowded routing (16 tokens x top-2 over 4 experts, capacity 3), so
    slots fill and assignments drop; several groups at once."""
    rng = np.random.default_rng(0)
    NG, G, k, E, d, cap = 3, 16, 2, 4, 8, 3
    ids = np.stack([np.stack([rng.choice(E, k, replace=False)
                              for _ in range(G)]) for _ in range(NG)])
    x = rng.normal(size=(NG, G, d)).astype(np.float32)
    gates = rng.uniform(size=(NG, G, k)).astype(np.float32)
    jbuf, jdest, jg = [], [], []
    for g in range(NG):
        b, de, fg = jmoe._dispatch_group(jnp.asarray(x[g]),
                                         jnp.asarray(ids[g]),
                                         jnp.asarray(gates[g]),
                                         n_experts=E, cap=cap)
        jbuf.append(np.asarray(b))
        jdest.append(np.asarray(de))
        jg.append(fg)
    dest = tmoe._dispatch_group(torch.from_numpy(ids), n_experts=E, cap=cap)
    assert np.array_equal(dest.numpy(), np.stack(jdest))
    assert (dest == E * cap).any() and (dest < E * cap).any()
    buf, rows = tmoe._dispatch(torch.from_numpy(x.reshape(NG * G, d)), dest,
                               n_experts=E, cap=cap)
    # the reference's (NG, E, C, d) buffer, expert-major
    want = np.stack(jbuf).reshape(NG, E, cap, d).transpose(1, 0, 2, 3)
    assert np.array_equal(buf.numpy(), want.reshape(E, NG * cap, d))
    out = rng.normal(size=(E, NG * cap, d)).astype(np.float32)
    got = tmoe._combine_group(torch.from_numpy(out), rows,
                              torch.from_numpy(gates), top_k=k)
    ob = out.reshape(E, NG, cap, d).transpose(1, 0, 2, 3)
    want = np.concatenate([np.asarray(jmoe._combine_group(
        jnp.asarray(ob[g].reshape(E * cap, d)), jnp.asarray(jdest[g]),
        jg[g], group=G, top_k=k)) for g in range(NG)])
    assert np.array_equal(got.numpy(), want)


class _AllFields(jcommon.TapPolicy):
    def fields(self, name):
        return ("g", "d", "s", "n")


class _TAllFields(tcommon.TapPolicy):
    def fields(self, name):
        return ("g", "d", "s", "n")


# (arch, moe_group_size or None for the config's, S): mixtral's whole
# sequence, groups of 8, and granite's 40-expert top-8 block with a group
# size that does not divide S (the whole sequence again)
BLOCK_CASES = [("mixtral-8x7b", None, 24), ("mixtral-8x7b", 8, 24),
               ("granite-moe-3b-a800m", 7, 16)]


@pytest.mark.parametrize("arch,gsz,S", BLOCK_CASES)
def test_moe_block_and_taps_match(arch, gsz, S):
    jcfg, tcfg = jconfigs.get_tiny(arch), tconfigs.get_tiny(arch)
    if gsz is not None:
        jcfg, tcfg = (c.replace(moe_group_size=gsz) for c in (jcfg, tcfg))
    jp = jmoe.init_moe_params(jax.random.key(1), jcfg)
    x = np.random.default_rng(2).normal(size=(2, S, jcfg.d_model)).astype(
        np.float32)
    def block(p, xx):
        taps = {}
        out, aux = jmoe.moe_block(p, xx, jcfg, taps=taps)
        return out, aux, taps

    with jcommon.use_tap_policy(_AllFields()):
        jout, jaux, jtaps = jax.jit(block)(jp, jnp.asarray(x))
    taps = tcommon.Taps(_TAllFields())
    tp = convert.from_numpy(_np(jp))
    with torch.no_grad():
        out, aux = tmoe.moe_block(tp, torch.from_numpy(x), tcfg, taps=taps)
    logits = x @ np.asarray(jp["router"]).T
    top2 = np.sort(logits, -1)[..., ::-1]
    gap = (top2[..., jcfg.top_k - 1] - top2[..., jcfg.top_k]).min()
    _close(out, jout, msg=f"smallest top-k gap {gap:.3e}")
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    for name in ("moe_w_up", "moe_w_down"):
        for f in ("g", "d", "s", "n"):
            _close(taps.entries[name][f], jtaps[name][f], msg=f"{name}/{f}")
    n = taps.entries["moe_w_up"]["n"]
    assert float(n.sum()) <= 2 * S * jcfg.top_k
    tr = torch.diagonal(taps.entries["moe_w_up"]["g"], dim1=1, dim2=2).sum(1)
    assert torch.equal(tr > 0, n > 0)


# ---------------------------------------------------------------------------
# the whole model, pruning and serving
# ---------------------------------------------------------------------------

def _moe_masks(cfg, jparams, seed, pattern):
    """Masks of every prunable site from seeded scores, as numpy."""
    rng = np.random.default_rng(seed)
    tree = {"layers": {"attn": {}, "moe": {}}}
    for spec in tsites.site_specs(cfg, jparams):
        _, block, name = spec.name.split(".")
        shape = jparams["layers"][block][name].shape
        scores = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        m = tmasks.make_mask(scores.reshape(-1, shape[-1]), pattern)
        tree["layers"][block][name] = m.reshape(shape).numpy()
    return tree


@pytest.fixture(scope="module", params=MOE)
def world(request):
    arch = request.param
    jcfg = jconfigs.get_tiny(arch)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    calib = [_np(b) for b in jpruning.calibration_batches(
        jcfg, n_samples=4, seq_len=24, batch_size=2, seed=0)]
    return dict(arch=arch, japi=japi, jparams=jparams, calib=calib,
                jtaps=jpruning.accumulate(japi, jparams, calib),
                tapi=tmodels.build(tconfigs.get_tiny(arch)),
                tparams=convert.from_numpy(_np(jparams)),
                tcalib=[convert.from_numpy(b) for b in calib])


def test_loss_taps_prefill_decode_match(world):
    japi, tapi = world["japi"], world["tapi"]
    jp, tp = world["jparams"], world["tparams"]
    back = dict(_leaves(convert.to_numpy(tp)))       # and back, bitwise
    for name, w in _leaves(_np(jp)):
        assert back[name].dtype == w.dtype and np.array_equal(back[name], w)
    batch, tbatch = world["calib"][0], world["tcalib"][0]
    jl, jaux = jax.jit(japi.loss)(jp, batch)
    with torch.no_grad():
        tl, taux = tapi.loss(tp, tbatch)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(taux["aux"]) == pytest.approx(float(jaux["aux"]), rel=1e-5)
    assert float(taux["aux"]) > 0
    ttaps = tpruning.accumulate(tapi, tp, world["tcalib"])
    jt = dict(_leaves(_np(world["jtaps"])))
    tt = dict(_leaves(convert.to_numpy(ttaps)))
    assert sorted(jt) == sorted(tt)
    for name, w in jt.items():
        assert tt[name].shape == w.shape, name
        _close(tt[name], w, msg=name)
    # prefill of 20 tokens, then 2 decode steps: past mixtral's window 16
    toks = batch["tokens"]
    jc = japi.init_cache(jp, 2, 32)
    jlog, jc = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(toks[:, :20])},
                                     jc)
    jdecode = jax.jit(japi.decode_step)
    tc = tapi.init_cache(tp, 2, 32)
    tlog, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks[:, :20])},
                            tc)
    _close(tlog, jlog, msg="prefill")
    for i in range(20, 22):
        jlog, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        tlog, tc = tapi.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                    tc)
        _close(tlog, jlog, msg=f"decode at {i}")


def test_calibration_resumes_with_per_expert_shapes(world, tmp_path):
    """A checkpointed MoE calibration resumes (its (L, E, ...) tap leaves
    pass the shape check) and equals the uninterrupted run bitwise."""
    tapi, tp, calib = world["tapi"], world["tparams"], world["tcalib"]
    whole = tpruning.accumulate_stats(tapi, tp, calib)
    tpruning.accumulate_stats(tapi, tp, calib[:1], ckpt_dir=tmp_path,
                              checkpoint_every=1)
    # the first batch, restored, is never read again
    resumed = tpruning.accumulate_stats(tapi, tp, [None, *calib[1:]],
                                        ckpt_dir=tmp_path,
                                        checkpoint_every=1)
    assert resumed.batches == whole.batches == len(calib)
    got, want = dict(_leaves(resumed.taps)), dict(_leaves(whole.taps))
    assert got["moe_w_up.g"].shape == (tapi.cfg.n_layers, tapi.cfg.n_experts,
                                       tapi.cfg.d_model, tapi.cfg.d_model)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_same_grams_same_masks(world):
    """Unstructured on mixtral, 2:4 on granite-moe (the reference's
    compiles dominate; both patterns run per site group alike)."""
    spec = "0.6" if world["arch"] == "mixtral-8x7b" else "2:4"
    jtaps = world["jtaps"]
    with jss.count_search_passes() as jcnt:
        want = jpruning.prune_model(world["japi"], world["jparams"], None,
                                    jmasks.parse_pattern(spec), taps=jtaps,
                                    t_max=10, k_swaps=1)
    with tss.count_search_passes() as tcnt:
        got = tpruning.prune_model(world["tapi"], world["tparams"], None,
                                   tmasks.parse_pattern(spec),
                                   taps=convert.from_numpy(_np(jtaps)),
                                   t_max=10, k_swaps=1)
    assert (tcnt.passes, tcnt.rows_scored) == (jcnt.passes, jcnt.rows_scored)
    wl, gl = dict(_leaves(want.masks)), dict(_leaves(got.masks))
    assert sorted(wl) == sorted(gl) and "layers.moe.w_down" in gl
    for name in wl:
        assert np.array_equal(gl[name].numpy(), np.asarray(wl[name])), name
    for gs, ws in zip(got.sites, want.sites, strict=True):
        assert gs.name == ws.name
        assert np.array_equal(gs.swaps.numpy(), np.asarray(ws.swaps)), gs.name


def test_mixed_recipe_per_expert_groups(world):
    """N:M experts, PerRow(0.5) attention (the reference's
    test_mixed_recipe_moe): the masks land on the stacked expert dims,
    and a label rule with the expert index selects its group."""
    tapi, tp = world["tapi"], world["tparams"]
    recipe = trecipe.PruneRecipe(
        rules=(trecipe.SiteRule("layers.moe.*", pattern=tmasks.NM(2, 4)),
               trecipe.SiteRule("layers.attn.*",
                                pattern=tmasks.PerRow(0.5))),
        t_max=4)
    rep = tpruning.PruneExecutor(
        tapi, tp, tplan.plan_pruning(tapi, tp, recipe)).run(world["tcalib"])
    up = rep.masks["layers"]["moe"]["w_up"]
    assert up.shape == tp["layers"]["moe"]["w_up"].shape
    assert tmasks.validate_mask(up.reshape(-1, up.shape[-1]),
                                tmasks.NM(2, 4))
    assert tmasks.validate_mask(rep.masks["layers"]["attn"]["wq"],
                                tmasks.PerRow(0.5))
    with torch.no_grad():
        loss, _ = tapi.loss(tp, world["tcalib"][0], masks=rep.masks)
    assert math.isfinite(float(loss))
    specs = tsites.site_specs(tapi.cfg, tp)
    moe = next(s for s in specs if s.name == "layers.moe.w_up")
    r = trecipe.PruneRecipe(
        rules=(trecipe.SiteRule("layers.moe.w_up[0, 0]",
                                pattern=tmasks.NM(1, 4)),),
        pattern=tmasks.PerRow(0.5))
    r.validate(specs)
    assert r.resolve(moe.name, tuple(moe.labels())).pattern == \
        tmasks.NM(1, 4)


@pytest.mark.parametrize("pattern", ["2:4", "0.5"])
def test_packed_serving_matches_masked_and_reference(world, pattern):
    jcfg = world["japi"].cfg
    pat = tmasks.parse_pattern(pattern)
    jm = _moe_masks(jcfg, world["jparams"], 3, pat)
    tm = convert.from_numpy(jm)
    prompt = {"tokens": world["calib"][1]["tokens"][:, :12]}
    tprompt = convert.from_numpy(prompt)
    fmts = ["gathered"] + (["nm24"] if pattern == "2:4" else [])
    for fmt in fmts:
        want = jpacked.pack_tree(jcfg, world["jparams"], jm, fmt)
        got = tpacked.pack_tree(world["tapi"].cfg, world["tparams"], tm, fmt)
        for name in ("w_gate", "w_up", "w_down"):
            wl, gl = want["layers"]["moe"][name], got["layers"]["moe"][name]
            assert gl.values.shape[:2] == (jcfg.n_layers, jcfg.n_experts)
            assert np.array_equal(gl.values.numpy(), np.asarray(wl.values))
            assert np.array_equal(gl.idx.numpy(), np.asarray(wl.idx))
    ref = ServeEngine(world["tapi"], world["tparams"], masks=tm,
                      fmt="masked", device="cpu")
    want_logits = ref.logits_trace(tprompt, 4)
    traces = {}
    for fmt in fmts:
        eng = ServeEngine(world["tapi"], world["tparams"], masks=tm,
                          fmt=fmt, device="cpu")
        traces[fmt] = eng.logits_trace(tprompt, 4)
        _close(traces[fmt], want_logits.numpy(), msg=fmt)
        assert eng.weight_bytes() < ref.weight_bytes()
    # the reference's greedy tokens (one format: its nm24 and gathered
    # serve the same tokens)
    jeng = JServeEngine(world["japi"], world["jparams"], masks=jm,
                        fmt="gathered", kernel="jnp")
    assert np.array_equal(eng.generate(tprompt, 4).tokens.numpy(),
                          np.asarray(jeng.generate(prompt, 4).tokens))
    if "nm24" in traces:
        assert torch.equal(traces["nm24"], traces["gathered"])


# ---------------------------------------------------------------------------
# the stacked plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_plain_versions_are_per_slice(dtype):
    rng = np.random.default_rng(4)
    E, T, d_in, d_out = 3, 10, 32, 24
    x = torch.from_numpy(rng.normal(size=(E, T, d_in)).astype(
        np.float32)).to(dtype)
    G = ops.gram_xtx_stacked(x)
    assert G.shape == (E, d_in, d_in) and G.dtype == torch.float32
    for e in range(E):
        assert torch.equal(G[e], tgram.gram_xtx_plain(x[e]))
    w = torch.from_numpy(rng.normal(size=(E, d_out, d_in)).astype(
        np.float32)).to(dtype)
    scores = torch.from_numpy(rng.uniform(size=(E * d_out, d_in)).astype(
        np.float32))
    bias = torch.from_numpy(rng.normal(size=d_out).astype(np.float32))
    for fmt, pat in (("nm24", tmasks.NM(2, 4)),
                     ("gathered", tmasks.PerRow(0.6))):
        m = tmasks.make_mask(scores, pat).reshape(E, d_out, d_in)
        pw = tpacked.pack(w, m, fmt)
        y = ops.spmm_stacked(x, pw, bias=bias, act="silu")
        assert y.shape == (E, T, d_out) and y.dtype == dtype
        for e in range(E):
            one = dataclasses.replace(pw, values=pw.values[e], idx=pw.idx[e])
            assert torch.equal(y[e], tspmm.spmm_plain(x[e], one, bias,
                                                      "silu")), (fmt, e)
    with pytest.raises(ValueError, match="spmm_stacked"):
        ops.spmm(x[0], pw)
    with pytest.raises(ValueError, match="stacked"):
        ops.spmm_stacked(x[0], dataclasses.replace(pw, values=pw.values[0],
                                                   idx=pw.idx[0]))
