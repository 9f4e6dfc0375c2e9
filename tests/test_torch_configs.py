"""The port's dense configs vs the reference's, at full width and tiny.

All five dense configs (the reference's four dense assigned architectures
and llama31-8b), at full width, on shapes alone:

* every field of the port's ``ArchConfig`` equals the reference's, in
  ``CONFIG`` and ``TINY`` (zamba2-7b's, rwkv6-1.6b's and the
  cross-attention families' too, the hybrid family's SSM fields,
  ``d_inner`` / ``n_ssm_heads``, the RWKV6 fields, ``is_rwkv``, the
  frontend fields and ``is_encdec`` included); the reference
  fields the port does not carry yet are exactly ``NOT_PORTED``;
* the param tree of ``api.init(device="meta")`` has the paths and shapes
  of the reference's ``jax.eval_shape(api.init, key)``, and
  ``param_count`` / ``n_params`` agree;
* ``plan_pruning`` gives the reference plan's sites, weight bytes and
  Gram bytes.

The four new TINYs (fp32, 2 layers): the reference initialises the params
and samples the token arrays; both go to the port through numpy
(``repro_torch.convert``). One module-scoped world per config:

* forward logits within 1e-5 of max|logits| (matmuls summed in another
  order through two layers);
* every tap's Gram within 1e-5 of its max|G|, with equal tap keys;
* ``prune_model`` given the SAME Grams (k = 1): equal masks, swaps and
  search-pass counts at 0.6 and 2:4, dense and pruned perplexity within 1e-5
  relative;
* greedy tokens of dense and nm24 serving (2:4 masks of seeded scores)
  equal.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import sparseswaps as jss  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import sparseswaps as tss  # noqa: E402
from repro_torch.pruning import plan as tplan  # noqa: E402
from repro_torch.pruning import recipe as trecipe  # noqa: E402
from repro_torch.pruning import sites as tsites  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

DENSE = ["chatglm3-6b", "granite-34b", "minitron-4b", "internlm2-20b",
         "llama31-8b"]
NEW = DENSE[:4]
# k = 1 keeps the reference's compile time per shape family to seconds;
# the k = 8 path is held on llama31-8b (test_torch_pipeline.py) and in
# test_torch_kswap.py, and its code is the same at every shape
K_SWAPS = 1

# reference fields of execution knobs the port does not run (chunked
# attention, sharding, the chunked CE head, rolling windows, scans)
NOT_PORTED = {
    "attn_impl", "attn_q_chunk", "fsdp_params", "head_chunk", "long_window",
    "scan_layers",
}
# the MoE family, held in test_torch_moe.py
MOE = ["mixtral-8x7b", "granite-moe-3b-a800m"]
# the hybrid family, held in test_torch_zamba.py
HYBRID = ["zamba2-7b"]
# the RWKV6 model of the ssm family, held in test_torch_rwkv.py
RWKV = ["rwkv6-1.6b"]
# the cross-attention families, held in test_torch_vlm.py and
# test_torch_encdec.py
XATTN = ["llama-3.2-vision-90b", "seamless-m4t-medium"]


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_registry_holds_the_dense_family():
    ported = DENSE + MOE + HYBRID + RWKV + XATTN
    # every family of the reference, in its registry's order
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert sorted(tconfigs.ARCHS) == sorted(ported)
    assert list(tconfigs.TINY) == list(jconfigs.TINY)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("no-such-arch")


@pytest.mark.parametrize("arch", DENSE + HYBRID + RWKV + XATTN)
def test_config_fields_match_reference(arch):
    fields = {f.name for f in dataclasses.fields(tconfigs.ArchConfig)}
    ref_fields = {f.name for f in dataclasses.fields(jconfigs.ArchConfig)}
    assert ref_fields - fields == NOT_PORTED and fields <= ref_fields
    for t, j in ((tconfigs.get(arch), jconfigs.get(arch)),
                 (tconfigs.get_tiny(arch), jconfigs.get_tiny(arch))):
        for f in sorted(fields):
            assert getattr(t, f) == getattr(j, f), f
        assert t.head_dim == j.head_dim
        assert (t.d_inner, t.n_ssm_heads) == (j.d_inner, j.n_ssm_heads)
        assert t.is_rwkv == j.is_rwkv == (arch in RWKV)
        assert t.is_encdec == j.is_encdec == (arch == "seamless-m4t-medium")


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_params_and_plan_match_reference(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    japi, tapi = jmodels.build(jcfg), tmodels.build(tcfg)
    jshapes = jax.eval_shape(japi.init, jax.random.key(0))
    tparams = tapi.init(device="meta")
    want = {k: tuple(v.shape) for k, v in _leaves(jshapes)}
    got = {k: tuple(v.shape) for k, v in _leaves(tparams)}
    assert got == want
    assert all(v.device.type == "meta" for _, v in _leaves(tparams))
    # the reference's param_count: the sum over the same eval_shape tree
    n = sum(math.prod(s) for s in want.values())
    assert tmodels.param_count(tcfg) == tcfg.n_params() == n
    assert tmodels.embedding_params(tcfg) == jmodels.embedding_params(jcfg)
    jplan = jpruning.plan_pruning(
        japi, jshapes, jpruning.PruneRecipe.single(jmasks.PerRow(0.6)))
    tp = tplan.plan_pruning(
        tapi, tparams, trecipe.PruneRecipe.single(tmasks.PerRow(0.6)))
    assert [(g.name, g.spec.n_instances, g.spec.d_out, g.spec.d_in)
            for g in tp.groups] == \
        [(g.name, g.spec.n_instances, g.spec.d_out, g.spec.d_in)
         for g in jplan.groups]
    assert [(g.weight_bytes, g.gram_bytes) for g in tp.groups] == \
        [(g.weight_bytes, g.gram_bytes) for g in jplan.groups]
    assert tp.total_weight_bytes() == jplan.total_weight_bytes()
    assert tp.total_gram_bytes() == jplan.total_gram_bytes()
    assert tp.total_calib_bytes() == jplan.total_calib_bytes()


def _mask_tree(cfg, jparams, seed):
    """2:4 masks of every prunable site (``pruning.sites``) from seeded
    scores, as numpy."""
    rng = np.random.default_rng(seed)
    tree = {"layers": {"attn": {}, "mlp": {}}}
    for spec in tsites.site_specs(cfg, jparams):
        _, block, name = spec.name.split(".")
        scores = rng.normal(size=jparams["layers"][block][name].shape)
        tree["layers"][block][name] = tmasks.make_mask(
            torch.from_numpy(scores.astype(np.float32)),
            tmasks.NM(2, 4)).numpy()
    return tree


@pytest.fixture(scope="module", params=NEW)
def world(request):
    """One tiny config: reference params, calibration and validation
    batches, taps, 2:4 serving masks and a prompt, and their port-side
    copies."""
    arch = request.param
    jcfg = jconfigs.get_tiny(arch)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    calib = [_np(b) for b in jpruning.calibration_batches(
        jcfg, n_samples=8, seq_len=32, batch_size=4, seed=0)]
    val = [_np(b) for b in jpruning.val_batches(jcfg, n_batches=2, batch=4,
                                                seq=32)]
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   2, 8, split="val")
    jm24 = _mask_tree(jcfg, jparams, 0)
    return dict(
        arch=arch, japi=japi, jparams=jparams, calib=calib, val=val,
        jtaps=jpruning.accumulate(japi, jparams, calib), jm24=jm24,
        prompt=_np(pipe.get(0)),
        tapi=tmodels.build(tconfigs.get_tiny(arch)),
        tparams=convert.from_numpy(_np(jparams)),
        tcalib=[convert.from_numpy(b) for b in calib],
        tval=[convert.from_numpy(b) for b in val],
        tm24=convert.from_numpy(jm24))


def test_tiny_forward_and_taps_match(world):
    jcfg, tapi = world["japi"].cfg, world["tapi"]
    jh, _, _ = world["japi"].forward(world["jparams"], world["calib"][0])
    want = np.asarray(world["japi"].module.lm_head(world["jparams"], jh, jcfg))
    th, _, _ = tapi.forward(world["tparams"], world["tcalib"][0])
    got = tapi.module.lm_head(world["tparams"], th, tapi.cfg).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    ttaps = tpruning.accumulate(tapi, world["tparams"], world["tcalib"])
    jt = dict(_leaves(_np(world["jtaps"])))
    tt = dict(_leaves(convert.to_numpy(ttaps)))
    assert sorted(jt) == sorted(tt)
    for name, w in jt.items():
        assert tt[name].shape == w.shape, name
        np.testing.assert_allclose(tt[name], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("spec", ["0.6", "2:4"])
def test_tiny_same_grams_same_masks(world, spec):
    jtaps = world["jtaps"]
    with jss.count_search_passes() as jcnt:
        want = jpruning.prune_model(world["japi"], world["jparams"], None,
                                    jmasks.parse_pattern(spec), taps=jtaps,
                                    t_max=20, k_swaps=K_SWAPS)
    with tss.count_search_passes() as tcnt:
        got = tpruning.prune_model(world["tapi"], world["tparams"], None,
                                   tmasks.parse_pattern(spec),
                                   taps=convert.from_numpy(_np(jtaps)),
                                   t_max=20, k_swaps=K_SWAPS)
    assert (tcnt.passes, tcnt.rows_scored) == (jcnt.passes, jcnt.rows_scored)
    assert tcnt.passes > 0
    wl, gl = dict(_leaves(want.masks)), dict(_leaves(got.masks))
    assert sorted(wl) == sorted(gl)
    for name in wl:
        assert np.array_equal(gl[name].numpy(), np.asarray(wl[name])), name
    for gs, ws in zip(got.sites, want.sites, strict=True):
        assert gs.name == ws.name
        assert np.array_equal(gs.swaps.numpy(), np.asarray(ws.swaps)), gs.name
    assert got.mean_error_reduction() > 0
    for jm, tm in ((None, None), (want.masks, got.masks)):
        jp = jpruning.perplexity(world["japi"], world["jparams"], world["val"],
                                 masks=jm)
        tp = tpruning.perplexity(world["tapi"], world["tparams"],
                                 world["tval"], masks=tm)
        assert tp == pytest.approx(jp, rel=1e-5)


@pytest.mark.parametrize("fmt", ["dense", "nm24"])
def test_tiny_greedy_tokens_match(world, fmt):
    masks = None if fmt == "dense" else (world["jm24"], world["tm24"])
    jeng = JServeEngine(world["japi"], world["jparams"],
                        masks=masks and masks[0], fmt=fmt, kernel="jnp")
    teng = ServeEngine(world["tapi"], world["tparams"],
                       masks=masks and masks[1], fmt=fmt, device="cpu")
    want = np.asarray(jeng.generate(world["prompt"], 4).tokens)
    got = teng.generate(convert.from_numpy(world["prompt"]), 4).tokens
    assert np.array_equal(got.numpy(), want)
    assert teng.weight_bytes() == jeng.weight_bytes()
