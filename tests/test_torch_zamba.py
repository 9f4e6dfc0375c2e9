"""The port's hybrid family (zamba2-7b: Mamba2 backbone + shared attention
block) against the reference, on the CPU at TINY (fp32, 4 layers, d = 64,
the shared block every 2 layers: 2 sites).

The reference initialises the params and its zamba runs once per module
(one ``world``): loss with taps, ``prune_model`` at PerRow(0.6) and 2:4,
and greedy serving; the params, tokens and Grams go to the port through
numpy (``repro_torch.convert``). What is held, and at what tolerance:

* ``ssd_chunked`` against the reference's on the same numpy inputs, with
  and without ``h0`` and with S not a multiple of the chunk: y and the
  final state within 1e-5 of their max (fp32 sums in another order: the
  reference scans the chunk states associatively, the port in order);
  and against the port's own ``ssm_step`` loop within 1e-3 (the
  reference's ``test_mamba_chunked_matches_step`` bound);
* loss within 1e-5 relative; every mamba tap (stacked on L) and every
  shared tap, which must equal the reference's ``_sum_gram`` of its
  (L, ...) stack, within 5e-5 of its max: the SSD's fp32 sums in another
  order feed out_proj's input; a policy that skips the shared sites
  leaves no shared entry, mamba's survive;
* ``enumerate_sites``: names, shapes, instance counts and labels equal;
* ``prune_model`` given the reference's Grams (k = 1): equal masks and
  swaps at PerRow(0.6) and 2:4;
* greedy tokens of fixed-batch ``generate`` in masked, nm24 and gathered
  formats equal the reference's (its masked model's: its packed formats
  serve the same tokens, ``tests/test_serve_sparse.py``), nm24 ==
  gathered bitwise;
* prefill then decode against one full forward: logits and the SSM state
  carried through decode within 1e-3 of their max of the chunked path's
  (decode runs the one-token recurrence, the forward the chunked matmul
  form: the reference's chunked-vs-step bound), the conv tails too (the
  layers below feed them);
* the continuous scheduler refuses the hybrid as the reference does;
* params through numpy and back bitwise; ``pack_tree`` of the hybrid tree
  bitwise the reference's; full width on the meta device: the param tree,
  ``param_count`` and the plan's sites equal the reference's.
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
from repro.core import packed as jpacked  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

ARCH = "zamba2-7b"
TOL = 1e-5        # of the compared tensor's max: fp32 sums in another order
TAP_TOL = 5e-5    # taps behind the SSD (out_proj's input)
STEP_TOL = 1e-3   # ssm_step recurrence vs the chunked form
PATTERNS = {"0.6": (jmasks.PerRow(0.6), tmasks.PerRow(0.6)),
            "2:4": (jmasks.NM(2, 4), tmasks.NM(2, 4))}


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


def _shared_summed(taps):
    """The reference's tap tree with its shared block's (L, ...) stack
    summed over L (its ``sites._sum_gram``): the port's layout."""
    return {"mamba": taps["mamba"],
            "shared": {k: {f: v.sum(0) for f, v in ent.items()}
                       for k, ent in taps["shared"].items()}}


@pytest.fixture(scope="module")
def world():
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    loss, aux = japi.loss(jparams, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels)},
                          want_taps=True)
    ref_taps = _np(aux["taps"])
    prompt = tokens[:, :8]
    reports, served = {}, {}
    for pat in PATTERNS:
        rep = jpruning.prune_model(japi, jparams, None, PATTERNS[pat][0],
                                   t_max=4, k_swaps=1, taps=aux["taps"])
        reports[pat] = rep
        eng = JServeEngine(japi, jparams, masks=rep.masks, fmt="masked")
        served[pat] = np.asarray(
            eng.generate({"tokens": jnp.asarray(prompt)}, 6).tokens)
    tcfg = tconfigs.get_tiny(ARCH)
    tapi = tmodels.build(tcfg)
    return {"jcfg": jcfg, "japi": japi, "jparams": jparams,
            "tcfg": tcfg, "tapi": tapi,
            "params": convert.from_numpy(_np(jparams)),
            "tokens": tokens, "labels": labels, "loss": float(loss),
            "ref_taps": ref_taps,
            "taps": convert.from_numpy(_shared_summed(ref_taps)),
            "reports": reports, "served": served, "prompt": prompt}


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,with_h0", [(16, False), (16, True), (11, False),
                                       (11, True)])
def test_ssd_chunked_matches_reference_and_step(S, with_h0):
    rng = np.random.default_rng(S + with_h0)
    B, H, dh, ds, chunk = 2, 3, 4, 5, 4
    x = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    Bm = rng.normal(size=(B, S, ds)).astype(np.float32)
    Cm = rng.normal(size=(B, S, ds)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
    h0 = (rng.normal(size=(B, H, dh, ds)).astype(np.float32)
          if with_h0 else None)
    jy, jh = jmamba.ssd_chunked(*(jnp.asarray(a) for a in (x, Bm, Cm, dt, A)),
                                chunk=chunk,
                                h0=None if h0 is None else jnp.asarray(h0))
    t = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = tmamba.ssd_chunked(*t, chunk=chunk, h0=th0)
    _close(y, jy, msg="y")
    _close(h, jh, msg="h_final")
    hs = torch.zeros((B, H, dh, ds)) if th0 is None else th0
    ys = []
    for i in range(S):
        yi, hs = tmamba.ssm_step(t[0][:, i], t[1][:, i], t[2][:, i],
                                 t[3][:, i], t[4], hs)
        ys.append(yi)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(h.numpy(), hs.numpy(), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# forward, taps, sites
# ---------------------------------------------------------------------------

def test_forward_loss_and_taps_match(world):
    tapi, params = world["tapi"], world["params"]
    batch = {"tokens": torch.from_numpy(world["tokens"]).long(),
             "labels": torch.from_numpy(world["labels"]).long()}
    loss, aux = tapi.loss(params, batch, want_taps=True)
    assert abs(float(loss) - world["loss"]) <= TOL * abs(world["loss"])
    want = world["ref_taps"]
    got = aux["taps"]
    assert set(got) == {"shared", "mamba"}
    assert set(got["mamba"]) == set(want["mamba"]) == {"in_proj", "out_proj"}
    assert set(got["shared"]) == set(want["shared"])
    for name, ent in want["mamba"].items():
        for f, v in ent.items():
            assert tuple(got["mamba"][name][f].shape) == v.shape
            _close(got["mamba"][name][f], v, TAP_TOL, f"mamba.{name}.{f}")
    # the reference's stack: zero entries at the non-site layers, summed
    # over L by its sites._sum_gram
    summed = _np(jpruning.sites._sum_gram(want["shared"]))
    n_sites = -(-world["tcfg"].n_layers // world["tcfg"].shared_attn_every)
    for name, ent in summed.items():
        for f, v in ent.items():
            assert tuple(got["shared"][name][f].shape) == v.shape
            _close(got["shared"][name][f], v, TAP_TOL, f"shared.{name}.{f}")
        assert float(got["shared"][name]["n"]) == n_sites * world["tokens"].size


def test_shared_taps_follow_the_policy(world):
    """A recipe that skips the shared sites leaves no shared tap entry
    (the reference's ``test_zamba_shared_tap_structure_under_policy``); a
    policy without one projection drops only that entry."""
    tapi, params = world["tapi"], world["params"]
    batches = [{"tokens": torch.from_numpy(world["tokens"]).long(),
                "labels": torch.from_numpy(world["labels"]).long()}]
    rec = tpruning.PruneRecipe(rules=(
        tpruning.SiteRule("shared.*", skip=True),
        tpruning.SiteRule("*", pattern=tmasks.PerRow(0.6))), t_max=2)
    plan = tpruning.plan_pruning(tapi, params, rec)
    st = tpruning.accumulate_stats(tapi, params, batches,
                                   spec=plan.calib_spec(minimal=True))
    assert set(st.taps["shared"]) == set()
    assert set(st.taps["mamba"]) == {"in_proj", "out_proj"}
    rec = tpruning.PruneRecipe(rules=(
        tpruning.SiteRule("shared.attn.wq", skip=True),
        tpruning.SiteRule("*", pattern=tmasks.PerRow(0.6))), t_max=2)
    plan = tpruning.plan_pruning(tapi, params, rec)
    st = tpruning.accumulate_stats(tapi, params, batches,
                                   spec=plan.calib_spec(minimal=True))
    assert "wq" not in st.taps["shared"]
    _close(st.taps["shared"]["wk"]["g"], world["taps"]["shared"]["wk"]["g"],
           TAP_TOL)


def test_enumerate_sites_match(world):
    jg = jpruning.enumerate_sites(world["jcfg"], world["jparams"],
                                  world["ref_taps"])
    tg = tpruning.enumerate_sites(world["tcfg"], world["params"],
                                  world["taps"])
    assert [g.name for g in tg] == [g.name for g in jg]
    for a, b in zip(tg, jg):
        assert tuple(a.weights.shape) == tuple(b.weights.shape), a.name
        assert a.n_instances == b.n_instances and a.labels() == b.labels()
        assert a.stack_shape == tuple(b.stack_shape)
        _close(a.gram.G, b.gram.G, TAP_TOL, a.name)
    specs = tpruning.site_specs(world["tcfg"], world["params"])
    assert [(s.name, s.n_instances, s.d_out, s.d_in) for s in specs] == [
        (g.name, g.n_instances, g.weights.shape[1], g.weights.shape[2])
        for g in jg]


# ---------------------------------------------------------------------------
# pruning and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pat", list(PATTERNS))
def test_prune_same_grams_same_masks(world, pat):
    ref = world["reports"][pat]
    rep = tpruning.prune_model(world["tapi"], world["params"], None,
                               PATTERNS[pat][1], t_max=4, k_swaps=1,
                               taps=world["taps"])
    want = dict(_leaves(_np(ref.masks)))
    got = dict(_leaves(rep.masks))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert [s.name for s in rep.sites] == [s.name for s in ref.sites]
    for a, b in zip(rep.sites, ref.sites):
        assert a.swaps.tolist() == np.asarray(b.swaps).tolist(), a.name


def _masks(world, pat):
    return convert.from_numpy(_np(world["reports"][pat].masks))


@pytest.mark.parametrize("pat,fmt", [("0.6", "masked"), ("0.6", "gathered"),
                                     ("2:4", "masked"), ("2:4", "nm24"),
                                     ("2:4", "gathered")])
def test_generate_tokens_match_reference(world, pat, fmt):
    prompt = {"tokens": torch.from_numpy(world["prompt"]).long()}
    eng = ServeEngine(world["tapi"], world["params"],
                      masks=_masks(world, pat), fmt=fmt, device="cpu")
    toks = eng.generate(prompt, 6).tokens
    assert toks.tolist() == world["served"][pat].tolist()
    if fmt == "nm24":
        other = ServeEngine(world["tapi"], world["params"],
                            masks=_masks(world, pat), fmt="gathered",
                            device="cpu")
        assert torch.equal(eng.logits_trace(prompt, 4),
                           other.logits_trace(prompt, 4))


def test_prefill_decode_match_forward(world):
    tapi, params = world["tapi"], world["params"]
    toks = torch.from_numpy(world["tokens"]).long()
    S0, S = 7, toks.shape[1]
    cache = tapi.init_cache(params, toks.shape[0], 32)
    logits, cache = tapi.prefill(params, {"tokens": toks[:, :S0]}, cache)
    out = [logits]
    for t in range(S0, S):
        logits, cache = tapi.decode_step(params, toks[:, t:t + 1], cache)
        out.append(logits)
    assert cache.t == S
    hidden, _, _ = tapi.forward(params, {"tokens": toks})
    full = hidden @ params["head"].T
    _close(torch.cat(out[:-1], 1), full[:, S0 - 1:S - 1], STEP_TOL)
    one = tapi.init_cache(params, toks.shape[0], 32)
    _, one = tapi.prefill(params, {"tokens": toks}, one)
    _close(cache.ssm.h, one.ssm.h, STEP_TOL, "SSM state")
    _close(cache.ssm.conv, one.ssm.conv, STEP_TOL, "conv tail")
    with pytest.raises(ValueError, match="unpadded"):
        tapi.prefill(params, {"tokens": toks, "n_valid": 5},
                     tapi.init_cache(params, toks.shape[0], 32))


def test_continuous_refused_like_reference(world):
    eng = ServeEngine(world["tapi"], world["params"], fmt="dense",
                      device="cpu")
    ref = JServeEngine(world["japi"], world["jparams"], fmt="dense")
    assert not eng.supports_continuous and not ref.supports_continuous
    with pytest.raises(NotImplementedError) as got:
        ContinuousScheduler(eng)
    with pytest.raises(NotImplementedError) as want:
        ref._require_continuous()
    assert str(got.value) == str(want.value)
    assert world["tapi"].prefill_window is None


# ---------------------------------------------------------------------------
# trees: numpy round trip, packing, full width
# ---------------------------------------------------------------------------

def test_params_round_trip_and_pack_tree(world):
    params = world["params"]
    back = convert.from_numpy(convert.to_numpy(params))
    for (k, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for pat, fmt in (("2:4", "nm24"), ("0.6", "gathered")):
        jtree = _np(jpacked.pack_tree(world["jcfg"], world["jparams"],
                                      world["reports"][pat].masks, fmt))
        ttree = tpacked.pack_tree(world["tcfg"], params, _masks(world, pat),
                                  fmt)
        for path in (("layers", "mamba", "in_proj"), ("shared", "mlp",
                                                      "w_gate")):
            jw, tw = jtree, ttree
            for k in path:
                jw, tw = jw[k], tw[k]
            assert np.array_equal(tw.values.numpy(), np.asarray(jw.values))
            assert np.array_equal(tw.idx.numpy(), np.asarray(jw.idx))


def test_full_width_params_and_plan():
    jcfg, tcfg = jconfigs.get(ARCH), tconfigs.get(ARCH)
    jtree = jax.eval_shape(jmodels.build(jcfg).init, jax.random.key(0))
    jshapes = dict(_leaves(jtree))
    tapi = tmodels.build(tcfg)
    ttree = tapi.init(device="meta")
    assert {k: tuple(v.shape) for k, v in _leaves(ttree)} == {
        k: tuple(v.shape) for k, v in jshapes.items()}
    assert tmodels.param_count(tcfg) == sum(
        int(np.prod(v.shape)) for v in jshapes.values())
    got = [(s.name, s.n_instances, s.d_out, s.d_in, s.stack_shape)
           for s in tpruning.site_specs(tcfg, ttree)]
    assert got == [(s.name, s.n_instances, s.d_out, s.d_in,
                    tuple(s.stack_shape))
                   for s in jpruning.site_specs(jcfg, jtree)]
    assert got[0][1:4] == (81, 14576, 3584)
