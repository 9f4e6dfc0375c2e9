"""The port's RWKV6 family (rwkv6-1.6b: Finch time-mix and channel-mix)
against the reference, on the CPU at TINY (fp32, 2 layers, d = 64,
d_ff = 128, head dim 16, chunk 8, LoRA widths 8 / 4).

The reference initialises the params and its rwkv runs once per module
(one ``world``): loss with taps, ``prune_model`` at PerRow(0.5) and 2:4,
and greedy serving; the params, tokens and Grams go to the port through
numpy (``repro_torch.convert``). What is held, and at what tolerance:

* ``wkv_chunked`` against the reference's on the same numpy inputs, with
  and without ``s0`` and with S a multiple of the chunk and not: o and
  the final state within 1e-5 of their max (fp32 sums in another order:
  the reference scans the chunk states associatively, the port in
  order); and against the port's own ``wkv_step`` loop within 1e-3 (the
  reference's ``test_rwkv_chunked_matches_step`` bound);
* loss within 1e-5 relative; each of the ten taps (stacked on L) within
  1e-5 of its max;
* ``enumerate_sites``: names, shapes, instance counts and labels equal;
* ``prune_model`` given the reference's Grams: equal masks and swaps at
  PerRow(0.5) (SparseSwaps, t_max 5, the default k = 8) and 2:4 (k = 1:
  the reference's k = 8 N:M compile alone would take 13 s);
* masked serving equals serving the hard-zeroed weights dense, token for
  token (the reference's ``test_masked_serving_equals_hard_zero_all_
  families``: the per-layer mask slice reaches the "tm" subtree); greedy
  tokens of fixed-batch ``generate`` in masked, nm24 and gathered equal
  the reference's masked model's, nm24 == gathered bitwise;
* prefill then decode against one full forward: logits, and the WKV
  state and both token-shift vectors carried through decode, within
  1e-3 of their max of the chunked path's (the chunked-vs-step bound);
  the prompt (7 tokens, then 20) runs the chunk's pad path;
* the continuous scheduler refuses rwkv as the reference does;
* params through numpy and back bitwise; ``pack_tree`` bitwise the
  reference's; the reference's masks-tree checkpoint read back by
  ``load_masks_and_weights`` bitwise, served to the reference's tokens;
  full width on the meta device: the param tree,
  ``param_count`` (1.6 B) and the plan's sites equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import packed as jpacked  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

ARCH = "rwkv6-1.6b"
TOL = 1e-5        # of the compared tensor's max: fp32 sums in another order
STEP_TOL = 1e-3   # wkv_step recurrence vs the chunked form
T_MAX = 5
PATTERNS = {"0.5": (jmasks.PerRow(0.5), tmasks.PerRow(0.5)),
            "2:4": (jmasks.NM(2, 4), tmasks.NM(2, 4))}
K_SWAPS = {"0.5": 8, "2:4": 1}


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
    prompt = tokens[:, :7]
    reports, served = {}, {}
    for pat in PATTERNS:
        rep = jpruning.prune_model(japi, jparams, None, PATTERNS[pat][0],
                                   method="sparseswaps", t_max=T_MAX,
                                   k_swaps=K_SWAPS[pat], taps=aux["taps"])
        reports[pat] = rep
        eng = JServeEngine(japi, jparams, masks=rep.masks, fmt="masked")
        served[pat] = np.asarray(
            eng.generate({"tokens": jnp.asarray(prompt)}, 6).tokens)
    tcfg = tconfigs.get_tiny(ARCH)
    return {"jcfg": jcfg, "japi": japi, "jparams": jparams,
            "tcfg": tcfg, "tapi": tmodels.build(tcfg),
            "params": convert.from_numpy(_np(jparams)),
            "tokens": tokens, "labels": labels, "loss": float(loss),
            "ref_taps": _np(aux["taps"]),
            "taps": convert.from_numpy(_np(aux["taps"])),
            "reports": reports, "served": served, "prompt": prompt}


# ---------------------------------------------------------------------------
# the chunked WKV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,with_s0", [(16, False), (16, True), (13, False),
                                       (13, True)])
def test_wkv_chunked_matches_reference_and_step(S, with_s0):
    rng = np.random.default_rng(S + with_s0)
    B, H, dh, chunk = 2, 2, 8, 4
    r, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(0.01, 2.0, size=(B, S, H, dh)).astype(np.float32)
    u = rng.normal(size=(H, dh)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, dh, dh)).astype(np.float32)
          if with_s0 else None)
    jo, js = jrwkv.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                               chunk=chunk,
                               s0=None if s0 is None else jnp.asarray(s0))
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    o, s = trwkv.wkv_chunked(*t, chunk=chunk, s0=ts0)
    _close(o, jo, msg="o")
    _close(s, js, msg="s_final")
    ss = torch.zeros((B, H, dh, dh)) if ts0 is None else ts0
    os_ = []
    for i in range(S):
        oi, ss = trwkv.wkv_step(t[0][:, i], t[1][:, i], t[2][:, i],
                                t[3][:, i], t[4], ss)
        os_.append(oi)
    np.testing.assert_allclose(o.numpy(), torch.stack(os_, 1).numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), ss.numpy(), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# forward, taps, sites
# ---------------------------------------------------------------------------

def test_forward_loss_and_taps_match(world):
    tapi, params = world["tapi"], world["params"]
    batch = {"tokens": torch.from_numpy(world["tokens"]).long(),
             "labels": torch.from_numpy(world["labels"]).long()}
    loss, aux = tapi.loss(params, batch, want_taps=True)
    assert abs(float(loss) - world["loss"]) <= TOL * abs(world["loss"])
    want, got = world["ref_taps"], aux["taps"]
    assert set(got) == set(want) == set(trwkv.PRUNABLE_RWKV)
    L = world["tcfg"].n_layers
    for name, ent in want.items():
        assert set(got[name]) == set(ent)
        for f, v in ent.items():
            assert tuple(got[name][f].shape) == v.shape
            _close(got[name][f], v, msg=f"{name}.{f}")
        assert got[name]["g"].shape[:1] == (L,)
    # td_w2 reads tanh(td_w1 ·), the LoRA's width; cm_wv relu²(k), d_ff
    assert got["td_w2"]["g"].shape[-1] == world["tcfg"].rwkv_lora_decay
    assert got["cm_wv"]["g"].shape[-1] == world["tcfg"].d_ff


def test_enumerate_sites_match(world):
    jg = jpruning.enumerate_sites(world["jcfg"], world["jparams"],
                                  world["ref_taps"])
    tg = tpruning.enumerate_sites(world["tcfg"], world["params"],
                                  world["taps"])
    assert [g.name for g in tg] == [g.name for g in jg]
    assert len(tg) == 10
    for a, b in zip(tg, jg):
        assert tuple(a.weights.shape) == tuple(b.weights.shape), a.name
        assert a.n_instances == b.n_instances and a.labels() == b.labels()
        assert a.stack_shape == tuple(b.stack_shape)
        _close(a.gram.G, b.gram.G, TOL, a.name)
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
                               PATTERNS[pat][1], method="sparseswaps",
                               t_max=T_MAX, k_swaps=K_SWAPS[pat],
                               taps=world["taps"])
    want = dict(_leaves(_np(ref.masks)))
    got = dict(_leaves(rep.masks))
    assert set(got) == set(want) == {f"layers.tm.{k}"
                                     for k in trwkv.PRUNABLE_RWKV}
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert [s.name for s in rep.sites] == [s.name for s in ref.sites]
    for a, b in zip(rep.sites, ref.sites):
        assert a.swaps.tolist() == np.asarray(b.swaps).tolist(), a.name
    assert rep.mean_error_reduction() > 0


def _masks(world, pat):
    return convert.from_numpy(_np(world["reports"][pat].masks))


def _hard_zeroed(params, masks):
    out = tpacked._copy_dicts(params)
    for k in trwkv.PRUNABLE_RWKV:
        w = params["layers"]["tm"][k]
        out["layers"]["tm"][k] = w * masks["layers"]["tm"][k].to(w.dtype)
    return out


@pytest.mark.parametrize("pat", list(PATTERNS))
def test_masked_serving_equals_hard_zero(world, pat):
    prompt = {"tokens": torch.from_numpy(world["prompt"]).long()}
    masks = _masks(world, pat)
    masked = ServeEngine(world["tapi"], world["params"], masks=masks,
                         fmt="masked", device="cpu")
    hard = ServeEngine(world["tapi"], _hard_zeroed(world["params"], masks),
                       fmt="dense", device="cpu")
    assert masked.generate(prompt, 4).tokens.tolist() == \
        hard.generate(prompt, 4).tokens.tolist()
    _close(masked.logits_trace(prompt, 3), hard.logits_trace(prompt, 3))


@pytest.mark.parametrize("pat,fmt", [("0.5", "masked"), ("0.5", "gathered"),
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
    assert S0 % world["tcfg"].rwkv_chunk and S % world["tcfg"].rwkv_chunk
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
    assert one.s.dtype == torch.float32 and one.s.shape == (
        2, 2, 4, 16, 16)
    _close(cache.s, one.s, STEP_TOL, "WKV state")
    _close(cache.x_tm, one.x_tm, STEP_TOL, "time-mix shift")
    _close(cache.x_cm, one.x_cm, STEP_TOL, "channel-mix shift")
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
    assert [k for k, _ in _leaves(back)] == [k for k, _ in _leaves(params)]
    for (k, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    tm = params["layers"]["tm"]
    assert tm["maa_w2"].shape == (2, 5, 64, 4) and tm["u"].shape == (2, 4, 16)
    for pat, fmt in (("2:4", "nm24"), ("0.5", "gathered")):
        jtree = _np(jpacked.pack_tree(world["jcfg"], world["jparams"],
                                      world["reports"][pat].masks, fmt))
        ttree = tpacked.pack_tree(world["tcfg"], params, _masks(world, pat),
                                  fmt)
        for k in trwkv.PRUNABLE_RWKV:
            jw, tw = jtree["layers"]["tm"][k], ttree["layers"]["tm"][k]
            assert np.array_equal(tw.values.numpy(), np.asarray(jw.values)), k
            assert np.array_equal(tw.idx.numpy(), np.asarray(jw.idx)), k
        assert set(ttree) == {"embed", "ln_in", "layers", "ln_f", "head"}


def test_reference_mask_checkpoint_loads_and_serves(world, tmp_path):
    masks = world["reports"]["2:4"].masks
    jckpt.save(tmp_path / "m", 0, masks)
    got, params = tpacked.load_masks_and_weights(world["tcfg"],
                                                 world["params"],
                                                 tmp_path / "m")
    assert params is world["params"]
    want = dict(_leaves(_np(masks)))
    assert set(dict(_leaves(got))) == set(want)
    for k, v in _leaves(got):
        assert np.array_equal(v.numpy(), want[k]), k
    prompt = {"tokens": torch.from_numpy(world["prompt"]).long()}
    eng = ServeEngine(world["tapi"], params, masks=got, fmt="nm24",
                      device="cpu")
    assert eng.generate(prompt, 6).tokens.tolist() == \
        world["served"]["2:4"].tolist()


def test_full_width_params_and_plan():
    jcfg, tcfg = jconfigs.get(ARCH), tconfigs.get(ARCH)
    jtree = jax.eval_shape(jmodels.build(jcfg).init, jax.random.key(0))
    jshapes = dict(_leaves(jtree))
    tapi = tmodels.build(tcfg)
    ttree = tapi.init(device="meta")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _leaves(ttree)} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jshapes.items()}
    n = sum(int(np.prod(v.shape)) for v in jshapes.values())
    assert tmodels.param_count(tcfg) == n and round(n / 1e8) == 16
    got = [(s.name, s.n_instances, s.d_out, s.d_in, s.stack_shape)
           for s in tpruning.site_specs(tcfg, ttree)]
    assert got == [(s.name, s.n_instances, s.d_out, s.d_in,
                    tuple(s.stack_shape))
                   for s in jpruning.site_specs(jcfg, jtree)]
    by = {g[0]: g[2:4] for g in got}
    assert by["layers.tm.td_w1"] == (64, 2048)
    assert by["layers.tm.td_w2"] == (2048, 64)
    assert by["layers.tm.cm_wv"] == (2048, 7168)
