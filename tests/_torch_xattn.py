"""The cross-attention families (the VLM and the encoder-decoder) held
against the reference: one world a module, then the checks
``test_torch_vlm.py`` and ``test_torch_encdec.py`` share.

``build_world(arch)`` initialises the reference's TINY params from
``jax.random.key(0)`` (a VLM's cross gates set to GATES first: the
reference initialises them to 0, and tanh(0) = 0 would leave the cross
layers out of every logit), draws tokens and the frontend states (a VLM's
``img``, an encoder-decoder's ``src``) with numpy from a seed, and runs
the reference once: loss with taps, ``prune_model`` at PerRow(0.5)
(SparseSwaps, k = 8, t_max 5) and 2:4 (k = 1), greedy serving of the
masked model. The port gets the same arrays through numpy
(``repro_torch.convert``).
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
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.pruning import sites as tsites  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

TOL = 1e-5        # of the compared tensor's max: fp32 sums in another order
SERVE_TOL = 1e-4  # prefill + decode vs one forward, of max|logits|
T_MAX = 5
PATTERNS = {"0.5": (jmasks.PerRow(0.5), tmasks.PerRow(0.5)),
            "2:4": (jmasks.NM(2, 4), tmasks.NM(2, 4))}
K_SWAPS = {"0.5": 8, "2:4": 1}
GATES = (0.5, -0.5)          # a VLM's tanh-gates: attention, MLP
GEN_CASES = [("0.5", "masked"), ("0.5", "gathered"), ("2:4", "masked"),
             ("2:4", "nm24"), ("2:4", "gathered")]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def modality(cfg) -> tuple[str, int]:
    """(batch key, states a row) of a cross-attention family."""
    if cfg.is_encdec:
        return "src", cfg.n_src_frames
    return "img", cfg.n_img_tokens


def build_world(arch: str) -> dict:
    jcfg = jconfigs.get_tiny(arch)
    japi = jmodels.build(jcfg)
    params_np = np_tree(japi.init(jax.random.key(0)))
    if jcfg.cross_attn_every:
        G = jcfg.n_layers // jcfg.cross_attn_every
        for name, g in zip(("gate_attn", "gate_mlp"), GATES):
            params_np["cross_layers"][name] = np.full((G,), g, np.float32)
    jparams = jax.tree.map(jnp.asarray, params_np)
    key, n = modality(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    states = (0.02 * rng.normal(size=(2, n, jcfg.d_model))).astype(np.float32)
    other = (0.02 * rng.normal(size=states.shape)).astype(np.float32)
    loss, aux = japi.loss(jparams, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels),
                                    key: jnp.asarray(states)},
                          want_taps=True)
    prompt = {"tokens": jnp.asarray(tokens[:, :5]), key: jnp.asarray(states)}
    reports, served = {}, {}
    for pat in PATTERNS:
        rep = jpruning.prune_model(japi, jparams, None, PATTERNS[pat][0],
                                   method="sparseswaps", t_max=T_MAX,
                                   k_swaps=K_SWAPS[pat], taps=aux["taps"])
        reports[pat] = rep
        eng = JServeEngine(japi, jparams, masks=rep.masks, fmt="masked")
        served[pat] = np.asarray(eng.generate(prompt, 6).tokens)
    tcfg = tconfigs.get_tiny(arch)
    return {"arch": arch, "jcfg": jcfg, "japi": japi, "jparams": jparams,
            "tcfg": tcfg, "tapi": tmodels.build(tcfg),
            "params": convert.from_numpy(params_np), "key": key,
            "tokens": tokens, "labels": labels, "states": states,
            "other": other, "loss": float(loss),
            "ref_taps": np_tree(aux["taps"]),
            "taps": convert.from_numpy(np_tree(aux["taps"])),
            "reports": reports, "served": served}


def batch(world, *, n: int | None = None, states=None) -> dict:
    """The world's tokens (the first ``n``), labels and frontend states
    as port tensors."""
    toks = world["tokens"] if n is None else world["tokens"][:, :n]
    out = {"tokens": torch.from_numpy(toks).long(),
           world["key"]: torch.from_numpy(
               world["states"] if states is None else states)}
    if n is None:
        out["labels"] = torch.from_numpy(world["labels"]).long()
    return out


def prompt(world, states=None) -> dict:
    return batch(world, n=5, states=states)


def port_masks(world, pat):
    return convert.from_numpy(np_tree(world["reports"][pat].masks))


def site_paths(cfg):
    return [ppath for _, ppath, _, _ in tsites._table(cfg)]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def check_loss_and_taps(world, groups: dict) -> None:
    """Loss within TOL relative; every tap of every group (``groups``:
    {top-level tap key: its stack shape}) within TOL of its max."""
    loss, aux = world["tapi"].loss(world["params"], batch(world),
                                   want_taps=True)
    assert abs(float(loss) - world["loss"]) <= TOL * abs(world["loss"])
    want, got = world["ref_taps"], aux["taps"]
    assert set(got) == set(want) == set(groups)
    for top, stack in groups.items():
        assert set(got[top]) == set(want[top]), top
        for name, ent in want[top].items():
            assert set(got[top][name]) == set(ent)
            for f, v in ent.items():
                t = got[top][name][f]
                assert tuple(t.shape) == v.shape, (top, name, f)
                assert tuple(t.shape[:len(stack)]) == stack
                close(t, v, msg=f"{top}.{name}.{f}")


def check_sites(world, n_sites: int) -> None:
    jg = jpruning.enumerate_sites(world["jcfg"], world["jparams"],
                                  world["ref_taps"])
    tg = tpruning.enumerate_sites(world["tcfg"], world["params"],
                                  world["taps"])
    assert [g.name for g in tg] == [g.name for g in jg]
    assert len(tg) == n_sites
    for a, b in zip(tg, jg):
        assert tuple(a.weights.shape) == tuple(b.weights.shape), a.name
        assert a.n_instances == b.n_instances and a.labels() == b.labels()
        assert a.stack_shape == tuple(b.stack_shape)
        close(a.gram.G, b.gram.G, TOL, a.name)
    specs = tpruning.site_specs(world["tcfg"], world["params"])
    assert [(s.name, s.n_instances, s.d_out, s.d_in) for s in specs] == [
        (g.name, g.n_instances, g.weights.shape[1], g.weights.shape[2])
        for g in jg]
    jspecs = jpruning.site_specs(world["jcfg"], world["jparams"])
    assert ([(t.path, t.name, t.d_in, t.n, t.sites)
             for t in tsites.tap_specs(world["tcfg"], specs)]
            == [(t.path, t.name, t.d_in, t.n, t.sites)
                for t in jpruning.sites.tap_specs(world["jcfg"], jspecs)])


def check_prune(world, pat) -> None:
    ref = world["reports"][pat]
    rep = tpruning.prune_model(world["tapi"], world["params"], None,
                               PATTERNS[pat][1], method="sparseswaps",
                               t_max=T_MAX, k_swaps=K_SWAPS[pat],
                               taps=world["taps"])
    want = dict(leaves(np_tree(ref.masks)))
    got = dict(leaves(rep.masks))
    assert set(got) == set(want) == {".".join(p)
                                     for p in site_paths(world["tcfg"])}
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert [s.name for s in rep.sites] == [s.name for s in ref.sites]
    for a, b in zip(rep.sites, ref.sites):
        assert a.swaps.tolist() == np.asarray(b.swaps).tolist(), a.name
    assert rep.mean_error_reduction() > 0


def hard_zeroed(world, masks):
    params = world["params"]
    out = tpacked._copy_dicts(params)
    for ppath in site_paths(world["tcfg"]):
        w = tpacked._get(params, ppath)
        tpacked._set(out, ppath, w * tpacked._get(masks, ppath).to(w.dtype))
    return out


def check_masked_equals_hard_zero(world, pat) -> None:
    """The reference's ``test_masked_serving_equals_hard_zero_all_
    families``: masked prefill + decode (the masked cross-KV precompute)
    == the hard-zeroed weights served dense == the nm24-packed weights,
    token for token (``train.steps.greedy_decode``); the masked and
    hard-zeroed engines' logits within TOL."""
    tapi, p = world["tapi"], prompt(world)
    masks = port_masks(world, pat)
    hard = hard_zeroed(world, masks)
    want = tsteps.greedy_decode(tapi, hard, p, 4)
    assert torch.equal(tsteps.greedy_decode(tapi, world["params"], p, 4,
                                            masks=masks), want)
    if pat == "2:4":
        packed = tpacked.pack_tree(world["tcfg"], world["params"], masks,
                                   "nm24")
        assert torch.equal(tsteps.greedy_decode(tapi, packed, p, 4), want)
    masked = ServeEngine(tapi, world["params"], masks=masks, fmt="masked",
                         device="cpu")
    dense = ServeEngine(tapi, hard, fmt="dense", device="cpu")
    close(masked.logits_trace(p, 3), dense.logits_trace(p, 3))


def check_generate(world, pat, fmt) -> None:
    p = prompt(world)
    eng = ServeEngine(world["tapi"], world["params"],
                      masks=port_masks(world, pat), fmt=fmt, device="cpu")
    assert eng.generate(p, 6).tokens.tolist() == \
        world["served"][pat].tolist()
    if fmt == "nm24":
        other = ServeEngine(world["tapi"], world["params"],
                            masks=port_masks(world, pat), fmt="gathered",
                            device="cpu")
        assert torch.equal(eng.logits_trace(p, 4), other.logits_trace(p, 4))


def check_prefill_decode(world):
    """Prefill of 5 tokens, then decode steps over the rest, against one
    forward: within SERVE_TOL of max|logits|. Returns the last cache."""
    tapi, params = world["tapi"], world["params"]
    full = batch(world)
    toks = full["tokens"]
    S0, S = 5, toks.shape[1]
    cache = tapi.init_cache(params, toks.shape[0], 16)
    logits, cache = tapi.prefill(params, batch(world, n=S0), cache)
    out = [logits]
    for t in range(S0, S):
        logits, cache = tapi.decode_step(params, toks[:, t:t + 1], cache)
        out.append(logits)
    assert cache.t == S
    hidden, _, _ = tapi.forward(params, full)
    want = tapi.module.lm_head(params, hidden, world["tcfg"])
    close(torch.cat(out[:-1], 1), want[:, S0 - 1:S - 1], SERVE_TOL)
    return cache


def check_modality_matters(world) -> None:
    """Other frontend states change the logits: the forward's, the
    served prefill's, and the reference's alike."""
    tapi, params = world["tapi"], world["params"]
    a, _, _ = tapi.forward(params, batch(world))
    b, _, _ = tapi.forward(params, batch(world, states=world["other"]))
    assert float((a - b).abs().max()) > 1e-3 * float(a.abs().max())
    eng = ServeEngine(tapi, params, fmt="dense", device="cpu")
    la = eng.logits_trace(prompt(world), 2)
    lb = eng.logits_trace(prompt(world, world["other"]), 2)
    assert float((la - lb).abs().max()) > 1e-3 * float(la.abs().max())
    key = world["key"]
    ja, _, _ = world["japi"].forward(world["jparams"], {
        "tokens": jnp.asarray(world["tokens"]),
        key: jnp.asarray(world["states"])})
    close(a, ja, TOL, "hidden")


def check_continuous_refused(world) -> None:
    eng = ServeEngine(world["tapi"], world["params"], fmt="dense",
                      device="cpu")
    ref = JServeEngine(world["japi"], world["jparams"], fmt="dense")
    assert not eng.supports_continuous and not ref.supports_continuous
    with pytest.raises(NotImplementedError) as got:
        ContinuousScheduler(eng)
    with pytest.raises(NotImplementedError) as want:
        ref._require_continuous()
    assert str(got.value) == str(want.value)


def check_round_trip_and_pack(world) -> None:
    params = world["params"]
    back = convert.from_numpy(convert.to_numpy(params))
    assert [k for k, _ in leaves(back)] == [k for k, _ in leaves(params)]
    for (k, a), (_, b) in zip(leaves(params), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for pat in PATTERNS:
        masks = port_masks(world, pat)
        mback = convert.from_numpy(convert.to_numpy(masks))
        for (k, a), (_, b) in zip(leaves(masks), leaves(mback)):
            assert torch.equal(a, b), k
    for pat, fmt in (("2:4", "nm24"), ("0.5", "gathered")):
        jtree = np_tree(jpacked.pack_tree(world["jcfg"], world["jparams"],
                                          world["reports"][pat].masks, fmt))
        ttree = tpacked.pack_tree(world["tcfg"], params,
                                  port_masks(world, pat), fmt)
        for ppath in site_paths(world["tcfg"]):
            jw, tw = tpacked._get(jtree, ppath), tpacked._get(ttree, ppath)
            assert np.array_equal(tw.values.numpy(), np.asarray(jw.values))
            assert np.array_equal(tw.idx.numpy(), np.asarray(jw.idx)), ppath
        assert set(ttree) == set(jtree)


def check_mask_checkpoint(world, tmp_path) -> None:
    masks = world["reports"]["2:4"].masks
    jckpt.save(tmp_path / "m", 0, masks)
    got, params = tpacked.load_masks_and_weights(world["tcfg"],
                                                 world["params"],
                                                 tmp_path / "m")
    assert params is world["params"]
    want = dict(leaves(np_tree(masks)))
    assert set(dict(leaves(got))) == set(want)
    for k, v in leaves(got):
        assert np.array_equal(v.numpy(), want[k]), k
    eng = ServeEngine(world["tapi"], params, masks=got, fmt="nm24",
                      device="cpu")
    assert eng.generate(prompt(world), 6).tokens.tolist() == \
        world["served"]["2:4"].tolist()


def check_full_width(arch: str) -> list:
    """Full width on the meta device: the param tree (shapes and dtypes),
    ``param_count`` and the plan's sites equal the reference's. Returns
    the site specs."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jtree = jax.eval_shape(jmodels.build(jcfg).init, jax.random.key(0))
    jshapes = dict(leaves(jtree))
    ttree = tmodels.build(tcfg).init(device="meta")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in leaves(ttree)} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jshapes.items()}
    n = sum(int(np.prod(v.shape)) for v in jshapes.values())
    assert tmodels.param_count(tcfg) == tcfg.n_params() == n
    got = [(s.name, s.n_instances, s.d_out, s.d_in, s.stack_shape)
           for s in tpruning.site_specs(tcfg, ttree)]
    assert got == [(s.name, s.n_instances, s.d_out, s.d_in,
                    tuple(s.stack_shape))
                   for s in jpruning.site_specs(jcfg, jtree)]
    return got
