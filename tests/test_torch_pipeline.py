"""The port's pruning path vs the reference's, on tiny llama31-8b.

The reference initialises the params and samples the token arrays; both
go to the port through numpy (``repro_torch.convert``). The chain:

* forward logits agree within 1e-4 of max|logits| — fp32 on the CPU
  through two layers, matmuls summed in another order;
* every tap's Gram agrees within 1e-5 of its max|G| (fp32 sums);
* ``prune_model`` given the SAME Grams gives equal masks at 0.6 and 2:4;
* dense and pruned perplexity agree within 1e-4 relative, and so does
  ``evaluate``'s, its top-1 accuracy equal;
* the CLI runs with ``--tiny --device cpu``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.launch import prune as tlaunch  # noqa: E402

ARCH = "llama31-8b"


@pytest.fixture(scope="module")
def world():
    """Reference params, calibration and validation batches, and their
    port-side copies."""
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    calib = [jax.tree.map(np.asarray, b) for b in jpruning.calibration_batches(
        jcfg, n_samples=8, seq_len=32, batch_size=4, seed=0)]
    val = [jax.tree.map(np.asarray, b)
           for b in jpruning.val_batches(jcfg, n_batches=2, batch=4, seq=32)]
    tapi = tmodels.build(tconfigs.get_tiny(ARCH))
    return dict(
        japi=japi, jparams=jparams, calib=calib, val=val, tapi=tapi,
        tparams=convert.from_numpy(np_params),
        tcalib=[convert.from_numpy(b) for b in calib],
        tval=[convert.from_numpy(b) for b in val],
        jtaps=jpruning.accumulate(japi, jparams, calib))


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_config_copy_matches_reference():
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "rope_theta", "dtype", "head_dim"):
        assert getattr(tconfigs.get(ARCH), f) == getattr(jconfigs.get(ARCH), f)
        assert getattr(tconfigs.get_tiny(ARCH), f) == \
            getattr(jconfigs.get_tiny(ARCH), f)


def test_convert_round_trip(world):
    np_params = jax.tree.map(np.asarray, world["jparams"])
    back = convert.to_numpy(world["tparams"])
    for (ka, a), (kb, b) in zip(_leaves(np_params), _leaves(back)):
        assert ka == kb and np.array_equal(a, b)
    assert world["tparams"]["layers"]["attn"]["wq"].shape == \
        np_params["layers"]["attn"]["wq"].shape          # (L, d_out, d_in)
    bf = np.asarray(jax.numpy.arange(5, dtype=jax.numpy.bfloat16) / 3)
    t = convert.from_numpy(bf)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(convert.to_numpy(t), bf.astype(np.float32))


def test_forward_logits_match(world):
    jcfg = world["japi"].cfg
    b = world["calib"][0]
    jh, _, _ = world["japi"].forward(world["jparams"], b)
    want = np.asarray(world["japi"].module.lm_head(world["jparams"], jh, jcfg))
    tapi = world["tapi"]
    th, _, _ = tapi.forward(world["tparams"], world["tcalib"][0])
    got = tapi.module.lm_head(world["tparams"], th, tapi.cfg).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_taps_match(world):
    ttaps = tpruning.accumulate(world["tapi"], world["tparams"], world["tcalib"])
    jt = dict(_leaves(jax.tree.map(np.asarray, world["jtaps"])))
    tt = dict(_leaves(convert.to_numpy(ttaps)))
    assert sorted(jt) == sorted(tt)
    for name, want in jt.items():
        assert tt[name].shape == want.shape, name
        np.testing.assert_allclose(tt[name], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("spec", ["0.6", "2:4"])
def test_prune_model_same_grams_same_masks(world, spec):
    jtaps = world["jtaps"]
    want = jpruning.prune_model(world["japi"], world["jparams"], None,
                                jmasks.parse_pattern(spec), taps=jtaps,
                                t_max=20)
    ttaps = convert.from_numpy(jax.tree.map(np.asarray, jtaps))
    got = tpruning.prune_model(world["tapi"], world["tparams"], None,
                               tmasks.parse_pattern(spec), taps=ttaps,
                               t_max=20)
    wl, gl = dict(_leaves(want.masks)), dict(_leaves(got.masks))
    assert sorted(wl) == sorted(gl)
    for name in wl:
        assert np.array_equal(gl[name].numpy(), np.asarray(wl[name])), name
        assert tmasks.validate_mask(gl[name], tmasks.parse_pattern(spec))
    assert [s.name for s in got.sites] == [s.name for s in want.sites]
    for gs, ws in zip(got.sites, want.sites):
        assert np.array_equal(gs.swaps.numpy(), np.asarray(ws.swaps)), gs.name
        np.testing.assert_allclose(gs.loss_final.numpy(),
                                   np.asarray(ws.loss_final), rtol=1e-5)
    assert got.mean_error_reduction() == pytest.approx(
        want.mean_error_reduction(), rel=1e-5)
    assert got.mean_error_reduction() > 0
    # perplexity of the dense and the pruned model
    for jm, tm in ((None, None), (want.masks, got.masks)):
        jp = jpruning.perplexity(world["japi"], world["jparams"], world["val"],
                                 masks=jm)
        tp = tpruning.perplexity(world["tapi"], world["tparams"], world["tval"],
                                 masks=tm)
        assert tp == pytest.approx(jp, rel=1e-4)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_evaluate_matches_reference(world, pruned, monkeypatch):
    """``evaluate`` vs the reference's on the reference's validation tokens
    (the port samples its own corpus with torch's generator): perplexity
    within 1e-4 relative, top-1 accuracy equal, and each the value of
    ``perplexity`` / ``top1_accuracy`` on those batches."""
    tev = importlib.import_module("repro_torch.pruning.evaluate")
    jcfg = world["japi"].cfg
    monkeypatch.setattr(tev, "val_batches", lambda cfg, *, device, **kw: [
        convert.from_numpy(jax.tree.map(np.asarray, b))
        for b in jpruning.val_batches(jcfg, **kw)])
    tm = None
    if pruned:
        ttaps = convert.from_numpy(jax.tree.map(np.asarray, world["jtaps"]))
        tm = tpruning.prune_model(world["tapi"], world["tparams"], None,
                                  tmasks.PerRow(0.6), taps=ttaps,
                                  method="none").masks
    jm = None if tm is None else convert.to_numpy(tm)
    kw = dict(n_batches=2, batch=4, seq=32, seed=3)
    want = jpruning.evaluate(world["japi"], world["jparams"], masks=jm, **kw)
    got = tpruning.evaluate(world["tapi"], world["tparams"], masks=tm,
                            device="cpu", **kw)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-4)
    assert got["accuracy"] == want["accuracy"]
    bs = tev.val_batches(jcfg, device="cpu", **kw)
    assert got["perplexity"] == tpruning.perplexity(
        world["tapi"], world["tparams"], bs, masks=tm)
    assert got["accuracy"] == tpruning.top1_accuracy(
        world["tapi"], world["tparams"], bs, masks=tm)


def test_method_none_is_the_warmstart(world):
    ttaps = convert.from_numpy(jax.tree.map(np.asarray, world["jtaps"]))
    rep = tpruning.prune_model(world["tapi"], world["tparams"], None,
                               tmasks.PerRow(0.6), taps=ttaps, method="none")
    assert rep.mean_error_reduction() == 0.0
    assert all(int(s.swaps.sum()) == 0 for s in rep.sites)


def test_cli_runs_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--t-max", "3",
                  "--n-calib", "4", "--sparsity", "2:4"])
    out = capsys.readouterr().out
    assert "mean error reduction" in out
    assert "dense : ppl" in out and "pruned: ppl" in out


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.prune(ARCH, tiny=True, device="cuda", verbose=False)


def test_profile_prune_runs_on_cpu(capsys):
    from repro_torch.launch import profile_prune

    profile_prune.main(["--tiny", "--n-layers", "1", "--t-max", "2",
                        "--n-calib", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "n_calib 8" in out[0]
    assert out[1].startswith("calibration: 2 batches")
    assert out[1].endswith("device time: not measured (no card)")
    assert "unprofiled" in out[2]
    assert out[3].startswith("device time: not measured")
