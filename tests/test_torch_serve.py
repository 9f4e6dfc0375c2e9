"""The port's serving path vs the reference's, on tiny llama31-8b (fp32,
2 layers, d_model 64).

The reference initialises the params, makes 2:4 and PerRow(0.6) masks of
every prunable site (``make_mask``) and samples the prompt; all of it
goes to the port through numpy. Checked:

* model ``prefill`` + ``decode_step`` logits, dense and masked, and a
  right-padded prompt (``n_valid``): within 1e-5, equal greedy tokens;
* ``ServeEngine`` for dense, masked, nm24 and gathered: ``logits_trace``
  within atol 1e-5 (the reference's own packed-vs-masked bound), equal
  greedy tokens and weight bytes; nm24 == gathered bitwise in the port;
* a reference launcher ``--out-dir``: loaded by ``load_mask_tree`` into
  ``ServeEngine`` it gives the reference ``serve``'s tokens and weight
  bytes, and the port's ``serve(masks_from=...)`` serves it, and its
  executor ``groups/`` root too (the ``weights/`` and ``export_packed``
  splices: ``tests/test_torch_recover.py``);
* the CLI: ``launch.prune --out-dir`` then ``launch.serve --masks-from``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.launch import prune as tprune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "llama31-8b"
ROOT = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    masks = {"2:4": _mask_tree(jparams, jmasks.NM(2, 4), 0),
             "0.6": _mask_tree(jparams, jmasks.PerRow(0.6), 1)}
    pipe = jsynthetic.DataPipeline(jsynthetic.CorpusConfig(jcfg.vocab_size),
                                   2, 8, split="val")
    prompt = _np_tree(pipe.get(0))
    return dict(
        japi=japi, jparams=jparams, jmasks=masks, prompt=prompt,
        tapi=tmodels.build(tconfigs.get_tiny(ARCH)),
        tparams=convert.from_numpy(_np_tree(jparams)),
        tmasks={k: convert.from_numpy(v) for k, v in masks.items()},
        tprompt=convert.from_numpy(prompt))


def _mask_tree(jparams, pattern, seed):
    """Masks of every prunable site, by the reference's ``make_mask`` on
    seeded scores (the pattern, not the scores, is what serving sees)."""
    rng = np.random.default_rng(seed)
    tree = {"layers": {"attn": {}, "mlp": {}}}
    for block, names in (("attn", ("wq", "wk", "wv", "wo")),
                         ("mlp", ("w_gate", "w_up", "w_down"))):
        for name in names:
            shape = jparams["layers"][block][name].shape
            scores = rng.normal(size=shape).astype(np.float32)
            tree["layers"][block][name] = np.asarray(
                jmasks.make_mask(jax.numpy.asarray(scores), pattern))
    return tree


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("which", ["dense", "0.6"])
def test_prefill_decode_logits_match(world, which):
    japi, tapi = world["japi"], world["tapi"]
    jm = None if which == "dense" else world["jmasks"][which]
    tm = None if which == "dense" else world["tmasks"][which]
    B, S = world["prompt"]["tokens"].shape
    jc = japi.init_cache(world["jparams"], B, 16)
    tc = tapi.init_cache(world["tparams"], B, 16)
    jl, jc = japi.prefill(world["jparams"], world["prompt"], jc, masks=jm)
    tl, tc = tapi.prefill(world["tparams"], world["tprompt"], tc, masks=tm)
    for _ in range(3):
        _close(tl.numpy(), jl)
        jt = np.asarray(jax.numpy.argmax(jl[:, -1], axis=-1))
        tt = torch.argmax(tl[:, -1], dim=-1)
        assert np.array_equal(tt.numpy(), jt)
        jl, jc = japi.decode_step(world["jparams"], jt[:, None], jc, masks=jm)
        tl, tc = tapi.decode_step(world["tparams"], tt[:, None], tc, masks=tm)
    _close(tl.numpy(), jl)
    assert tc.t == int(jc.t) == S + 3
    assert np.array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))


def test_prefill_right_padded_prompt(world):
    japi, tapi = world["japi"], world["tapi"]
    B = world["prompt"]["tokens"].shape[0]
    jc = japi.init_cache(world["jparams"], B, 16)
    tc = tapi.init_cache(world["tparams"], B, 16)
    jb = {"tokens": world["prompt"]["tokens"], "n_valid": np.int32(5)}
    tb = {"tokens": world["tprompt"]["tokens"], "n_valid": 5}
    jl, jc = japi.prefill(world["jparams"], jb, jc)
    tl, tc = tapi.prefill(world["tparams"], tb, tc)
    _close(tl.numpy(), jl)
    assert tc.t == int(jc.t) == 5
    assert np.array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))


def test_greedy_decode_matches(world):
    want = jsteps.greedy_decode(world["japi"], world["jparams"],
                                world["prompt"], 4,
                                masks=world["jmasks"]["2:4"])
    got = tsteps.greedy_decode(world["tapi"], world["tparams"],
                               world["tprompt"], 4,
                               masks=world["tmasks"]["2:4"])
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt,pattern", [("dense", None), ("masked", "0.6"),
                                         ("nm24", "2:4"), ("gathered", "0.6"),
                                         ("gathered", "2:4")])
def test_engine_matches_reference(world, fmt, pattern):
    jm = None if pattern is None else world["jmasks"][pattern]
    tm = None if pattern is None else world["tmasks"][pattern]
    jeng = JServeEngine(world["japi"], world["jparams"], masks=jm, fmt=fmt,
                        kernel="jnp")
    teng = ServeEngine(world["tapi"], world["tparams"], masks=tm, fmt=fmt,
                       device="cpu")
    _close(teng.logits_trace(world["tprompt"], 4).numpy(),
           jeng.logits_trace(world["prompt"], 4))
    got = teng.generate(world["tprompt"], 4)
    assert np.array_equal(got.tokens.numpy(),
                          np.asarray(jeng.generate(world["prompt"], 4).tokens))
    assert teng.weight_bytes() == jeng.weight_bytes()
    packed = fmt in ("nm24", "gathered")
    assert teng.kernel_used == {"prefill": "plain" if packed else "dense",
                                "decode": "plain" if packed else "dense"}
    assert got.tokens.shape == (2, 4) and got.tok_s > 0


def test_nm24_equals_gathered_bitwise(world):
    tm = world["tmasks"]["2:4"]
    traces = [ServeEngine(world["tapi"], world["tparams"], masks=tm, fmt=f,
                          device="cpu").logits_trace(world["tprompt"], 3)
              for f in ("nm24", "gathered")]
    assert torch.equal(*traces)


def test_serve_from_reference_out_dir(world, tmp_path):
    from repro.launch.prune import prune as jprune
    from repro.launch.serve import serve as jserve

    jprune(ARCH, tiny=True, pattern="2:4", method="none", t_max=2, n_calib=2,
           calib_seq=16, out_dir=str(tmp_path), verbose=False)
    want = jserve(ARCH, tiny=True, batch=2, prompt_len=8, gen=3,
                  masks_from=str(tmp_path), fmt="nm24", verbose=False)
    pipe = jsynthetic.DataPipeline(
        jsynthetic.CorpusConfig(world["japi"].cfg.vocab_size, seed=0), 2, 8,
        split="val")
    tmask = tpacked.load_mask_tree(world["tapi"].cfg, world["tparams"],
                                   tmp_path)
    eng = ServeEngine(world["tapi"], world["tparams"], masks=tmask,
                      fmt="nm24", device="cpu")
    got = eng.generate(convert.from_numpy(_np_tree(pipe.get(0))), 3)
    assert np.array_equal(got.tokens.numpy(), np.asarray(want["tokens"]))
    assert eng.weight_bytes() == want["weight_bytes"]
    # the launcher serves the same directory (its own seeded weights)
    out = tserve.serve(ARCH, tiny=True, batch=2, prompt_len=8, gen=3,
                       masks_from=str(tmp_path), fmt="nm24", device="cpu",
                       verbose=False)
    assert out["tokens"].shape == (2, 3)
    assert out["weight_bytes"] == want["weight_bytes"]
    # the reference's executor groups/ root serves the same tokens, and a
    # weights/ dir without a valid checkpoint splices nothing
    via_groups = ServeEngine(world["tapi"], world["tparams"], fmt="nm24",
                             masks=tmp_path / "prune_ckpt", device="cpu")
    got2 = via_groups.generate(convert.from_numpy(_np_tree(pipe.get(0))), 3)
    assert np.array_equal(got2.tokens.numpy(), np.asarray(want["tokens"]))
    (tmp_path / "weights").mkdir()
    out = tserve.serve(ARCH, tiny=True, batch=2, prompt_len=8, gen=3,
                       masks_from=str(tmp_path), fmt="nm24", device="cpu",
                       verbose=False)
    assert out["tokens"].shape == (2, 3)
    with pytest.raises(FileNotFoundError, match="no mask checkpoint"):
        tserve.serve(ARCH, tiny=True, masks_from=str(tmp_path / "nothing"),
                     device="cpu", verbose=False)


def test_cli_prune_then_serve(tmp_path, capsys):
    bench_file = ROOT / "BENCH_serve.json"
    before = bench_file.read_bytes()
    out = tmp_path / "run"
    tprune.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--sparsity",
                 "2:4", "--t-max", "2", "--n-calib", "4", "--out-dir",
                 str(out)])
    doc = json.loads((out / "report.json").read_text())
    assert doc["pattern"] == "2:4" and len(doc["sites"]) == 7
    assert {"dense", "pruned", "mean_error_reduction"} <= set(doc)
    capsys.readouterr()
    tserve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--masks-from",
                 str(out), "--format", "nm24", "--gen", "4", "--bench",
                 "--bench-out", str(tmp_path / "b.json")])
    text = capsys.readouterr().out
    assert "format=nm24" in text and "'decode': 'plain'" in text
    rows = json.loads((tmp_path / "b.json").read_text())["rows"]
    assert sorted({r["variant"] for r in rows}) == \
        ["dense", "gathered", "masked", "nm24"]
    assert {r["phase"] for r in rows} == {"prefill", "decode"}
    assert bench_file.read_bytes() == before      # never the committed file


def test_engine_errors_and_no_card(world):
    tapi, tparams = world["tapi"], world["tparams"]
    with pytest.raises(ValueError, match="unknown serve format"):
        ServeEngine(tapi, tparams, fmt="csr", device="cpu")
    with pytest.raises(ValueError, match="needs masks"):
        ServeEngine(tapi, tparams, fmt="nm24", device="cpu")
    eng = ServeEngine(tapi, tparams, masks=world["tmasks"]["2:4"],
                      fmt="nm24", device="cpu")
    with pytest.raises(ValueError, match="already encodes its mask"):
        tapi.prefill(eng.params, world["tprompt"],
                     tapi.init_cache(eng.params, 2, 16),
                     masks=world["tmasks"]["2:4"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tapi, tparams, fmt="dense")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(ARCH, tiny=True, verbose=False)
