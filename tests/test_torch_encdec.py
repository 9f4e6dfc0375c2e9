"""The port's encoder-decoder family (seamless-m4t-medium: a
bidirectional encoder over audio-frame states, a causal decoder with
cross-attention to it) against the reference, on the CPU at TINY (fp32,
2 encoder + 2 decoder layers, d = 64, 4 heads (MHA), plain ReLU MLP d_ff
128, layernorm, 16 source frames).

One ``world`` a module (``tests/_torch_xattn.py``): the reference's
params, its loss with taps, its prunes and its masked serving. What is
held, and at what tolerance:

* loss within 1e-5 relative; every tap of "enc" and "dec" (the decoder's
  cross-attention taps under "x_wq" ...) within 1e-5 of its max;
* ``enumerate_sites`` and ``tap_specs`` (the ``x_`` taps emitted as
  "wq" ...): names, shapes, instance counts, labels and tap paths equal;
  the Grams within 1e-5;
* ``prune_model`` given the reference's Grams: equal masks and swaps at
  PerRow(0.5) (k = 8) and 2:4 (k = 1); a recipe that skips
  ``enc_layers.attn.wq`` keeps the decoder's wq (the same calibration
  levels as the reference's: policies key on the emitted name) and its
  masks;
* masked serving (the masked cross-KV precompute) == the hard-zeroed
  weights served dense == nm24-packed, token for token; greedy tokens of
  ``generate`` in masked, nm24 and gathered equal the reference's masked
  model's, nm24 == gathered bitwise;
* prefill + decode against one forward within 1e-4 of max|logits|, the
  cross KV (L_dec, B, S_src, kvH, dh) precomputed once;
* other source frames change the logits;
* the continuous scheduler refuses the encoder-decoder as the reference
  does;
* params and masks through numpy and back bitwise; ``pack_tree`` bitwise
  the reference's; the reference's masks-tree checkpoint loaded and
  served; full width on the meta device: the param tree, ``param_count``
  and the plan's sites;
* both launchers on the TINY config: prune into an out dir, serve it.
"""
import json

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import _torch_xattn as X  # noqa: E402

from repro_torch.launch import prune as tprune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def world():
    return X.build_world(ARCH)


def test_forward_loss_and_taps_match(world):
    cfg = world["tcfg"]
    X.check_loss_and_taps(world, {"enc": (cfg.n_enc_layers,),
                                  "dec": (cfg.n_layers,)})
    _, aux = world["tapi"].loss(world["params"], X.batch(world),
                                want_taps=True)
    assert sorted(aux["taps"]["dec"]) == sorted(
        ["wq", "wk", "wv", "wo", "x_wq", "x_wk", "x_wv", "x_wo", "w_up",
         "w_down"])
    # the cross wk / wv Grams are over the encoder's states
    assert float(aux["taps"]["dec"]["x_wk"]["n"][0]) == 2 * cfg.n_src_frames


def test_enumerate_sites_match(world):
    X.check_sites(world, 16)


@pytest.mark.parametrize("pat", list(X.PATTERNS))
def test_prune_same_grams_same_masks(world, pat):
    X.check_prune(world, pat)


def test_recipe_skipping_the_encoders_wq_keeps_the_decoders(world):
    text = json.dumps({"defaults": {"pattern": "0.5", "t_max": X.T_MAX},
                       "rules": [{"select": "enc_layers.attn.wq",
                                  "skip": True}, {"select": "*"}]})
    jplan = jpruning.plan_pruning(world["japi"], world["jparams"],
                                  jpruning.PruneRecipe.from_json(text))
    tplan = tpruning.plan_pruning(world["tapi"], world["params"],
                                  tpruning.PruneRecipe.from_json(text))
    spec = tplan.calib_spec()
    assert spec.levels == jplan.calib_spec().levels
    assert spec.level("wq") == "gram"
    stats = tpruning.accumulate_stats(world["tapi"], world["params"],
                                      [X.batch(world)], spec=spec)
    assert "wq" in stats.taps["enc"] and "wq" in stats.taps["dec"]
    rep = tpruning.PruneExecutor(world["tapi"], world["params"], tplan,
                                 taps=world["taps"]).run()
    assert "wq" not in rep.masks["enc_layers"]["attn"]
    want = world["reports"]["0.5"].masks["dec_layers"]["attn"]["wq"]
    got = rep.masks["dec_layers"]["attn"]["wq"]
    assert X.np.array_equal(got.numpy(), X.np.asarray(want))


@pytest.mark.parametrize("pat", list(X.PATTERNS))
def test_masked_serving_equals_hard_zero(world, pat):
    X.check_masked_equals_hard_zero(world, pat)


@pytest.mark.parametrize("pat,fmt", X.GEN_CASES)
def test_generate_tokens_match_reference(world, pat, fmt):
    X.check_generate(world, pat, fmt)


def test_prefill_decode_match_forward(world):
    cache = X.check_prefill_decode(world)
    cfg = world["tcfg"]
    k, v = cache.cross_kv
    assert k.shape == v.shape == (cfg.n_layers, 2, cfg.n_src_frames,
                                  cfg.n_kv_heads, cfg.head_dim)


def test_logits_depend_on_source(world):
    X.check_modality_matters(world)


def test_continuous_refused_like_reference(world):
    X.check_continuous_refused(world)


def test_params_round_trip_and_pack_tree(world):
    assert set(world["params"]) == {"embed", "enc_layers", "ln_enc",
                                    "dec_layers", "ln_f", "head"}
    X.check_round_trip_and_pack(world)


def test_reference_mask_checkpoint_loads_and_serves(world, tmp_path):
    X.check_mask_checkpoint(world, tmp_path)


def test_full_width_params_and_plan():
    got = X.check_full_width(ARCH)
    by = {g[0]: g[1:] for g in got}
    assert by["enc_layers.mlp.w_up"] == (12, 4096, 1024, (12,))
    assert by["dec_layers.xattn.wk"] == (12, 1024, 1024, (12,))


def test_launchers_prune_and_serve(tmp_path):
    out = tprune.prune(ARCH, tiny=True, pattern="2:4", t_max=2,
                       n_calib=4, calib_seq=16, calib_batch=2,
                       out_dir=str(tmp_path), device="cpu", verbose=False)
    assert out["report"].mean_error_reduction() > 0
    got = tserve.serve(ARCH, tiny=True, batch=2, prompt_len=6, gen=3,
                       masks_from=str(tmp_path), fmt="nm24", device="cpu",
                       verbose=False)
    assert tuple(got["tokens"].shape) == (2, 3)
    assert got["kernel_used"]["prefill"] == "plain"
