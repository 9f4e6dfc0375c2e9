"""The port's VLM family (llama-3.2-vision-90b: groups of self layers
and a gated cross-attention layer over image states) against the
reference, on the CPU at TINY (fp32, 4 layers in 2 groups of 1 self + 1
cross layer, d = 64, 4 heads / 2 KV, d_ff 96, 8 image tokens).

One ``world`` a module (``tests/_torch_xattn.py``): the reference's
params with the cross gates set to 0.5 / -0.5 (its init leaves them at
0, where the cross layers add nothing), its loss with taps, its prunes
and its masked serving. What is held, and at what tolerance:

* loss within 1e-5 relative; every tap of "self" (stacked (G, NS)) and
  "cross" (stacked (G,)) within 1e-5 of its max;
* ``enumerate_sites`` and ``tap_specs``: names, shapes, instance counts,
  labels and tap paths equal; the Grams within 1e-5;
* ``prune_model`` given the reference's Grams: equal masks and swaps at
  PerRow(0.5) (k = 8) and 2:4 (k = 1);
* masked serving (the masked cross-KV precompute) == the hard-zeroed
  weights served dense == nm24-packed, token for token; greedy tokens of
  ``generate`` in masked, nm24 and gathered equal the reference's masked
  model's, nm24 == gathered bitwise;
* prefill + decode against one forward within 1e-4 of max|logits|, the
  cross KV (G, B, P, kvH, dh) precomputed once;
* other image states change the logits (the gates are nonzero);
* the continuous scheduler refuses the VLM as the reference does;
* params (the (G, NS) stacks, the fp32 scalar gates) and masks through
  numpy and back bitwise; ``pack_tree`` bitwise the reference's; the
  reference's masks-tree checkpoint loaded and served; full width on the
  meta device: the param tree, ``param_count`` and the plan's sites;
* both launchers on the TINY config: prune into an out dir, serve it.
"""
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import _torch_xattn as X  # noqa: E402

from repro_torch.launch import prune as tprune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCH = "llama-3.2-vision-90b"


@pytest.fixture(scope="module")
def world():
    return X.build_world(ARCH)


def test_forward_loss_and_taps_match(world):
    G, NS = transformer.groups(world["tcfg"])
    assert (G, NS) == (2, 1)
    X.check_loss_and_taps(world, {"self": (G, NS), "cross": (G,)})


def test_enumerate_sites_match(world):
    X.check_sites(world, 14)


@pytest.mark.parametrize("pat", list(X.PATTERNS))
def test_prune_same_grams_same_masks(world, pat):
    X.check_prune(world, pat)


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
    assert k.shape == v.shape == (2, 2, cfg.n_img_tokens, cfg.n_kv_heads,
                                  cfg.head_dim)
    assert cache.kv.k.shape[:2] == transformer.groups(cfg)


def test_logits_depend_on_image(world):
    X.check_modality_matters(world)


def test_continuous_refused_like_reference(world):
    X.check_continuous_refused(world)


def test_params_round_trip_and_pack_tree(world):
    cross = world["params"]["cross_layers"]
    assert cross["gate_attn"].dtype == torch.float32
    assert cross["gate_attn"].tolist() == [X.GATES[0]] * 2
    X.check_round_trip_and_pack(world)


def test_reference_mask_checkpoint_loads_and_serves(world, tmp_path):
    X.check_mask_checkpoint(world, tmp_path)


def test_full_width_params_and_plan():
    got = X.check_full_width(ARCH)
    by = {g[0]: g[1:] for g in got}
    assert by["layers.mlp.w_down"] == (80, 8192, 28672, (20, 4))
    assert by["cross_layers.attn.wk"] == (20, 1024, 8192, (20,))


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
