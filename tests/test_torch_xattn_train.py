"""Training and post-prune recovery of the port's cross-attention
families against the reference, on their TINYs (fp32): seamless-m4t-medium
(2 encoder + 2 decoder layers, 16 source frames) and llama-3.2-vision-90b
(2 groups of 1 self layer + 1 gated cross layer over 8 image tokens, the
gates set to ``_torch_xattn.GATES``). The world and the checks are
``tests/_torch_family_train.py``'s; every batch carries its frontend
states (``src`` / ``img``, the reference's ``with_modality``). Held:

* the train step after 1 and 3 steps (metrics, params, m, v);
  ``grad_accum`` 2 against the full batch, the frontend states split with
  the tokens; ``remat`` checkpoints every layer (seamless: the encoder's
  and the decoder's; the VLM: each self and cross layer) and leaves every
  gradient bitwise unchanged; at bf16 the norms (and the VLM's scalar
  gates) stay fp32 through a step, every leaf in the reference's dtype;
* the launcher trains from its synthetic stream, batch i carrying
  ``with_modality(pipe.get(i), cfg, seed, i)``; SIGTERM, then a resume
  bitwise; the reference's TrainState read bitwise, and the port's read
  back by the reference;
* every recovery selection against the reference (the VLM, rmsnorm
  throughout, has no biases: ``biases`` raises in both packages and
  ``norms_biases`` selects its scales alone; ``lora`` adapters on the
  VLM's (G, NS) self and (G,) cross stacks);
* the export's greedy tokens in nm24 and gathered, the reference reading
  the same export, the port reading and serving the reference's; the CLI: train, prune ``--from-ckpt --recover
  norms_biases``, resume, serve.
"""
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import _torch_family_train as F  # noqa: E402
import _torch_xattn as X  # noqa: E402

ARCHS = ["seamless-m4t-medium", "llama-3.2-vision-90b"]


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    assert F.GATES == X.GATES
    return F.build_world(request.param)


def _vlm(world):
    return bool(world["tcfg"].cross_attn_every)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(world, steps):
    F.check_train_step(world, steps)


def test_grad_accum_equals_full_batch(world):
    F.check_grad_accum(world)


def test_remat_leaves_gradients_unchanged(world, monkeypatch):
    cfg = world["tcfg"]
    n = cfg.n_layers + (0 if _vlm(world) else cfg.n_enc_layers)
    F.check_remat(world, monkeypatch, n)


def test_fp32_leaves_stay_fp32(world):
    names = [n for n, _ in F.leaves(world["tparams"])
             if n.rsplit(".", 1)[-1] in ("scale", "bias", "gate_attn",
                                         "gate_mlp")]
    assert names
    F.check_fp32_leaves(world, names)


def test_launcher_trains_from_synthetic_stream(world, monkeypatch):
    F.check_launcher_stream(world, monkeypatch)


def test_train_launcher_preempt_resume_bitwise(world, tmp_path, monkeypatch):
    F.check_preempt_resume(world, tmp_path, monkeypatch)


def test_trainstate_resumes_across_packages(world, tmp_path):
    paths = ([".params/cross_layers/gate_attn", ".params/layers/mlp/w_up",
              ".opt/.m/cross_layers/attn/wk"] if _vlm(world) else
             [".params/enc_layers/attn/wq", ".params/dec_layers/xattn/wk",
              ".opt/.v/dec_layers/ln_x/scale"])
    F.check_trainstate_across_packages(world, tmp_path, paths)


def test_selections_like_reference(world):
    F.check_selections(world, raises=("biases",) if _vlm(world) else ())


@pytest.mark.parametrize("select", F.SELECTIONS)
def test_recover_matches_reference(world, select):
    if select == "biases" and _vlm(world):
        F.check_recover_refused(world, select)
    else:
        F.check_recover(world, select)


@pytest.mark.parametrize("fmt", ["nm24", "gathered"])
def test_export_serves_recovered_tokens(world, fmt, tmp_path):
    F.check_export(world, fmt, tmp_path)


def test_reference_export_served_by_the_port(world, tmp_path):
    F.check_reference_export(world, tmp_path)


def test_cli_train_prune_recover_serve(world, tmp_path, capsys):
    F.check_cli(world, tmp_path, capsys, "norms_biases")
