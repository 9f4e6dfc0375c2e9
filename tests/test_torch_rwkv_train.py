"""Training and post-prune recovery of the port's RWKV6 family
(rwkv6-1.6b) against the reference, on its TINY (fp32, 2 layers,
``grad_accum`` 1). The world and the checks are
``tests/_torch_family_train.py``'s. Held:

* the train step after 1 and 3 steps (metrics, params, m, v);
  ``grad_accum`` 2 against the full batch; ``remat`` checkpoints each of
  the 2 layers (time-mix and channel-mix) and leaves every gradient
  bitwise unchanged; at bf16 the token-shift mixes (``maa_*``), the
  decay base, the WKV group norm (``ln_x_*``) and the bonus ``u`` stay
  fp32 through a step, every leaf in the reference's dtype;
* the launcher's synthetic stream; SIGTERM, then a resume bitwise; the
  reference's TrainState read bitwise, and the port's read back by the
  reference;
* every recovery selection against the reference; ``ln_x_*``,
  ``decay_base`` and ``maa_*`` are in none of them (the reference selects
  a leaf by its last key: ``scale``, ``norm_scale``, ``bias`` or
  ``dt_bias``); ``lora`` adapters on the ten ``layers.tm.*`` sites,
  stacked on L;
* the export's greedy tokens in nm24 and gathered, the reference reading
  the same export, the port reading and serving the reference's; the CLI: train, prune ``--from-ckpt --recover
  all_masked``, resume, serve.
"""
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import _torch_family_train as F  # noqa: E402

ARCH = "rwkv6-1.6b"
FP32 = ["layers.tm.maa_x", "layers.tm.maa_rkvwg", "layers.tm.maa_w1",
        "layers.tm.maa_w2", "layers.tm.cm_maa_k", "layers.tm.cm_maa_r",
        "layers.tm.decay_base", "layers.tm.ln_x_scale",
        "layers.tm.ln_x_bias", "layers.tm.u"]
NEVER = ("ln_x_", "decay_base", "maa_", "cm_maa_")


@pytest.fixture(scope="module")
def world():
    return F.build_world(ARCH)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(world, steps):
    F.check_train_step(world, steps)


def test_grad_accum_equals_full_batch(world):
    F.check_grad_accum(world)


def test_remat_leaves_gradients_unchanged(world, monkeypatch):
    F.check_remat(world, monkeypatch, world["tcfg"].n_layers)


def test_fp32_leaves_stay_fp32(world):
    F.check_fp32_leaves(world, FP32)


def test_launcher_trains_from_synthetic_stream(world, monkeypatch):
    F.check_launcher_stream(world, monkeypatch)


def test_train_launcher_preempt_resume_bitwise(world, tmp_path, monkeypatch):
    F.check_preempt_resume(world, tmp_path, monkeypatch)


def test_trainstate_resumes_across_packages(world, tmp_path):
    F.check_trainstate_across_packages(world, tmp_path, [
        ".params/layers/tm/td_w1", ".params/layers/tm/decay_base",
        ".opt/.m/layers/tm/maa_w2", ".opt/.v/layers/tm/u"])


def test_selections_like_reference(world):
    F.check_selections(world, never=NEVER)


@pytest.mark.parametrize("select", F.SELECTIONS)
def test_recover_matches_reference(world, select):
    F.check_recover(world, select)


@pytest.mark.parametrize("fmt", ["nm24", "gathered"])
def test_export_serves_recovered_tokens(world, fmt, tmp_path):
    F.check_export(world, fmt, tmp_path)


def test_reference_export_served_by_the_port(world, tmp_path):
    F.check_reference_export(world, tmp_path)


def test_cli_train_prune_recover_serve(world, tmp_path, capsys):
    F.check_cli(world, tmp_path, capsys, "all_masked")
