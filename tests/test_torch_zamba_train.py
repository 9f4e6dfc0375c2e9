"""Training and post-prune recovery of the port's hybrid family
(zamba2-7b: a Mamba2 backbone and one shared attention block) against the
reference, on its TINY (fp32, 4 layers, the shared block at layers 0 and
2, ``grad_accum`` 2). The world and the checks are
``tests/_torch_family_train.py``'s. Held:

* the train step at ``grad_accum`` 2 after 1 and 3 steps (metrics,
  params, m, v); ``grad_accum`` 2 against the full batch; ``remat``
  checkpoints each of the 4 layers (the shared block inside layers 0
  and 2) and leaves every gradient bitwise unchanged; at bf16 ``A_log``,
  ``D``, ``dt_bias`` and ``norm_scale`` stay fp32 through a step, every
  leaf in the reference's dtype;
* the chunked SSD scan's gradients where a chunk's decay sum passes
  fp32's exp range (they were NaN, in the reference's form too): finite
  and within 1e-3 of their max of the exact ``ssm_step`` recurrence's
  (fp32 sums in other orders: A's sums over every position);
* the launcher's synthetic stream; SIGTERM, then a resume bitwise; the
  reference's TrainState (shared and stacked leaves) read bitwise, and
  the port's read back by the reference;
* every recovery selection against the reference (``biases`` picks
  mamba2's ``dt_bias``; ``lora`` adapters on the shared leaves without a
  stack and on the (L, ...) mamba leaves with one);
* the export's greedy tokens in nm24 and gathered, the reference reading
  the same export, the port reading and serving the reference's; the CLI: train, prune ``--from-ckpt --recover lora``,
  resume, serve.
"""
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import _torch_family_train as F  # noqa: E402

ARCH = "zamba2-7b"
FP32 = ["layers.mamba.A_log", "layers.mamba.D", "layers.mamba.dt_bias",
        "layers.mamba.norm_scale"]


@pytest.fixture(scope="module")
def world():
    w = F.build_world(ARCH)
    assert w["tcfg"].grad_accum == 2
    return w


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(world, steps):
    F.check_train_step(world, steps)


def test_grad_accum_equals_full_batch(world):
    F.check_grad_accum(world)


def test_remat_leaves_gradients_unchanged(world, monkeypatch):
    F.check_remat(world, monkeypatch, world["tcfg"].n_layers)


def test_ssd_gradients_finite_past_the_exp_range():
    from repro_torch.models import mamba2

    g = torch.Generator().manual_seed(0)
    B, S, H, dh, ds, Q = 2, 24, 2, 4, 3, 16
    leaves = dict(x=torch.randn(B, S, H, dh, generator=g),
                  Bm=torch.randn(B, S, ds, generator=g),
                  Cm=torch.randn(B, S, ds, generator=g),
                  # 16 steps of dt·|A| = 8: a decay sum of 128 in a chunk
                  dt=torch.full((B, S, H), 8.0),
                  A=-torch.ones(H))
    w_y = torch.randn(B, S, H, dh, generator=g)
    w_h = torch.randn(B, H, dh, ds, generator=g)

    def grads(fn):
        ins = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        y, h = fn(**ins)
        loss = (y * w_y).sum() + (h * w_h).sum()
        return dict(zip(ins, torch.autograd.grad(loss, list(ins.values()))))

    def chunked(x, Bm, Cm, dt, A):
        return mamba2.ssd_chunked(x, Bm, Cm, dt, A, chunk=Q)

    def exact(x, Bm, Cm, dt, A):
        h, ys = torch.zeros(B, H, dh, ds), []
        for t in range(S):
            y, h = mamba2.ssm_step(x[:, t], Bm[:, t], Cm[:, t], dt[:, t], A,
                                   h)
            ys.append(y)
        return torch.stack(ys, dim=1), h

    got, want = grads(chunked), grads(exact)
    for k in leaves:
        assert bool(torch.isfinite(got[k]).all()), k
        tol = 1e-3 * float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol, k


def test_fp32_leaves_stay_fp32(world):
    F.check_fp32_leaves(world, FP32)


def test_launcher_trains_from_synthetic_stream(world, monkeypatch):
    F.check_launcher_stream(world, monkeypatch)


def test_train_launcher_preempt_resume_bitwise(world, tmp_path, monkeypatch):
    F.check_preempt_resume(world, tmp_path, monkeypatch)


def test_trainstate_resumes_across_packages(world, tmp_path):
    F.check_trainstate_across_packages(world, tmp_path, [
        ".params/shared/attn/wq", ".params/layers/mamba/in_proj",
        ".opt/.m/layers/mamba/A_log", ".opt/.v/shared/mlp/w_down"])


def test_selections_like_reference(world):
    F.check_selections(world)


@pytest.mark.parametrize("select", F.SELECTIONS)
def test_recover_matches_reference(world, select):
    # all_masked trains in_proj, out_proj and the shared block's seven
    # projections: 0.27-0.90% of their coordinates part by more than
    # 1e-6 + 1e-5·|w| over the 3 free steps (CE 1.7e-7 apart), the
    # train step's AdamW amplification of fp32 rounding
    F.check_recover(world, select, per_coordinate=select != "all_masked")


@pytest.mark.parametrize("fmt", ["nm24", "gathered"])
def test_export_serves_recovered_tokens(world, fmt, tmp_path):
    F.check_export(world, fmt, tmp_path)


def test_reference_export_served_by_the_port(world, tmp_path):
    F.check_reference_export(world, tmp_path)


def test_cli_train_prune_recover_serve(world, tmp_path, capsys):
    F.check_cli(world, tmp_path, capsys, "lora")
