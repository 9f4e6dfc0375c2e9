"""The port's SparseSwaps refinement vs the reference's, plus brute force.

``refine`` runs in both packages on the same numpy problem at k ∈ {1, 8},
for PerRow(0.6) and NM(2, 4), with the dense and the chunked search.
Masks must be equal and the counted search passes equal; tracked losses
agree to rtol 1e-5 (fp32 matmuls and FMA contraction differ between XLA's
CPU backend and PyTorch). The brute-force checks of
``tests/test_swap_optimal.py`` hold the port alone at d_in ≤ 10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from test_swap_optimal import _brute_force, _problem, _row_loss_np  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import sparseswaps as jss  # noqa: E402
from repro.core.warmstart import warmstart_mask as jwarmstart  # noqa: E402

from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import sparseswaps as tss  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _case(spec, seed=0, R=12, d=32):
    W, G, _ = _problem(seed, R, d, 0, corr=0.5)
    m0 = np.array(jwarmstart(jnp.asarray(W), jnp.asarray(G),
                             jmasks.parse_pattern(spec), "wanda"))
    return W, G, m0


@pytest.mark.parametrize("method", ["dense", "chunked"])
@pytest.mark.parametrize("spec", ["0.6", "2:4"])
@pytest.mark.parametrize("k", [1, 8])
def test_refine_matches_reference(k, spec, method):
    W, G, m0 = _case(spec, seed=k + len(spec))
    kw = dict(t_max=60, method=method, chunk=8, k_swaps=k)
    with jss.count_search_passes() as jcnt:
        want = jss.refine(jnp.asarray(W), jnp.asarray(G), jnp.asarray(m0),
                          jmasks.parse_pattern(spec), **kw)
    with tss.count_search_passes() as tcnt:
        got = tss.refine(torch.from_numpy(W), torch.from_numpy(G),
                         torch.from_numpy(m0), tmasks.parse_pattern(spec), **kw)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert (tcnt.passes, tcnt.rows_scored) == (jcnt.passes, jcnt.rows_scored)
    assert got.iters == int(want.iters)
    assert np.array_equal(got.swaps.numpy(), np.asarray(want.swaps))
    assert int(got.swaps.sum()) > 0
    for a, b in ((got.loss_init, want.loss_init),
                 (got.loss_final, want.loss_final)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert bool((got.loss_final <= got.loss_init).all())


def test_refine_row_block_padding_and_history():
    """A partial last row block is padded with inert rows; the history is
    the mean over real rows, as in the reference."""
    W, G, m0 = _case("0.6", seed=3, R=10)
    kw = dict(t_max=5, method="dense", row_block=4, k_swaps=8,
              track_history=True)
    want = jss.refine(jnp.asarray(W), jnp.asarray(G), jnp.asarray(m0),
                      jmasks.PerRow(0.6), **kw)
    got = tss.refine(torch.from_numpy(W), torch.from_numpy(G),
                     torch.from_numpy(m0), tmasks.PerRow(0.6), **kw)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               rtol=1e-5)


def test_kernel_method_on_cpu_takes_plain_versions():
    W, G, m0 = _case("0.6", seed=4)
    args = (torch.from_numpy(W), torch.from_numpy(G), torch.from_numpy(m0),
            tmasks.PerRow(0.6))
    ops.reset_launches()
    for k, mode in ((1, "columns"), (8, "columns"), (8, "candidates")):
        a = tss.refine(*args, t_max=20, method="kernel", k_swaps=k,
                       commit_mode=mode)
        b = tss.refine(*args, t_max=20, method="chunked", k_swaps=k,
                       commit_mode=mode)
        assert torch.equal(a.mask, b.mask)
    assert ops.LAUNCHES == {"gram_xtx": 0, "gram_xtx_bf16": 0,
                            "gram_xtx_stacked": 0,
                            "gram_xtx_stacked_bf16": 0, "swap_topk": 0,
                            "swap_argmin": 0, "swap_commit": 0, "spmm": 0,
                            "spmm_stacked": 0}
    assert tss._pick_method("auto", 32, 12, "cpu") == "dense"
    assert tss._pick_method("auto", 32, 12, "cuda") == "kernel"
    assert tss._pick_method("auto", 1024, 1024, "cpu") == "chunked"


# ---------------------------------------------------------------------------
# brute force (d_in <= 10)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dense", "chunked", "kernel"])
def test_one_step_applies_bruteforce_swap(method):
    W, G, m = _problem(7, 5, 10, 5)
    want_dl, bu, bp = _brute_force(W, G, m)
    res = tss.refine(torch.from_numpy(W), torch.from_numpy(G),
                     torch.from_numpy(m), tmasks.PerRow(0.5), t_max=1,
                     method=method, chunk=4)
    got = res.mask.numpy()
    for r in range(W.shape[0]):
        want = m[r].copy()
        if want_dl[r] < 0:
            want[bu[r]], want[bp[r]] = 0.0, 1.0
        np.testing.assert_array_equal(got[r], want, err_msg=f"{method} row {r}")


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("method", ["dense", "chunked"])
def test_fixed_point_has_no_profitable_swap(k, method):
    """A converged mask is a certified 1-swap local optimum: brute force
    finds no negative-ΔL pair and a re-run performs zero swaps."""
    W, G, m = _problem(11, 4, 10, 4)
    pat = tmasks.PerRow(0.6)
    args = (torch.from_numpy(W), torch.from_numpy(G))
    res = tss.refine(*args, torch.from_numpy(m), pat, t_max=500,
                     method=method, chunk=4, k_swaps=k)
    mf = res.mask.numpy()
    want_dl, _, _ = _brute_force(W, G, mf)
    assert np.all(want_dl >= -1e-4), want_dl
    res2 = tss.refine(*args, res.mask, pat, t_max=500, method=method,
                      chunk=4, k_swaps=k)
    assert int(res2.swaps.sum()) == 0
    direct = [_row_loss_np(W[r], mf[r], G) for r in range(W.shape[0])]
    np.testing.assert_allclose(res.loss_final.numpy(), direct, rtol=1e-4)
