"""The port's candidate-space commit, active-row compaction and the DSnoT
and SparseGPT baselines vs the reference's, on shared numpy problems.

* ``ops.swap_topk_commit`` (its plain version on the CPU) against the
  reference's ``kops.swap_topk_commit`` in Pallas interpret mode: equal
  masks and accept counts; ``c`` and the ΔL sums within rtol 1e-5 — not
  bitwise, because XLA's CPU backend contracts multiply-adds into FMAs
  and PyTorch does not;
* ``refine(commit_mode="candidates")``: masks, swaps and search-pass
  counts equal to the reference's; with ``compact_every`` ∈ {1, 3, 7} the
  port's masks, swaps and losses are bitwise its uncompacted ones;
* DSnoT and SparseGPT given the same Gram and moments: equal masks (for
  SparseGPT also at d_in = 4096 with 128-column blocks);
  SparseGPT's updated weights within 1e-4 of max|W'| — the inverse and
  the Cholesky factor come from two fp32 libraries, and their rounding
  spreads through every later column's OBS update.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_swap_optimal import _problem  # noqa: E402

from repro.core import masks as jmasks  # noqa: E402
from repro.core import sparseswaps as jss  # noqa: E402
from repro.core import swap_math as jsm  # noqa: E402
from repro.core.warmstart import warmstart_mask as jwarmstart  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.core import dsnot as tdsnot  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import sparsegpt as tsgpt  # noqa: E402
from repro_torch.core import sparseswaps as tss  # noqa: E402
from repro_torch.core import swap_math as tsm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the reference's core package re-exports functions under these names
jdsnot = importlib.import_module("repro.core.dsnot")
jsgpt = importlib.import_module("repro.core.sparsegpt")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_swap_topk_commit_matches_reference():
    W, G, m = _problem(13, 9, 24, 12, corr=0.5)
    jW, jG, jm = map(jnp.asarray, (W, G, m))
    jc = jsm.correlation_vector(jW, jm, jG)
    want = [np.asarray(x) for x in jops.swap_topk_commit(jW, jm, jc, jG, k=5,
                                                         interpret=True)]
    tW, tG, tm = map(_t, (W, G, m))
    ops.reset_launches()
    got = [x.numpy() for x in ops.swap_topk_commit(
        tW, tm, tsm.correlation_vector(tW, tm, tG), tG, k=5)]
    assert np.array_equal(got[0], want[0])                 # masks
    assert np.array_equal(got[3], want[3])                 # accepts per row
    assert got[3].sum() > 0
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=1e-5 * np.abs(want[1]).max())
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5,
                               atol=1e-5 * np.abs(want[2]).max())
    assert ops.LAUNCHES["swap_commit"] == 0                # plain on the CPU


def test_swap_commit_rejects_bad_shapes():
    R, k = 4, 3
    vec = torch.zeros(R, k)
    cube = torch.zeros(R, k, k)
    idx = torch.zeros(R, k, dtype=torch.int64)
    with pytest.raises(ValueError, match="k <= 32"):
        ops.swap_commit(*(torch.zeros(R, 33),) * 4, *(torch.zeros(R, 33, 33),)
                        * 3, *(torch.zeros(R, 33, dtype=torch.int64),) * 2,
                        torch.zeros(R, 33), eps=0.0, k=33)
    with pytest.raises(ValueError, match="Sup"):
        ops.swap_commit(vec, vec, vec, vec, cube, cube[:, :2], cube, idx, idx,
                        vec, eps=0.0, k=k)
    with pytest.raises(ValueError, match="valid"):
        ops.swap_commit(vec, vec, vec, vec, cube, cube, cube, idx, idx,
                        vec[:2], eps=0.0, k=k)


@pytest.mark.parametrize("seed,R,d,keep", [(61, 5, 12, 6), (37, 24, 32, 16)])
def test_candidate_commit_and_compaction_match_reference(seed, R, d, keep):
    W, G, m = _problem(seed, R, d, keep)
    kw = dict(t_max=300, k_swaps=4, method="chunked", chunk=8,
              commit_mode="candidates")
    want = jss.refine(jnp.asarray(W), jnp.asarray(G), jnp.asarray(m),
                      jmasks.PerRow(0.5), **kw)
    args = (_t(W), _t(G), _t(m), tmasks.PerRow(0.5))
    with tss.count_search_passes() as cnt:
        got = tss.refine(*args, **kw)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert np.array_equal(got.swaps.numpy(), np.asarray(want.swaps))
    assert got.iters == int(want.iters) == cnt.passes
    np.testing.assert_allclose(got.loss_final.numpy(),
                               np.asarray(want.loss_final), rtol=1e-5)
    for every in (1, 3, 7):
        with tss.count_search_passes() as cc:
            comp = tss.refine(*args, compact_every=every, **kw)
        assert torch.equal(comp.mask, got.mask), every
        assert torch.equal(comp.swaps, got.swaps), every
        assert torch.equal(comp.loss_final, got.loss_final), every
        assert torch.equal(comp.loss_init, got.loss_init), every
        assert comp.iters == got.iters, every
        assert cc.rows_scored <= cnt.rows_scored, every


def test_compaction_scores_fewer_rows_and_truncates_bitwise():
    """Default column commit: compaction shrinks the rows scored, and stays
    bitwise when t_max cuts the run mid-refinement (row_block padding
    included)."""
    W, G, m = _problem(41, 13, 32, 16)
    args = (_t(W), _t(G), _t(m), tmasks.PerRow(0.5))
    scored = []
    for t_max, rb in ((400, None), (5, 8)):
        kw = dict(t_max=t_max, k_swaps=4, method="chunked", chunk=8,
                  row_block=rb)
        with tss.count_search_passes() as a:
            base = tss.refine(*args, **kw)
        with tss.count_search_passes() as b:
            comp = tss.refine(*args, compact_every=2, **kw)
        assert torch.equal(base.mask, comp.mask)
        assert torch.equal(base.swaps, comp.swaps)
        assert torch.equal(base.loss_final, comp.loss_final)
        scored.append((a.rows_scored, b.rows_scored))
    assert scored[0][1] < scored[0][0]           # the full run shrinks
    assert scored[1][1] <= scored[1][0]


def test_compaction_rejects_history_and_unknown_commit_mode():
    W, G, m = _problem(43, 4, 12, 6)
    args = (_t(W), _t(G), _t(m), tmasks.PerRow(0.5))
    with pytest.raises(ValueError, match="compact_every"):
        tss.refine(*args, t_max=5, compact_every=2, track_history=True)
    with pytest.raises(ValueError, match="commit_mode"):
        tss.refine(*args, t_max=5, k_swaps=4, commit_mode="rows")


def _moments_problem(seed, d_out, d_in, spec):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(200, d_in)) + 0.3).astype(np.float32)
    W = (rng.normal(size=(d_out, d_in)) * d_in ** -0.5).astype(np.float32)
    G = X.T @ X
    mu = X.mean(0)
    ex2 = np.diag(G) / 200
    var = np.maximum(ex2 - mu ** 2, 0).astype(np.float32)
    m0 = np.asarray(jwarmstart(jnp.asarray(W), jnp.asarray(G),
                               jmasks.parse_pattern(spec), "wanda"))
    return W, G, m0, mu, var, ex2.astype(np.float32)


@pytest.mark.parametrize("spec", ["0.6", "2:4"])
def test_dsnot_matches_reference(spec):
    W, G, m0, mu, var, ex2 = _moments_problem(3, 16, 64, spec)
    want = np.asarray(jdsnot.dsnot(*map(jnp.asarray, (W, m0, mu, var, ex2)),
                                   jmasks.parse_pattern(spec), t_max=50))
    got = tdsnot.dsnot(*map(_t, (W, m0, mu, var, ex2)),
                       tmasks.parse_pattern(spec), t_max=50).numpy()
    assert np.array_equal(got, want)
    assert (got != m0).any()                      # it did swap
    assert tmasks.validate_mask(torch.from_numpy(got),
                                tmasks.parse_pattern(spec))


@pytest.mark.parametrize("spec", ["0.6", "2:4"])
def test_sparsegpt_matches_reference(spec):
    W, G, *_ = _moments_problem(5, 16, 64, spec)
    jW1, jM = jsgpt.sparsegpt(jnp.asarray(W), jnp.asarray(G),
                              jmasks.parse_pattern(spec), blocksize=32)
    W1, M = tsgpt.sparsegpt(_t(W), _t(G), tmasks.parse_pattern(spec),
                            blocksize=32)
    assert np.array_equal(M.numpy(), np.asarray(jM))
    scale = float(np.abs(np.asarray(jW1)).max())
    np.testing.assert_allclose(W1.numpy(), np.asarray(jW1), rtol=0,
                               atol=1e-4 * scale)
    assert torch.equal(W1 * M, W1)                # pruned weights are zero


def test_sparsegpt_matches_reference_at_full_width():
    """d_in = 4096 (llama31-8b's d_model) with the default 128-column
    blocks, at PerRow(0.5): keep = 2048 is a multiple of the 32 blocks, so
    both packages keep 64 weights per block and their masks must agree.

    The Gram is 200 tokens' XᵀX plus 200·I (unit-variance independent
    noise on every feature), so the damped Hessian's condition number is
    ~380 and the two fp32 inverses agree to ~1e-5. Without the ridge it is
    ~3.6e4: the inverses then differ by 2e-3 of their largest entry, the
    last blocks' updates by up to 14% of max|W'|, and a near-tie in the
    last block flips. Weights within 1e-5 of max|W'| (measured 7e-7)."""
    W, G, *_ = _moments_problem(11, 4, 4096, "0.5")
    G = G + 200 * np.eye(4096, dtype=np.float32)
    pat = tmasks.PerRow(0.5)
    jW1, jM = jsgpt.sparsegpt(jnp.asarray(W), jnp.asarray(G),
                              jmasks.PerRow(0.5))
    W1, M = tsgpt.sparsegpt(_t(W), _t(G), pat)
    assert np.array_equal(M.numpy(), np.asarray(jM))
    assert tmasks.validate_mask(M, pat)
    scale = float(np.abs(np.asarray(jW1)).max())
    np.testing.assert_allclose(W1.numpy(), np.asarray(jW1), rtol=0,
                               atol=1e-5 * scale)


def test_sparsegpt_keeps_the_exact_per_row_count():
    """Where keep is not a multiple of the block count, the reference's
    per-block floor keeps too few weights per row (a fault of the
    reference: 60 of 64 here, 1632 of 1638 for PerRow(0.6) at d_in = 4096);
    the port spreads the exact count over the blocks."""
    W, G, *_ = _moments_problem(7, 8, 160, "0.6")
    pat = tmasks.PerRow(0.6)
    _, M = tsgpt.sparsegpt(_t(W), _t(G), pat, blocksize=32)
    assert tmasks.validate_mask(M, pat)
    assert int(M.sum(1)[0]) == pat.keep_per_row(160) == 64
    _, jM = jsgpt.sparsegpt(jnp.asarray(W), jnp.asarray(G),
                            jmasks.PerRow(0.6), blocksize=32)
    assert int(np.asarray(jM).sum(1)[0]) == 60
