"""The port's core math vs the reference package, on shared numpy inputs.

Masks, warmstarts, Gram statistics, the objective and every
``swap_math`` function go through both packages. Tolerances:

* masks, swap indices and accept counts: exactly equal;
* sums, matmuls and Grams: rtol 1e-5 — fp32 reductions in another order
  (XLA vs PyTorch CPU kernels);
* elementwise ΔL values: rtol 1e-5 of the row scale — XLA's CPU backend
  contracts ``a * b + c`` into fused multiply-adds, PyTorch does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from test_swap_optimal import _problem  # noqa: E402
from repro.core import gram as jgram  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro.core import swap_math as jsm  # noqa: E402
from repro.core import warmstart as jws  # noqa: E402

from repro_torch.core import gram as tgram  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core import swap_math as tsm  # noqa: E402
from repro_torch.core import warmstart as tws  # noqa: E402

RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _both(*arrays):
    """The same numpy inputs as (jax arrays, torch tensors)."""
    j = tuple(jnp.asarray(a) for a in arrays)
    t = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    return j, t


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(_np(got)), fin)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(_np(got)[fin], want[fin], rtol=rtol,
                               atol=rtol * max(scale, 1.0))


def _equal(got, want):
    assert np.array_equal(_np(got), np.asarray(want))


def _state(seed=0, R=8, d=24, keep=12, corr=0.5):
    """(w, m, c, G) numpy problem with the reference's correlation c."""
    W, G, m = _problem(seed, R, d, keep, corr=corr)
    c = np.asarray(jsm.correlation_vector(*(jnp.asarray(x) for x in (W, m, G))))
    return W, m, c, G


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", [jmasks.PerRow(0.6), jmasks.PerRow(0.5),
                                     jmasks.NM(2, 4), jmasks.NM(1, 8)])
def test_make_mask_matches(pattern):
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 5, size=(6, 32)).astype(np.float32)   # ties
    tpat = tmasks.parse_pattern(jmasks.format_pattern(pattern))
    want = jmasks.make_mask(jnp.asarray(scores), pattern)
    got = tmasks.make_mask(torch.from_numpy(scores), tpat)
    _equal(got, want)
    assert tmasks.validate_mask(got, tpat)
    assert tmasks.sparsity_of(got) == pytest.approx(jmasks.sparsity_of(want))


@settings(deadline=None, max_examples=25)
@given(st.integers(1, 31), st.integers(0, 2**31 - 1))
def test_topk_mask_per_row_matches(keep, seed):
    scores = np.random.default_rng(seed).integers(0, 4, size=(3, 32)).astype(
        np.float32)
    want = jmasks.topk_mask_per_row(jnp.asarray(scores), keep)
    got = tmasks.topk_mask_per_row(torch.from_numpy(scores), keep)
    _equal(got, want)


@pytest.mark.parametrize("spec", ["0.6", 0.5, "2:4", " 1:8 "])
def test_parse_pattern_matches(spec):
    assert tmasks.format_pattern(tmasks.parse_pattern(spec)) == \
        jmasks.format_pattern(jmasks.parse_pattern(spec))


@pytest.mark.parametrize("bad", ["3:2", "x", "1.5", "a:b"])
def test_parse_pattern_rejects(bad):
    with pytest.raises(ValueError):
        tmasks.parse_pattern(bad)


def test_validate_mask_rejects():
    m = torch.zeros(2, 8)
    m[:, :4] = 1.0
    assert tmasks.validate_mask(m, tmasks.PerRow(0.5))
    assert not tmasks.validate_mask(m, tmasks.NM(2, 4))   # blocks 4:0
    m[0, 0] = 0.0
    assert not tmasks.validate_mask(m, tmasks.PerRow(0.5))


# ---------------------------------------------------------------------------
# warmstarts, Gram statistics, objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("criterion", ["magnitude", "wanda", "ria"])
@pytest.mark.parametrize("spec", ["0.6", "2:4"])
def test_warmstart_masks_match(criterion, spec):
    W, _, _, G = _state(seed=3, R=10, d=32)
    (jW, jG), (tW, tG) = _both(W, G)
    want = jws.warmstart_mask(jW, jG, jmasks.parse_pattern(spec), criterion)
    got = tws.warmstart_mask(tW, tG, tmasks.parse_pattern(spec), criterion)
    _equal(got, want)


def test_gram_state_update_matches():
    rng = np.random.default_rng(4)
    chunks = [rng.normal(size=(2, 7, 12)).astype(np.float32) for _ in range(3)]
    js, ts = jgram.GramState.create(12), tgram.GramState.create(12)
    for x in chunks:
        js = js.update(jnp.asarray(x))
        ts = ts.update(torch.from_numpy(x))
    for f in ("G", "count", "mean", "m2", "variance"):
        _close(getattr(ts, f), getattr(js, f))
    _close(tgram.feature_norms(ts.G), jgram.feature_norms(js.G))
    _close(tgram.update_from_acts(torch.zeros(12, 12), torch.from_numpy(chunks[0])),
           jgram.update_from_acts(jnp.zeros((12, 12)), jnp.asarray(chunks[0])))


def test_state_from_moments_round_trip():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40, 6)).astype(np.float32)           # (L, T, d)
    g = np.einsum("lti,ltj->lij", x, x)
    s, n = x.sum(1), np.full(3, 40.0, np.float32)
    js = jgram.state_from_moments(g, s, n)
    ts = tgram.state_from_moments(torch.from_numpy(g), torch.from_numpy(s),
                                  torch.from_numpy(n))
    for f in ("count", "mean", "m2"):
        _close(getattr(ts, f), getattr(js, f))
    for a, b in zip(tgram.moments_from_state(ts), (g, s, n)):
        _close(a, b)


def test_objective_matches():
    W, m, _, G = _state(seed=6)
    X = np.random.default_rng(6).normal(size=(24, 50)).astype(np.float32)
    (jW, jm, jG, jX), (tW, tm, tG, tX) = _both(W, m, G, X)
    _close(tobj.layer_loss(tW, tm, tG), jobj.layer_loss(jW, jm, jG))
    _close(tobj.layer_loss_direct(tW, tm, tX), jobj.layer_loss_direct(jW, jm, jX))
    l0, l1 = np.array([4.0, 2.0, 1e-40], np.float32), np.array([1.0, 2.0, 0.0],
                                                               np.float32)
    _close(tobj.relative_error_reduction(torch.from_numpy(l0), torch.from_numpy(l1)),
           jobj.relative_error_reduction(jnp.asarray(l0), jnp.asarray(l1)))


# ---------------------------------------------------------------------------
# swap_math
# ---------------------------------------------------------------------------


def test_scores_and_losses_match():
    W, m, c, G = _state(seed=7)
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    _close(tsm.correlation_vector(tW, tm, tG), jsm.correlation_vector(jW, jm, jG))
    _close(tsm.row_loss(tW, tm, tG), jsm.row_loss(jW, jm, jG))
    for got, want in zip(tsm.swap_scores(tW, tm, tc, torch.diagonal(tG)),
                         jsm.swap_scores(jW, jm, jc, jnp.diagonal(jG))):
        _close(got, want)
    _close(tsm.delta_matrix(tW, tm, tc, tG), jsm.delta_matrix(jW, jm, jc, jG))


@pytest.mark.parametrize("chunk", [5, 24])
def test_best_swap_matches(chunk):
    W, m, c, G = _state(seed=8)
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    want = jsm.best_swap_dense(jW, jm, jc, jG)
    for got in (tsm.best_swap_dense(tW, tm, tc, tG),
                tsm.best_swap_chunked(tW, tm, tc, tG, chunk=chunk)):
        _close(got[0], want[0])
        _equal(got[1], want[1])
        _equal(got[2], want[2])


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_swaps_match(k):
    W, m, c, G = _state(seed=9)
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    want = jsm.topk_swaps_dense(jW, jm, jc, jG, k=k)
    fin = np.isfinite(np.asarray(want[0]))
    for got in (tsm.topk_swaps_dense(tW, tm, tc, tG, k=k),
                tsm.topk_swaps_chunked(tW, tm, tc, tG, k=k, chunk=7)):
        _close(got[0], want[0])
        _equal(_np(got[1])[fin], np.asarray(want[1])[fin])
        _equal(_np(got[2])[fin], np.asarray(want[2])[fin])


@pytest.mark.parametrize("block,n", [(4, 2), (8, 3)])
def test_nm_searches_match(block, n):
    W, _, _, G = _state(seed=10, d=32)
    scores = np.random.default_rng(10).normal(size=W.shape).astype(np.float32)
    m = np.asarray(jmasks.make_mask(jnp.asarray(scores), jmasks.NM(n, block)))
    c = np.asarray(jsm.correlation_vector(*(jnp.asarray(x) for x in (W, m, G))))
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    want = jsm.best_swap_nm(jW, jm, jc, jG, block=block)
    got = tsm.best_swap_nm(tW, tm, tc, tG, block=block)
    _close(got[0], want[0])
    _equal(got[1], want[1])
    _equal(got[2], want[2])
    want = jsm.topk_swaps_nm(jW, jm, jc, jG, block=block, k=5)
    got = tsm.topk_swaps_nm(tW, tm, tc, tG, block=block, k=5)
    fin = np.isfinite(np.asarray(want[0]))
    _close(got[0], want[0])
    _equal(_np(got[1])[fin], np.asarray(want[1])[fin])
    _equal(_np(got[2])[fin], np.asarray(want[2])[fin])


def test_commit_swaps_columns_matches():
    W, m, c, G = _state(seed=11, R=10)
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    dl, _, p = jsm.topk_swaps_chunked(jW, jm, jc, jG, k=5, chunk=8)
    want = jsm.commit_swaps_columns(jW, jm, jc, jG, dl, p)
    got = tsm.commit_swaps_columns(tW, tm, tc, tG, torch.from_numpy(np.array(dl)),
                                   torch.from_numpy(np.array(p)).long())
    _equal(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2], want[2])
    _equal(got[3], want[3])
    assert int(got[3].sum()) > 0
    _equal(tm, m)                                  # inputs untouched


def test_candidate_commit_matches():
    W, m, c, G = _state(seed=12, R=10)
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    dl, u, p = jsm.topk_swaps_chunked(jW, jm, jc, jG, k=5, chunk=8)
    tdl, tu, tp = (torch.from_numpy(np.array(x)) for x in (dl, u, p))
    tu, tp = tu.long(), tp.long()
    jstats = jsm.gather_candidate_stats(jW, jc, jG, u, p)
    tstats = tsm.gather_candidate_stats(tW, tc, tG, tu, tp)
    for a, b in zip(tstats, jstats):
        _equal(a, b)                               # pure gathers: bitwise
    valid = np.isfinite(np.asarray(dl)).astype(np.float32)
    jacc, jdls = jsm.commit_decisions(*jstats, u, p, jnp.asarray(valid),
                                      eps=0.0, k=5)
    tacc, tdls = tsm.commit_decisions(*tstats, tu, tp, torch.from_numpy(valid),
                                      eps=0.0, k=5)
    _equal(tacc, jacc)
    _close(tdls, jdls)
    want = jsm.apply_commits(jW, jm, jc, jG, jacc, jdls, u, p)
    got = tsm.apply_commits(tW, tm, tc, tG, tacc, tdls, tu, tp)
    _equal(got[0], want[0])
    _close(got[1], want[1])
    want = jsm.commit_swaps(jW, jm, jc, jG, dl, u, p)
    got = tsm.commit_swaps(tW, tm, tc, tG, tdl, tu, tp)
    _equal(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2], want[2])
    _equal(got[3], want[3])


def test_apply_swap_matches():
    W, m, c, G = _state(seed=13)
    (jW, jm, jc, jG), (tW, tm, tc, tG) = _both(W, m, c, G)
    dl, u, p = jsm.best_swap_dense(jW, jm, jc, jG)
    want = jsm.apply_swap(jW, jm, jc, jG, dl, u, p)
    got = tsm.apply_swap(tW, tm, tc, tG, *(torch.from_numpy(np.array(x))
                                           for x in (dl, u, p)))
    _equal(got[0], want[0])
    _close(got[1], want[1])
    _equal(got[2], want[2])
