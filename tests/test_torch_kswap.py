"""The port's candidate-space commit, active-row compaction and the DSnoT
and SparseGPT baselines vs the reference's, on shared numpy problems.

* ``ops.swap_topk_commit`` (its plain version on the CPU) against the
  reference's ``kops.swap_topk_commit`` in Pallas interpret mode: equal
  masks and accept counts; ``c`` and the ΔL sums within rtol 1e-5 — not
  bitwise, because XLA's CPU backend contracts multiply-adds into FMAs
  and PyTorch does not;
* the commit kernels' plain versions (the decisions with their sub-Gram
  gather, and the apply) against the reference's functions on an
  asymmetric Gram, duplicate u, the +inf tail, k = 1, 8 and 32: bitwise
  (the reference's functions run op by op, so nothing is fused);
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
import _torch_threads  # noqa: E402,F401
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
from repro_torch.kernels import swap_topk as topk_mod  # noqa: E402

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
    R, d, k = 4, 40, 3
    w, m, c = torch.zeros(R, d), torch.ones(R, d), torch.zeros(R, d)
    G = torch.eye(d)
    dl = torch.zeros(R, k)
    idx = torch.zeros(R, k, dtype=torch.int64)
    with pytest.raises(ValueError, match="k <= 32"):
        ops.swap_commit(w, m, c, G, torch.zeros(R, 33),
                        *(torch.zeros(R, 33, dtype=torch.int64),) * 2)
    with pytest.raises(ValueError, match="u must be"):
        ops.swap_commit(w, m, c, G, dl, idx[:, :2], idx)
    with pytest.raises(ValueError, match="dl"):
        ops.swap_commit(w, m, c, G, dl[:2], idx, idx)
    with pytest.raises(ValueError, match="G must be"):
        ops.swap_commit(w, m, c, G[:8, :8], dl, idx, idx)


# (id, k, asymmetric G, duplicate u, +inf tail)
COMMIT_CASES = [("k1", 1, False, False, False),
                ("k8-asym-dup-inf", 8, True, True, True),
                ("k32-asym-dup-inf", 32, True, True, True)]


def _commit_batch(seed, k, asym, dup_u, inf_tail, R=12, d=80):
    """A searched candidate batch as numpy: (W, m, c, G, dl, u, p). The
    candidates are the reference's dense top-k on a symmetric Gram; then G
    is made plainly asymmetric (the decisions and the apply read it in
    their own index orders), half the rows repeat candidate 0's u in
    candidate 1, and the last two candidates of every third row become the
    +inf tail with indices clamped to d - 1, as the search emits it."""
    W, G, m = _problem(seed, R, d, d // 2)
    jW, jG, jm = map(jnp.asarray, (W, G, m))
    c = np.asarray(jsm.correlation_vector(jW, jm, jG), dtype=np.float32)
    dl, u, p = (np.array(x) for x in jsm.topk_swaps_dense(
        jW, jm, jnp.asarray(c), jG, k=k))
    dl = dl.astype(np.float32)
    u, p = u.astype(np.int64), p.astype(np.int64)
    rng = np.random.default_rng(seed + 1)
    if asym:
        G = G + np.float32(0.05 * np.abs(G).max()) * rng.normal(
            size=G.shape).astype(np.float32)
    if dup_u:
        u[::2, 1] = u[::2, 0]
    if inf_tail:
        dl[::3, -2:] = np.inf
        u[::3, -2:] = p[::3, -2:] = d - 1
    return W, m, c, G.astype(np.float32), dl, u, p


@pytest.mark.parametrize("case", COMMIT_CASES, ids=[c[0] for c in COMMIT_CASES])
def test_commit_plain_versions_match_reference(case):
    """The port's plain decide (gather + decisions) and apply against the
    reference's gather_candidate_stats + commit_decisions + apply_commits,
    called op by op (eagerly, so XLA fuses no multiply-add): every output
    bitwise. ops.swap_commit on CPU tensors equals the plain versions
    bitwise and launches nothing."""
    _, k, asym, dup_u, inf_tail = case
    W, m, c, G, dl, u, p = _commit_batch(7 + k, k, asym, dup_u, inf_tail)
    jW, jm, jc, jG = map(jnp.asarray, (W, m, c, G))
    ju, jp = jnp.asarray(u, jnp.int32), jnp.asarray(p, jnp.int32)
    stats = jsm.gather_candidate_stats(jW, jc, jG, ju, jp)
    jacc, jdls = jsm.commit_decisions(
        *stats, ju, jp, jnp.isfinite(jnp.asarray(dl)).astype(jnp.float32),
        eps=0.0, k=k)
    want = [np.asarray(x) for x in
            jsm.apply_commits(jW, jm, jc, jG, jacc, jdls, ju, jp)]
    tW, tm, tc, tG, tdl = map(_t, (W, m, c, G, dl))
    tu, tp = torch.from_numpy(u), torch.from_numpy(p)
    acc, dls = topk_mod.swap_commit_decide_plain(tW, tc, tG, tdl, tu, tp,
                                                 eps=0.0)
    m2, c2 = topk_mod.swap_commit_apply_plain(tW, tm, tc, tG, acc, tu, tp)
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert int(acc.sum()) > 0
    assert k == 1 or int(acc.sum()) < acc.numel()     # rejects too
    assert np.array_equal(m2.numpy(), want[0])
    assert np.array_equal(dls.numpy(), np.asarray(jdls))
    assert np.array_equal(c2.numpy(), want[1])
    if dup_u:        # a u shared by two candidates is flipped at most once
        assert not (acc[::2, 0] * acc[::2, 1]).any()
    if inf_tail:
        assert not acc[::3, -2:].any()
    ops.reset_launches()
    got = ops.swap_commit(tW, tm, tc, tG, tdl, tu, tp)
    for g, t in zip(got, (m2, c2, acc, dls)):
        assert torch.equal(g, t)
    assert ops.LAUNCHES["swap_commit"] == 0


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


@pytest.mark.parametrize("compact_every,row_block", [(0, None), (0, 8),
                                                     (2, None)])
def test_candidate_kernel_path_takes_gram_facts_once(monkeypatch,
                                                     compact_every, row_block):
    """refine(method="kernel", commit_mode="candidates") takes G's facts
    for the commit's apply once per call, whatever its passes, row blocks
    and compaction segments, and on CPU tensors gives the chunked path's
    masks, swaps and losses bitwise."""
    W, G, m = _problem(47, 13, 32, 16)
    args = (_t(W), _t(G), _t(m), tmasks.PerRow(0.5))
    kw = dict(t_max=50, k_swaps=4, commit_mode="candidates",
              compact_every=compact_every, row_block=row_block)
    calls = []
    facts = ops.gram_facts
    monkeypatch.setattr(ops, "gram_facts",
                        lambda G: calls.append(1) or facts(G))
    got = tss.refine(*args, method="kernel", **kw)
    assert len(calls) == 1 and got.iters > 2
    want = tss.refine(*args, method="chunked", chunk=8, **kw)
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.swaps, want.swaps)
    assert torch.equal(got.loss_final, want.loss_final)


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
