"""Kernel plain versions of the port vs the reference's Pallas kernels.

The reference kernels run in Pallas interpret mode on the CPU, as
``tests/test_kernels.py`` and ``tests/test_kswap.py`` run them; the port's
wrappers take their plain PyTorch versions for CPU tensors. Inputs come
from numpy seeds and go through both packages.

Tolerances: swap indices must be exactly equal on feasible entries and
the +inf tail must be +inf with in-range indices. Swap values agree to
fp32 rounding, not bit for bit: XLA's CPU backend contracts
``a * b + c`` into fused multiply-adds, PyTorch's CPU kernels do not
(rtol 1e-5 on |ΔL| scale). Grams sum in another order (rtol 1e-5; bf16
inputs are exact in fp32, so the same bound holds).

The ``gpu``-marked tests hold each CUDA kernel against its plain version
on the card: bitwise for the swap searches (no FMA on either side), a
relative tolerance for the Gram (fp32 sums in another order), and for
spmm 1e-5 of max|y| in fp32 and one bf16 ulp (or 1e-5 of max|y|) in
bf16 — the kernel and the plain matmul sum in other orders — with the
nm24 and gathered packings of one 2:4 mask bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402

from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import swap_math as sm  # noqa: E402
from repro_torch.core.warmstart import warmstart_mask  # noqa: E402
from repro_torch.kernels import gram as gram_mod  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import spmm as spmm_mod  # noqa: E402
from repro_torch.kernels import swap_argmin as argmin_mod  # noqa: E402
from repro_torch.kernels import swap_topk as topk_mod  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.pruning import stats as stats_mod  # noqa: E402

try:  # the reference package, on JAX's CPU backend
    import jax.numpy as jnp

    from conftest import make_problem
    from repro.core import masks as jmasks
    from repro.core import swap_math as jsm
    from repro.core.warmstart import warmstart_mask as jwarmstart
    from repro.kernels import ops as jops
except ImportError:  # a card machine without JAX runs the gpu test only
    jnp = None

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package is not installed")


@pytest.fixture(autouse=True, scope="module")
def _default_threads():
    """torch's own intra-op thread count in this module: its swap cases
    build exact ties in products of MKL's, whose blocking (so which
    columns tie bit for bit) follows the thread count, and they were
    built at the default (``_torch_threads`` sets 1 for the suite)."""
    torch.set_num_threads(_torch_threads.DEFAULT)
    yield
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _swap_problem(seed, d_out, d_in, sparsity=0.6):
    """(w, m, c, G) as numpy, from the reference's make_problem + Wanda."""
    rng = np.random.default_rng(seed)
    W, _, G = make_problem(rng, d_out=d_out, d_in=d_in)
    m = jwarmstart(W, G, jmasks.PerRow(sparsity), "wanda")
    c = jsm.correlation_vector(W, m, G)
    return tuple(np.array(x, dtype=np.float32) for x in (W, m, c, G))


def _scale(v):
    fin = np.isfinite(v)
    return max(1.0, float(np.max(np.abs(v[fin])))) if fin.any() else 1.0


@pytest.fixture(autouse=True)
def _fresh_counters():
    ops.reset_launches()
    yield


# ---------------------------------------------------------------------------
# gram_xtx
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("T,d", [(64, 32), (130, 48), (100, 128)])
def test_gram_plain_matches_reference_kernel(T, d):
    x = np.random.default_rng(T + d).normal(size=(T, d)).astype(np.float32)
    want = np.asarray(jops.gram_xtx(jnp.asarray(x), interpret=True))
    got = ops.gram_xtx(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert ops.LAUNCHES["gram_xtx"] == 0          # CPU took the plain version


@needs_reference
def test_gram_bf16_and_batched_layout():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 17, 40)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jops.gram_xtx(xb, interpret=True))
    xt = _t(x).to(torch.bfloat16)
    got = ops.gram_xtx(xt).numpy()
    assert got.dtype == np.float32                 # fp32 accumulation contract
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, ref.gram_xtx_ref(xt).numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@needs_reference
def test_gram_update_streaming():
    """The reference's streaming ``gram_update`` equals the port's way of
    streaming: one ``gram_xtx`` per batch, added in place (calibration)."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(64, 32)).astype(np.float32) for _ in range(3)]
    Gj = jnp.zeros((32, 32), jnp.float32)
    Gt = torch.zeros(32, 32)
    for x in xs:
        Gj = jops.gram_update(Gj, jnp.asarray(x), interpret=True)
        Gt += ops.gram_xtx(_t(x))
    want = np.asarray(Gj)
    np.testing.assert_allclose(Gt.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(Gt.numpy(), ref.gram_accum_ref(
        torch.zeros(32, 32), _t(np.concatenate(xs))).numpy(),
        rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("policy", ["default", "calibration"])
def test_bf16_taps_equal_fp32_upcast_route(policy):
    """bf16 activations reach the tap policy's Gram in their own dtype; on
    the CPU the taps equal, bit for bit, those of upcasting first (the
    route before: ``x.float()`` then XᵀX), accumulated over two calls."""
    pol = (common.DEFAULT_TAP_POLICY if policy == "default"
           else stats_mod.CalibSpec(levels=(("t", "gram"),)).policy())
    rng = np.random.default_rng(5)
    xs = [_t(rng.normal(size=(2, 9, 40))).to(torch.bfloat16) for _ in range(2)]
    taps = common.Taps(pol)
    for x in xs:
        common.emit_tap(taps, "t", x)
    ent = taps.entries["t"]
    x32 = [x.reshape(-1, 40).float() for x in xs]
    assert ent["g"].dtype == torch.float32
    assert torch.equal(ent["g"], x32[0].T @ x32[0] + x32[1].T @ x32[1])
    assert torch.equal(ent["s"], x32[0].sum(0) + x32[1].sum(0))
    assert float(ent["n"]) == 36.0
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_tap_policy_gram_upcasts_bf16():
    x = _t(np.random.default_rng(6).normal(size=(33, 24))).to(torch.bfloat16)
    got = common.DEFAULT_TAP_POLICY.gram(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, gram_mod.gram_xtx_plain(x))


# ---------------------------------------------------------------------------
# swap_argmin
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("d_out,d_in", [(7, 130), (16, 96)])
def test_swap_argmin_plain_matches_reference_kernel(d_out, d_in):
    w, m, c, G = _swap_problem(d_out + d_in, d_out, d_in)
    jv, ju, jp = (np.asarray(x) for x in jops.swap_argmin(
        *(jnp.asarray(x) for x in (w, m, c, G)), interpret=True))
    tv, tu, tp = (x.numpy() for x in ops.swap_argmin(*map(_t, (w, m, c, G))))
    assert np.array_equal(tu, ju) and np.array_equal(tp, jp)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5 * _scale(jv))
    # the dense oracle agrees with the chunked plain version
    rv, ru, rp = (x.numpy() for x in ref.swap_argmin_ref(*map(_t, (w, m, c, G))))
    assert np.array_equal(ru, tu) and np.array_equal(rp, tp)
    assert ops.LAUNCHES["swap_argmin"] == 0


@needs_reference
@pytest.mark.parametrize("chunk", [5, 16, 512])
def test_swap_argmin_tiebreak_smallest_flat_index(chunk):
    """Equal ΔL pairs resolve to the smallest u·d + p, across chunks too."""
    d = 24
    w = np.ones((2, d), np.float32)
    G = np.eye(d, dtype=np.float32)                # orthogonal features: ties
    m = np.zeros((2, d), np.float32)
    m[:, d // 2:] = 1.0                            # kept u above the pruned p
    c = np.asarray(jsm.correlation_vector(*(jnp.asarray(x) for x in (w, m, G))))
    _, ju, jp = jops.swap_argmin(*(jnp.asarray(x) for x in (w, m, c, G)),
                                 interpret=True)
    _, tu, tp = argmin_mod.swap_argmin_plain(*map(_t, (w, m, c, G)), chunk=chunk)
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(tp.numpy(), np.asarray(jp))


@needs_reference
def test_swap_argmin_infeasible_row():
    """A row with no feasible pair returns (+inf, 0, 0) like the oracle."""
    w, m, c, G = _swap_problem(3, 3, 32)
    m[1] = 1.0                                     # keep-all: nothing pruned
    tv, tu, tp = ops.swap_argmin(*map(_t, (w, m, c, G)))
    assert np.isinf(tv[1].item()) and tu[1].item() == 0 and tp[1].item() == 0


@needs_reference
def test_swap_argmin_nan_delta_reads_as_inf():
    """A NaN ΔL (one Gram entry made NaN, so one pair of every row) reads
    as +inf in the port's plain searches, the CUDA kernels' rule: each row
    gets the best of its finite pairs, as the dense ΔL with NaN as +inf
    gives it. The reference's Pallas kernel lets the NaN take its 256 x
    256 tile's minimum and then drops the tile, so its pick is the best
    pair outside that tile: row 0's best pair shares the NaN's tile, and
    the reference misses it (a fault of the reference, ROADMAP C)."""
    R, d, tile = 16, 512, 256
    w, m, c, G = _swap_problem(5, R, d)
    dl = sm.delta_matrix(*map(_t, (w, m, c, G))).reshape(R, d * d)
    u0, p0 = divmod(int(dl[0].argmin()), d)
    u1 = u0 + 1 if u0 % tile < tile - 1 else u0 - 1      # same tile, off
    p1 = p0 if p0 != u1 else p0 ^ 1                      # the diagonal
    assert (u1 // tile, p1 // tile) == (u0 // tile, p0 // tile)
    G[u1, p1] = np.nan                                   # c, diag(G) clean
    want = torch.where(torch.isnan(dl), torch.inf, dl)
    want[:, u1 * d + p1] = torch.inf
    idx = want.argmin(1)
    got = argmin_mod.swap_argmin_plain(*map(_t, (w, m, c, G)))
    assert torch.equal(got[0], want.gather(1, idx[:, None])[:, 0])
    assert torch.equal(got[1], idx // d) and torch.equal(got[2], idx % d)
    assert (int(got[1][0]), int(got[2][0])) == (u0, p0)
    for k in (1, 8):                       # the top-k search: NaN slots too
        tv, tu, tp = topk_mod.swap_topk_plain(*map(_t, (w, m, c, G)), k=k)
        assert bool(torch.isfinite(tv).all())
        assert torch.equal(tv[:, 0], got[0]) and torch.equal(tp[:, 0], got[2])
    rv, ru, rp = ref.swap_argmin_ref(*map(_t, (w, m, c, G)))
    assert torch.equal(ru, got[1]) and torch.equal(rp, got[2])
    # the reference: best pair outside the NaN's tile, in every row
    drop = want.reshape(R, d // tile, tile, d // tile, tile).clone()
    drop[:, u1 // tile, :, p1 // tile, :] = torch.inf
    jidx = drop.reshape(R, d * d).argmin(1)
    jv, ju, jp = (np.asarray(x) for x in jops.swap_argmin(
        *(jnp.asarray(x) for x in (w, m, c, G)), interpret=True))
    assert np.array_equal(ju, (jidx // d).numpy())
    assert np.array_equal(jp, (jidx % d).numpy())
    assert (ju[0], jp[0]) != (u0, p0)


# ---------------------------------------------------------------------------
# swap_topk
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("k,d_out,d_in", [(1, 8, 24), (3, 5, 130), (8, 8, 24)])
def test_swap_topk_plain_matches_reference_kernel(k, d_out, d_in):
    w, m, c, G = _swap_problem(7 * k + d_in, d_out, d_in)
    jv, ju, jp = (np.asarray(x) for x in jops.swap_topk(
        *(jnp.asarray(x) for x in (w, m, c, G)), k=k, interpret=True))
    tv, tu, tp = (x.numpy() for x in ops.swap_topk(*map(_t, (w, m, c, G)), k=k))
    fin = np.isfinite(jv)
    assert np.array_equal(np.isfinite(tv), fin)
    assert np.array_equal(tu[fin], ju[fin]) and np.array_equal(tp[fin], jp[fin])
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5, atol=1e-5 * _scale(jv))
    assert np.all(tu < d_in) and np.all(tp < d_in)  # tail clamped into range
    assert ops.LAUNCHES["swap_topk"] == 0


@needs_reference
def test_swap_topk_short_rows_pad_with_inf():
    """Rows with fewer than k feasible pairs end in +inf entries."""
    w, m, c, G = _swap_problem(4, 4, 16, sparsity=0.875)   # 2 kept, 14 pruned
    m[2] = 1.0                                             # no pruned column
    tv, tu, tp = (x.numpy() for x in ops.swap_topk(*map(_t, (w, m, c, G)), k=8))
    assert np.all(np.isinf(tv[2]))
    assert np.all(np.isfinite(tv[0]))
    assert np.all((tu >= 0) & (tu < 16) & (tp >= 0) & (tp < 16))


@needs_reference
@pytest.mark.parametrize("chunk", [5, 8, 24])
def test_swap_topk_chunk_invariance(chunk):
    w, m, c, G = _swap_problem(9, 6, 24)
    args = tuple(map(_t, (w, m, c, G)))
    base = sm.topk_swaps_dense(*args, k=6)
    got = topk_mod.swap_topk_plain(*args, k=6, chunk=chunk)
    for b, g in zip(base, got):
        assert torch.equal(b, g)


def test_swap_topk_merge_of_disjoint_p_ranges():
    """The premise of the kernel's p-split: top-k lists of disjoint
    p-ranges, merged in any order by (ΔL, p), equal the top-k over every
    column, +inf tail included (rows with fewer than k pruned columns)."""
    w, m, c, G = _port_problem(5, 6, 40, "cpu")
    m[0] = 1.0
    m[0, 3:6] = 0.0                                  # 3 pruned columns
    m[1] = 1.0                                       # none pruned
    c = sm.correlation_vector(w, m, G)
    k = 8
    want = sm.topk_swaps_dense(w, m, c, G, k=k)
    dl = sm.delta_matrix(w, m, c, G)
    vals_p, u_p = dl.min(dim=1).values, torch.argmin(dl, dim=1)
    R = w.shape[0]
    v = torch.full((R, k), sm.INVALID)
    p = torch.full((R, k), sm.BIG_INDEX, dtype=torch.int64)
    u = torch.zeros((R, k), dtype=torch.int64)
    edges = [0, 3, 13, 29, 40]                       # one range narrower than k
    for lo, hi in reversed(list(zip(edges[:-1], edges[1:]))):
        idx = sm._k_smallest(vals_p[:, lo:hi], min(k, hi - lo))
        v, p, u = sm._merge_topk(v, p, u, vals_p[:, lo:hi].gather(1, idx),
                                 idx + lo, u_p[:, lo:hi].gather(1, idx), k)
    assert torch.isinf(want[0][0, 3:]).all() and torch.isinf(want[0][1]).all()
    for got, ref_ in zip((v, u, p), want):
        assert torch.equal(got, ref_)


def _argmin_consts():
    """(list length, p-tile width) of swap_argmin's partial search, read
    from csrc/swap_topk.cu so the model below follows the kernel."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "swap_topk.cu").read_text()
    k = re.search(r"constexpr int ARGMIN_K = (\d+);", src)
    tp = re.search(r"constexpr int TP = (\d+);", src)
    return int(k.group(1)), int(tp.group(1))


# (id, R, d, k, kind): swap_argmin's own edges beside TOPK_CASES. Rows of
# zero weights (every feasible ΔL is ±0), 8 identical columns of one late
# p-tile that win every row (more tied columns than a tile's list holds;
# odd rows keep no u below 300), rows with no feasible pair, and d below
# the list length. k is unused.
ARGMIN_CASES = [
    ("all-tied-8x600", 8, 600, None, "all_tied"),
    ("many-tied-late-8x600", 8, 600, None, "many_tied"),
    ("infeasible-8x600", 8, 600, None, "infeasible"),
    ("small-d-6x3", 6, 3, None, "small_d"),
]


def _argmin_problem(R, d, kind, device):
    """(w, m, c, G) for one ARGMIN_CASES entry, from numpy seeds."""
    rng = np.random.default_rng(R * 7919 + d + 1)
    X = rng.normal(size=(d, 96)).astype(np.float32)
    group = np.arange(520, 528) if kind == "many_tied" else []
    if kind == "many_tied":
        X[group] = X[group[0]]                 # identical features
    G = X @ X.T + np.float32(0.1) * np.eye(d, dtype=np.float32)
    w = rng.normal(size=(R, d)).astype(np.float32)
    m = (rng.random((R, d)) < 0.5).astype(np.float32)
    if kind == "all_tied":
        w[0] = 0.0
        w[5] = np.where(rng.random(d) < 0.5, 0.0, -0.0)
    if kind == "many_tied":
        w[:, group] = np.float32(4.0) * np.sign(w[:, group[:1]])
        m[:, group] = 0.0
        m[1::2, :300] = 0.0
    if kind == "infeasible":
        m[1] = 1.0                             # nothing pruned
        m[4] = 0.0                             # nothing kept
    wt, Gt = torch.from_numpy(w).to(device), torch.from_numpy(G).to(device)
    mt = torch.from_numpy(m).to(device)
    return wt, mt, sm.correlation_vector(wt, mt, Gt), Gt


def _argmin_select_model(w, m, c, G, *, k, tile):
    """swap_argmin's selection in plain torch, on the dense ΔL with NaN as
    +inf (a NaN never wins): per p-tile the k smallest (column minimum, p);
    v* the smallest of them; then each tied column's lowest u and the
    smallest (u, p) of those, or, where a tile's list ends in v* (it may
    hold fewer tied columns than the tile has), the scan of every column
    at each kept u upwards. Returns (best, u, p, paths), paths[r] one of
    "none" (no feasible pair: (+inf, 0, 0)), ("ties", |S|) or "scan"."""
    R, d = w.shape
    dl = sm.delta_matrix(w, m, c, G)
    dl = torch.where(torch.isnan(dl), torch.inf, dl)
    colmin = dl.min(dim=1).values
    best = torch.full((R,), torch.inf)
    us = torch.zeros(R, dtype=torch.int64)
    ps = torch.zeros(R, dtype=torch.int64)
    paths = []
    for r in range(R):
        lists = []
        for lo in range(0, d, tile):
            v = colmin[r, lo:lo + tile]
            idx = sm._k_smallest(v[None], min(k, v.numel()))[0]
            lists.append((v[idx], idx + lo))
        vs = min(float(v.min()) for v, _ in lists)
        if not vs < float("inf"):
            paths.append("none")
            continue
        if any(len(v) == k and float(v[-1]) == vs for v, _ in lists):
            u = next(u for u in (m[r] > 0.5).nonzero().flatten().tolist()
                     if bool((dl[r, u] == vs).any()))
            p = int((dl[r, u] == vs).nonzero()[0, 0])
            paths.append("scan")
        else:
            tied = torch.cat([p[v == vs] for v, p in lists]).tolist()
            u, p = min((int((dl[r, :, q] == vs).nonzero()[0, 0]), q)
                       for q in tied)
            paths.append(("ties", len(tied)))
        best[r], us[r], ps[r] = dl[r, u, p], u, p
    return best, us, ps, paths


@needs_reference
@pytest.mark.parametrize("kind", ["ties", "all_tied", "many_tied",
                                  "infeasible"])
def test_swap_argmin_selection_from_topk_lists(kind):
    """The premise of swap_argmin's selection kernel: from top-k lists of
    256-column p-tiles, the smallest value, the tied columns' lowest u (or
    the scan where a list may hold too few tied columns) give the
    smallest-(u, p) argmin, equal to the plain version (value bits too)
    and to the reference kernel (indices; values to fp32 rounding)."""
    if kind == "ties":
        w, m, c, G = _topk_problem(16, 384, "ties", "cpu")
    else:
        w, m, c, G = _argmin_problem(8, 600, kind, "cpu")
    k, tile = _argmin_consts()
    best, u, p, paths = _argmin_select_model(w, m, c, G, k=k, tile=tile)
    want = argmin_mod.swap_argmin_plain(w, m, c, G)
    assert torch.equal(best.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(u, want[1]) and torch.equal(p, want[2])
    jv, ju, jp = (np.asarray(x) for x in jops.swap_argmin(
        *(jnp.asarray(x.numpy()) for x in (w, m, c, G)), interpret=True))
    assert np.array_equal(u.numpy(), ju) and np.array_equal(p.numpy(), jp)
    np.testing.assert_allclose(best.numpy(), jv, rtol=1e-5,
                               atol=1e-5 * _scale(jv))
    # each problem takes the path it is built for
    ties = [x[1] for x in paths if isinstance(x, tuple)]
    if kind == "ties":
        assert paths[0] == "scan" and max(ties) >= 2
    if kind == "all_tied":
        assert paths[0] == paths[5] == "scan" and best[0] == 0 == best[5]
    if kind == "many_tied":
        assert paths == ["scan"] * 8 and bool((p >= 512).all())
        assert bool((u[1::2] >= 300).all())
    if kind == "infeasible":
        assert paths[1] == paths[4] == "none"
        assert [best[1].item(), u[1].item(), p[1].item()] == [np.inf, 0, 0]
    assert ops.LAUNCHES["swap_argmin"] == 0


def test_profile_swap_variants_edit_the_kernel_source():
    """Every edit of ``profile_swap.VARIANTS`` finds its text in
    csrc/swap_topk.cu, so the variants build from the shipped source."""
    from repro_torch.kernels import build
    from repro_torch.launch import profile_swap

    src = (build.CSRC / "swap_topk.cu").read_text()
    for name, edits in profile_swap.VARIANTS.items():
        for old, new in edits:
            assert old in src and old != new, name


@pytest.mark.parametrize("cuts", ["CUTS", "GATHER_CUTS", "PHASES"])
def test_profile_spmm_cuts_edit_the_kernel_source(cuts):
    """Every edit of ``profile_spmm``'s cut-down copies (nm24's and the
    gathered kernel's) and of its counted copy finds its text in
    csrc/spmm.cu exactly once, so the copies build from the shipped source
    and cut or count what they say."""
    from repro_torch.kernels import build
    from repro_torch.launch import profile_spmm

    src = (build.CSRC / "spmm.cu").read_text()
    for name, edits in getattr(profile_spmm, cuts).items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, (name, old)


@needs_reference
def test_kernel_wrappers_reject_bad_input():
    w, m, c, G = map(_t, _swap_problem(1, 4, 64))
    with pytest.raises(ValueError):
        ops.swap_topk(w, m, c, G, k=33)
    with pytest.raises(ValueError):
        ops.swap_argmin(w, m, c, G[:8, :8])
    with pytest.raises(ValueError):
        ops.gram_xtx(torch.zeros(4, 4, dtype=torch.float64))


def test_gram_facts():
    """G's facts for the commit's apply kernel: bitwise symmetry (one last
    bit off makes G asymmetric) and max|G|, NaN and inf carried through."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(12, 30)).astype(np.float32)
    G = X @ X.T
    G = np.triu(G) + np.triu(G, 1).T
    G[2, 5] = G[5, 2] = -500.0
    facts = ops.gram_facts(_t(G))
    assert facts == ops.GramFacts(True, 500.0)
    G[3, 4] = np.nextafter(G[3, 4], np.float32(np.inf))
    assert not ops.gram_facts(_t(G)).symmetric
    G[1, 1] = np.inf
    assert ops.gram_facts(_t(G)).amax == float("inf")
    G[0, 7] = np.nan
    assert np.isnan(ops.gram_facts(_t(G)).amax)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _port_problem(seed, d_out, d_in, device):
    """(w, m, c, G) built by the port alone: correlated features, Wanda 0.6."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(d_in, 200)).astype(np.float32)
    M = np.eye(d_in) + 0.3 * rng.normal(size=(d_in, d_in))
    X = (M @ X).astype(np.float32)
    w = _t(rng.normal(size=(d_out, d_in))).to(device)
    G = _t(X @ X.T).to(device)
    m = warmstart_mask(w, G, tmasks.PerRow(0.6), "wanda")
    return w, m, sm.correlation_vector(w, m, G), G


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d_out,d_in", [(33, 300), (64, 1024)])
def test_cuda_kernels_match_plain(cuda, d_out, d_in):
    w, m, c, G = _port_problem(d_in, d_out, d_in, cuda)
    ops.reset_launches()
    for k in (1, 8):
        got = ops.swap_topk(w, m, c, G, k=k)
        want = topk_mod.swap_topk_plain(w, m, c, G, k=k)
        fin = torch.isfinite(want[0])
        assert torch.equal(torch.isfinite(got[0]), fin)
        for g, t in zip(got, want):
            assert torch.equal(g[fin], t[fin])               # bitwise
    got = ops.swap_argmin(w, m, c, G)
    want = argmin_mod.swap_argmin_plain(w, m, c, G)
    for g, t in zip(got, want):
        assert torch.equal(g, t)
    x = torch.randn(130, d_in, device=cuda)
    for xx in (x, x.to(torch.bfloat16)):
        Gk = ops.gram_xtx(xx)
        Gp = gram_mod.gram_xtx_plain(xx)
        assert torch.equal(Gk, Gk.T)                          # exact mirror
        torch.testing.assert_close(Gk, Gp, rtol=1e-5, atol=1e-4)
    assert ops.LAUNCHES == {"gram_xtx": 1, "gram_xtx_bf16": 1,
                            "gram_xtx_stacked": 0,
                            "gram_xtx_stacked_bf16": 0, "swap_topk": 2,
                            "swap_argmin": 1, "swap_commit": 0, "spmm": 0,
                            "spmm_stacked": 0}


# (id, R, d, k, mask): ragged R and d, a small R that only the p-split
# fills the card with, k at both ends, R = 128 rows (MQA's wk / wv) with a
# 128-column last p-tile (d % 256 == 128, as chatglm3's d_ff = 13696), PerRow at 0.1 / 0.5 / 0.9, a
# Bernoulli mask (unequal per-row counts; d = 301 takes the padded-G path,
# and G differs from Gᵀ in one entry's last bit),
# rows with fewer than k pruned columns, exact ties across u and p, and a
# Gram entry or a weight too large for the doubled Gram (the exact path)
TOPK_CASES = [
    ("ragged-33x300-k8", 33, 300, 8, "perrow0.6"),
    ("ragged-37x1000-k32", 37, 1000, 32, "perrow0.6"),
    ("split-8x4096-k8", 8, 4096, 8, "perrow0.6"),
    ("k1-64x512", 64, 512, 1, "perrow0.6"),
    ("perrow0.1-64x512-k8", 64, 512, 8, "perrow0.1"),
    ("perrow0.5-64x512-k32", 64, 512, 32, "perrow0.5"),
    ("perrow0.9-64x512-k8", 64, 512, 8, "perrow0.9"),
    ("bernoulli-29x301-k8", 29, 301, 8, "bernoulli"),
    ("short-rows-40x256-k8", 40, 256, 8, "short"),
    ("ties-48x384-k8", 48, 384, 8, "ties"),
    ("huge-g-40x256-k8", 40, 256, 8, "huge_g"),
    ("huge-w-40x256-k8", 40, 256, 8, "huge_w"),
    ("ptile-128x384-k8", 128, 384, 8, "perrow0.6"),
]


def _topk_problem(R, d, mask, device):
    """(w, m, c, G) for one TOPK_CASES entry, from numpy seeds."""
    rng = np.random.default_rng(R * 7919 + d)
    X = rng.normal(size=(d, 96)).astype(np.float32)
    G = X @ X.T + np.float32(0.1) * np.eye(d, dtype=np.float32)
    w = rng.normal(size=(R, d)).astype(np.float32)
    d1, d2 = np.array([10, 50, 100, 200, 350]), np.array([11, 51, 101, 201, 20])
    if mask == "ties":
        # duplicated columns tie ΔL across u (both kept) and across p (both
        # pruned); exact zeros of both signs (a whole zero row included),
        # with some negative diagonal entries, give ΔL = ±0
        G[d2, :] = G[d1, :]
        G[:, d2] = G[:, d1]
        neg = np.arange(0, d, 7)
        G[neg, neg] = -G[neg, neg]
        w[:, d2] = w[:, d1]
        zero = rng.random((R, d)) < 0.1
        zero[0] = True
        w[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        w[0, 0], w[0, neg[1:]] = -0.0, 0.0   # ΔL(0, p) = -0 where G[0, p] < 0
        w[:, d2] = w[:, d1]
    if mask == "huge_g":                    # 2 g overflows; w small enough
        G[5, 9] = G[9, 5] = np.float32(1.5 * 2.0**127)   # that no a or b does
        w *= np.float32(2.0**-20)
    if mask == "huge_w":
        w[3, 7] = np.float32(2.0**64)                     # so may 2 w_u w_p
    if mask == "bernoulli":
        G[3, 4] = np.nextafter(G[3, 4], np.float32(np.inf))
    wt, Gt = torch.from_numpy(w).to(device), torch.from_numpy(G).to(device)
    if mask.startswith("perrow"):
        m = warmstart_mask(wt, Gt, tmasks.PerRow(float(mask[6:])), "wanda")
    elif mask == "short":
        m = warmstart_mask(wt, Gt, tmasks.PerRow(0.6), "wanda")
        m[0] = 1.0
        m[0, 17:22] = 0.0                             # 5 pruned columns
        m[1] = 1.0                                    # none pruned
        m[2] = 0.0                                    # none kept
    else:                                   # bernoulli, ties, huge_*
        keep = 0.45 if mask == "bernoulli" else 0.5
        m = torch.from_numpy((rng.random((R, d)) < keep).astype(np.float32))
        m = m.to(device)
        if mask == "ties":
            m[0, 0], m[0, neg[1:]] = 1.0, 0.0     # u = 0 kept, those p pruned
            m[:, d2] = m[:, d1]
    c = sm.correlation_vector(wt, m, Gt)
    if mask == "ties":
        c[:, d2] = c[:, d1]
        c[0] = 0.0
    return wt, m, c, Gt


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES, ids=[c[0] for c in TOPK_CASES])
def test_cuda_swap_topk_edges(cuda, case):
    """swap_topk on the card against swap_topk_plain: bitwise on feasible
    entries, the same +inf positions, indices in [0, d), one launch; each
    finite value is ΔL at its own (u, p) to the bit (a zero's sign too)."""
    _, R, d, k, mask = case
    w, m, c, G = _topk_problem(R, d, mask, cuda)
    ops.reset_launches()
    got = ops.swap_topk(w, m, c, G, k=k)
    assert ops.LAUNCHES["swap_topk"] == 1
    want = topk_mod.swap_topk_plain(w, m, c, G, k=k)
    fin = torch.isfinite(want[0])
    assert torch.equal(torch.isfinite(got[0]), fin)
    for g, t in zip(got, want):
        assert torch.equal(g[fin], t[fin])                   # bitwise
    for idx in got[1:]:
        assert bool(((idx >= 0) & (idx < d)).all())
    a, b = sm.swap_scores(w, m, c, torch.diagonal(G))
    u, p = got[1], got[2]
    at = sm._delta(a.gather(1, u), b.gather(1, p), w.gather(1, u),
                   w.gather(1, p), G[u, p])
    assert torch.equal(got[0][fin].view(torch.int32), at[fin].view(torch.int32))
    if mask == "short":
        assert int(fin[0].sum()) == 5 and not fin[1].any() and not fin[2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES + ARGMIN_CASES,
                         ids=[c[0] for c in TOPK_CASES + ARGMIN_CASES])
def test_cuda_swap_argmin_edges(cuda, case):
    """swap_argmin on the card against swap_argmin_plain, every row bitwise
    (value bits, u and p; (+inf, 0, 0) where no pair is feasible), one
    launch; each finite value is ΔL at its own (u, p) to the bit. Rows
    with a NaN ΔL (huge-w: a column's b is inf - inf) included: both read
    it as +inf, so the plain version equals the dense ΔL's pick with NaN
    as +inf there."""
    _, R, d, _, mask = case
    make = _argmin_problem if case in ARGMIN_CASES else _topk_problem
    w, m, c, G = make(R, d, mask, cuda)
    ops.reset_launches()
    got = ops.swap_argmin(w, m, c, G)
    assert ops.LAUNCHES["swap_argmin"] == 1
    want = argmin_mod.swap_argmin_plain(w, m, c, G)
    dense = ref.swap_argmin_ref(w, m, c, G)
    assert torch.equal(dense[1], want[1]) and torch.equal(dense[2], want[2])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    fin = torch.isfinite(got[0])
    assert bool((got[1][~fin] == 0).all() and (got[2][~fin] == 0).all())
    a, b = sm.swap_scores(w, m, c, torch.diagonal(G))
    u, p = got[1][:, None], got[2][:, None]
    at = sm._delta(a.gather(1, u), b.gather(1, p), w.gather(1, u),
                   w.gather(1, p), G[u, p])[:, 0]
    assert torch.equal(got[0][fin].view(torch.int32),
                       at[fin].view(torch.int32))
    if mask == "infeasible":
        assert not fin[1] and not fin[4]


@pytest.mark.gpu
@pytest.mark.parametrize("T,d", [
    (130, 96),      # one diagonal tile, a partial last strip
    (512, 96),
    (130, 300),     # bf16 rows padded to 304 (a copy), fp32 read in place
    (512, 1024),    # 36 tiles, 8 strips through the 3-stage ring
    (130, 4160),    # a ragged last tile (64 of 128 columns)
])
def test_cuda_gram_matches_plain(cuda, T, d):
    """Both input paths (bf16 on the tensor cores, fp32 on the CUDA
    cores) against the plain fp32 product: exactly symmetric, within
    rtol 1e-5 / atol 1e-4, one launch each on its own counter; a view
    whose rows are not contiguous reads through the padded copy."""
    gen = torch.Generator(device=cuda).manual_seed(T + d)
    x = torch.randn(T, d, generator=gen, device=cuda)
    ops.reset_launches()
    for xx in (x, x.to(torch.bfloat16)):
        Gk = ops.gram_xtx(xx)
        Gp = gram_mod.gram_xtx_plain(xx)
        assert Gk.dtype == torch.float32 and Gk.shape == (d, d)
        assert torch.equal(Gk, Gk.T)                          # exact mirror
        torch.testing.assert_close(Gk, Gp, rtol=1e-5, atol=1e-4)
    assert ops.LAUNCHES["gram_xtx"] == 1 and ops.LAUNCHES["gram_xtx_bf16"] == 1
    base = torch.randn(T, d + 5, generator=gen, device=cuda)
    for xx in (base[:, 3:d + 3], base.to(torch.bfloat16)[:, 3:d + 3]):
        Gk = ops.gram_xtx(xx)
        assert torch.equal(Gk, Gk.T)
        torch.testing.assert_close(Gk, gram_mod.gram_xtx_plain(xx), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("E,T,d", [
    (3, 160, 96),     # mixtral's calibration T: a strip past T in each expert
    (4, 40, 300),     # bf16 rows padded to 304 (a copy)
    (2, 130, 1024),
    (5, 1, 130),      # one token an expert, a ragged tile
])
def test_cuda_gram_stacked_matches_unstacked(cuda, E, T, d):
    """The stacked Gram, both input paths, one launch a call: each
    expert's G bitwise the unstacked kernel on its slice (so exactly
    symmetric) and within rtol 1e-5 / atol 1e-4 of the plain version;
    slices of different scales, so a strip that read the next expert's
    rows would show."""
    gen = torch.Generator(device=cuda).manual_seed(E * T + d)
    scale = torch.arange(1, E + 1, device=cuda, dtype=torch.float32)
    x = torch.randn(E, T, d, generator=gen, device=cuda) * scale[:, None,
                                                                  None]
    for xx, name in ((x, "gram_xtx_stacked"),
                     (x.to(torch.bfloat16), "gram_xtx_stacked_bf16")):
        ops.reset_launches()
        Gk = ops.gram_xtx_stacked(xx)
        assert ops.LAUNCHES[name] == 1 and Gk.shape == (E, d, d)
        torch.testing.assert_close(Gk, gram_mod.gram_xtx_stacked_plain(xx),
                                   rtol=1e-5, atol=1e-4)
        for e in range(E):
            assert torch.equal(Gk[e], ops.gram_xtx(xx[e])), e


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,T,d_out,d_in", [
    (8, 4, 1024, 512),      # decode (the reference's T = capacity x batch)
    (8, 40, 512, 1024),     # mixtral's prefill T: split d_in, BN = 128
    (40, 4, 256, 384),      # granite-moe's expert count, 2 row blocks
    (3, 9, 70, 1200),       # ragged rows and tiles; nm24 positions by cp.async
])
def test_cuda_spmm_stacked_matches_unstacked(cuda, dtype, E, T, d_out, d_in):
    """The stacked spmm in one launch per call, nm24 and gathered (2:4
    and PerRow(0.6)), with a bias and silu: each expert's y bitwise the
    unstacked kernel on its slice, within the spmm tolerance of the plain
    version, and nm24 == gathered bitwise on the 2:4 mask."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(E + T + d_in)
    w = (torch.randn(E, d_out, d_in, generator=gen, device=cuda)
         * d_in ** -0.5).to(dt)
    x = torch.randn(E, T, d_in, generator=gen, device=cuda).to(dt)
    bias = torch.randn(d_out, generator=gen, device=cuda)
    scores = torch.rand(E * d_out, d_in, generator=gen, device=cuda)
    m24 = tmasks.make_mask(scores, tmasks.NM(2, 4)).reshape(w.shape)
    m60 = tmasks.make_mask(scores, tmasks.PerRow(0.6)).reshape(w.shape)
    ys = {}
    for name, fmt, m in (("nm24", "nm24", m24), ("gathered", "gathered", m24),
                         ("gathered 0.6", "gathered", m60)):
        pw = tpacked.pack(w, m, fmt)
        ops.reset_launches()
        y = ys[name] = ops.spmm_stacked(x, pw, bias=bias, act="silu")
        assert ops.LAUNCHES["spmm_stacked"] == 1 and ops.LAUNCHES["spmm"] == 0
        assert y.shape == (E, T, d_out) and y.dtype == dt
        want = spmm_mod.spmm_stacked_plain(x, pw, bias, "silu")
        assert _spmm_ok(y.reshape(-1, d_out), want.reshape(-1, d_out)), name
        for e in range(E):
            one = dataclasses.replace(pw, values=pw.values[e], idx=pw.idx[e])
            assert torch.equal(y[e], ops.spmm(x[e], one, bias=bias,
                                              act="silu")), (name, e)
    assert torch.equal(ys["nm24"], ys["gathered"])


@pytest.mark.gpu
@pytest.mark.parametrize("d_out,d_in,k", [(33, 300, 8), (64, 1024, 5),
                                          (40, 96, 32)])
def test_cuda_swap_commit_matches_plain(cuda, d_out, d_in, k):
    """The commit kernels on swap_topk's candidates (the +inf tail
    included): the decisions bitwise equal to gather_candidate_stats +
    commit_decisions, with accepts and rejects, the apply bitwise equal to
    apply_commits' mask flips and Eq. 6 update, one launch; and the fused
    step equals the plain candidate-space commit."""
    w, m, c, G = _port_problem(d_in + k, d_out, d_in, cuda)
    dl, u, p = ops._swap_topk(w, m, c, G, k=k)     # int32, as the step uses
    ops.reset_launches()
    m2, c2, acc, dls = ops.swap_commit(w, m, c, G, dl, u, p)
    want = topk_mod.swap_commit_decide_plain(w, c, G, dl, u, p, eps=0.0)
    assert torch.equal(acc, want[0]) and torch.equal(dls, want[1])
    assert 0 < int(acc.sum()) < acc.numel()             # accepts and rejects
    assert bool((dls[acc == 0] == 0).all())
    want_m, want_c = topk_mod.swap_commit_apply_plain(w, m, c, G, acc, u, p)
    assert torch.equal(m2, want_m) and torch.equal(c2, want_c)
    got = ops.swap_topk_commit(w, m, c, G, k=k)
    plain = sm.commit_swaps(w, m, c, G, dl, u.long(), p.long())
    for g, t in zip(got, plain):
        assert torch.equal(g, t)
    assert ops.LAUNCHES["swap_commit"] == 2


# (id, R, d, k, kind): G mirrored bit for bit (the apply reads its rows)
# or asymmetric (it reads columns; "lastbit": one entry's last bit, at an
# odd d, so scalar loads); k at both ends; R = 128 rows with a 128-column
# last p-tile (d % 256 == 128); R not a multiple of the
# decisions' 4 rows a block; d = 3; rows with fewer than k pruned columns
# (the +inf tail, indices clamped to d - 1); and, planted after the
# search: duplicate u with repeated rows (compaction's pad slots), -0.0
# and NaN in c and -0.0 in m (a rejected candidate's 0·x turns -0.0 into
# +0.0 and a NaN into the card's NaN), inf in G, and weights so large that
# a rejected candidate's update overflows (no skipping it then)
COMMIT_CASES = [
    ("sym-33x300-k8", 33, 300, 8, "sym"),
    ("asym-37x256-k8", 37, 256, 8, "asym"),
    ("lastbit-29x301-k8", 29, 301, 8, "lastbit"),
    ("sym-29x301-k8", 29, 301, 8, "sym"),
    ("k1-64x512", 64, 512, 1, "sym"),
    ("k32-37x1000", 37, 1000, 32, "sym"),
    ("k32-asym-21x600", 21, 600, 32, "asym"),
    ("rows-5x4096-k8", 5, 4096, 8, "sym"),
    ("d3-64x3-k2", 64, 3, 2, "sym"),
    ("short-rows-40x256-k8", 40, 256, 8, "short"),
    ("dup-u-pad-rows-40x256-k8", 40, 256, 8, "dup_pad"),
    ("neg-zero-nan-40x256-k8", 40, 256, 8, "negzero"),
    ("inf-g-40x256-k8", 40, 256, 8, "inf_g"),
    ("huge-w-40x256-k8", 40, 256, 8, "huge_w"),
    ("ptile-128x384-k8", 128, 384, 8, "sym"),
]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _commit_case(R, d, k, kind, device):
    """(w, m, c, G, dl, u, p) of one COMMIT_CASES entry: the kernel
    search's int32 candidates on a PerRow(0.6) Wanda mask, then the
    case's plants."""
    rng = np.random.default_rng(R * 104729 + d)
    X = rng.normal(size=(d, 96)).astype(np.float32)
    G = X @ X.T + np.float32(0.1) * np.eye(d, dtype=np.float32)
    G = np.triu(G) + np.triu(G, 1).T                  # bitwise symmetric
    if kind == "asym":
        G = G + np.float32(0.05 * np.abs(G).max()) * rng.normal(
            size=(d, d)).astype(np.float32)
    if kind == "lastbit":
        G[3, 4] = np.nextafter(G[3, 4], np.float32(np.inf))
    w = torch.from_numpy(rng.normal(size=(R, d)).astype(np.float32)).to(device)
    G = torch.from_numpy(G).to(device)
    m = warmstart_mask(w, G, tmasks.PerRow(0.6), "wanda")
    if kind == "short":
        m[0] = 1.0
        m[0, 17:22] = 0.0                             # 5 pruned columns
        m[1] = 1.0                                    # none pruned
    c = sm.correlation_vector(w, m, G)
    dl, u, p = ops._swap_topk(w, m, c, G, k=k)
    if kind == "dup_pad":
        u[::2, 1] = u[::2, 0]
        idx = torch.cat([torch.arange(R // 2), torch.zeros(R - R // 2,
                                                           dtype=torch.int64)])
        idx = idx.to(device)
        w, m, c, dl, u, p = (t.index_select(0, idx)
                             for t in (w, m, c, dl, u, p))
    if kind == "negzero":
        pick = torch.from_numpy(rng.random((R, d))).to(device)
        c = torch.where(pick < 0.1, -0.0, c)
        c = torch.where(pick > 0.95, torch.from_numpy(
            np.array(np.nan, np.float32)).to(device), c)
        m = torch.where(m == 0, -0.0, m)
    if kind == "inf_g":
        for r, t, sign in ((0, 1, 1.0), (1, 2, -1.0), (2, 0, 1.0)):
            col = int(u[r, t])
            G[17, col] = G[col, 17] = sign * float("inf")
    if kind == "huge_w":      # against 1e38 / max|G| (max|G| ~ 150 here)
        w[3, int(u[3, 2])] = 2.0**110                 # skippable, x finite
        w[4, int(p[4, 0])] = 2.0**125                 # x overflows to inf
    return w, m, c, G, dl, u, p


@pytest.mark.gpu
@pytest.mark.parametrize("case", COMMIT_CASES, ids=[c[0] for c in COMMIT_CASES])
def test_cuda_swap_commit_edges(cuda, case):
    """Both commit kernels bitwise against their plain versions (every
    output's bits, NaNs included) in one launch, G read as rows exactly
    when it is bitwise symmetric; and ``ops.swap_topk_commit`` equal to the
    plain ``swap_math.commit_swaps`` on the search's candidates, every
    output bitwise."""
    _, R, d, k, kind = case
    w, m, c, G, dl, u, p = _commit_case(R, d, k, kind, cuda)
    gram = ops.gram_facts(G)
    assert gram.symmetric == (kind not in ("asym", "lastbit"))
    ops.reset_launches()
    got = ops.swap_commit(w, m, c, G, dl, u, p, gram=gram)
    assert ops.LAUNCHES["swap_commit"] == 1
    acc, dls = topk_mod.swap_commit_decide_plain(w, c, G, dl, u, p, eps=0.0)
    want = (*topk_mod.swap_commit_apply_plain(w, m, c, G, acc, u, p), acc,
            dls)
    for g, t in zip(got, want):
        assert torch.equal(_bits(g), _bits(t))
    assert int(acc.sum()) > 0
    if kind == "dup_pad":
        for t in got:
            assert torch.equal(_bits(t[R // 2:]), _bits(t[:1].expand(
                R - R // 2, *t.shape[1:])))
    if kind == "short":
        assert not bool(torch.isfinite(dl[1]).any()) and not acc[1].any()
    if kind in ("negzero", "inf_g", "huge_w"):
        assert not bool(torch.isfinite(got[1]).all())
    if kind == "negzero":     # nothing accepted: every candidate skippable
        none = ops.swap_commit(w, m, c, G, dl, u, p, eps=float("inf"),
                               gram=gram)
        acc, dls = topk_mod.swap_commit_decide_plain(w, c, G, dl, u, p,
                                                     eps=float("inf"))
        want = (*topk_mod.swap_commit_apply_plain(w, m, c, G, acc, u, p),
                acc, dls)
        for g, t in zip(none, want):
            assert torch.equal(_bits(g), _bits(t))
        assert not none[2].any()
        neg0 = _bits(torch.tensor(-0.0, device=cuda))
        assert bool(((_bits(c) == neg0) & (_bits(none[1]) == 0)).any())
        assert bool(((_bits(m) == neg0) & (_bits(none[0]) == 0)).any())
    dl2, u2, p2 = ops.swap_topk(w, m, c, G, k=k)
    plain = sm.commit_swaps(w, m, c, G, dl2, u2, p2)
    for g, t in zip(ops.swap_topk_commit(w, m, c, G, k=k, gram=gram), plain):
        assert torch.equal(_bits(g), _bits(t))


def _spmm_tol(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound: 1e-5 of max|y|, and in bf16 one ulp of the
    plain element as well."""
    w32 = want.float()
    tol = torch.full_like(w32, 1e-5 * float(w32.abs().max()))
    if want.dtype == torch.bfloat16:
        mag = w32.abs().clamp_min(torch.finfo(torch.float32).tiny)
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(mag)) - 7))
    return tol


def _spmm_ok(got, want) -> bool:
    return bool(((got.float() - want.float()).abs() <= _spmm_tol(want)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d_out,d_in", [
    (1, 70, 1200), (4, 70, 1200), (5, 70, 1200), (8, 70, 1200),
    (9, 70, 1200), (37, 70, 1200), (130, 70, 1200),
    (2, 4160, 2080),     # decode: 4 splits of 5 tiles wrap the 4-stage ring
    (64, 70, 5536),      # prefill (128 tokens): 8 splits of 6 tiles
])
def test_cuda_spmm_matches_plain(cuda, dtype, T, d_out, d_in):
    """Both kernels (tensor cores for bf16, CUDA cores for fp32), the
    decode and prefill tilings, every epilogue. x holds 2T tokens. Every
    d_in ends in a ragged 128-column tile; T = 130 and the last two cases
    give a block more tiles than the nm24 ring has stages; d_in = 1200
    stages nm24 positions by cp.async (k % 16 != 0), the others by TMA.
    d_in is split at T <= 37 and in the last two cases (at decode and at
    128 tokens)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T)
    w = torch.randn(d_out, d_in, generator=gen, device=cuda).to(dt)
    x = torch.randn(2, T, d_in, generator=gen, device=cuda).to(dt)
    bias = torch.randn(d_out, generator=gen, device=cuda)
    scores = torch.rand(d_out, d_in, generator=gen, device=cuda)
    m24 = tmasks.make_mask(scores, tmasks.NM(2, 4))
    m60 = tmasks.make_mask(scores, tmasks.PerRow(0.6))
    nm = tpacked.pack(w, m24, "nm24")
    ga = tpacked.pack(w, m24, "gathered")
    g60 = tpacked.pack(w, m60, "gathered")
    x2 = x.reshape(-1, d_in)
    ops.reset_launches()
    for act in (None, *spmm_mod.EPILOGUES):
        b = bias if act in (None, "silu") else None
        y_nm = ops.spmm(x, nm, bias=b, act=act)
        assert y_nm.dtype == dt and y_nm.shape == (2, T, d_out)
        assert torch.equal(y_nm, ops.spmm(x, ga, bias=b, act=act)), act
        assert _spmm_ok(y_nm.reshape(-1, d_out),
                        spmm_mod.spmm_plain(x2, nm, b, act)), act
        got = ops.spmm(x, g60, bias=b, act=act).reshape(-1, d_out)
        assert _spmm_ok(got, spmm_mod.spmm_plain(x2, g60, b, act)), act
    # spmm_gather takes columns in any order (it sorts them)
    perm = torch.randperm(g60.k, generator=gen, device=cuda)
    vals, idx = g60.values[:, perm], g60.idx[:, perm]
    got = ops.spmm_gather(x2, vals, idx, d_in=d_in)
    assert _spmm_ok(got, spmm_mod.spmm_plain(x2, g60))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spmm"] == 3 * len(spmm_mod.EPILOGUES) + 3 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [4, 128])
@pytest.mark.parametrize("act", ["gelu", "relu2", "silu"])
def test_cuda_spmm_bias_epilogues(cuda, dtype, T, act):
    """A bias with the plain MLPs' epilogues (gelu, tanh form; relu2) and
    silu, at d_out = 128 (an MQA wk / wv: one 128-row block, so d_in is
    split) in both packings: within tolerance of spmm_plain, which adds
    the bias and applies the epilogue in the same order on the fp32 sum;
    nm24 and gathered bitwise equal on one 2:4 mask."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T)
    d_out, d_in = 128, 2048
    w = (torch.randn(d_out, d_in, generator=gen, device=cuda)
         * d_in ** -0.5).to(dt)
    x = torch.randn(T, d_in, generator=gen, device=cuda).to(dt)
    bias = torch.randn(d_out, generator=gen, device=cuda)
    scores = torch.rand(d_out, d_in, generator=gen, device=cuda)
    m24 = tmasks.make_mask(scores, tmasks.NM(2, 4))
    nm = tpacked.pack(w, m24, "nm24")
    ops.reset_launches()
    y_nm = ops.spmm(x, nm, bias=bias, act=act)
    assert _spmm_ok(y_nm, spmm_mod.spmm_plain(x, nm, bias, act))
    assert torch.equal(y_nm, ops.spmm(x, tpacked.pack(w, m24, "gathered"),
                                      bias=bias, act=act))
    g60 = tpacked.pack(w, tmasks.make_mask(scores, tmasks.PerRow(0.6)),
                       "gathered")
    got = ops.spmm(x, g60, bias=bias, act=act)
    assert _spmm_ok(got, spmm_mod.spmm_plain(x, g60, bias, act))
    assert not torch.equal(got, ops.spmm(x, g60, act=act))   # the bias lands
    assert ops.LAUNCHES["spmm"] == 4


# (id, T, d_out, d_in, mask, offset): the bf16 gathered kernel's edges.
# "crowded": half the rows keep their first K columns, half their last K
# (K odd, so value rows are 2-byte aligned; tiles of 128 kept slots
# overflow the slot rings); "offset": values and columns viewed off a
# 16-byte boundary (3 bf16 / 1 int32 elements in); d_out not a multiple
# of 128 everywhere but one case; 32 tiles, more than the x ring's stages
# and the slot rings' refill depth, at decode and at 128 tokens; split
# d_in in all but the last case (one split: 133 row blocks at T = 4).
GATHER_CASES = [
    ("crowded-oddk-decode", 4, 200, 2048, "crowded", 0),
    ("crowded-oddk-prefill", 128, 200, 2048, "crowded", 0),
    ("perrow-oddk-offset", 6, 70, 1208, "perrow", 3),
    ("full-rows-prefill", 100, 130, 1024, "full", 0),
    ("many-tiles-offset-decode", 4, 300, 4096, "perrow", 3),
    ("many-tiles-prefill", 128, 300, 4096, "perrow", 0),
    ("one-split-decode", 4, 17000, 512, "perrow", 0),
]


def _offset_view(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of t that starts ``off`` elements into its buffer."""
    if not off:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:].copy_(t.reshape(-1))
    return buf[off:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GATHER_CASES, ids=[c[0] for c in GATHER_CASES])
def test_cuda_spmm_gather_edges(cuda, case):
    """The bf16 gathered kernel against spmm_plain (one bf16 ulp or 1e-5
    of max|y|), one launch a call, on masks and layouts that stress its
    slot rings; and, where d_in % 16 == 0, the nm24 and gathered packings
    of one 2:4 mask bitwise equal (the gathered one offset as the case
    says)."""
    _, T, d_out, d_in, kind, off = case
    gen = torch.Generator(device=cuda).manual_seed(T * 7 + d_out + d_in)
    w = torch.randn(d_out, d_in, generator=gen, device=cuda).to(torch.bfloat16)
    x = torch.randn(T, d_in, generator=gen, device=cuda).to(torch.bfloat16)
    bias = torch.randn(d_out, generator=gen, device=cuda)
    scores = torch.rand(d_out, d_in, generator=gen, device=cuda)
    if kind == "crowded":
        k = int(0.4 * d_in) | 1
        mask = torch.zeros(d_out, d_in, device=cuda)
        mask[0::2, :k] = 1.0
        mask[1::2, d_in - k:] = 1.0
    elif kind == "full":
        mask = torch.ones(d_out, d_in, device=cuda)
    else:
        mask = tmasks.make_mask(scores, tmasks.PerRow(0.6))
    pw = tpacked.pack(w, mask, "gathered")
    if "oddk" in case[0]:
        assert pw.k % 2 == 1
    pw = tpacked.PackedWeight(_offset_view(pw.values, off),
                              _offset_view(pw.idx, off), "gathered", d_in)
    ops.reset_launches()
    for b, act in ((None, None), (bias, "silu")):
        got = ops.spmm(x, pw, bias=b, act=act)
        assert _spmm_ok(got, spmm_mod.spmm_plain(x, pw, b, act)), act
    assert ops.LAUNCHES["spmm"] == 2
    if d_in % 16 == 0:
        m24 = tmasks.make_mask(scores, tmasks.NM(2, 4))
        ga = tpacked.pack(w, m24, "gathered")
        ga = tpacked.PackedWeight(_offset_view(ga.values, off),
                                  _offset_view(ga.idx, off), "gathered", d_in)
        y_nm = ops.spmm(x, tpacked.pack(w, m24, "nm24"), bias=bias, act="silu")
        assert torch.equal(y_nm, ops.spmm(x, ga, bias=bias, act="silu"))
        assert _spmm_ok(y_nm, spmm_mod.spmm_plain(x, ga, bias, "silu"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_spmm_contracts(cuda, dtype):
    """One contract for both kernels: a row whose columns do not ascend
    strictly within [0, d_in) (nm24: positions within a block) comes out
    NaN, that row only, whatever the epilogue. d_in = 1200 takes the
    tensor cores in bf16, d_in = 1204 and fp32 the CUDA cores."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    d_out = 40
    for d_in in (1200, 1204):
        w = torch.randn(d_out, d_in, generator=gen, device=cuda).to(dt)
        x = torch.randn(6, d_in, generator=gen, device=cuda).to(dt)
        scores = torch.rand(d_out, d_in, generator=gen, device=cuda)
        pw = tpacked.pack(w, tmasks.make_mask(scores, tmasks.PerRow(0.6)),
                          "gathered")
        assert _spmm_ok(ops.spmm(x, pw), spmm_mod.spmm_plain(x, pw))
        full = tpacked.pack(w, torch.ones_like(w), "gathered")  # 64 a tile
        assert _spmm_ok(ops.spmm(x, full), spmm_mod.spmm_plain(x, full))
        cases = []
        perm = torch.randperm(pw.k, generator=gen, device=cuda)
        shuf = tpacked.PackedWeight(pw.values[:, perm].contiguous(),
                                    pw.idx[:, perm].contiguous(), "gathered",
                                    d_in)
        cases.append((shuf, range(d_out)))                # every row
        idx = pw.idx.clone()
        idx[5, -1] = d_in + 3                             # past d_in
        idx[9, 0] = -1                                    # below 0
        idx[12, 7] = idx[12, 6]                           # a repeat
        cases.append((tpacked.PackedWeight(pw.values, idx, "gathered", d_in),
                      (5, 9, 12)))
        if d_in % 4 == 0:
            m24 = tmasks.make_mask(scores, tmasks.NM(2, 4))
            nm = tpacked.pack(w, m24, "nm24")
            assert _spmm_ok(ops.spmm(x, nm), spmm_mod.spmm_plain(x, nm))
            idx = nm.idx.clone()
            idx[3, :2] = idx[3, :2].flip(0)               # within a block
            idx[7, 10] = 4                                # past the block
            idx[11, 591] = idx[11, 590]                   # a repeat, in the
                                                          # ragged last tile
            cases.append((tpacked.PackedWeight(nm.values, idx, "nm24", d_in,
                                               2, 4), (3, 7, 11)))
        for bad, rows in cases:
            rows = list(rows)
            keep = [r for r in range(d_out) if r not in rows]
            for act in (None, "relu"):
                y = ops.spmm(x, bad, act=act)
                assert bool(torch.isnan(y[:, rows]).all()), (d_in, act)
                assert not bool(torch.isnan(y[:, keep]).any()), (d_in, act)
    # other N:M patterns take the CUDA-core kernel
    m48 = tmasks.make_mask(torch.rand(d_out, 1200, generator=gen,
                                      device=cuda), tmasks.NM(4, 8))
    w8 = torch.randn(d_out, 1200, generator=gen, device=cuda).to(dt)
    x8 = torch.randn(6, 1200, generator=gen, device=cuda).to(dt)
    pw = tpacked.pack(w8, m48, "nm24", n=4, m=8)
    assert _spmm_ok(ops.spmm(x8, pw), spmm_mod.spmm_plain(x8, pw))
    # a misaligned nm24 view raises rather than being copied per call
    m24 = tmasks.make_mask(torch.rand(d_out, 1200, generator=gen,
                                      device=cuda), tmasks.NM(2, 4))
    nm = tpacked.pack(w8, m24, "nm24")
    off = torch.empty(nm.values.numel() + 1, dtype=dt, device=cuda)[1:]
    off.copy_(nm.values.reshape(-1))
    with pytest.raises(ValueError, match="aligned"):
        ops.spmm(x8, tpacked.PackedWeight(off.view(nm.values.shape), nm.idx,
                                          "nm24", 1200, 2, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 64])
def test_cuda_spmm_serving_token_counts(cuda, T):
    """spmm at the token counts only the continuous scheduler gives it —
    T = 1 (a one-row decode bucket) and T = 64 (a chunked-prefill
    window) — at llama31-8b's w_gate (14336 x 4096, silu) in bf16: nm24
    (2:4) and gathered (PerRow 0.6 and the same 2:4 mask) against the
    plain version, nm24 == gathered bitwise on the 2:4 mask."""
    d_out, d_in = 14336, 4096
    gen = torch.Generator(device=cuda).manual_seed(T)
    w = (torch.randn(d_out, d_in, generator=gen, device=cuda)
         * d_in ** -0.5).to(torch.bfloat16)
    x = torch.randn(T, d_in, generator=gen, device=cuda).to(torch.bfloat16)
    scores = torch.rand(d_out, d_in, generator=gen, device=cuda)
    m24 = tmasks.make_mask(scores, tmasks.NM(2, 4))
    m60 = tmasks.make_mask(scores, tmasks.PerRow(0.6))
    y = {}
    for name, fmt, mask in (("nm24", "nm24", m24), ("ga24", "gathered", m24),
                            ("ga60", "gathered", m60)):
        pw = tpacked.pack(w, mask, fmt)
        y[name] = ops.spmm(x, pw, act="silu")
        assert _spmm_ok(y[name], spmm_mod.spmm_plain(x, pw, None, "silu")), \
            name
    assert torch.equal(y["nm24"], y["ga24"])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spmm"] == 3


@pytest.mark.gpu
def test_cuda_sampler_matches_cpu(cuda):
    """The sampler on CUDA tensors against itself on CPU tensors for the
    same logits and knobs: threefry bits and uniforms bitwise equal, and
    tokens equal wherever both devices keep the same top-k / top-p
    candidates and the CPU's two best perturbed scores differ by more
    than 1e-4 (the card's ``log``, sort, softmax and cumsum are other
    implementations)."""
    from repro_torch.serve import _threefry, sampling

    seeds = torch.tensor([0, 1, 7, 2**31 + 5, 2**32 - 1])
    ts = torch.tensor([0, 5, 100, 2047, 65535])
    bits = {}
    for dev in ("cpu", cuda):
        key = _threefry.fold_in(_threefry.seed_key(seeds.to(dev)), ts.to(dev))
        bits[str(dev)] = _threefry.random_bits(key, 128256)
    got, want = bits["cuda"].cpu(), bits["cpu"]
    assert torch.equal(got, want)
    assert torch.equal(_threefry.uniform(bits["cuda"]).cpu(),
                       _threefry.uniform(want))
    gen = torch.Generator().manual_seed(0)
    knobs = [(0.0, 1.0, 0), (1.0, 1.0, 0), (0.8, 0.95, 40), (1.2, 0.9, 0),
             (3.0, 1.0, 8), (0.7, 0.5, 0)]
    compared = total = 0
    for trial in range(8):
        logits = torch.randn(len(knobs), 128256, generator=gen) * 3
        args = [torch.tensor([k[i] for k in knobs]) for i in range(3)] + [
            torch.randint(0, 2**32, (len(knobs),), generator=gen),
            torch.randint(0, 4096, (len(knobs),), generator=gen)]
        args[2] = args[2].long()
        dargs = [logits.to(cuda)] + [a.to(cuda) for a in args]
        cpu = sampling.sample_tokens(logits, *args)
        dev = sampling.sample_tokens(*dargs).cpu()
        scores, order, _ = sampling.perturbed_scores(logits, *args)
        d_scores, d_order, _ = sampling.perturbed_scores(*dargs)
        kept = lambda sc, od: torch.zeros_like(sc, dtype=torch.bool).scatter(
            -1, od, sc > -1e29)
        same_kept = (kept(scores, order)
                     == kept(d_scores.cpu(), d_order.cpu())).all(-1)
        top2 = torch.topk(scores, 2, dim=-1).values
        clear = (((top2[:, 0] - top2[:, 1]) > 1e-4) & same_kept) \
            | (args[0] <= 0)
        total += len(knobs)
        compared += int(clear.sum())
        assert torch.equal(cpu[clear], dev[clear]), (trial, cpu, dev)
    assert compared >= 0.9 * total, (compared, total)
