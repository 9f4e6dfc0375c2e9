"""Distributed SparseSwaps: the paper's row parallelism on a mesh (the
reference's ``repro.pruning.distributed``).

Two regimes:

* ``refine_rows_sharded`` — W's rows split over the flattened mesh, G
  replicated. Equal per-row sparsity decouples the rows (paper §2.2), so
  each rank runs the single-device loop (``core.sparseswaps``: the CUDA
  searches and commit on the card, the chunked rule on the CPU) on its
  contiguous row block with no communication inside the loop; masks and
  losses are all-gathered in row order at the end.

* ``refine_g_sharded`` — for layers whose fp32 Gram cannot be replicated
  (granite-34b's and the VLM's w_down). A rank holds only its column
  block G[:, own] (``col_axes``), and the correlation vector c is split
  with it. The initial carry is each rank's ``((1-m0)·w) @ g_cols`` and
  the row losses come from the all-gathered c, as in the reference. Each
  pass all-gathers c, scores every u against the rank's own p columns,
  and all-gathers the per-rank winners: (ΔL, u, p) at k = 1, the local
  top-k columns at k > 1, whose column-rescored greedy commit then costs
  one all-reduce (c[p_t]) and one all-gather ((ΔL, u)) per candidate.
  The Eq. 6 updates read rows of the block (G[u, own] = G[own, u] for a
  symmetric G: the card's Gram writes each tile's mirror, and
  ``psum_gram`` sums symmetric matrices elementwise). ``row_axes``
  additionally splits the rows. ``gram_split`` gives the engine's split:
  on a mesh with a "model" axis the columns go over "model" and the rows
  over the data axes, so a rank's block is exactly its calibration shard
  (``dist.specs.calib_pspecs``) and G is never assembled whole.

Both keep the single-device ΔL order and tie-breaks (the smallest flat
index u·d + p at k = 1; (ΔL, p) for the k best columns, ties to the
lowest p by a stable sort; the lowest u in the commit), and a NaN ΔL
reads as +inf, so the masks equal the single-device loop's wherever the
ΔL gaps exceed the rounding of the initial carry. That carry is the one
O(R·d²) product, and cuBLAS and MKL round it by shape:

* the rows regime takes it over all R rows on every rank and slices, so
  its masks and losses are bitwise the single-device loop's (it holds G
  whole by design: its groups fit the engine's Gram budget);
* the Gram regime takes it in (rows, d) @ (d, cols) products, so it is
  bitwise ``refine_split_single``, the single-device loop from the same
  split's carry; against the single-device all-columns carry it may
  differ by an ulp.

A rank refines only its real rows (R need not divide the mesh); rows are
padded only to all-gather equal blocks. ``refine_bytes`` is the per-rank
reckoning of either regime that ``PrunePlan`` reports.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import masks as masks_lib
from repro_torch.core import sparseswaps as ss
from repro_torch.core import swap_math as sm
from repro_torch.dist import groups as groups_lib

# bytes of one (rows, d, cols) ΔL block of the Gram-sharded search
DELTA_BLOCK_BYTES = 256 * 2**20


def _block(R: int, grp: groups_lib.Group) -> tuple[int, int, int]:
    """(rows a rank, first row, end row) of this rank's contiguous block."""
    n = -(-R // grp.size)
    lo = min(R, grp.index * n)
    return n, lo, min(R, lo + n)


def _gather_rows(x: torch.Tensor, grp: groups_lib.Group, n: int,
                 R: int) -> torch.Tensor:
    """Every rank's row block (each padded to ``n`` rows) back in row order,
    the pad rows dropped."""
    if x.shape[0] < n:
        x = torch.cat([x, x.new_zeros(n - x.shape[0], *x.shape[1:])])
    return grp.all_gather(x).reshape(-1, *x.shape[1:])[:R]


def _gather_mask_rows(m, grp, n, R):
    """``_gather_rows`` of a 0/1 mask, sent as bytes."""
    return _gather_rows(m.to(torch.uint8), grp, n, R).float()


def _gather_cols(x_own: torch.Tensor, grp: groups_lib.Group) -> torch.Tensor:
    """(R, cols) per rank -> (R, size · cols) in column order."""
    g = grp.all_gather(x_own)                       # (P, R, cols)
    return g.permute(1, 0, 2).reshape(x_own.shape[0], -1)


def refine_rows_sharded(W, G, mask_init, pattern: masks_lib.Pattern, mesh,
                        *, t_max: int = 50, eps: float = 0.0,
                        chunk: int = 512, k_swaps: int = 1,
                        commit_mode: str = "columns"):
    """Row-sharded refinement: W's rows over every mesh axis, G replicated.

    Each rank refines rows [index · n, (index + 1) · n), n = ceil(R / P),
    with ``core.sparseswaps``' loop from the shared initial carry; the
    loop stops once none of its rows accepts. ``commit_mode`` is the
    single-device loop's (``"candidates"`` runs the CUDA commit on the
    card). Returns (mask, loss_init, loss_final), all R rows, on every
    rank."""
    grp = groups_lib.axis_group(mesh, groups_lib.all_axes(mesh))
    R, d = W.shape
    w = W.float()
    m0 = mask_init.float()
    c0, l0 = ss._init_carry(w, m0, G)
    n, lo, hi = _block(R, grp)
    m, l1 = m0[lo:hi], l0[lo:hi]
    if hi > lo:
        block = pattern.block(d)
        method = ss._pick_method("auto", d, hi - lo, w.device)
        k = ss._pick_k(k_swaps, d, block)
        gram = ss._commit_gram(G, method=method, block=block, k_swaps=k,
                               commit_mode=commit_mode)
        swaps = torch.zeros(hi - lo, dtype=torch.int64, device=w.device)
        m, _, l1, _, _, _ = ss._refine_carry(
            w[lo:hi], m, c0[lo:hi], l1, swaps, G, n_iter=t_max, eps=eps,
            method=method, block=block, chunk=chunk, k_swaps=k,
            commit_mode=commit_mode, gram=gram)
    return (_gather_mask_rows(m, grp, n, R), l0,
            _gather_rows(l1, grp, n, R))


def _chunks(rows: int, d: int, cols: int) -> tuple[int, int]:
    """(rows, p-columns) of a ΔL block under DELTA_BLOCK_BYTES."""
    pc = max(1, min(cols, DELTA_BLOCK_BYTES // (4 * d)))
    rb = max(1, min(rows, DELTA_BLOCK_BYTES // (4 * d * pc)))
    return rb, pc


def _own_delta(a, b_own, w, w_own, g_cols, r0, r1, p0, p1):
    """ΔL[r, u, p] for rows r0:r1, every u, own columns p0:p1:
    ``swap_math._delta``'s arithmetic in its order, done in place, so a
    block holds two (rows, d, cols) buffers at its peak, not three."""
    dl = w[r0:r1, :, None] * w_own[r0:r1, None, p0:p1]
    dl.mul_(2.0).mul_(g_cols[None, :, p0:p1])
    inter, dl = dl, a[r0:r1, :, None] + b_own[r0:r1, None, p0:p1]
    dl.sub_(inter)
    del inter
    return dl.nan_to_num_(nan=sm.INVALID, posinf=sm.INVALID,
                          neginf=-sm.INVALID)


def _local_best(a, b_own, w, w_own, g_cols, start):
    """Per row, the rank's lexicographically least (ΔL, u, p) over every u
    and its own p."""
    R, d = w.shape
    cols = g_cols.shape[1]
    rb, pc = _chunks(R, d, cols)
    best = torch.full((R,), sm.INVALID, dtype=torch.float32, device=w.device)
    bu = torch.zeros(R, dtype=torch.int64, device=w.device)
    bp = torch.zeros(R, dtype=torch.int64, device=w.device)
    for r0 in range(0, R, rb):
        r1 = min(R, r0 + rb)
        for p0 in range(0, cols, pc):
            p1 = min(cols, p0 + pc)
            flat = _own_delta(a, b_own, w, w_own, g_cols, r0, r1, p0,
                              p1).reshape(r1 - r0, -1)
            idx = torch.argmin(flat, dim=1)
            val = flat.gather(1, idx[:, None])[:, 0]
            del flat
            u = idx // (p1 - p0)
            p = idx % (p1 - p0) + p0 + start
            upd = sm._lex_less(val, u, p, best[r0:r1], bu[r0:r1], bp[r0:r1])
            best[r0:r1] = torch.where(upd, val, best[r0:r1])
            bu[r0:r1] = torch.where(upd, u, bu[r0:r1])
            bp[r0:r1] = torch.where(upd, p, bp[r0:r1])
    return best, bu, bp


def _local_vals_p(a, b_own, w, w_own, g_cols):
    """Per row and own column p, min over u of ΔL[u, p]: (R, cols)."""
    R, d = w.shape
    cols = g_cols.shape[1]
    rb, pc = _chunks(R, d, cols)
    out = torch.empty((R, cols), dtype=torch.float32, device=w.device)
    for r0 in range(0, R, rb):
        r1 = min(R, r0 + rb)
        for p0 in range(0, cols, pc):
            p1 = min(cols, p0 + pc)
            out[r0:r1, p0:p1] = _own_delta(a, b_own, w, w_own, g_cols, r0,
                                           r1, p0, p1).min(dim=1).values
    return out


def _global_min(grp, val, u, p=None):
    """The group's lexicographically least (val, u[, p]) per row: the
    (ΔL, u, p) of the rank that holds it."""
    big = sm.BIG_INDEX
    av, au = grp.all_gather(val), grp.all_gather(u)          # (P, R)
    vmin = av.min(dim=0).values
    tie = av == vmin[None]
    umin = torch.where(tie, au, big).min(dim=0).values
    if p is None:
        return vmin, umin
    ap = grp.all_gather(p)
    pmin = torch.where(tie & (au == umin[None]), ap, big).min(dim=0).values
    return vmin, umin, pmin


def gram_split(mesh) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(row_axes, col_axes) of the engine's Gram-sharded regime: on a mesh
    whose "model" axis has more than one rank, G's columns over "model"
    (a rank's block is its calibration shard, ``calib_pspecs``) and W's
    rows over the data axes; otherwise the columns over every axis."""
    sizes = groups_lib.axis_sizes(mesh)
    if sizes.get("model", 1) > 1:
        return (tuple(a for a in ("pod", "data") if a in sizes),
                ("model",))
    return (), groups_lib.all_axes(mesh)


def column_block(G: torch.Tensor, cg: groups_lib.Group) -> torch.Tensor:
    """This rank's (d, cols) column block of ``G``, which is either that
    block already or G whole (sliced here)."""
    d = G.shape[-2]
    cols = d // cg.size
    if G.shape[-1] == cols:
        return G
    if G.shape[-1] != d:
        raise ValueError(f"G {tuple(G.shape)} is neither whole nor a "
                         f"(d, {cols}) column block")
    return G[..., cg.index * cols:(cg.index + 1) * cols]


def block_diag(g_cols: torch.Tensor, cg: groups_lib.Group) -> torch.Tensor:
    """diag(G), (d,) fp32, all-gathered from the column blocks' diagonals
    (block i holds G[i·cols + j, i·cols + j] at row i·cols + j, column j)."""
    cols = g_cols.shape[-1]
    own = g_cols[cg.index * cols:(cg.index + 1) * cols]
    return cg.all_gather(torch.diagonal(own).float().contiguous()).reshape(-1)


def gram_diag(G: torch.Tensor, mesh, col_axes=None) -> torch.Tensor:
    """diag(G) from this rank's column block (or G whole) over
    ``col_axes`` (default: ``gram_split``'s)."""
    axes = gram_split(mesh)[1] if col_axes is None else tuple(col_axes)
    cg = groups_lib.axis_group(mesh, axes)
    return block_diag(column_block(G, cg), cg)


def _split_carry(wp: torch.Tensor, g_cols: torch.Tensor, cg):
    """(c_own0, c_full0, loss0) of one row block: ``wp @ g_cols`` (a
    (rows, d) @ (d, cols) product), c gathered over the column group, and
    each row's loss sum(wp · c)."""
    c_own = wp @ g_cols
    c_full = _gather_cols(c_own, cg)
    return c_own, c_full, (wp * c_full).sum(1)


def refine_split_single(W, G, mask_init, pattern: masks_lib.Pattern, *,
                        n_cols: int, n_rows: int = 1, t_max: int = 50,
                        eps: float = 0.0, k_swaps: int = 1):
    """A one-process run of the Gram-sharded refiner's split: the initial
    carry taken block by block as its ranks take it (``n_rows`` row blocks
    × ``n_cols`` column blocks, the same product shapes), then the
    single-device loop (``core.sparseswaps``: the CUDA searches on the
    card) from it. ``refine_g_sharded`` on that split gives these masks
    and losses bitwise. Returns (mask, loss_init, loss_final)."""
    R, d = W.shape
    if d % n_cols:
        raise ValueError(f"d_in {d} does not divide {n_cols} column blocks")
    cols, n = d // n_cols, -(-R // n_rows)
    G32 = G.float()
    c, l0 = torch.empty_like(W, dtype=torch.float32), []
    for lo in range(0, R, n):
        hi = min(R, lo + n)
        wp = (1.0 - mask_init[lo:hi].float()) * W[lo:hi].float()
        for j in range(n_cols):
            c[lo:hi, j * cols:(j + 1) * cols] = (
                wp @ G32[:, j * cols:(j + 1) * cols].contiguous())
        l0.append((wp * c[lo:hi]).sum(1))
    l0 = torch.cat(l0)
    w, m = W.float(), mask_init.float().clone()
    method = ss._pick_method("auto", d, R, w.device)
    k = ss._pick_k(k_swaps, d, None)
    gram = ss._commit_gram(G32, method=method, block=None, k_swaps=k,
                           commit_mode="columns")
    swaps = torch.zeros(R, dtype=torch.int64, device=w.device)
    m, _, l1, _, _, _ = ss._refine_carry(
        w, m, c, l0.clone(), swaps, G32, n_iter=t_max, eps=eps,
        method=method, block=None, chunk=512, k_swaps=k, gram=gram)
    return m, l0, l1


# the per-rank reckoning's counts of live fp32 arrays (read off the loops
# below and ``core.sparseswaps``): (rows, d) — W and the mask, the
# caller's and the loop's, c gathered, the swap scores a and b, the next
# mask; (rows, cols) — c_own, its update and the k > 1 commit's columns;
# ΔL blocks — a block and its product term (``_own_delta``)
ROW_ARRAYS, COL_ARRAYS, DELTA_LIVE = 8, 12, 2


def refine_bytes(regime: str, R: int, d: int, mesh) -> dict:
    """Per-rank bytes of one instance's refine in ``regime`` ("rows" or
    "gram") on ``mesh`` (a mapping of axis sizes will do): {"gram": the
    Gram the rank holds (its (d, d / n) column block in the Gram regime, G
    whole and the card search's 2·G scratch in the rows regime), "rows":
    the O(rows · d) arrays, "carry": the O(rows · d / n) ones, "delta":
    the ΔL blocks, "total"}."""
    sizes = groups_lib.axis_sizes(mesh)
    if regime == "gram":
        row_axes, col_axes = gram_split(sizes)
        n_cols = math.prod(sizes[a] for a in col_axes)
        n_rows = math.prod(sizes[a] for a in row_axes) if row_axes else 1
        rows, cols = -(-R // n_rows), d // n_cols
        out = {"gram": 4 * d * cols, "rows": 4 * rows * d * ROW_ARRAYS,
               "carry": 4 * rows * cols * COL_ARRAYS,
               "delta": DELTA_LIVE * min(
                   DELTA_BLOCK_BYTES, 4 * rows * d * cols)}
    else:
        # the all-rows initial carry (c and the losses) on every rank, the
        # rank's block through the single-device loop
        rows = -(-R // groups_lib.mesh_size(sizes))
        out = {"gram": 2 * 4 * d * d, "rows": 4 * rows * d * ROW_ARRAYS,
               "carry": 4 * R * d, "delta": 0}
    out["total"] = sum(out.values())
    return out


def refine_g_sharded(W, G, mask_init, pattern: masks_lib.Pattern, mesh,
                     *, t_max: int = 50, eps: float = 0.0,
                     row_axes: tuple = (), col_axes: tuple | None = None,
                     k_swaps: int = 1):
    """Column-sharded-G refinement for a d_in too large to replicate.

    ``col_axes`` (default: every mesh axis) split G's columns and c;
    ``row_axes`` (disjoint from them) additionally split W's rows. ``G``
    is this rank's (d, d / n) column block over ``col_axes`` (the engine
    passes its calibration shard); G whole is accepted and sliced here.
    Returns (mask, loss_init, loss_final), all R rows, on every rank.
    Unstructured patterns only: N:M swaps stay within a block of G's
    diagonal."""
    cols_axes = (tuple(col_axes) if col_axes is not None
                 else groups_lib.all_axes(mesh))
    if set(cols_axes) & set(row_axes):
        raise ValueError(f"row_axes {row_axes} and col_axes {cols_axes} "
                         "overlap")
    R, d = W.shape
    sizes = groups_lib.axis_sizes(mesh)
    n_cols = math.prod(sizes[a] for a in cols_axes)
    if d % n_cols:
        raise ValueError(f"d_in {d} does not divide the {n_cols} column "
                         "shards")
    if pattern.block(d) is not None:
        raise NotImplementedError(
            "N:M swaps are within-block (the block-diagonal G path); the "
            "Gram-sharded refiner is for unstructured patterns")
    cg = groups_lib.axis_group(mesh, cols_axes)
    cols = d // cg.size
    start = cg.index * cols
    own = slice(start, start + cols)
    g_cols = column_block(G, cg).float()         # G[:, own]
    g_diag = block_diag(g_cols, cg)
    if row_axes:
        rg = groups_lib.axis_group(mesh, row_axes)
        n, lo, hi = _block(R, rg)
    else:
        rg, n, lo, hi = None, R, 0, R
    w, m = W[lo:hi].float(), mask_init[lo:hi].float().clone()
    c_own, c_full, l0 = _split_carry((1.0 - m) * w, g_cols, cg)
    del c_full
    loss = l0
    w_own = w[:, own]
    rows = torch.arange(hi - lo, device=w.device)
    k = ss._pick_k(k_swaps, d, None)

    def pass_k1(m, c_own, loss):
        c_full = _gather_cols(c_own, cg)
        a, b = sm.swap_scores(w, m, c_full, g_diag)
        del c_full
        val, u, p = _local_best(a, b[:, own], w, w_own, g_cols, start)
        del a, b
        dl, u, p = _global_min(cg, val, u, p)
        acc = dl < -eps
        wu = w.gather(1, u[:, None])[:, 0]
        wp = w.gather(1, p[:, None])[:, 0]
        # Eq. 6 on the own columns: G[own, j] = G[j, own], a row of the block
        c_new = (c_own + wu[:, None] * g_cols.index_select(0, u)
                 - wp[:, None] * g_cols.index_select(0, p))
        r = rows[acc]
        m[r, u[acc]] = 0.0
        m[r, p[acc]] = 1.0
        return (m, torch.where(acc[:, None], c_new, c_own),
                torch.where(acc, loss + dl, loss), acc)

    def pass_k(m, c_own, loss):
        c_full = _gather_cols(c_own, cg)
        a, b = sm.swap_scores(w, m, c_full, g_diag)
        del c_full
        vals_p = _local_vals_p(a, b[:, own], w, w_own, g_cols)
        del a, b
        p_loc = sm._k_smallest(vals_p, min(k, cols))     # ties: lowest p
        cand_v = _gather_cols(vals_p.gather(1, p_loc), cg)
        cand_p = _gather_cols(p_loc + start, cg)
        del vals_p
        order = torch.sort(cand_p, dim=1, stable=True).indices
        cand_v, cand_p = cand_v.gather(1, order), cand_p.gather(1, order)
        order = torch.sort(cand_v, dim=1, stable=True).indices
        top_v = cand_v.gather(1, order)[:, :k]
        top_p = cand_p.gather(1, order)[:, :k]
        valid = torch.isfinite(top_v)
        quad_own = (w_own * w_own) * g_diag[None, own]
        w2_own = 2.0 * w_own
        dsum = torch.zeros_like(loss)
        nacc = torch.zeros(hi - lo, dtype=torch.int64, device=w.device)
        for t in range(top_p.shape[1]):
            pt = top_p[:, t]
            gcol = g_cols.index_select(0, pt)                # G[p_t, own]
            wpt = w[rows, pt]
            mine = (pt >= start) & (pt < start + cols)
            loc = (pt - start).clamp(0, cols - 1)
            cpt = cg.all_reduce(torch.where(
                mine, c_own.gather(1, loc[:, None])[:, 0], 0.0))
            b_t = -2.0 * wpt * cpt + (wpt * wpt) * g_diag[pt]
            a_own = w2_own * c_own + quad_own
            a_own = torch.where(m[:, own] > 0.5, a_own, sm.INVALID)
            dl_u = sm._delta(a_own, b_t[:, None], w_own, wpt[:, None], gcol)
            del a_own
            ui = torch.argmin(dl_u, dim=1)                   # ties: low u
            dl_t, u_w = _global_min(cg, dl_u[rows, ui], ui + start)
            del dl_u
            still_pruned = m[rows, pt] < 0.5
            ok = ((dl_t < -eps) & still_pruned & valid[:, t]
                  & torch.isfinite(dl_t))
            okf = ok.float()[:, None]
            wut = w[rows, u_w][:, None]
            c_own += okf * (wut * g_cols.index_select(0, u_w)
                            - wpt[:, None] * gcol)
            m[rows, u_w] = torch.where(ok, 0.0, m[rows, u_w])
            m[rows, pt] = torch.where(ok, 1.0, m[rows, pt])
            dsum += torch.where(ok, dl_t, 0.0)
            nacc += ok.to(torch.int64)
        return m, c_own, loss + dsum, nacc > 0

    step = pass_k1 if k == 1 else pass_k
    if hi > lo:
        for _ in range(t_max):
            m, c_own, loss, alive = step(m, c_own, loss)
            # the column group shares these rows and every decision, so
            # its ranks leave the loop together
            if not bool(alive.any()):
                break
    if rg is None:
        return m, l0, loss
    return (_gather_mask_rows(m, rg, n, R), _gather_rows(l0, rg, n, R),
            _gather_rows(loss, rg, n, R))
