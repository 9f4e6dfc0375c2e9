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
  (granite-34b's and the VLM's w_down). G's columns, and the correlation
  vector c with them, are split over ``col_axes``. Each pass all-gathers
  c, scores every u against the rank's own p columns, and all-gathers the
  per-rank winners: (ΔL, u, p) at k = 1, the local top-k columns at
  k > 1, whose column-rescored greedy commit then costs one all-reduce
  (c[p_t]) and one all-gather ((ΔL, u)) per candidate. ``row_axes``
  additionally splits the rows.

Both give masks bitwise equal to the single-device loop: the same
elementwise ΔL, the same tie-breaks (the smallest flat index u·d + p at
k = 1; (ΔL, p) for the k best columns, ties to the lowest p by a stable
sort; the lowest u in the commit), and a NaN ΔL reads as +inf. Two
choices keep it bitwise where the reference's shapes would not:

* the initial carry (c and the row losses, the one O(R·d²) product) is
  taken over all R rows on every rank and then sliced: cuBLAS and MKL
  pick their kernels, and with them the rounding, by the row count;
* a rank refines only its real rows (R need not divide the mesh); rows
  are padded only to all-gather equal blocks.

G arrives whole, as the reference's refiners take it; the Gram-sharded
loop reads only G[:, own] (the ΔL columns) and G[own, :] (the Eq. 6
updates: its transpose for a symmetric G, read as the single-device loop
reads it). What parity costs: every rank holds the whole fp32 G in both
regimes (the engine's Gram budget picks the regime, it does not bound a
rank's peak), and every rank computes the O(R·d²) initial carry over all
rows, which caps the rows regime's speed-up (ROADMAP A5 item 5).
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
    """ΔL[r, u, p] for rows r0:r1, every u, own columns p0:p1."""
    return sm._delta(a[r0:r1, :, None], b_own[r0:r1, None, p0:p1],
                     w[r0:r1, :, None], w_own[r0:r1, None, p0:p1],
                     g_cols[None, :, p0:p1])


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


def refine_g_sharded(W, G, mask_init, pattern: masks_lib.Pattern, mesh,
                     *, t_max: int = 50, eps: float = 0.0,
                     row_axes: tuple = (), col_axes: tuple | None = None,
                     k_swaps: int = 1):
    """Column-sharded-G refinement for a d_in too large to replicate.

    ``col_axes`` (default: every mesh axis) split G's columns and c;
    ``row_axes`` (disjoint from them) additionally split W's rows. Returns
    (mask, loss_init, loss_final), all R rows, on every rank. Unstructured
    patterns only: N:M swaps stay within a block of G's diagonal."""
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
    w_all = W.float()
    m_all = mask_init.float()
    G32 = G.float()
    c0, l0 = ss._init_carry(w_all, m_all, G32)
    if row_axes:
        rg = groups_lib.axis_group(mesh, row_axes)
        n, lo, hi = _block(R, rg)
    else:
        rg, n, lo, hi = None, R, 0, R
    w, m = w_all[lo:hi], m_all[lo:hi].clone()
    c_own = c0[lo:hi, own].clone()
    loss = l0[lo:hi]
    g_cols = G32[:, own]                 # ΔL: G[u, p], p own
    g_rows = G32[own, :]                 # updates: G[own, j]
    g_diag = torch.diagonal(G32)
    w_own = w[:, own]
    rows = torch.arange(hi - lo, device=w.device)
    k = ss._pick_k(k_swaps, d, None)

    def pass_k1(m, c_own, loss):
        c_full = _gather_cols(c_own, cg)
        a, b = sm.swap_scores(w, m, c_full, g_diag)
        val, u, p = _local_best(a, b[:, own], w, w_own, g_cols, start)
        dl, u, p = _global_min(cg, val, u, p)
        acc = dl < -eps
        wu = w.gather(1, u[:, None])[:, 0]
        wp = w.gather(1, p[:, None])[:, 0]
        c_new = (c_own + wu[:, None] * g_rows.index_select(1, u).T
                 - wp[:, None] * g_rows.index_select(1, p).T)
        m_new = m.clone()
        m_new[rows, u] = 0.0
        m_new[rows, p] = 1.0
        return (torch.where(acc[:, None], m_new, m),
                torch.where(acc[:, None], c_new, c_own),
                torch.where(acc, loss + dl, loss), acc)

    def pass_k(m, c_own, loss):
        c_full = _gather_cols(c_own, cg)
        a, b = sm.swap_scores(w, m, c_full, g_diag)
        vals_p = _local_vals_p(a, b[:, own], w, w_own, g_cols)
        p_loc = sm._k_smallest(vals_p, min(k, cols))     # ties: lowest p
        cand_v = _gather_cols(vals_p.gather(1, p_loc), cg)
        cand_p = _gather_cols(p_loc + start, cg)
        order = torch.sort(cand_p, dim=1, stable=True).indices
        cand_v, cand_p = cand_v.gather(1, order), cand_p.gather(1, order)
        order = torch.sort(cand_v, dim=1, stable=True).indices
        top_v = cand_v.gather(1, order)[:, :k]
        top_p = cand_p.gather(1, order)[:, :k]
        valid = torch.isfinite(top_v)
        m, c_own = m.clone(), c_own.clone()
        quad_own = (w_own * w_own) * g_diag[None, own]
        w2_own = 2.0 * w_own
        dsum = torch.zeros_like(loss)
        nacc = torch.zeros(hi - lo, dtype=torch.int64, device=w.device)
        for t in range(top_p.shape[1]):
            pt = top_p[:, t]
            gcol = g_rows.index_select(1, pt).T              # G[own, p_t]
            wpt = w[rows, pt]
            mine = (pt >= start) & (pt < start + cols)
            loc = (pt - start).clamp(0, cols - 1)
            cpt = cg.all_reduce(torch.where(
                mine, c_own.gather(1, loc[:, None])[:, 0], 0.0))
            b_t = -2.0 * wpt * cpt + (wpt * wpt) * g_diag[pt]
            a_own = w2_own * c_own + quad_own
            a_own = torch.where(m[:, own] > 0.5, a_own, sm.INVALID)
            dl_u = sm._delta(a_own, b_t[:, None], w_own, wpt[:, None], gcol)
            ui = torch.argmin(dl_u, dim=1)                   # ties: low u
            dl_t, u_w = _global_min(cg, dl_u[rows, ui], ui + start)
            still_pruned = m[rows, pt] < 0.5
            ok = ((dl_t < -eps) & still_pruned & valid[:, t]
                  & torch.isfinite(dl_t))
            okf = ok.float()[:, None]
            wut = w[rows, u_w][:, None]
            c_own += okf * (wut * g_rows.index_select(1, u_w).T
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
    return (_gather_mask_rows(m, rg, n, R), l0, _gather_rows(loss, rg, n, R))
