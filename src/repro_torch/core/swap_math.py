"""Exact swap cost algebra from the paper (§2.1.3), 1-swap and k-swap.

Row-batched like the reference: a "row block" is ``w, m, c`` of shape
(R, d_in) plus the shared Gram matrix G (d_in, d_in). These functions are
the single source of truth for the swap formulas in the port; the CUDA
kernels in ``repro_torch.kernels`` are held against them.

Notation (paper Eq. 5/6):
    a_u = 2 w_u c_u + w_u^2 G_uu          cost of *pruning* kept index u
    b_p = -2 w_p c_p + w_p^2 G_pp         cost of *unpruning* pruned index p
    dL[u, p] = a_u + b_p - 2 w_u w_p G_up

``m == 1`` keeps a weight. A swap (u, p) prunes kept u and keeps pruned p.

Two search families:

* ``best_swap_*``  — the jointly-best single swap per row (k = 1).
* ``topk_swaps_*`` — the k best candidate pairs per row from ONE ΔL
  evaluation: the k best pruned columns p by ``min_u ΔL[u, p]`` (each
  paired with its own argmin u, ties to the lowest u), sorted ascending by
  (ΔL, p). Every implementation — dense, chunked, N:M and the CUDA
  kernel — returns the same candidates.

The ΔL evaluation order is fixed: ``inter = 2 * (w_u * w_p) * G_up``,
then ``dl = (a_u + b_p) - inter``; a NaN ΔL reads as +inf in every
search, as in the CUDA kernels. PyTorch runs each elementwise op as its
own rounding step (no fused multiply-add), and the CUDA kernels keep the
same order with round-to-nearest intrinsics, so kernel and plain version
agree bit for bit on the card.

Functions return new tensors and leave their inputs untouched; the
commit loops clone ``m`` and ``c`` once and then update the clones in
place, which avoids one (R, d) copy per candidate.
"""
from __future__ import annotations

import torch

INVALID = float("inf")  # +inf sentinel for masked-out candidates
BIG_INDEX = 2**30       # index sentinel that loses every tie-break


def correlation_vector(w: torch.Tensor, m: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """c = G ((1 - m) ⊙ w), row-batched. (R, d) -> (R, d) fp32."""
    wp = ((1.0 - m) * w).float()
    return wp @ G.float().T   # G symmetric; .T keeps the reference's layout


def row_loss(w: torch.Tensor, m: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Exact per-row loss L = (w - m⊙w)^T G (w - m⊙w). (R,)."""
    wp = ((1.0 - m) * w).float()
    return ((wp @ G.float()) * wp).sum(-1)


def swap_scores(w, m, c, g_diag):
    """Per-index swap half-costs (a, b) with infeasible entries at +inf."""
    w = w.float()
    c = c.float()
    quad = (w * w) * g_diag.float()
    a = 2.0 * w * c + quad
    b = -2.0 * w * c + quad
    a = torch.where(m > 0.5, a, INVALID)
    b = torch.where(m > 0.5, INVALID, b)
    return a, b


def _delta(a_u, b_p, w_u, w_p, g):
    """ΔL in the fixed evaluation order (broadcasting operands). A NaN
    (inf - inf, for weights near 2^64) reads as +inf, the CUDA searches'
    rule, so it never takes an argmin or a top-k slot from a finite pair."""
    inter = 2.0 * (w_u * w_p) * g
    dl = (a_u + b_p) - inter
    return dl.nan_to_num_(nan=INVALID, posinf=INVALID, neginf=-INVALID)


def delta_matrix(w, m, c, G):
    """Full ΔL[r, u, p] (reference path — O(R d²) memory); +inf infeasible."""
    a, b = swap_scores(w, m, c, torch.diagonal(G))
    w32 = w.float()
    return _delta(a[:, :, None], b[:, None, :], w32[:, :, None],
                  w32[:, None, :], G.float()[None])


def best_swap_dense(w, m, c, G):
    """Jointly-best (ΔL*, u*, p*) per row via the dense ΔL matrix.

    Ties go to the smallest flat index u·d + p (first minimum).
    """
    dl = delta_matrix(w, m, c, G)
    R, d, _ = dl.shape
    flat = dl.reshape(R, d * d)
    idx = torch.argmin(flat, dim=1)
    best = flat.gather(1, idx[:, None])[:, 0]
    return best, idx // d, idx % d


def _lex_less(v1, u1, p1, v2, u2, p2):
    """(v1, u1, p1) < (v2, u2, p2) lexicographically, elementwise."""
    return (v1 < v2) | ((v1 == v2) & ((u1 < u2) | ((u1 == u2) & (p1 < p2))))


def best_swap_chunked(w, m, c, G, *, chunk: int = 512):
    """Memory-lean jointly-best swap: stream over p-column chunks of G.

    Memory O(R·d·chunk). Across chunks a tie in ΔL goes to the smaller
    (u, p) pair, so the pick is the smallest flat index u·d + p — the
    tie-break of ``ref.swap_argmin_ref`` and of the CUDA kernel.
    """
    R, d_in = w.shape
    a, b = swap_scores(w, m, c, torch.diagonal(G))
    w32 = w.float()
    G32 = G.float()
    best = torch.full((R,), INVALID, dtype=torch.float32, device=w.device)
    best_u = torch.zeros(R, dtype=torch.int64, device=w.device)
    best_p = torch.zeros(R, dtype=torch.int64, device=w.device)
    for lo in range(0, d_in, chunk):
        hi = min(lo + chunk, d_in)
        dl = _delta(a[:, :, None], b[:, None, lo:hi], w32[:, :, None],
                    w32[:, None, lo:hi], G32[None, :, lo:hi])   # (R, d, n)
        n = hi - lo
        flat = dl.reshape(R, -1)
        idx = torch.argmin(flat, dim=1)
        val = flat.gather(1, idx[:, None])[:, 0]
        u_i = idx // n
        p_i = idx % n + lo
        upd = _lex_less(val, u_i, p_i, best, best_u, best_p)
        best = torch.where(upd, val, best)
        best_u = torch.where(upd, u_i, best_u)
        best_p = torch.where(upd, p_i, best_p)
    return best, best_u, best_p


def _block_diag(G: torch.Tensor, block: int) -> torch.Tensor:
    """(nb, block, block) block-diagonal of G."""
    d = G.shape[0]
    nb = d // block
    G4 = G.float().reshape(nb, block, nb, block)
    return torch.diagonal(G4, dim1=0, dim2=2).permute(2, 0, 1)


def _nm_delta(w, m, c, G, block):
    """ΔL restricted to same-block pairs: (R, nb, block_u, block_p)."""
    R, d_in = w.shape
    nb = d_in // block
    a, b = swap_scores(w, m, c, torch.diagonal(G))
    a = a.reshape(R, nb, block)
    b = b.reshape(R, nb, block)
    w32 = w.float().reshape(R, nb, block)
    Gb = _block_diag(G, block)
    return _delta(a[..., :, None], b[..., None, :], w32[..., :, None],
                  w32[..., None, :], Gb[None])


def best_swap_nm(w, m, c, G, *, block: int):
    """Best within-block swap for N:M sparsity (paper §2.2)."""
    R, d_in = w.shape
    dl = _nm_delta(w, m, c, G, block)
    flat = dl.reshape(R, -1)
    idx = torch.argmin(flat, dim=1)
    val = flat.gather(1, idx[:, None])[:, 0]
    blk = idx // (block * block)
    rem = idx % (block * block)
    return val, blk * block + rem // block, blk * block + rem % block


# ---------------------------------------------------------------------------
# k-swap candidate search
# ---------------------------------------------------------------------------


def _k_smallest(vals: torch.Tensor, k: int):
    """Indices of the k smallest entries per row, ties to the lowest index
    (a stable ascending sort)."""
    return torch.sort(vals, dim=1, stable=True).indices[:, :k]


def _merge_topk(vals, ps, us, new_vals, new_ps, new_us, k: int):
    """Merge two per-row candidate lists, keep the k best by (ΔL, p)."""
    v = torch.cat([vals, new_vals], dim=1)
    p = torch.cat([ps, new_ps], dim=1)
    u = torch.cat([us, new_us], dim=1)
    order = torch.sort(p, dim=1, stable=True).indices      # secondary key
    v, p, u = v.gather(1, order), p.gather(1, order), u.gather(1, order)
    order = torch.sort(v, dim=1, stable=True).indices      # primary key
    return (v.gather(1, order)[:, :k], p.gather(1, order)[:, :k],
            u.gather(1, order)[:, :k])


def topk_swaps_dense(w, m, c, G, *, k: int):
    """k best candidate swaps per row via the dense ΔL matrix.

    Returns (dl, u, p) each (R, k), ascending by (ΔL, p); rows with fewer
    than k feasible pairs pad with +inf entries.
    """
    dl = delta_matrix(w, m, c, G)                 # (R, d, d)
    d = dl.shape[2]
    vals_p = dl.min(dim=1).values                 # best over u, per p
    u_p = torch.argmin(dl, dim=1)                 # ties -> lowest u
    p_idx = _k_smallest(vals_p, min(k, d))        # ties -> lowest p
    return vals_p.gather(1, p_idx), u_p.gather(1, p_idx), p_idx


def topk_swaps_chunked(w, m, c, G, *, k: int, chunk: int = 512):
    """k best candidate swaps per row, streaming over p-column chunks of G.

    Memory O(R·d·chunk); the same candidates as ``topk_swaps_dense``.
    """
    R, d_in = w.shape
    k = min(k, d_in)
    a, b = swap_scores(w, m, c, torch.diagonal(G))
    w32 = w.float()
    G32 = G.float()
    dev = w.device
    best_v = torch.full((R, k), INVALID, dtype=torch.float32, device=dev)
    best_p = torch.full((R, k), BIG_INDEX, dtype=torch.int64, device=dev)
    best_u = torch.zeros((R, k), dtype=torch.int64, device=dev)
    for lo in range(0, d_in, chunk):
        hi = min(lo + chunk, d_in)
        dl = _delta(a[:, :, None], b[:, None, lo:hi], w32[:, :, None],
                    w32[:, None, lo:hi], G32[None, :, lo:hi])   # (R, d, n)
        vals_p = dl.min(dim=1).values
        u_p = torch.argmin(dl, dim=1)
        del dl
        p_loc = _k_smallest(vals_p, min(k, hi - lo))
        best_v, best_p, best_u = _merge_topk(
            best_v, best_p, best_u, vals_p.gather(1, p_loc), p_loc + lo,
            u_p.gather(1, p_loc), k)
    return best_v, best_u, best_p


def topk_swaps_nm(w, m, c, G, *, block: int, k: int):
    """k best within-block candidate swaps for N:M sparsity."""
    R, d_in = w.shape
    nb = d_in // block
    k = min(k, d_in)
    dl = _nm_delta(w, m, c, G, block)             # (R, nb, bu, bp)
    vals_p = dl.min(dim=2).values.reshape(R, d_in)
    u_loc = torch.argmin(dl, dim=2)               # (R, nb, bp)
    offs = block * torch.arange(nb, device=w.device)[None, :, None]
    u_glob = (u_loc + offs).reshape(R, d_in)
    p_idx = _k_smallest(vals_p, k)
    return vals_p.gather(1, p_idx), u_glob.gather(1, p_idx), p_idx


# ---------------------------------------------------------------------------
# k-swap commit: greedy apply with exact re-scoring
# ---------------------------------------------------------------------------


def _cols(G32: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of G32[:, idx].T — the Gram columns of ``idx``, (len(idx), d)."""
    return G32.index_select(1, idx).T


def gather_candidate_stats(w, c, G, u, p):
    """Per-candidate inputs of the commit loop (everything O(R·k²)).

    Returns (wu, wp, cu, cp, Suu, Sup, Spp) with Suu[i, j] = G[u_i, u_j],
    Sup[i, j] = G[u_i, p_j], Spp[i, j] = G[p_i, p_j].
    """
    w32 = w.float()
    G32 = G.float()
    wu, wp = w32.gather(1, u), w32.gather(1, p)
    cu, cp = c.gather(1, u), c.gather(1, p)
    Suu = G32[u[:, :, None], u[:, None, :]]
    Sup = G32[u[:, :, None], p[:, None, :]]
    Spp = G32[p[:, :, None], p[:, None, :]]
    return wu, wp, cu, cp, Suu, Sup, Spp


def commit_decisions(wu, wp, cu, cp, Suu, Sup, Spp, u, p, valid, *,
                     eps: float, k: int):
    """Sequential greedy accept/reject over a candidate batch, in candidate
    space only: each candidate is re-scored against the correlation values
    updated by every earlier accepted swap and accepted iff still feasible
    and still improving (ΔL < -eps). Returns (acc (R, k) 0/1, dls (R, k))."""
    u_dead = torch.zeros_like(wu)
    p_dead = torch.zeros_like(wp)
    accs, dls = [], []
    for t in range(k):
        wu_t, wp_t = wu[:, t:t + 1], wp[:, t:t + 1]
        suu_t = Suu[:, :, t]
        sup_col_t = Sup[:, :, t]
        sup_row_t = Sup[:, t, :]
        spp_t = Spp[:, :, t]
        a_t = 2.0 * wu_t * cu[:, t:t + 1] + (wu_t * wu_t) * suu_t[:, t:t + 1]
        b_t = (-2.0 * wp_t * cp[:, t:t + 1]
               + (wp_t * wp_t) * spp_t[:, t:t + 1])
        dl_t = a_t + b_t - 2.0 * (wu_t * wp_t) * sup_col_t[:, t:t + 1]
        ok = ((valid[:, t:t + 1] > 0.5) & (u_dead[:, t:t + 1] < 0.5)
              & (p_dead[:, t:t + 1] < 0.5) & (dl_t < -eps))
        okf = ok.float()
        cu = cu + okf * (wu_t * suu_t - wp_t * sup_col_t)
        cp = cp + okf * (wu_t * sup_row_t - wp_t * spp_t)
        u_dead = torch.maximum(u_dead, okf * (u == u[:, t:t + 1]).float())
        p_dead = torch.maximum(p_dead, okf * (p == p[:, t:t + 1]).float())
        accs.append(okf)
        dls.append(torch.where(ok, dl_t, 0.0))
    return torch.cat(accs, dim=1), torch.cat(dls, dim=1)


def apply_commits(w, m, c, G, acc, dls, u, p):
    """Apply a decided candidate batch: mask flips + full-width Eq. 6.

    Returns (m', c', dl_sum, n_accepted)."""
    R, k = acc.shape
    w32 = w.float()
    G32 = G.float()
    m = m.clone()
    c = c.clone()
    rows = torch.arange(R, device=w.device)
    for t in range(k):
        sel = acc[:, t][:, None]
        wu_t = w32.gather(1, u[:, t:t + 1])
        wp_t = w32.gather(1, p[:, t:t + 1])
        c += sel * (wu_t * _cols(G32, u[:, t]) - wp_t * _cols(G32, p[:, t]))
        s = acc[:, t].to(m.dtype)
        m[rows, p[:, t]] += s
        m[rows, u[:, t]] -= s
    return m, c, dls.sum(1), acc.sum(1).to(torch.int64)


def commit_swaps_columns(w, m, c, G, dl, p_idx, *, eps: float = 0.0):
    """Greedily commit the k best candidate COLUMNS per row, re-pairing u.

    The production unstructured commit: for each stale candidate column
    in order, the best kept u is re-searched exactly against the current
    (m, c) — an O(R·d) column-restricted argmin — and the swap is
    accepted iff the column is still pruned and the re-scored ΔL < -eps.
    Each accept applies the exact Eq. 6 rank-1 update before the next
    candidate. Returns (m', c', dl_sum (R,), n_accepted (R,)).
    """
    R, k = p_idx.shape
    d_in = w.shape[1]
    w32 = w.float()
    G32 = G.float()
    m = m.clone()
    c = c.float().clone()
    g_diag = torch.diagonal(G32)
    valid = torch.isfinite(dl)
    p_idx = p_idx.clamp(0, d_in - 1)
    rows = torch.arange(R, device=w.device)
    dsum = torch.zeros(R, dtype=torch.float32, device=w.device)
    nacc = torch.zeros(R, dtype=torch.int64, device=w.device)
    quad = (w32 * w32) * g_diag[None, :]
    w2 = 2.0 * w32            # the same bits as 2.0 * w32 in the loop
    for t in range(k):
        pt = p_idx[:, t]
        gcol = _cols(G32, pt)                                 # (R, d)
        wpt = w32[rows, pt]
        cpt = c[rows, pt]
        b_t = -2.0 * wpt * cpt + (wpt * wpt) * g_diag[pt]     # (R,)
        a = w2 * c + quad
        a = torch.where(m > 0.5, a, INVALID)
        dl_u = _delta(a, b_t[:, None], w32, wpt[:, None], gcol)
        ui = torch.argmin(dl_u, dim=1)                        # ties -> low u
        dl_t = dl_u[rows, ui]
        still_pruned = m[rows, pt] < 0.5
        ok = (dl_t < -eps) & still_pruned & valid[:, t] & torch.isfinite(dl_t)
        okf = ok.float()[:, None]
        wut = w32[rows, ui][:, None]
        c += okf * (wut * _cols(G32, ui) - wpt[:, None] * gcol)
        m[rows, ui] = torch.where(ok, 0.0, m[rows, ui])
        m[rows, pt] = torch.where(ok, 1.0, m[rows, pt])
        dsum += torch.where(ok, dl_t, 0.0)
        nacc += ok.to(torch.int64)
    return m, c, dsum, nacc


def commit_swaps(w, m, c, G, dl, u_idx, p_idx, *, eps: float = 0.0):
    """Greedily commit a k-candidate batch per row in candidate space (the
    N:M commit): re-score in order, reject any that turned non-improving
    or infeasible. Returns (m', c', dl_sum (R,), n_accepted (R,))."""
    k = dl.shape[1]
    c = c.float()
    valid = torch.isfinite(dl).float()
    d_in = w.shape[1]
    u_idx = u_idx.clamp(0, d_in - 1)
    p_idx = p_idx.clamp(0, d_in - 1)
    wu, wp, cu, cp, Suu, Sup, Spp = gather_candidate_stats(w, c, G, u_idx,
                                                           p_idx)
    acc, dls = commit_decisions(wu, wp, cu, cp, Suu, Sup, Spp, u_idx, p_idx,
                                valid, eps=eps, k=k)
    return apply_commits(w, m, c, G, acc, dls, u_idx, p_idx)


def apply_swap(w, m, c, G, dl, u_idx, p_idx, *, eps: float = 0.0):
    """Apply accepted swaps row-batched; rows with dl >= -eps are no-ops.

    Returns (m', c', accepted) — Eq. 6: c ← c + w_u G_{:,u} − w_p G_{:,p}.
    """
    accepted = dl < -eps
    R = m.shape[0]
    rows = torch.arange(R, device=w.device)
    G32 = G.float()
    wu = w.gather(1, u_idx[:, None])[:, 0].float()
    wp = w.gather(1, p_idx[:, None])[:, 0].float()
    c_new = c + wu[:, None] * _cols(G32, u_idx) - wp[:, None] * _cols(G32, p_idx)
    m_new = m.clone()
    m_new[rows, u_idx] = 0.0
    m_new[rows, p_idx] = 1.0
    acc = accepted[:, None]
    return torch.where(acc, m_new, m), torch.where(acc, c_new, c), accepted
