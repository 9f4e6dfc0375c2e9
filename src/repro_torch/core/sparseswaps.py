"""SparseSwaps (paper Algorithm 1): monotone swap refinement, 1- and k-swap.

Row-batched: all per-row state is laid out (R, d_in) with the Gram matrix
G (d_in, d_in) shared. Three swap-search backends:

* ``dense``   — materialize ΔL (R, d, d). Reference; small d only.
* ``chunked`` — stream over p-chunks of G; O(R·d·chunk) memory.
* ``kernel``  — the hand-written CUDA kernels (``repro_torch.kernels``):
  ``swap_argmin`` for k = 1, ``swap_topk`` for the k > 1 candidate search
  and ``swap_commit`` for its candidate-space commit. On a CPU tensor the wrappers take their plain PyTorch versions.

``method="auto"`` picks ``kernel`` for CUDA tensors and keeps the
reference's CPU rule otherwise (dense while R·d²·4 ≤ 256 MB, else
chunked). N:M patterns always use the block-diagonal search.

k-swap refinement (``k_swaps > 1``): every O(R·d²) search returns the k
best candidates per row and a greedy exact commit applies them:

* unstructured, ``commit_mode="columns"`` (the default): the stale top-k
  columns each re-pair their u against the updated state
  (``swap_math.commit_swaps_columns``);
* unstructured, ``commit_mode="candidates"`` on the ``kernel`` backend:
  ``ops.swap_topk_commit``, whose decisions and apply run in the two CUDA
  commit kernels (``csrc/swap_commit.cu``; what they need to know of G is
  taken once per refinement);
* otherwise (N:M, or ``"candidates"`` on dense/chunked): the O(R·k²)
  candidate-space commit ``swap_math.commit_swaps``.

Each pass stays exactly monotone; a pass that accepts nothing certifies a
1-swap fixed point.

The refinement loop is a Python loop with one host read per pass (does
any row still accept?), so it executes exactly the reference's number of
passes. Losses are tracked incrementally: L_{t+1} = L_t + ΣΔL*.

Active-row compaction (``compact_every = S > 0``): every S passes, rows
whose last pass accepted nothing (certified converged) leave the working
set, so late passes score only the rows still moving. Working-set sizes
are bucketed to powers of two; pad slots repeat an active row and scatter
back identical values. The initial state is computed once at the full
block shape and then gathered, and every later step is row-independent,
so masks, swaps and losses are bitwise those of the uncompacted loop.

Search-pass accounting: wrap a refinement in
``with sparseswaps.count_search_passes() as cnt:`` to count the search
passes (and row·pass volume) actually executed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Literal

import numpy as np
import torch

from . import masks as masks_lib
from . import swap_math as sm

Method = Literal["auto", "dense", "chunked", "kernel"]
COMMIT_MODES = ("columns", "candidates")


@dataclasses.dataclass
class RefineResult:
    mask: torch.Tensor          # (d_out, d_in) refined keep-mask
    loss_init: torch.Tensor     # (d_out,) exact row loss before
    loss_final: torch.Tensor    # (d_out,) tracked row loss after
    swaps: torch.Tensor         # (d_out,) accepted swaps per row
    iters: int                  # search passes executed (max over blocks)
    history: torch.Tensor | None = None  # (t_max,) mean loss per pass

    @property
    def error_reduction(self) -> torch.Tensor:
        """Per-row relative reduction of the local pruning error."""
        denom = torch.clamp(self.loss_init, min=1e-30)
        return (self.loss_init - self.loss_final) / denom


# ---------------------------------------------------------------------------
# search-pass accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class SearchPassCounter:
    """Tally of search passes executed while the hook was active.

    ``passes``: full swap searches (each streams the Gram once);
    ``rows_scored``: Σ per pass of the rows it scored. ``eq=False``:
    counters are registered and removed by identity.
    """

    passes: int = 0
    rows_scored: int = 0


_COUNTERS: list[SearchPassCounter] = []


@contextlib.contextmanager
def count_search_passes():
    """Context manager: count search passes of enclosed refinements."""
    cnt = SearchPassCounter()
    _COUNTERS.append(cnt)
    try:
        yield cnt
    finally:
        _COUNTERS.remove(cnt)


def record_search_passes(passes: int, rows: int) -> None:
    """Credit ``passes`` searches over ``rows`` rows to active hooks."""
    for cnt in _COUNTERS:
        cnt.passes += int(passes)
        cnt.rows_scored += int(passes) * int(rows)


def _pick_method(method: Method, d_in: int, R: int, device) -> str:
    if method != "auto":
        return method
    if torch.device(device).type == "cuda":
        return "kernel"
    # dense ΔL is R*d*d fp32 — keep it under ~256MB
    if R * d_in * d_in * 4 <= 256 * 2**20:
        return "dense"
    return "chunked"


def _pick_k(k_swaps: int | None, d_in: int, block: int | None) -> int:
    """Resolve the ``k_swaps`` knob (None = auto = 8), clamped to [1, d_in]."""
    k = 8 if k_swaps is None else k_swaps
    if k < 1:
        raise ValueError(f"k_swaps must be >= 1, got {k_swaps}")
    return max(1, min(k, d_in))


def _best_swap(method: str, block: int | None, chunk: int, w, m, c, G):
    if block is not None:
        return sm.best_swap_nm(w, m, c, G, block=block)
    if method == "dense":
        return sm.best_swap_dense(w, m, c, G)
    if method == "kernel":
        from repro_torch.kernels import ops

        return ops.swap_argmin(w, m, c, G)
    return sm.best_swap_chunked(w, m, c, G, chunk=chunk)


def _topk_swaps(method: str, block: int | None, chunk: int, k: int,
                w, m, c, G):
    if block is not None:
        return sm.topk_swaps_nm(w, m, c, G, block=block, k=k)
    if method == "dense":
        return sm.topk_swaps_dense(w, m, c, G, k=k)
    if method == "kernel":
        from repro_torch.kernels import ops

        return ops.swap_topk(w, m, c, G, k=k)
    return sm.topk_swaps_chunked(w, m, c, G, k=k, chunk=chunk)


def _commit_gram(G, *, method, block, k_swaps, commit_mode):
    """G's ``ops.GramFacts`` where the kernel's candidate commit will run
    (taken once per refinement, not per pass), else None."""
    if k_swaps == 1 or block is not None or commit_mode != "candidates" \
            or method != "kernel":
        return None
    from repro_torch.kernels import ops

    return ops.gram_facts(G)


def _swap_step(w, m, c, loss, swaps, G, *, eps, method, block, chunk,
               k_swaps, commit_mode: str = "columns", gram=None):
    """One search pass + commit. Returns (m, c, loss, swaps, row_accepted).

    ``k_swaps == 1`` keeps the argmin + ``apply_swap`` path; ``k_swaps > 1``
    runs one top-k search, then the column-rescored commit (unstructured,
    ``"columns"``), the kernel's candidate commit (unstructured,
    ``"candidates"`` on ``kernel``; ``gram`` from ``_commit_gram``) or the
    candidate-space commit.
    """
    if k_swaps == 1:
        dl, u, p = _best_swap(method, block, chunk, w, m, c, G)
        m, c, acc = sm.apply_swap(w, m, c, G, dl, u, p, eps=eps)
        loss = torch.where(acc, loss + dl, loss)
        return m, c, loss, swaps + acc.to(swaps.dtype), acc
    if block is None and commit_mode == "columns":
        dl, u, p = _topk_swaps(method, block, chunk, k_swaps, w, m, c, G)
        m, c, dsum, nacc = sm.commit_swaps_columns(w, m, c, G, dl, p, eps=eps)
    elif method == "kernel" and block is None:
        from repro_torch.kernels import ops

        m, c, dsum, nacc = ops.swap_topk_commit(w, m, c, G, k=k_swaps, eps=eps,
                                                gram=gram)
    else:
        dl, u, p = _topk_swaps(method, block, chunk, k_swaps, w, m, c, G)
        m, c, dsum, nacc = sm.commit_swaps(w, m, c, G, dl, u, p, eps=eps)
    return m, c, loss + dsum, swaps + nacc, nacc > 0


def _init_carry(w, m0, G):
    """Initial (c, loss) for a row block — the one O(R·d²) matmul, left to
    ``torch.matmul`` (run with TF32 off). The compacted loop calls it at
    the same block shapes as the plain one, then gathers rows from it."""
    return sm.correlation_vector(w, m0, G), sm.row_loss(w, m0, G)


def _refine_carry(w, m, c, loss, swaps, G, *, n_iter: int, eps: float,
                  method: str, block: int | None, chunk: int, k_swaps: int,
                  commit_mode: str = "columns", gram=None):
    """Run up to ``n_iter`` passes from a carry; stop once no row accepts.

    Returns (m, c, loss, swaps, t, row_alive): ``t`` = passes executed,
    ``row_alive`` = whether each row's LAST pass accepted a swap (rows are
    independent, so False certifies that row converged).
    """
    alive = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
    t = 0
    while t < n_iter:
        m, c, loss, swaps, alive = _swap_step(
            w, m, c, loss, swaps, G, eps=eps, method=method, block=block,
            chunk=chunk, k_swaps=k_swaps, commit_mode=commit_mode, gram=gram)
        t += 1
        if not bool(alive.any()):
            break
    return m, c, loss, swaps, t, alive


def _refine_block(w, m0, G, *, t_max: int, eps: float, method: str,
                  block: int | None, chunk: int, track_history: bool,
                  k_swaps: int = 1, commit_mode: str = "columns", gram=None):
    """Refine one block of rows. Returns (m, loss0, loss, swaps, t, hist).

    Early-exits once no row accepts (one host read per pass); with
    ``track_history`` runs all ``t_max`` passes and records the mean loss.
    ``gram``: G's ``_commit_gram``, taken here when not given.
    """
    c, loss0 = _init_carry(w, m0, G)
    swaps = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
    if gram is None:
        gram = _commit_gram(G, method=method, block=block, k_swaps=k_swaps,
                            commit_mode=commit_mode)
    kw = dict(eps=eps, method=method, block=block, chunk=chunk,
              k_swaps=k_swaps, commit_mode=commit_mode, gram=gram)
    if not track_history:
        m, _, loss, swaps, t, _ = _refine_carry(w, m0, c, loss0, swaps, G,
                                                n_iter=t_max, **kw)
        return m, loss0, loss, swaps, t, None
    m, loss, hist = m0, loss0, []
    for _ in range(t_max):
        m, c, loss, swaps, _ = _swap_step(w, m, c, loss, swaps, G, **kw)
        hist.append(loss.mean())
    return m, loss0, loss, swaps, t_max, torch.stack(hist) if hist else None


# ---------------------------------------------------------------------------
# active-row compaction
# ---------------------------------------------------------------------------


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _gather_rows(state: dict, idx: list[torch.Tensor]) -> dict:
    """Per-instance row gather: x (N, R, ...) + idx[i] (R',) -> (N, R', ...)."""
    return {k: torch.stack([x[i].index_select(0, ii) for i, ii in enumerate(idx)])
            for k, x in state.items()}


def _scatter_rows(state: dict, sub: dict, idx: list[torch.Tensor]) -> dict:
    """Inverse of ``_gather_rows``, in place; duplicate indices write equal
    values."""
    for k, x in state.items():
        for i, ii in enumerate(idx):
            x[i].index_copy_(0, ii, sub[k][i])
    return state


def refine_stacked_compacted(W, M0, G, *, t_max: int, eps: float,
                             method: str, block: int | None, chunk: int,
                             k_swaps: int, compact_every: int,
                             commit_mode: str = "columns",
                             row_block: int | None = None):
    """Stacked refinement with active-row compaction.

    W, M0: (N, R, d); G: (N, d, d). Every ``compact_every`` passes the
    working set drops rows whose last pass accepted nothing, per instance;
    the next segment scores only surviving rows. Working-set sizes bucket
    to powers of two; pad slots repeat an instance's first active row.
    Instances run one after another, each until its own rows settle (the
    reference vmaps them, running no-op passes on settled lanes); a
    segment's pass count is the maximum over instances, as there.

    Returns (M, L0, L, swaps, passes): stacked results + total search
    passes executed.
    """
    N, R, d = W.shape
    rb = row_block or R
    true_R = R
    pad = (-R) % rb
    if pad:
        # converged dummy rows, as the uncompacted path pads them, so
        # _init_carry runs at the same block shapes
        W = torch.cat([W, W.new_zeros(N, pad, d)], dim=1)
        M0 = torch.cat([M0, M0.new_ones(N, pad, d)], dim=1)
        R += pad
    Cs, Ls = [], []
    for i in range(N):
        cs, ls = zip(*(_init_carry(W[i, lo:lo + rb], M0[i, lo:lo + rb], G[i])
                       for lo in range(0, R, rb)))
        Cs.append(torch.cat(cs))
        Ls.append(torch.cat(ls))
    L0 = torch.stack(Ls)
    state = {"m": M0.clone(), "c": torch.stack(Cs), "l": L0.clone(),
             "s": torch.zeros((N, R), dtype=torch.int64, device=W.device)}

    grams = [_commit_gram(G[i], method=method, block=block, k_swaps=k_swaps,
                          commit_mode=commit_mode) for i in range(N)]
    active = [np.arange(R)] * N
    done, passes = 0, 0
    while done < t_max and any(a.size for a in active):
        width = _bucket(max(a.size for a in active))
        if width >= R:                      # nothing to compact away yet
            width = R
            idx = np.tile(np.arange(R), (N, 1))
            reals = [R] * N
        else:
            idx = np.stack([
                np.concatenate([a, np.full(width - a.size,
                                           a[0] if a.size else 0)])
                for a in active])
            reals = [a.size for a in active]
        idx_t = [torch.as_tensor(ii, dtype=torch.int64, device=W.device)
                 for ii in idx]
        seg = min(compact_every, t_max - done)
        sub = _gather_rows(state, idx_t)
        wg = _gather_rows({"w": W}, idx_t)["w"]
        outs = [_refine_carry(
                    wg[i], sub["m"][i], sub["c"][i], sub["l"][i], sub["s"][i],
                    G[i], n_iter=seg, eps=eps, method=method, block=block,
                    chunk=chunk, k_swaps=k_swaps, commit_mode=commit_mode,
                    gram=grams[i])
                for i in range(N)]
        stack = lambda j: torch.stack([o[j] for o in outs])
        _scatter_rows(state, {"m": stack(0), "c": stack(1), "l": stack(2),
                              "s": stack(3)}, idx_t)
        t_host = max(o[4] for o in outs)
        record_search_passes(t_host, N * width)
        passes += t_host
        alive = stack(5).cpu().numpy()
        # next working set: the gathered rows whose last pass accepted
        active = [idx[i, :reals[i]][alive[i, :reals[i]]] for i in range(N)]
        if t_host < seg:        # every gathered row converged mid-segment
            break
        done += seg
    trim = lambda x: x[:, :true_R]
    return (trim(state["m"]), trim(L0), trim(state["l"]), trim(state["s"]),
            passes)


def refine(
    W: torch.Tensor,
    G: torch.Tensor,
    mask_init: torch.Tensor,
    pattern: masks_lib.Pattern,
    *,
    t_max: int = 100,
    eps: float = 0.0,
    method: Method = "auto",
    chunk: int = 512,
    row_block: int | None = None,
    track_history: bool = False,
    k_swaps: int = 1,
    compact_every: int = 0,
    commit_mode: str = "columns",
) -> RefineResult:
    """Run SparseSwaps on a full weight matrix.

    Rows are processed in blocks of ``row_block`` (None = all at once); a
    partial last block is padded with converged dummy rows (zero weights
    under a keep-all mask — no candidate is ever feasible) and sliced
    back. ``k_swaps``: candidate swaps committed per search pass;
    ``t_max`` bounds search PASSES.

    ``compact_every = S``: gather converged rows out of the working set
    every S passes (bitwise the same masks, swaps and losses; fewer rows
    scored late in the run). Incompatible with ``track_history``.

    ``commit_mode`` (k > 1, unstructured only): ``"columns"`` re-searches
    the best u per candidate column; ``"candidates"`` re-scores the
    searched pairs in O(R·k²) candidate space (in the CUDA commit kernel
    on the ``kernel`` backend). N:M always commits in candidate space.
    """
    if compact_every and track_history:
        raise ValueError("compact_every is incompatible with track_history")
    if commit_mode not in COMMIT_MODES:
        raise ValueError(f"unknown commit_mode {commit_mode!r}; "
                         f"have {COMMIT_MODES}")
    d_out, d_in = W.shape
    block = pattern.block(d_in)
    meth = _pick_method(method, d_in, row_block or d_out, W.device)
    k = _pick_k(k_swaps, d_in, block)
    rb = row_block or d_out

    W32 = W.float()
    M32 = mask_init.float()
    G32 = G.float()
    pad = (-d_out) % rb
    if pad:
        W32 = torch.cat([W32, W32.new_zeros(pad, d_in)])
        M32 = torch.cat([M32, M32.new_ones(pad, d_in)])

    if compact_every:
        m, l0, l1, swaps, passes = refine_stacked_compacted(
            W32[None], M32[None], G32[None], t_max=t_max, eps=eps,
            method=meth, block=block, chunk=chunk, k_swaps=k,
            compact_every=compact_every, row_block=rb,
            commit_mode=commit_mode)
        return RefineResult(
            mask=m[0, :d_out], loss_init=l0[0, :d_out],
            loss_final=l1[0, :d_out], swaps=swaps[0, :d_out], iters=passes)

    outs = []
    gram = _commit_gram(G32, method=meth, block=block, k_swaps=k,
                        commit_mode=commit_mode)
    for lo in range(0, W32.shape[0], rb):
        out = _refine_block(
            W32[lo:lo + rb], M32[lo:lo + rb], G32, t_max=t_max, eps=eps,
            method=meth, block=block, chunk=chunk,
            track_history=track_history, k_swaps=k, commit_mode=commit_mode,
            gram=gram)
        record_search_passes(out[4], rb)
        outs.append(out)
    cat = lambda i: torch.cat([o[i] for o in outs])[:d_out]
    hist = None
    if track_history:
        # mean over the true rows: pad rows sit at loss 0
        hist = sum(o[5] * rb for o in outs) / d_out
    return RefineResult(
        mask=cat(0), loss_init=cat(1), loss_final=cat(2), swaps=cat(3),
        iters=max(o[4] for o in outs), history=hist)


def refine_layer(
    W: torch.Tensor,
    G: torch.Tensor,
    pattern: masks_lib.Pattern,
    *,
    warmstart: str = "wanda",
    t_max: int = 100,
    eps: float = 0.0,
    method: Method = "auto",
    row_block: int | None = None,
    k_swaps: int = 1,
    compact_every: int = 0,
) -> RefineResult:
    """Convenience: warmstart + refine in one call (the paper's pipeline)."""
    from .warmstart import warmstart_mask

    m0 = warmstart_mask(W, G, pattern, criterion=warmstart)
    return refine(W, G, m0, pattern, t_max=t_max, eps=eps, method=method,
                  row_block=row_block, k_swaps=k_swaps,
                  compact_every=compact_every)
