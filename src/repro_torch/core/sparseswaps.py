"""SparseSwaps (paper Algorithm 1): monotone swap refinement, 1- and k-swap.

Row-batched: all per-row state is laid out (R, d_in) with the Gram matrix
G (d_in, d_in) shared. Three swap-search backends:

* ``dense``   — materialize ΔL (R, d, d). Reference; small d only.
* ``chunked`` — stream over p-chunks of G; O(R·d·chunk) memory.
* ``kernel``  — the hand-written CUDA kernels (``repro_torch.kernels``):
  ``swap_argmin`` for k = 1, ``swap_topk`` for the k > 1 candidate search.
  On a CPU tensor the wrappers take their plain PyTorch versions.

``method="auto"`` picks ``kernel`` for CUDA tensors and keeps the
reference's CPU rule otherwise (dense while R·d²·4 ≤ 256 MB, else
chunked). N:M patterns always use the block-diagonal search.

k-swap refinement (``k_swaps > 1``): every O(R·d²) search returns the k
best candidate columns per row, and ``swap_math.commit_swaps_columns``
commits them greedily, re-pairing each column's u against the updated
state (N:M commits in candidate space with ``commit_swaps``). Each pass
stays exactly monotone; a pass that accepts nothing certifies a 1-swap
fixed point.

The refinement loop is a Python loop with one host read per pass (does
any row still accept?), so it executes exactly the reference's number of
passes. Losses are tracked incrementally: L_{t+1} = L_t + ΣΔL*.

Search-pass accounting: wrap a refinement in
``with sparseswaps.count_search_passes() as cnt:`` to count the search
passes (and row·pass volume) actually executed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Literal

import torch

from . import masks as masks_lib
from . import swap_math as sm

Method = Literal["auto", "dense", "chunked", "kernel"]


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


def _swap_step(w, m, c, loss, swaps, G, *, eps, method, block, chunk,
               k_swaps):
    """One search pass + commit. Returns (m, c, loss, swaps, row_accepted).

    ``k_swaps == 1`` keeps the argmin + ``apply_swap`` path; ``k_swaps > 1``
    runs one top-k search, then the column-rescored commit (unstructured)
    or the candidate-space commit (N:M).
    """
    if k_swaps == 1:
        dl, u, p = _best_swap(method, block, chunk, w, m, c, G)
        m, c, acc = sm.apply_swap(w, m, c, G, dl, u, p, eps=eps)
        loss = torch.where(acc, loss + dl, loss)
        return m, c, loss, swaps + acc.to(swaps.dtype), acc
    dl, u, p = _topk_swaps(method, block, chunk, k_swaps, w, m, c, G)
    if block is None:
        m, c, dsum, nacc = sm.commit_swaps_columns(w, m, c, G, dl, p, eps=eps)
    else:
        m, c, dsum, nacc = sm.commit_swaps(w, m, c, G, dl, u, p, eps=eps)
    return m, c, loss + dsum, swaps + nacc, nacc > 0


def _init_carry(w, m0, G):
    """Initial (c, loss) for a row block — the one O(R·d²) matmul, left to
    ``torch.matmul`` (run with TF32 off)."""
    return sm.correlation_vector(w, m0, G), sm.row_loss(w, m0, G)


def _refine_block(w, m0, G, *, t_max: int, eps: float, method: str,
                  block: int | None, chunk: int, track_history: bool,
                  k_swaps: int = 1):
    """Refine one block of rows. Returns (m, loss0, loss, swaps, t, hist).

    Early-exits once no row accepts (one host read per pass); with
    ``track_history`` runs all ``t_max`` passes and records the mean loss.
    """
    c, loss0 = _init_carry(w, m0, G)
    m, loss = m0, loss0
    swaps = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
    hist = []
    t = 0
    while t < t_max:
        m, c, loss, swaps, acc = _swap_step(
            w, m, c, loss, swaps, G, eps=eps, method=method, block=block,
            chunk=chunk, k_swaps=k_swaps)
        t += 1
        if track_history:
            hist.append(loss.mean())
        elif not bool(acc.any()):
            break
    return m, loss0, loss, swaps, t, (torch.stack(hist) if hist else None)


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
) -> RefineResult:
    """Run SparseSwaps on a full weight matrix.

    Rows are processed in blocks of ``row_block`` (None = all at once); a
    partial last block is padded with converged dummy rows (zero weights
    under a keep-all mask — no candidate is ever feasible) and sliced
    back. ``k_swaps``: candidate swaps committed per search pass;
    ``t_max`` bounds search PASSES.
    """
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

    outs = []
    for lo in range(0, W32.shape[0], rb):
        out = _refine_block(
            W32[lo:lo + rb], M32[lo:lo + rb], G32, t_max=t_max, eps=eps,
            method=meth, block=block, chunk=chunk,
            track_history=track_history, k_swaps=k)
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
) -> RefineResult:
    """Convenience: warmstart + refine in one call (the paper's pipeline)."""
    from .warmstart import warmstart_mask

    m0 = warmstart_mask(W, G, pattern, criterion=warmstart)
    return refine(W, G, m0, pattern, t_max=t_max, eps=eps, method=method,
                  row_block=row_block, k_swaps=k_swaps)
