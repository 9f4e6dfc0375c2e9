"""Group refinement engine: one call per SiteGroup.

The paper's refiners are row-parallel. The reference vmaps each site
group's N instances (layers) into one jit call; the port loops over the
instances, each on its full (d_out, d_in) matrix, and credits search
passes exactly as the reference does (per row block: the max over
instances, over N·rows). Methods plug in through a registry::

    @register("sparseswaps")
    def _refine_sparseswaps(W, gram, pattern, ctx) -> GroupResult: ...

Registered: ``none`` (warmstart only), ``sparseswaps`` (with active-row
compaction under ``ctx.compact_every``), ``dsnot`` (runs off moments
alone) and ``sparsegpt`` (mask + updated weights).
``refine_instance`` / ``refine_group_reference`` keep the per-instance
loop the batched engine is held against.

Mesh dispatch (``ctx.mesh``): the sparseswaps refiner routes each
instance through ``distributed.refine_rows_sharded`` (rows over every
mesh axis, G replicated). Unstructured sites whose fp32 Gram exceeds
``ctx.gram_budget_bytes`` (granite-34b's and the VLM's w_down) take the
column-sharded ``refine_g_sharded`` instead, on this rank's (d, d / n)
column block (``distributed.gram_split``; the executor hands it over,
cut from calibration's "model" shard), warmstarted from the diagonal
gathered from the blocks. The rows regime gives the single-device masks
bitwise; the Gram regime gives them wherever the ΔL gaps exceed the
rounding of its block-by-block initial carry.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core import masks as masks_lib
from repro_torch.core import sparseswaps
from repro_torch.core import swap_math as sm
from repro_torch.core.dsnot import _dsnot_rows, dsnot as _dsnot
from repro_torch.core.sparsegpt import sparsegpt as _sparsegpt
from repro_torch.core.warmstart import warmstart_mask

from repro_torch.dist import groups as groups_lib

from . import distributed
from . import sites as sites_lib

CHUNK = 512   # p-columns per step of the CPU chunked search
# G replicated on every rank while its rows refine: at most 1 GiB of fp32
DEFAULT_GRAM_BUDGET = 1 << 30


@dataclasses.dataclass(frozen=True)
class RefineContext:
    """Per-run knobs every refiner sees.

    ``k_swaps``: candidate swaps committed per search pass (None = auto,
    8). ``t_max`` bounds search PASSES. ``compact_every``: gather converged
    rows out of the working set every S passes (None/0 = off; not on a
    mesh). The search runs the CUDA kernels for tensors on the card and
    the reference's dense/chunked rule on the CPU. ``mesh``: refine
    sparseswaps groups over this mesh (``launch.mesh``);
    ``gram_budget_bytes``: the largest fp32 Gram the rows regime
    replicates; a larger one refines Gram-sharded, each rank holding its
    column block (``PrunePlan.refine_bytes_per_device`` reckons a rank's
    refine).
    """

    warmstart: str = "wanda"
    t_max: int = 100
    eps: float = 0.0
    k_swaps: int | None = None
    compact_every: int | None = None
    mesh: object = None
    gram_budget_bytes: int = DEFAULT_GRAM_BUDGET

    def with_overrides(self, **overrides) -> "RefineContext":
        """Per-group context: replace only the knobs a recipe rule sets
        (``None`` means inherit)."""
        kept = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **kept) if kept else self


@dataclasses.dataclass
class GroupResult:
    """Refinement output for one SiteGroup."""

    masks: torch.Tensor          # (N, d_out, d_in)
    loss_init: torch.Tensor      # (N, d_out) exact row loss, warmstart
    loss_final: torch.Tensor     # (N, d_out) after refinement
    swaps: torch.Tensor          # (N, d_out) accepted swaps per row
    new_weights: torch.Tensor | None = None   # (N, d_out, d_in), sparsegpt


REFINERS: dict = {}


def register(name: str):
    """Register a group refiner under a method name."""

    def deco(fn):
        REFINERS[name] = fn
        return fn

    return deco


def refine_group(method: str, group: sites_lib.SiteGroup,
                 pattern: masks_lib.Pattern, ctx: RefineContext) -> GroupResult:
    """Refine every instance of ``group``."""
    if method not in REFINERS:
        raise ValueError(f"unknown method {method!r}; have {sorted(REFINERS)}")
    if group.gram.G is None and method != "dsnot":
        raise ValueError(
            f"method {method!r} needs full Gram statistics but group "
            f"{group.name!r} was calibrated at moments level — rebuild the "
            f"CalibSpec from the current plan (pruning.stats)")
    return REFINERS[method](group.weights, group.gram, pattern, ctx)


# ---------------------------------------------------------------------------
# per-instance building blocks
# ---------------------------------------------------------------------------

def _warmstart_batch(W, G, pattern, criterion):
    """(N, R, d) stacked warmstart masks; ``G`` may be the (N, d) diagonal."""
    return torch.stack([warmstart_mask(W[i].float(), G[i], pattern, criterion)
                        for i in range(W.shape[0])])


def _row_loss_batch(W, M, G):
    return torch.stack([sm.row_loss(W[i].float(), M[i], G[i])
                        for i in range(W.shape[0])])


def _row_loss_diag_batch(W, M, diag):
    """Diagonal (Jensen) proxy of the row loss: Σ_j c_j² G_jj.

    Used when only moments-level statistics exist (dsnot under a minimal
    ``CalibSpec``): exact for uncorrelated features, an upper bound
    otherwise — the reported losses are then proxies.
    """
    C = W.float() * (1.0 - M)
    return torch.einsum("nrj,nj->nr", C * C, diag.float())


def _sparsegpt_loss(W, W1, G):
    """||WX - W1X||² per row via G: the loss of (mask, updated weights)
    against the dense output."""
    diff = W.float() - W1
    return torch.einsum("ri,ij,rj->r", diff, G.float(), diff)


def _no_swaps(W):
    return torch.zeros(W.shape[:2], dtype=torch.int64, device=W.device)


# ---------------------------------------------------------------------------
# methods
# ---------------------------------------------------------------------------

@register("none")
def _refine_none(W, gram, pattern, ctx):
    """Warmstart mask only (= Wanda / RIA / magnitude baselines)."""
    m0 = _warmstart_batch(W, gram.G, pattern, ctx.warmstart)
    l0 = _row_loss_batch(W, m0, gram.G)
    return GroupResult(masks=m0, loss_init=l0, loss_final=l0,
                       swaps=_no_swaps(W))


@register("sparseswaps")
def _refine_sparseswaps(W, gram, pattern, ctx):
    """The paper's swap refinement (k-swap), per instance (or sharded
    over the mesh: ``_refine_sparseswaps_sharded``)."""
    if ctx.mesh is not None:
        return _refine_sparseswaps_sharded(W, gram, pattern, ctx)
    N, R, d = W.shape
    m0 = _warmstart_batch(W, gram.G, pattern, ctx.warmstart)
    # auto budgets against N·R rows, as the reference's batched call does
    meth = sparseswaps._pick_method("auto", d, N * R, W.device)
    block = pattern.block(d)
    k = sparseswaps._pick_k(ctx.k_swaps, d, block)

    if ctx.compact_every:
        m, l0, l1, swaps, _ = sparseswaps.refine_stacked_compacted(
            W.float(), m0, gram.G.float(), t_max=ctx.t_max, eps=ctx.eps,
            method=meth, block=block, chunk=CHUNK, k_swaps=k,
            compact_every=ctx.compact_every)
        return GroupResult(masks=m, loss_init=l0, loss_final=l1, swaps=swaps)

    outs = [sparseswaps._refine_block(
                W[i].float(), m0[i], gram.G[i], t_max=ctx.t_max, eps=ctx.eps,
                method=meth, block=block, chunk=CHUNK, track_history=False,
                k_swaps=k)
            for i in range(N)]
    sparseswaps.record_search_passes(max(o[4] for o in outs), N * R)
    stack = lambda j: torch.stack([o[j] for o in outs])
    return GroupResult(masks=stack(0), loss_init=stack(1),
                       loss_final=stack(2), swaps=stack(3))


@register("dsnot")
def _refine_dsnot(W, gram, pattern, ctx):
    """DSnoT baseline: surrogate-driven swaps from feature mean/variance.

    Runs off moments alone: with a full Gram the reported losses are the
    exact row objective; at moments level the warmstart scores from
    diag(G) (the same masks — Wanda/RIA read only the diagonal) and the
    losses fall back to the diagonal proxy.
    """
    d = W.shape[2]
    g_or_diag = gram.G if gram.G is not None else gram.gram_diag
    row_loss = (_row_loss_batch if gram.G is not None
                else _row_loss_diag_batch)
    m0 = _warmstart_batch(W, g_or_diag, pattern, ctx.warmstart)
    l0 = row_loss(W, m0, g_or_diag)
    block = pattern.block(d)
    mean, var, ex2 = gram.mean, gram.variance, gram.ex2
    m1 = torch.stack([
        _dsnot_rows(W[i].float(), m0[i], mean[i], var[i], ex2[i],
                    t_max=ctx.t_max, block=block)
        for i in range(W.shape[0])])
    l1 = row_loss(W, m1, g_or_diag)
    return GroupResult(masks=m1, loss_init=l0, loss_final=l1,
                       swaps=_no_swaps(W))


@register("sparsegpt")
def _refine_sparsegpt(W, gram, pattern, ctx):
    """SparseGPT baseline: OBS mask + weight update, per instance."""
    m0 = _warmstart_batch(W, gram.G, pattern, ctx.warmstart)
    l0 = _row_loss_batch(W, m0, gram.G)
    outs = [_sparsegpt(W[i], gram.G[i], pattern) for i in range(W.shape[0])]
    W1 = torch.stack([o[0] for o in outs])
    m1 = torch.stack([o[1] for o in outs])
    l1 = torch.stack([_sparsegpt_loss(W[i], W1[i], gram.G[i])
                      for i in range(W.shape[0])])
    return GroupResult(masks=m1, loss_init=l0, loss_final=l1,
                       swaps=_no_swaps(W), new_weights=W1)


# ---------------------------------------------------------------------------
# mesh dispatch (sparseswaps only: the distributed refiners implement it)
# ---------------------------------------------------------------------------

def _sharded_regime(pattern, d_in: int, mesh, budget: int) -> str:
    """"rows" unless G cannot be replicated, then "gram" (column-shard G).

    N:M always refines rows-sharded: its swaps stay within a block, so
    only G's block diagonal is read.
    """
    if pattern.block(d_in) is not None or d_in * d_in * 4 <= budget:
        return "rows"
    n = groups_lib.mesh_size(mesh)
    if d_in % n:
        warnings.warn(
            f"Gram ({d_in}x{d_in} fp32) exceeds the per-device replication "
            f"budget but d_in is not divisible by {n} devices — "
            "column-sharded fallback unavailable, replicating G anyway")
        return "rows"
    return "gram"


def _refine_sparseswaps_sharded(W, gram, pattern, ctx):
    """Each instance from its own warmstart through the mesh's refiner;
    every rank returns every row. No compaction here."""
    N, R, d = W.shape
    mesh = ctx.mesh
    regime = _sharded_regime(pattern, d, mesh, ctx.gram_budget_bytes)
    k = sparseswaps._pick_k(ctx.k_swaps, d, pattern.block(d))
    outs, m0s = [], []
    for i in range(N):
        Wi = W[i].float()
        Gi = gram.G[i]
        if regime == "gram":
            # Gi: this rank's column block; the warmstart reads diag(G)
            row_axes, col_axes = distributed.gram_split(mesh)
            m0 = warmstart_mask(Wi, distributed.gram_diag(Gi, mesh),
                                pattern, ctx.warmstart)
            out = distributed.refine_g_sharded(
                Wi, Gi, m0, pattern, mesh, t_max=ctx.t_max, eps=ctx.eps,
                row_axes=row_axes, col_axes=col_axes, k_swaps=k)
        else:
            m0 = warmstart_mask(Wi, Gi, pattern, ctx.warmstart)
            out = distributed.refine_rows_sharded(
                Wi, Gi, m0, pattern, mesh, t_max=ctx.t_max, eps=ctx.eps,
                chunk=CHUNK, k_swaps=k)
        sparseswaps.record_search_passes(ctx.t_max, R)
        outs.append(out)
        m0s.append(m0)
    stack = lambda j: torch.stack([o[j] for o in outs])
    m = stack(0)
    # the sharded loops do not count acceptances; each accepted swap flips
    # two entries, so the net mask distance / 2 (a lower bound)
    swaps = ((m - torch.stack(m0s)).abs().sum(2) / 2).to(torch.int64)
    return GroupResult(masks=m, loss_init=stack(1), loss_final=stack(2),
                       swaps=swaps)


# ---------------------------------------------------------------------------
# per-instance reference path (under test against the engine)
# ---------------------------------------------------------------------------

def refine_instance(W, gram: sites_lib.GramStats, pattern, *, method: str,
                    warmstart: str, t_max: int, eps: float, k_swaps=None,
                    compact_every=None):
    """Prune one (d_out, d_in) instance. Returns (mask, l0, l1, swaps, W')."""
    G = gram.G
    zeros = torch.zeros(W.shape[0], dtype=torch.int64, device=W.device)
    if G is None:
        if method != "dsnot":
            raise ValueError(f"method {method!r} needs full Gram statistics")
        diag = gram.gram_diag
        m0 = warmstart_mask(W, diag, pattern, criterion=warmstart)
        l0 = _row_loss_diag_batch(W[None], m0[None], diag[None])[0]
        m1 = _dsnot(W, m0, gram.mean, gram.variance, gram.ex2, pattern,
                    t_max=t_max)
        l1 = _row_loss_diag_batch(W[None], m1[None], diag[None])[0]
        return m1, l0, l1, zeros, None
    m0 = warmstart_mask(W, G, pattern, criterion=warmstart)
    l0 = sm.row_loss(W.float(), m0, G)

    if method == "none":
        return m0, l0, l0, zeros, None
    if method == "sparseswaps":
        k = sparseswaps._pick_k(k_swaps, W.shape[1], pattern.block(W.shape[1]))
        res = sparseswaps.refine(W, G, m0, pattern, t_max=t_max, eps=eps,
                                 k_swaps=k, compact_every=compact_every or 0)
        return res.mask, res.loss_init, res.loss_final, res.swaps, None
    if method == "dsnot":
        m1 = _dsnot(W, m0, gram.mean, gram.variance, gram.ex2, pattern,
                    t_max=t_max)
        return m1, l0, sm.row_loss(W.float(), m1, G), zeros, None
    if method == "sparsegpt":
        W1, m1 = _sparsegpt(W, G, pattern)
        return m1, l0, _sparsegpt_loss(W, W1, G), zeros, W1
    raise ValueError(f"unknown method {method!r}")


def refine_group_reference(method: str, group: sites_lib.SiteGroup,
                           pattern: masks_lib.Pattern,
                           ctx: RefineContext) -> GroupResult:
    """The per-instance Python loop, reshaped into a GroupResult."""
    outs = [refine_instance(
                group.weights[i], group.gram.instance(i), pattern,
                method=method, warmstart=ctx.warmstart, t_max=ctx.t_max,
                eps=ctx.eps, k_swaps=ctx.k_swaps,
                compact_every=ctx.compact_every)
            for i in range(group.n_instances)]
    stack = lambda j: torch.stack([o[j] for o in outs])
    return GroupResult(masks=stack(0), loss_init=stack(1),
                       loss_final=stack(2), swaps=stack(3),
                       new_weights=stack(4) if outs[0][4] is not None
                       else None)
