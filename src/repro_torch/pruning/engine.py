"""Group refinement engine: one call per SiteGroup.

The paper's refiners are row-parallel. The reference vmaps each site
group's N instances (layers) into one jit call; the port loops over the
instances, each on its full (d_out, d_in) matrix, and credits search
passes exactly as the reference does (per row block: the max over
instances, over N·rows). Methods plug in through a registry::

    @register("sparseswaps")
    def _refine_sparseswaps(W, gram, pattern, ctx) -> GroupResult: ...

Ported so far: ``none`` (warmstart only) and ``sparseswaps``. DSnoT,
SparseGPT, compaction and mesh-sharded refinement come later.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import masks as masks_lib
from repro_torch.core import sparseswaps
from repro_torch.core import swap_math as sm
from repro_torch.core.warmstart import warmstart_mask

from . import sites as sites_lib

CHUNK = 512   # p-columns per step of the CPU chunked search


@dataclasses.dataclass(frozen=True)
class RefineContext:
    """Per-run knobs every refiner sees.

    ``k_swaps``: candidate swaps committed per search pass (None = auto,
    8). ``t_max`` bounds search PASSES. The search runs the CUDA kernels
    for tensors on the card and the reference's dense/chunked rule on the
    CPU.
    """

    warmstart: str = "wanda"
    t_max: int = 100
    k_swaps: int | None = None


@dataclasses.dataclass
class GroupResult:
    """Refinement output for one SiteGroup."""

    masks: torch.Tensor          # (N, d_out, d_in)
    loss_init: torch.Tensor      # (N, d_out) exact row loss, warmstart
    loss_final: torch.Tensor     # (N, d_out) after refinement
    swaps: torch.Tensor          # (N, d_out) accepted swaps per row


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
    return REFINERS[method](group.weights, group.gram, pattern, ctx)


def _warmstart_batch(W, G, pattern, criterion):
    """(N, R, d) stacked warmstart masks."""
    return torch.stack([warmstart_mask(W[i].float(), G[i], pattern, criterion)
                        for i in range(W.shape[0])])


def _row_loss_batch(W, M, G):
    return torch.stack([sm.row_loss(W[i].float(), M[i], G[i])
                        for i in range(W.shape[0])])


@register("none")
def _refine_none(W, gram, pattern, ctx):
    """Warmstart mask only (= Wanda / RIA / magnitude baselines)."""
    m0 = _warmstart_batch(W, gram.G, pattern, ctx.warmstart)
    l0 = _row_loss_batch(W, m0, gram.G)
    return GroupResult(masks=m0, loss_init=l0, loss_final=l0,
                       swaps=torch.zeros(W.shape[:2], dtype=torch.int64,
                                         device=W.device))


@register("sparseswaps")
def _refine_sparseswaps(W, gram, pattern, ctx):
    """The paper's swap refinement (k-swap), per instance."""
    N, R, d = W.shape
    m0 = _warmstart_batch(W, gram.G, pattern, ctx.warmstart)
    # auto budgets against N·R rows, as the reference's batched call does
    meth = sparseswaps._pick_method("auto", d, N * R, W.device)
    block = pattern.block(d)
    k = sparseswaps._pick_k(ctx.k_swaps, d, block)
    outs = [sparseswaps._refine_block(
                W[i].float(), m0[i], gram.G[i], t_max=ctx.t_max, eps=0.0,
                method=meth, block=block, chunk=CHUNK, track_history=False,
                k_swaps=k)
            for i in range(N)]
    sparseswaps.record_search_passes(max(o[4] for o in outs), N * R)
    stack = lambda j: torch.stack([o[j] for o in outs])
    return GroupResult(masks=stack(0), loss_init=stack(1),
                       loss_final=stack(2), swaps=stack(3))
