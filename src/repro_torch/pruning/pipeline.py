"""The one-call pruning entry point, a shim over recipe -> plan -> execute.

    report = prune_model(api, params, batches, pattern,
                         warmstart="wanda", method="sparseswaps", t_max=100)
    masks  = report.masks          # tree for api.loss(..., masks=masks)

``prune_model`` is ``PruneRecipe.single`` -> ``plan_pruning`` ->
``PruneExecutor.run``, as in the reference. Pass ``taps`` (from
``calibrate.accumulate``) to skip calibration — the tests feed both
packages identical Grams this way. ``ckpt_dir`` opts into the executor's
group-granular resume.

Methods (the ``engine`` registry): "none" (warmstart only),
"sparseswaps", "dsnot", "sparsegpt". ``mesh`` (``launch.mesh``) shards
calibration over the data axes and the sparseswaps refinement over the
mesh, with the single-device masks bitwise.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.core import masks as masks_lib
from repro_torch.models import ModelApi

from .engine import DEFAULT_GRAM_BUDGET
from .executor import (PruneCallback, PruneExecutor, PruneReport,
                       PrintProgress, SiteReport)
from .plan import plan_pruning
from .recipe import PruneRecipe

__all__ = ["PruneCallback", "PruneExecutor", "PruneReport", "PrintProgress",
           "SiteReport", "prune_model"]


def prune_model(
    api: ModelApi,
    params: dict,
    calib_batches: Iterable[dict] | None,
    pattern: masks_lib.Pattern,
    *,
    method: str = "sparseswaps",
    warmstart: str = "wanda",
    t_max: int = 100,
    k_swaps: int | None = None,
    compact_every: int | None = None,
    taps: dict | None = None,
    progress: bool = False,
    mesh=None,
    gram_budget_bytes: int = DEFAULT_GRAM_BUDGET,
    ckpt_dir=None,
    callback: PruneCallback | None = None,
) -> PruneReport:
    """Full pipeline with one global rule. Pass ``taps`` to skip calibration.

    ``k_swaps`` (None = auto, 8): swaps committed per search pass;
    ``t_max`` bounds passes, so the swap budget is ``t_max · k_swaps``.
    ``compact_every``: active-row compaction period (``core.sparseswaps``).
    ``mesh``: refine over this mesh; a site whose fp32 Gram exceeds
    ``gram_budget_bytes`` takes the column-sharded refiner.
    """
    recipe = PruneRecipe.single(pattern, method=method, warmstart=warmstart,
                                t_max=t_max, k_swaps=k_swaps)
    plan = plan_pruning(api, params, recipe, mesh=mesh,
                        gram_budget_bytes=gram_budget_bytes,
                        compact_every=compact_every)
    if callback is None and progress:
        callback = PrintProgress()
    ex = PruneExecutor(api, params, plan, taps=taps, ckpt_dir=ckpt_dir,
                       callback=callback)
    return ex.run(calib_batches)
