"""The one-call pruning entry point: calibrate -> sites -> refine -> report.

    report = prune_model(api, params, batches, pattern,
                         warmstart="wanda", method="sparseswaps", t_max=100)
    masks  = report.masks          # tree for api.loss(..., masks=masks)

A direct loop over the site groups, with the reference's single-rule
``prune_model`` signature for the calls this slice runs. Pass ``taps``
(from ``calibrate.accumulate``) to skip calibration — the tests feed both
packages identical Grams this way. Every group's masks are validated
against the pattern before the report is assembled.

Methods: "none" (warmstart only) and "sparseswaps". Recipes, plans,
resumable execution, mesh sharding and the dsnot/sparsegpt baselines are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import torch

from repro_torch.core import masks as masks_lib
from repro_torch.models import ModelApi

from . import calibrate
from . import engine as engine_lib
from . import sites as sites_lib


@dataclasses.dataclass
class SiteReport:
    name: str                    # site-group name
    labels: list[str]            # per-instance labels
    loss_init: torch.Tensor      # (N,) summed row loss per instance, warmstart
    loss_final: torch.Tensor     # (N,) after refinement
    swaps: torch.Tensor          # (N,) accepted swaps
    row_loss_init: torch.Tensor  # (N, d_out) per-row losses, warmstart
    row_loss_final: torch.Tensor  # (N, d_out) per-row losses, refined
    pattern: str = ""
    method: str = ""

    @property
    def error_reduction(self) -> torch.Tensor:
        return (self.loss_init - self.loss_final) / torch.clamp(
            self.loss_init, min=1e-30)


@dataclasses.dataclass
class PruneReport:
    masks: dict                  # tree for loss(..., masks=...)
    sites: list[SiteReport]
    method: str
    warmstart: str
    pattern: str
    wall_time_s: float

    def mean_error_reduction(self) -> float:
        """Mean relative per-layer error reduction (paper Tables 3/4)."""
        if not self.sites:
            return 0.0
        return float(torch.cat([s.error_reduction for s in self.sites]).mean())

    def total_loss(self, which: str = "final") -> float:
        key = {"init": "loss_init", "final": "loss_final"}[which]
        return float(sum(getattr(s, key).sum() for s in self.sites))

    def summary(self) -> str:
        lines = [f"method={self.method} warmstart={self.warmstart} "
                 f"pattern={self.pattern} wall={self.wall_time_s:.1f}s",
                 f"mean error reduction: {100*self.mean_error_reduction():.2f}%"]
        for s in self.sites:
            red = 100 * float(s.error_reduction.mean())
            lines.append(f"  {s.name:28s} n={len(s.labels):3d} "
                         f"err-reduction {red:6.2f}%")
        return "\n".join(lines)


@torch.no_grad()
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
    taps: dict | None = None,
    progress: bool = False,
) -> PruneReport:
    """Full pipeline with one global rule. Pass ``taps`` to skip calibration.

    ``k_swaps`` (None = auto, 8): swaps committed per search pass;
    ``t_max`` bounds passes, so the swap budget is ``t_max · k_swaps``.
    """
    t_start = time.time()
    if taps is None:
        if calib_batches is None:
            raise ValueError("no taps and no calib_batches to accumulate "
                             "them from")
        taps = calibrate.accumulate(api, params, calib_batches)
    ctx = engine_lib.RefineContext(warmstart=warmstart, t_max=t_max,
                                   k_swaps=k_swaps)
    groups = sites_lib.enumerate_sites(api.cfg, params, taps)
    site_masks: dict[str, torch.Tensor] = {}
    reports: list[SiteReport] = []
    for g in groups:
        res = engine_lib.refine_group(method, g, pattern, ctx)
        if not masks_lib.validate_mask(res.masks, pattern):
            raise ValueError(f"refiner {method!r} produced masks violating "
                             f"{masks_lib.format_pattern(pattern)!r} at "
                             f"group {g.name!r}")
        site_masks[g.name] = res.masks
        rep = SiteReport(
            name=g.name, labels=g.labels(),
            loss_init=res.loss_init.sum(1), loss_final=res.loss_final.sum(1),
            swaps=res.swaps.sum(1), row_loss_init=res.loss_init,
            row_loss_final=res.loss_final,
            pattern=masks_lib.format_pattern(pattern), method=method)
        reports.append(rep)
        if progress:
            red = 100 * float(rep.error_reduction.mean())
            print(f"  {rep.name:28s} err-reduction {red:6.2f}%")
    return PruneReport(
        masks=sites_lib.build_mask_tree(api.cfg, site_masks, groups),
        sites=reports, method=method, warmstart=warmstart,
        pattern=masks_lib.format_pattern(pattern),
        wall_time_s=time.time() - t_start)
