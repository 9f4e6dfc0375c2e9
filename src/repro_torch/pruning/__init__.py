"""Pruning pipeline: recipe -> plan -> execute (calibrate / refine / report).

``prune_model`` remains the one-call entry point (a single-rule recipe);
``PruneRecipe`` / ``plan_pruning`` / ``PruneExecutor`` expose the staged
API with per-site rules, dry-run cost tables and group-granular resume;
``recover`` runs PERP post-prune recovery on the result.
"""
from .calibrate import accumulate, calibration_batches
from .engine import (GroupResult, RefineContext, refine_group,
                     refine_group_reference, register)
from .evaluate import evaluate, perplexity, top1_accuracy, val_batches
from .executor import PruneCallback, PruneExecutor, PrintProgress
from .pipeline import PruneReport, SiteReport, prune_model
from .plan import PlannedGroup, PrunePlan, plan_pruning
from .recipe import PruneRecipe, ResolvedRule, SiteRule
from .recover import RecoverResult, RecoverSpec, recover
from .sites import (GramBatch, GramStats, SiteGroup, SiteSpec, TapSpec,
                    build_mask_tree, enumerate_sites, prunable_param_count,
                    site_specs, tap_specs)
from .stats import CalibSpec, CalibStats, accumulate_stats

__all__ = [
    "CalibSpec", "CalibStats", "GramBatch", "GramStats", "GroupResult",
    "PlannedGroup", "PrintProgress", "PruneCallback", "PruneExecutor",
    "PrunePlan", "PruneRecipe", "PruneReport", "RecoverResult",
    "RecoverSpec", "RefineContext", "ResolvedRule", "SiteGroup",
    "SiteReport", "SiteRule", "SiteSpec", "TapSpec", "accumulate",
    "accumulate_stats", "build_mask_tree", "calibration_batches",
    "enumerate_sites", "evaluate", "perplexity", "plan_pruning",
    "prunable_param_count", "prune_model", "recover", "refine_group",
    "refine_group_reference", "register", "site_specs", "tap_specs",
    "top1_accuracy", "val_batches",
]
