"""Pruning pipeline: calibrate -> enumerate sites -> refine -> report."""
from .calibrate import (CalibSpec, CalibStats, accumulate, accumulate_stats,
                        calibration_batches)
from .engine import GroupResult, RefineContext, refine_group, register
from .evaluate import evaluate, perplexity, top1_accuracy, val_batches
from .pipeline import PruneReport, SiteReport, prune_model
from .sites import GramBatch, SiteGroup, build_mask_tree, enumerate_sites

__all__ = [
    "CalibSpec", "CalibStats", "GramBatch", "GroupResult", "PruneReport",
    "RefineContext", "SiteGroup", "SiteReport", "accumulate",
    "accumulate_stats", "build_mask_tree", "calibration_batches",
    "enumerate_sites", "evaluate", "perplexity", "prune_model",
    "refine_group", "register", "top1_accuracy", "val_batches",
]
