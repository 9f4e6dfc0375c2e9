"""Core of the paper: SparseSwaps mask refinement and its warmstarts."""
from .masks import NM, Pattern, PerRow, make_mask, parse_pattern, validate_mask
from .gram import GramState, feature_norms, update_from_acts
from .warmstart import warmstart_mask
from .sparseswaps import RefineResult, refine, refine_layer
from .objective import layer_loss, layer_loss_direct, relative_error_reduction

__all__ = [
    "NM", "Pattern", "PerRow", "make_mask", "parse_pattern", "validate_mask",
    "GramState", "feature_norms", "update_from_acts",
    "warmstart_mask", "RefineResult", "refine", "refine_layer",
    "layer_loss", "layer_loss_direct", "relative_error_reduction",
]
