"""Atomic checkpoints in the reference's on-disk format (numpy only)."""
from .store import (gc, latest_valid, restore, restore_latest,
                    restore_latest_like, restore_like, save, steps,
                    to_tensor, unflatten, validate)

__all__ = ["gc", "latest_valid", "restore", "restore_latest",
           "restore_latest_like", "restore_like", "save", "steps",
           "to_tensor", "unflatten", "validate"]
