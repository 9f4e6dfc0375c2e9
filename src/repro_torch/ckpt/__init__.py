"""Atomic checkpoints in the reference's on-disk format (numpy only)."""
from .store import (gc, latest_valid, restore, restore_latest, save, steps,
                    validate)

__all__ = ["gc", "latest_valid", "restore", "restore_latest", "save",
           "steps", "validate"]
