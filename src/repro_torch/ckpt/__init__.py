"""Atomic checkpoints in the reference's on-disk format (numpy only)."""
from .store import latest_valid, restore, save, steps, validate

__all__ = ["latest_valid", "restore", "save", "steps", "validate"]
