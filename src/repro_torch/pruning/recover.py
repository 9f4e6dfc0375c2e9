"""Post-prune recovery: only the ``RecoverSpec`` dataclass so far.

A recipe may attach a recovery pass (PERP: retrain a small selection of
params under the refined masks); ``RecoverSpec`` is what its JSON carries,
so recipes round-trip between the two packages. Running recovery is
training work that is not ported yet (ROADMAP A3): ``plan_pruning``
raises ``NotImplementedError`` on a recipe that asks for it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

SELECTIONS = ("norms", "biases", "norms_biases", "all_masked", "lora")

_SPEC_KEYS = ("select", "steps", "lr", "weight_decay", "clip_norm",
              "warmup_frac", "min_lr_frac", "b1", "b2", "batch_size",
              "seq_len", "seed", "lora_rank")


@dataclasses.dataclass(frozen=True)
class RecoverSpec:
    """What to retrain after pruning, and how (the reference's fields)."""

    select: str = "norms_biases"
    steps: int = 50
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    warmup_frac: float = 0.1
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    batch_size: int = 4
    seq_len: int = 128
    seed: int = 0
    lora_rank: int = 4

    def __post_init__(self):
        if self.select not in SELECTIONS:
            raise ValueError(f"unknown select {self.select!r}; "
                             f"have {SELECTIONS}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if self.lora_rank < 1:
            raise ValueError(f"lora_rank must be >= 1, got {self.lora_rank}")

    def to_json_dict(self) -> dict:
        return {k: getattr(self, k) for k in _SPEC_KEYS}

    @classmethod
    def from_json_dict(cls, d: dict) -> "RecoverSpec":
        unknown = set(d) - set(_SPEC_KEYS)
        if unknown:
            raise ValueError(f"unknown RecoverSpec keys {sorted(unknown)}")
        kw = dict(d)
        for k in ("steps", "batch_size", "seq_len", "seed", "lora_rank"):
            if k in kw:
                kw[k] = int(kw[k])
        return cls(**kw)

    def fingerprint(self) -> str:
        """Content hash of the spec (the reference's recovery ckpt key)."""
        return hashlib.sha256(json.dumps(
            self.to_json_dict(), sort_keys=True).encode()).hexdigest()[:16]
