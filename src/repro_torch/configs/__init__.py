"""Config registry of the port: llama31-8b (the paper's own) and its TINY.

``get(name)`` returns the full config; ``get_tiny(name)`` the reduced
same-family config the CPU tests instantiate.
"""
from __future__ import annotations

from . import llama31_8b
from .base import ArchConfig

_MODULES = [llama31_8b]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
TINY: dict[str, ArchConfig] = {m.CONFIG.name: m.TINY for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_tiny(name: str) -> ArchConfig:
    return TINY[get(name).name]


__all__ = ["ARCHS", "TINY", "ArchConfig", "get", "get_tiny"]
