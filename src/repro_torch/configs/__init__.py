"""Config registry of the port: the dense family — the reference's four
dense assigned architectures and llama31-8b (the paper's own) — and the
MoE family (mixtral-8x7b, granite-moe-3b-a800m), the hybrid family
(zamba2-7b) and the RWKV6 model of the ssm family (rwkv6-1.6b), each with
its TINY.

``get(name)`` returns the full config; ``get_tiny(name)`` the reduced
same-family config the CPU tests instantiate.
"""
from __future__ import annotations

from . import (chatglm3_6b, granite_34b, granite_moe_3b, internlm2_20b,
               llama31_8b, minitron_4b, mixtral_8x7b, rwkv6_1b6, zamba2_7b)
from .base import ArchConfig

# the reference registry's order, the families not ported yet left out
_MODULES = [chatglm3_6b, granite_34b, minitron_4b, internlm2_20b,
            mixtral_8x7b, granite_moe_3b, rwkv6_1b6, zamba2_7b, llama31_8b]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
TINY: dict[str, ArchConfig] = {m.CONFIG.name: m.TINY for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_tiny(name: str) -> ArchConfig:
    return TINY[get(name).name]


__all__ = ["ARCHS", "TINY", "ArchConfig", "get", "get_tiny"]
