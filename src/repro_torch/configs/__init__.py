"""Config registry of the port: the reference's eleven — the dense family
(its four dense assigned architectures and llama31-8b, the paper's own),
the MoE family (mixtral-8x7b, granite-moe-3b-a800m), the hybrid family
(zamba2-7b), the RWKV6 model of the ssm family (rwkv6-1.6b) and the
cross-attention families (llama-3.2-vision-90b, seamless-m4t-medium),
each with its TINY.

``get(name)`` returns the full config; ``get_tiny(name)`` the reduced
same-family config the CPU tests instantiate.
"""
from __future__ import annotations

from . import (chatglm3_6b, granite_34b, granite_moe_3b, internlm2_20b,
               llama31_8b, llama32_vision_90b, minitron_4b, mixtral_8x7b,
               rwkv6_1b6, seamless_m4t_medium, zamba2_7b)
from .base import ArchConfig

# the reference registry's order
_MODULES = [chatglm3_6b, granite_34b, minitron_4b, internlm2_20b,
            mixtral_8x7b, granite_moe_3b, rwkv6_1b6, llama32_vision_90b,
            seamless_m4t_medium, zamba2_7b, llama31_8b]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
TINY: dict[str, ArchConfig] = {m.CONFIG.name: m.TINY for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_tiny(name: str) -> ArchConfig:
    return TINY[get(name).name]


__all__ = ["ARCHS", "TINY", "ArchConfig", "get", "get_tiny"]
