"""Batched sparse serving: pack once, prefill + greedy decode.

The reference's ``repro.serve`` also exports its scheduler, load
generator, sampling and fault injection; those are not ported yet
(ROADMAP A2).
"""
from .engine import FORMATS, ServeEngine, ServeResult, bench_rows, next_pow2

__all__ = ["FORMATS", "ServeEngine", "ServeResult", "bench_rows",
           "next_pow2"]
