"""Sparse serving runtime: engine (step fns over packed weights), scheduler
(continuous batching), kvcache (paged session storage), sampling,
faultinject (deterministic chaos plans for robustness testing), loadgen
(Poisson traffic on a virtual clock)."""
from .engine import FORMATS, ServeEngine, ServeResult, bench_rows, next_pow2
from .faultinject import FaultInjector, FaultPlan, ShipFault
from .kvcache import HostSpill, PagedKVCache
from .sampling import GREEDY, SamplingParams
from .scheduler import Completion, ContinuousScheduler, Rejected, StepEvents

__all__ = ["FORMATS", "ServeEngine", "ServeResult", "bench_rows",
           "next_pow2", "PagedKVCache", "HostSpill", "SamplingParams",
           "GREEDY", "ContinuousScheduler", "Completion", "StepEvents",
           "Rejected", "FaultPlan", "FaultInjector", "ShipFault"]
