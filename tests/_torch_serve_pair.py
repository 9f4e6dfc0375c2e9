"""Shared driver of the continuous-serving tests: one workload through the
reference's ``ContinuousScheduler`` and through the port's, step for
step, on tiny llama31-8b in fp32 (params from the reference, carried over
by ``convert``).

``drive`` submits requests on a fixed schedule, steps until the
scheduler is idle (or drained after a preemption signal) and records per
step the events a load generator reads (first tokens, prefill starts,
tokens, completions, waste, batch and queue sizes, expiries, evictions)
and the pools' ``used_bytes``, then the completions, counters, fired
faults, shipped bytes and the engine's shape keys. The two records must
be equal.
"""
import numpy as np
import jax

import repro.configs as jconfigs
import repro.models as jmodels
from repro import serve as jserve

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import models as tmodels
from repro_torch import serve as tserve

ARCH = "llama31-8b"
REF, PORT = jserve, tserve


def build_world() -> dict:
    jcfg = jconfigs.get_tiny(ARCH)
    japi = jmodels.build(jcfg)
    jparams = japi.init(jax.random.key(0))
    tcfg = tconfigs.get_tiny(ARCH)
    tapi = tmodels.build(tcfg)
    tparams = convert.from_numpy(jax.tree.map(np.asarray, jparams))
    return dict(cfg=tcfg, api=tapi, params=tparams,
                engines={REF: jserve.ServeEngine(japi, jparams, fmt="dense"),
                         PORT: tserve.ServeEngine(tapi, tparams, fmt="dense",
                                                  device="cpu")})


def prompt(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=n).astype(np.int32)


def sched(mod, engine, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("capacity", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("decode_chunk", 4)
    return mod.ContinuousScheduler(engine, **kw)


def _events(ev, sch) -> dict:
    pre = sch.prefill_pool
    return {
        "prefilled": list(ev.prefilled),
        "prefill_started": list(ev.prefill_started),
        "tokens": {int(r): [int(x) for x in v] for r, v in ev.tokens.items()},
        "completed": [(c.rid, c.session, [int(x) for x in c.tokens],
                       c.prompt_len, c.n_new, c.kept) for c in ev.completed],
        "n_active": ev.n_active, "n_queued": ev.n_queued,
        "wasted": ev.wasted_decode_tokens, "expired": list(ev.expired),
        "evicted": list(ev.evicted), "used_bytes": sch.pool.used_bytes,
        "prefill_used_bytes": None if pre is None else pre.used_bytes,
    }


def drive(mod, engine, reqs, *, per_step: int = 2, faults=None,
          clock_step: float | None = None, **kw) -> dict:
    """Run ``reqs`` — (prompt, max_new, sampling knobs dict, submit
    kwargs) — through ``mod``'s scheduler, ``per_step`` submissions
    before each step (0: all before the first), on a virtual clock that
    advances ``clock_step`` per step when given."""
    now = [0.0]
    if clock_step is not None:
        kw["clock"] = lambda: now[0]
    if faults is not None:
        kw["faults"] = mod.FaultPlan(**faults)
    sch = sched(mod, engine, **kw)
    steps, rids, i = [], [], 0
    try:
        for _ in range(10_000):
            if i >= len(reqs) and (sch.idle or sch.drained):
                break
            if not sch.draining:
                for _ in range(per_step or len(reqs)):
                    if i >= len(reqs):
                        break
                    p, n, knobs, skw = reqs[i]
                    r = sch.submit(p, n, sampling=mod.SamplingParams(
                        **knobs), **skw)
                    rids.append(r if isinstance(r, int)
                                else (r.rid, r.reason))
                    i += 1
            elif sch.drained:
                break
            steps.append(_events(sch.step(), sch))
            if clock_step is not None:
                now[0] += clock_step
        else:
            raise RuntimeError("drive did not converge")
    finally:
        engine.dispatch_hook = None
    done = {}
    for s in steps:
        for rid, _, toks, *_ in s["completed"]:
            done[rid] = toks
    return {"steps": steps, "rids": rids, "done": done,
            "counters": dict(sch.counters),
            "fired": [] if sch._injector is None else list(sch._injector.log),
            "shipped": sch.shipped_bytes, "keys": engine.compiled_fn_keys(),
            "idle": sch.idle, "drained": sch.drained}


def run_pair(world, reqs, **kw) -> dict:
    """The same workload through both schedulers: {REF: rec, PORT: rec}."""
    return {mod: drive(mod, world["engines"][mod], reqs, **kw)
            for mod in (REF, PORT)}


def assert_same(pair) -> None:
    ref, port = pair[REF], pair[PORT]
    assert len(port["steps"]) == len(ref["steps"])
    for n, (a, b) in enumerate(zip(ref["steps"], port["steps"])):
        assert b == a, f"step {n + 1}: port {b} != reference {a}"
    for key in ("rids", "done", "counters", "fired", "shipped", "keys",
                "idle", "drained"):
        assert port[key] == ref[key], key
