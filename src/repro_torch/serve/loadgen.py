"""Load generation: Poisson arrivals, virtual clock, serving metrics.

The core of the launcher's ``--load-bench`` and ``--chaos`` flags, as
in the reference.

**Workload.** ``make_workload`` draws a deterministic request trace from
``LoadConfig``: inter-arrival times are Exp(arrival_rate) (a Poisson
process over the ``duration_s`` window), prompt and output lengths are
uniform over inclusive bounds, token ids come from the same rng. The
trace is a plain list — both drivers replay the identical requests.

**Virtual clock.** Arrivals live on a simulated clock that advances by
the *measured wall time* of each scheduler step (or fixed-batch call):
a request "arrives" when the simulated clock passes its arrival time,
and every token is stamped with the simulated time its dispatch
completed; every engine dispatch ends in a device synchronize, so the
wall time is the device's. This folds real compute cost into queueing
behaviour without needing a real-time client harness; timestamps are
chunk-granular (a token's latency includes the dispatch it rode in on).
The disaggregated mode clocks its two lanes on separate timelines — see
``run_continuous``.

**Drivers.**

* ``run_continuous`` — the ``ContinuousScheduler``: requests join the
  decode batch as they arrive, leave when done.
* ``run_fixed`` — the baseline ``ServeEngine.generate`` path: requests
  queue until a batch of EQUAL prompt lengths is available (the fixed
  path's shape constraint), and the whole batch decodes the pow2 bucket
  of the group's longest output — stragglers wait, surplus tokens are
  waste. This is the honest cost of fixed-shape serving under ragged
  traffic, which is exactly what continuous batching removes.

**Metrics** (one dict per run): ``offered_tok_s`` counts every
*requested* generation token over the makespan, ``goodput_tok_s`` every
*delivered* token of completed requests — goodput ≤ offered by
construction. TTFT and per-token latency report p50/p99 over requests
(per-token latency for a request is its decode span divided by its
decoded tokens). Both drivers run the workload TWICE (a warm-up pass,
then a timed pass) so first-call costs never pollute the rows.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

import torch

from .engine import ServeEngine, next_pow2
from .faultinject import FaultPlan
from .sampling import GREEDY, SamplingParams
from .scheduler import ContinuousScheduler, Rejected


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """A deterministic synthetic traffic trace."""

    arrival_rate: float = 8.0          # requests / simulated second
    duration_s: float = 2.0            # arrival window (simulated)
    seed: int = 0
    prompt_len: tuple = (8, 24)        # inclusive uniform bounds
    output_len: tuple = (4, 16)
    sampling: SamplingParams = GREEDY
    vocab_size: int = 256
    # per-request lifecycle bounds on the SIMULATED clock (None = off):
    # deadline_s caps a request's total lifetime, queue_ttl_s its queue
    # wait — expiries are counted in the bench row, not served late
    deadline_s: float | None = None
    queue_ttl_s: float | None = None


@dataclasses.dataclass(frozen=True)
class LoadRequest:
    arrival: float
    prompt: np.ndarray
    max_new: int
    sampling: SamplingParams


def make_workload(cfg: LoadConfig) -> list:
    """Poisson arrivals with uniform prompt/output lengths, seeded."""
    rng = np.random.default_rng(cfg.seed)
    out, now = [], 0.0
    while True:
        now += float(rng.exponential(1.0 / cfg.arrival_rate))
        if now >= cfg.duration_s:
            return out
        s = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        n = int(rng.integers(cfg.output_len[0], cfg.output_len[1] + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=s).astype(np.int32)
        out.append(LoadRequest(arrival=now, prompt=prompt, max_new=n,
                               sampling=cfg.sampling))


def _metrics(workload, first_t, done_t, done_new, arrivals, makespan, *,
             start_t=None, wasted: int = 0, shipped: int = 0,
             counters: dict | None = None, leaked: int = 0):
    """Fold raw timestamps into the bench-row metric dict.

    ``start_t`` stamps when each request's prefill began, splitting TTFT
    into ``queue_wait`` (arrival -> prefill start) + ``prefill`` (start
    -> first token) — the two components sum to TTFT exactly, per
    request, so the percentiles are decomposable and the mean identity
    ``mean_ttft == mean_queue_wait + mean_prefill`` holds to float
    precision. ``wasted`` counts decode steps dispatched past request
    budgets (discarded tokens); ``shipped`` counts KV bytes that crossed
    pools (0 outside disaggregated mode). ``counters`` carries the
    scheduler's robustness tallies (shed / expired / cancelled /
    evicted) — zeros for drivers that have none (fixed batch).
    ``leaked`` counts KV bytes left in the pools after the run (0 for a
    run that freed every page; the fixed path has no pools).
    """
    start_t = start_t or {}
    c = counters or {}
    offered = sum(r.max_new for r in workload)
    delivered = sum(done_new.values())
    rids = sorted(first_t)
    ttft = [first_t[i] - arrivals[i] for i in rids]
    q_wait = [start_t.get(i, arrivals[i]) - arrivals[i] for i in rids]
    pre = [first_t[i] - start_t.get(i, arrivals[i]) for i in rids]
    per_tok = [(done_t[i] - first_t[i]) / max(done_new[i] - 1, 1)
               for i in done_t]
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else 0.0
    mean = lambda xs: float(np.mean(xs)) if xs else 0.0
    makespan = max(makespan, 1e-9)
    return {
        "n_requests": len(workload),
        "completed": len(done_t),
        "makespan_s": makespan,
        "offered_tok_s": offered / makespan,
        "goodput_tok_s": delivered / makespan,
        "tok_s": delivered / makespan,
        "p50_ttft_s": pct(ttft, 50), "p99_ttft_s": pct(ttft, 99),
        "p50_queue_wait_s": pct(q_wait, 50),
        "p99_queue_wait_s": pct(q_wait, 99),
        "p50_prefill_s": pct(pre, 50), "p99_prefill_s": pct(pre, 99),
        "mean_ttft_s": mean(ttft),
        "mean_queue_wait_s": mean(q_wait),
        "mean_prefill_s": mean(pre),
        "p50_tok_latency_s": pct(per_tok, 50),
        "p99_tok_latency_s": pct(per_tok, 99),
        "wasted_decode_tokens": int(wasted),
        "shipped_bytes": int(shipped),
        "shed": int(c.get("shed", 0)),
        "expired": int(c.get("expired", 0)),
        "cancelled": int(c.get("cancelled", 0)),
        "evicted": int(c.get("evicted", 0)),
        "leaked_bytes": int(leaked),
    }


def run_continuous(engine: ServeEngine, workload: list, *,
                   warmup: bool = True, deadline_s: float | None = None,
                   queue_ttl_s: float | None = None, **sched_kw) -> dict:
    """Drive a ``ContinuousScheduler`` through the workload.

    **Two-lane clock (disaggregated mode).** With ``disaggregate=True``
    the virtual clock splits into two timelines, as in the reference:
    the decode lane paces simulated time (arrivals, decode tokens,
    completions, page shipping), while the prefill lane is a
    coprocessor with its own busy-until time. A step's prefill work
    starts at ``max(prefill_lane_free, step_start)`` and first tokens
    (prefill emits them) are stamped on the prefill timeline. Both
    pools live on one card here, so the lanes' measured dispatch costs
    are real and only their overlap is simulated (as if the prefill lane
    had a card of its own). The interleaved modes keep the single shared
    clock — their prefill really steals decode time.
    """
    disagg = bool(sched_kw.get("disaggregate", False))

    def one_pass() -> dict:
        now, p_now, i, wasted = 0.0, 0.0, 0, 0
        # deadlines/TTLs live on the SIMULATED timeline: the scheduler
        # reads this closure instead of the wall clock, so an expiry
        # means the virtual deployment missed it, not that the harness
        # was slow
        sch = ContinuousScheduler(engine, clock=lambda: now, **sched_kw)
        # Run every (chunk length, row bucket) decode shape the scheduler
        # can dispatch once. Without this, a combination first hit
        # mid-run (the timed pass's virtual clock diverges from the warm
        # pass's, so partial batches form differently) charges its
        # first-call cost to whichever requests are in flight — a p99
        # TTFT outlier that is a harness artifact, not queueing.
        sch.warm()
        arrivals, start_t, first_t, done_t, done_new = {}, {}, {}, {}, {}
        while i < len(workload) or not sch.idle:
            while i < len(workload) and workload[i].arrival <= now:
                r = workload[i]
                rid = sch.submit(r.prompt, r.max_new, sampling=r.sampling,
                                 deadline_s=deadline_s,
                                 queue_ttl_s=queue_ttl_s)
                i += 1
                if isinstance(rid, Rejected):
                    continue             # shed: never arrives, never waits
                arrivals[rid] = r.arrival
            if sch.idle and i < len(workload):
                now = workload[i].arrival        # jump an idle gap
                continue
            before = now
            t0 = time.perf_counter()
            ev = sch.step()
            wall = time.perf_counter() - t0
            if disagg:
                # prefill lane on its own timeline (its own devices)
                p_start = max(p_now, before)
                p_now = p_start + ev.prefill_lane_s
                now = before + ev.decode_lane_s
                for rid in ev.prefill_started:   # queue wait ends here
                    start_t.setdefault(rid, p_start)
                for rid in ev.prefilled:         # prefill emits token 0
                    first_t.setdefault(rid, p_now)
            else:
                now = before + wall
                for rid in ev.prefill_started:
                    start_t.setdefault(rid, before)
            wasted += ev.wasted_decode_tokens
            for rid in ev.tokens:
                first_t.setdefault(rid, now)
            for c in ev.completed:
                # a single-token request finishes on the prefill
                # timeline, which may run ahead of the decode clock
                done_t[c.rid] = max(now, first_t.get(c.rid, now))
                done_new[c.rid] = c.n_new
        leaked = sch.pool.used_bytes + (
            sch.prefill_pool.used_bytes if sch.prefill_pool else 0)
        return _metrics(workload, first_t, done_t, done_new, arrivals,
                        max(now, p_now), start_t=start_t, wasted=wasted,
                        shipped=sch.shipped_bytes, counters=sch.counters,
                        leaked=leaked)

    if warmup:
        one_pass()                               # warm-up pass
    return one_pass()


def run_fixed(engine: ServeEngine, workload: list, *, batch: int = 8,
              warmup: bool = True) -> dict:
    """Drive the fixed-batch ``ServeEngine.generate`` path.

    The fixed path needs one prompt length per call, so queued requests
    group by exact prompt length (arrival order within a group, oldest
    group first) and each group decodes ``next_pow2(max(max_new))``
    tokens — padding rows and surplus tokens are counted against it, as
    they cost real compute.
    """
    def one_pass() -> dict:
        pending = list(range(len(workload)))     # arrival-sorted indices
        arrivals = {i: workload[i].arrival for i in pending}
        start_t, first_t, done_t, done_new = {}, {}, {}, {}
        now, n_in, wasted = 0.0, 0, 0
        backlog: list = []
        while backlog or n_in < len(workload):
            while n_in < len(workload) and workload[n_in].arrival <= now:
                backlog.append(n_in)
                n_in += 1
            if not backlog:
                now = workload[n_in].arrival
                continue
            lead = workload[backlog[0]]
            group = [i for i in backlog
                     if len(workload[i].prompt) == len(lead.prompt)][:batch]
            backlog = [i for i in backlog if i not in group]
            toks = np.stack([workload[i].prompt for i in group])
            n_new = next_pow2(max(workload[i].max_new for i in group))
            wasted += sum(n_new - workload[i].max_new for i in group)
            samp = [workload[i].sampling for i in group]
            sampled = any(s.temperature > 0 for s in samp)
            t0 = time.perf_counter()
            res = engine.generate({"tokens": torch.from_numpy(
                toks.astype(np.int64))}, n_new,
                                  sampling=samp if sampled else None)
            dt = time.perf_counter() - t0
            for i in group:                      # first token ≈ prefill end
                start_t[i] = now
                first_t[i] = now + res.prefill_s
            now += dt
            for i in group:
                done_t[i] = now
                done_new[i] = workload[i].max_new
        return _metrics(workload, first_t, done_t, done_new, arrivals, now,
                        start_t=start_t, wasted=wasted)

    if warmup:
        one_pass()
    return one_pass()


def run_chaos(engine: ServeEngine, workload: list,
              faults: FaultPlan, *, submit_per_step: int = 2,
              **sched_kw) -> dict:
    """The chaos harness: same workload fault-free then under ``faults``.

    Both passes run at the pinned batch width (``bucket_batch=False``,
    the bitwise-repro mode) with requests fed ``submit_per_step`` per
    scheduler step in the same order, so rids align across passes. The
    verdict the chaos CI gate asserts:

    * ``leaked_bytes == 0`` — after the faulted pass drains (or goes
      idle) and ``shutdown()`` runs, both pools hold zero pages: no
      fault path (injected exhaustion, failed ship, eviction, SIGTERM)
      leaked a page.
    * ``stream_mismatches == 0`` — every request the faulted pass
      completed produced a token stream bitwise equal to the fault-free
      pass (evict→restore→resume and ship-retry are exact replays under
      the positional PRNG).

    Returns the verdict plus the faulted pass's counters and the
    injector's fired-fault log (``faults_fired``) so a quiet plan —
    faults scheduled after the run went idle — is visible, not a
    silently green gate.
    """
    sched_kw.setdefault("bucket_batch", False)

    def drive(plan):
        sch = ContinuousScheduler(engine, faults=plan, **sched_kw)
        sch.warm()
        streams, i = {}, 0
        for _ in range(100_000):
            if i >= len(workload) and (sch.idle or sch.drained):
                break
            if not sch.draining:
                for _ in range(submit_per_step):
                    if i >= len(workload):
                        break
                    r = workload[i]
                    sch.submit(r.prompt, r.max_new, sampling=r.sampling)
                    i += 1
            elif sch.drained:
                break                    # preempted: queued work stays
            ev = sch.step()
            for c in ev.completed:
                streams[c.rid] = np.asarray(c.tokens)
        else:
            raise RuntimeError("chaos drive did not converge")
        sch.shutdown()                   # spills kept sessions (none here)
        engine.dispatch_hook = None      # engine outlives this scheduler
        leaked = sch.pool.used_bytes + (
            sch.prefill_pool.used_bytes if sch.prefill_pool else 0)
        fired = list(sch._injector.log) if sch._injector else []
        return streams, leaked, dict(sch.counters), fired

    base, base_leak, _, _ = drive(None)
    got, leaked, counters, fired = drive(faults)
    mismatches = [int(rid) for rid, toks in got.items()
                  if not np.array_equal(toks, base.get(rid))]
    return {
        "plan": faults.describe(),
        "n_requests": len(workload),
        "completed_clean": len(base),
        "completed_faulted": len(got),
        "leaked_bytes_clean": int(base_leak),
        "leaked_bytes": int(leaked),
        "stream_mismatches": len(mismatches),
        "mismatched_rids": mismatches,
        "faults_fired": [list(x) for x in fired],
        "counters": counters,
        "ok": leaked == 0 and base_leak == 0 and not mismatches,
    }


def bench_load_rows(api, params, mask_src, *, formats=("masked",),
                    rates=(8.0,), load: LoadConfig | None = None,
                    device="cuda", modes=("continuous", "fixed"),
                    prefill_chunk: int | None = None,
                    warmup: bool = True, **sched_kw) -> list:
    """The arrival-rate sweep: one ``phase == "load"`` row per
    (variant, mode, rate), ready for BENCH_serve.json.

    ``mode == "disaggregated"`` reruns the continuous driver with
    ``disaggregate=True`` (plus ``prefill_chunk`` when given — the
    chunked-prefill window applies to that mode only, so the
    "continuous" rows stay the single-pool interleaved baseline).

    A cell that raises does NOT abort the sweep: the row records the
    failure under ``"error"`` (with the usual identity keys so the
    checker can still place it) and the remaining cells run — one bad
    (variant, rate) combination no longer costs the whole artifact.
    ``kernel`` is "spmm" for the packed formats (the device decides what
    runs: the kernel on the card, its plain version on the CPU, as
    ``kernel_used`` records), else "dense". ``warmup=False`` skips each
    driver's warm-up pass, for a caller that has already run the
    traffic's shapes in this process.
    """
    load = load or LoadConfig()
    max_batch = sched_kw.get("max_batch", 8)
    rows = []
    for fmt in formats:
        try:
            eng = ServeEngine(api, params,
                              masks=mask_src if fmt != "dense" else None,
                              fmt=fmt, device=device)
        except Exception as e:  # noqa: BLE001 — sweep must survive a cell
            for rate in rates:
                for mode in modes:
                    rows.append(_error_row(fmt, mode, rate, load, e))
            continue
        for rate in rates:
            wl = make_workload(dataclasses.replace(
                load, arrival_rate=rate, vocab_size=api.cfg.vocab_size))
            for mode in modes:
                try:
                    if mode == "continuous":
                        m = run_continuous(eng, wl, warmup=warmup,
                                           deadline_s=load.deadline_s,
                                           queue_ttl_s=load.queue_ttl_s,
                                           **sched_kw)
                    elif mode == "disaggregated":
                        kw = dict(sched_kw, disaggregate=True)
                        if prefill_chunk is not None:
                            kw["prefill_chunk"] = prefill_chunk
                        m = run_continuous(eng, wl, warmup=warmup,
                                           deadline_s=load.deadline_s,
                                           queue_ttl_s=load.queue_ttl_s,
                                           **kw)
                    else:
                        m = run_fixed(eng, wl, batch=max_batch,
                                      warmup=warmup)
                except Exception as e:  # noqa: BLE001
                    rows.append(_error_row(fmt, mode, rate, load, e))
                    continue
                rows.append({
                    "variant": fmt, "phase": "load", "mode": mode,
                    "kernel": _kernel(fmt),
                    "kernel_used": eng.kernel_used.get("decode", "dense"),
                    "arrival_rate": rate, "duration_s": load.duration_s,
                    "seed": load.seed, "weight_bytes": eng.weight_bytes(),
                    "pack_s": eng.pack_s,
                    **m,
                })
    return rows


def _kernel(fmt: str) -> str:
    return "spmm" if fmt in ("nm24", "gathered") else "dense"


def _error_row(fmt, mode, rate, load: LoadConfig, exc) -> dict:
    """A failed sweep cell: identity keys + the error, no metrics."""
    return {
        "variant": fmt, "phase": "load", "mode": mode,
        "kernel": _kernel(fmt),
        "arrival_rate": rate, "duration_s": load.duration_s,
        "seed": load.seed,
        "error": f"{type(exc).__name__}: {exc}",
    }


def merge_load_rows(doc: dict, rows: list) -> dict:
    """Replace a bench doc's ``phase == "load"`` rows with ``rows``,
    keeping the per-phase prefill/decode rows untouched."""
    kept = [r for r in doc.get("rows", []) if r.get("phase") != "load"]
    doc["rows"] = kept + list(rows)
    return doc
