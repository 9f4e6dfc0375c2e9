"""Continuous batching: prefill lane + decode lane over paged sessions.

The request-lifecycle layer of the serving stack, sitting between
``serve.engine`` (step fns over packed weights) and
``serve.kvcache`` (paged session storage). Requests flow through two
lanes:

  submit() ─> queue ──(admission window: pages + lane capacity)──┐
                                                                 v
   PREFILL LANE: one-shot prefill_session, or ⌈S/W⌉ fixed-shape
   prefill_chunk windows advanced one per budget unit ── store KV
                │                 (prefill pool when disaggregated)
                v
   ready ──(slot free; disagg: ship_pages prefill→decode pool)──┐
                                                                v
   DECODE LANE: join row b ─> decode_chunk (clamped to max rem) ─┐
                │                      ┌── leave (done): free / │
                └──────── repeat ──────┤   sync row ─> pages     │
                                       └── swap-remove compaction┘

**Shape discipline**, as in the reference: a bounded set of shapes,
the keys ``ServeEngine.compiled_fn_keys`` records (and the keys a decode
loop captured as a CUDA graph would use):

* prompts right-pad to a pow2 bucket; ``n_valid`` goes to the device as
  a tensor, so one prefill shape per bucket (≤ log2(capacity));
* chunked prefill replays the same window shape for every chunk of
  every prompt, one per (W, s_bucket) pair; it matches one-shot prefill
  wherever the projections give each row the same sums at W and at
  s_bucket rows (``models.attention.window_attention``: masked scores
  are exact zeros, so attending over the full capacity every chunk
  keeps the one-shot reduction lengths);
* the decode working cache is a FIXED (max_batch, capacity) dense
  cache; chunks run on its leading pow2 bucket of rows
  (``bucket_batch=False`` pins the full width — the bitwise-repro
  mode), giving ≤ log2(max_batch) chunk shapes. The chunk LENGTH clamps
  to the pow2 bucket of the largest remaining budget (≤
  log2(decode_chunk) shapes), so a tail of short requests stops paying
  for whole chunks of discarded steps;
* join/leave are in-place row copies, and sessions swap-remove so live
  rows stay compact at the front. The decode lane's one host read per
  chunk is the chunk's tokens.

**Disaggregation.** With ``disaggregate=True`` prefill writes into its
own ``PagedKVCache`` (a second pool on the same card) and finished
sessions ship page-granular to the decode pool (``kvcache.ship_pages``)
before joining the batch.
The queue admits ahead of free decode slots (up to ``max_batch`` extra
in flight), so prefill work no longer waits for a decode row to drain —
the head-of-line coupling that dominates TTFT at saturation. The
default (``disaggregate=False``, ``prefill_chunk=None``) is today's
single-pool interleaved mode and the bitwise-repro baseline.

**Admission.** ``_next_admissible`` scans a bounded window (first
``admit_window`` waiting requests) and starts the FIRST one whose
pages fit — FIFO order preserved among admissible requests, but one
page-starved large request no longer blocks smaller ones behind it.

**Sessions.** A request with ``keep=True`` leaves its pages allocated
on completion (in the DECODE pool, in both modes); a later
``submit(None, n, session=sid)`` rejoins exactly where it left off
(tokens replay bitwise at the same batch width: the PRNG key of
position p is ``fold_in(seed, p)`` regardless of when — or next to
whom — p is decoded; see ``serve.sampling``). ``release(sid)`` frees a
kept session.

**Work accounting.** Each ``step()`` spends up to ``prefill_budget``
units in the prefill lane (one chunk OR one admission each), joins
ready sessions, then runs one decode chunk, and returns the step's
events — first-token appearances, prefill starts (for queue-wait vs
prefill-time TTFT decomposition), per-request tokens, completions, and
the decode steps discarded past request budgets
(``wasted_decode_tokens``) — so a load generator can timestamp
TTFT / per-token latency without reaching inside.

**Robustness.** Requests carry optional deadlines (``deadline_s``,
total) and queue TTLs (``queue_ttl_s``); expired requests free their
pages and surface in ``StepEvents.expired``. ``cancel(rid)`` removes a
request from any lane (queue, inflight prefill, ready, decode row,
evicted) and compacts the decode batch. ``admission="shed"`` turns
queue-overflow and draining refusals into a typed ``Rejected(reason)``
return instead of an exception (the backpressure mode a load balancer
wants). Under page pressure the scheduler degrades instead of dying: a
``MemoryError`` from ``alloc``/``extend``/``ship_pages`` retries once
(absorbing transient faults) and then evicts the LRU victim — an idle
kept session first, else the least-recently-scheduled decode row,
synced back to pages and spilled page-granular to host memory
(``kvcache.spill``). Evicted rows resume bitwise-identically: the
positional PRNG keys tokens by absolute position, so
evict→restore→resume replays the exact stream. ``ship_pages`` failures
retry with ``runtime.fault_tolerance.retry`` against intact source
pages (the dst-alloc-first contract means a failed ship mutates
nothing). A ``PreemptionGuard`` (or ``FaultPlan.sigterm_at``) flips
the scheduler into *draining*: no new admissions, in-flight work runs
to completion, ``shutdown()`` spills kept sessions and verifies the
pools are empty. All of it is counted in ``counters`` (shed / expired
/ cancelled / evicted / ...) and — via ``serve.faultinject`` — every
failure is deterministically injectable for chaos runs.

Meshes (``prefill_mesh`` / ``decode_mesh``) are not ported and raise
(ROADMAP A5).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.runtime import fault_tolerance as ft

from . import sampling as sampling_lib
from .engine import ServeEngine, next_pow2
from .faultinject import FaultInjector, FaultPlan, ShipFault
from .kvcache import HostSpill, PagedKVCache, ship_pages


@dataclasses.dataclass
class Completion:
    """One finished request."""

    rid: int
    session: object
    tokens: np.ndarray            # (n_new,) int32 generated tokens
    prompt_len: int
    n_new: int
    kept: bool                    # pages still allocated (resumable)


@dataclasses.dataclass(frozen=True)
class Rejected:
    """An admission-control refusal (``admission="shed"`` mode).

    ``submit`` returns this instead of queueing when the scheduler is
    over ``max_queue`` (``reason="queue_full"``) or draining after a
    preemption signal (``reason="draining"``) — typed backpressure a
    client can retry against, instead of an exception or an unbounded
    queue.
    """

    rid: int
    reason: str


@dataclasses.dataclass
class StepEvents:
    """What one ``step()`` did — the load generator's measurement hooks."""

    prefilled: list               # rids whose first token appeared
    tokens: dict                  # rid -> [new token ids] this step
    completed: list               # Completion
    n_active: int
    n_queued: int
    prefill_started: list = dataclasses.field(default_factory=list)
    wasted_decode_tokens: int = 0  # decode steps discarded past budgets
    # wall time spent in each lane this step — a load generator clocks
    # a disaggregated run's lanes on separate timelines (see loadgen)
    prefill_lane_s: float = 0.0
    decode_lane_s: float = 0.0
    expired: list = dataclasses.field(default_factory=list)   # rids
    evicted: list = dataclasses.field(default_factory=list)   # sids


@dataclasses.dataclass
class _Slot:
    rid: int
    sid: object
    samp: sampling_lib.SamplingParams
    rem: int                      # tokens still to emit
    t_true: int                   # real KV length (graph t may overshoot)
    emitted: list
    keep: bool
    prompt_len: int
    deadline: float | None = None  # absolute scheduler-clock expiry


@dataclasses.dataclass
class _Request:
    """A waiting request (the queue entry)."""

    rid: int
    prompt: np.ndarray | None     # None resumes a kept session
    max_new: int
    samp: sampling_lib.SamplingParams
    session: object
    keep: bool
    t_submit: float
    queue_ttl: float | None       # max seconds waiting in the queue
    deadline: float | None        # absolute scheduler-clock expiry


@dataclasses.dataclass
class _Evicted:
    """A decode row evicted to host mid-request, waiting to resume."""

    slot: _Slot
    spill: HostSpill
    tok: int                      # token feeding the next decode step


@dataclasses.dataclass
class _Prefilling:
    """A prompt mid-way through the chunked-prefill lane."""

    rid: int
    sid: object
    prompt: np.ndarray            # (1, s_bucket) right-padded
    S: int
    max_new: int
    samp: sampling_lib.SamplingParams
    keep: bool
    cache: object                 # B=1 DecodeCache carried across chunks
    offset: int = 0               # tokens already processed
    deadline: float | None = None  # absolute scheduler-clock expiry


@dataclasses.dataclass
class _Ready:
    """A prefilled (or resumed) session waiting for a decode slot."""

    slot: _Slot
    tok: int                      # token feeding the first decode step
    ship: bool                    # pages sit in the prefill pool


def _write_slot(cache, b: int, k, v, pos, t: int, tok: int, toks_all):
    """Install a session into working-cache row ``b`` (in place)."""
    kv = cache.kv
    kv.k[:, b] = k.to(kv.k.dtype)
    kv.v[:, b] = v.to(kv.v.dtype)
    kv.pos[:, b] = pos
    cache.t[b] = t
    toks_all[b] = tok


def _move_slot(cache, src: int, dst: int, toks_all):
    """Swap-remove compaction: copy row ``src`` over row ``dst``."""
    kv = cache.kv
    kv.k[:, dst] = kv.k[:, src]
    kv.v[:, dst] = kv.v[:, src]
    kv.pos[:, dst] = kv.pos[:, src]
    cache.t[dst] = cache.t[src]
    toks_all[dst] = toks_all[src]


def _read_slot(cache, b: int):
    return cache.kv.k[:, b], cache.kv.v[:, b]


class ContinuousScheduler:
    """Continuous-batching scheduler over a ``ServeEngine``.

    Args:
        engine: the packed-weight engine (dense decoder-only models).
        max_batch: decode slots (power of two).
        capacity: per-slot token capacity (prompt + output; power of
            two, multiple of ``page_size``).
        page_size: tokens per KV page.
        n_pages: decode-pool size in pages; default backs every slot at
            full capacity (kept sessions beyond that need headroom —
            pass more).
        prefill_budget: prefill-lane units per step — each unit advances
            one inflight chunked prefill by one window, or starts one
            new admission (a full prompt in one-shot mode). Default 1
            interleaved, 4 disaggregated: a lane on its own devices is
            not paced by the decode chunk, and one unit per step starves
            it whenever decode steps are short (chunked prompts need
            ⌈S/W⌉ units each).
        decode_chunk: decode steps per dispatch (upper bound; each
            chunk clamps to the pow2 bucket of the largest remaining
            request budget).
        bucket_batch: run chunks on the pow2 bucket of live rows (True,
            the throughput mode) or always at ``max_batch`` (False —
            fixed shapes, the bitwise-reproducibility mode).
        max_queue: admission control — ``submit`` beyond this many
            waiting requests raises.
        admit_window: how many waiting requests the admission scan may
            look past a page-starved head (FIFO among admissible).
        prefill_chunk: window width W (power of two) for chunked
            prefill — a prompt becomes ⌈S/W⌉ fixed-shape dispatches
            interleaving with decode chunks, bitwise identical to the
            one-shot path. ``None`` (default) prefills each prompt in
            one dispatch.
        disaggregate: prefill into a separate page pool and ship
            sessions to the decode pool page-granular on join; admits
            ahead of free decode slots. Default False — single pool,
            today's interleaved mode.
        prefill_mesh / decode_mesh: not ported; a mesh raises
            ``NotImplementedError`` (ROADMAP A5). Both pools live on the
            engine's device.
        n_prefill_pages: prefill-pool size in pages (disaggregated
            only); defaults to ``n_pages``.
        admission: "raise" (default — queue overflow and draining raise
            ``RuntimeError``) or "shed" (``submit`` returns a typed
            ``Rejected(reason)`` instead; counted in
            ``counters["shed"]``).
        evict: degrade gracefully on pool exhaustion by evicting the
            LRU session to a host spill (default True); False turns
            page pressure back into a hard ``MemoryError``.
        ship_retries: how many times a failed ``ship_pages`` transfer
            retries (``runtime.fault_tolerance.retry`` semantics)
            before the session waits for the next step.
        faults: a ``faultinject.FaultPlan`` to thread through the
            pool/engine/ship hooks (deterministic chaos runs).
        guard: a ``runtime.fault_tolerance.PreemptionGuard``; when its
            flag is set (real SIGTERM or ``simulate()``), the scheduler
            drains — created implicitly when ``faults`` plans a
            SIGTERM.
        clock: monotonic-seconds callable for deadlines/TTLs (default
            ``time.monotonic``); the load generator passes its virtual
            clock so deadlines live on the simulated timeline.
    """

    def __init__(self, engine: ServeEngine, *, max_batch: int = 8,
                 capacity: int = 256, page_size: int = 16,
                 n_pages: int | None = None,
                 prefill_budget: int | None = None,
                 decode_chunk: int = 8, bucket_batch: bool = True,
                 max_queue: int = 1024, admit_window: int = 4,
                 prefill_chunk: int | None = None,
                 disaggregate: bool = False, prefill_mesh=None,
                 decode_mesh=None, n_prefill_pages: int | None = None,
                 admission: str = "raise", evict: bool = True,
                 ship_retries: int = 3, faults: FaultPlan | None = None,
                 guard: ft.PreemptionGuard | None = None, clock=None):
        engine._require_continuous()
        if prefill_mesh is not None or decode_mesh is not None:
            raise NotImplementedError(
                "mesh-placed page pools are not ported (ROADMAP A5)")
        if max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {max_batch}")
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, "
                             f"got {page_size}")
        if capacity % page_size:
            raise ValueError(f"capacity {capacity} not divisible by "
                             f"page size {page_size}")
        if prefill_chunk is not None and (
                prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two, "
                             f"got {prefill_chunk}")
        if prefill_chunk is not None and engine.api.prefill_window is None:
            raise NotImplementedError(
                f"{engine.cfg.family}: no chunked-prefill continuation")
        self.engine = engine
        self.cfg = engine.cfg
        self.max_batch = max_batch
        self.capacity = capacity
        self.page_size = page_size
        self.prefill_budget = (4 if disaggregate else 1) \
            if prefill_budget is None else max(prefill_budget, 1)
        self.decode_chunk = max(decode_chunk, 1)
        self.bucket_batch = bucket_batch
        self.max_queue = max_queue
        self.admit_window = max(admit_window, 1)
        self.prefill_chunk = prefill_chunk
        self.disaggregate = disaggregate
        if n_pages is None:
            n_pages = max_batch * capacity // page_size
        self.device = engine.device
        self.pool = PagedKVCache(self.cfg, n_pages=n_pages,
                                 page_size=page_size, device=self.device)
        self.prefill_pool = None
        if disaggregate:
            self.prefill_pool = PagedKVCache(
                self.cfg,
                n_pages=n_pages if n_prefill_pages is None
                else n_prefill_pages,
                page_size=page_size, device=self.device)
        # async lanes may hold this many prefills beyond free decode slots
        self._admit_ahead = (max_batch if (disaggregate or prefill_chunk)
                             else 0)
        # fixed-shape working cache; the scalar clock becomes per-row
        cache = engine.api.init_cache(engine.params, max_batch, capacity)
        self.cache = cache._replace(t=torch.zeros(
            max_batch, dtype=torch.int64, device=self.device))
        self._toks = torch.zeros(max_batch, dtype=torch.int64,
                                 device=self.device)
        self.slots: list[_Slot] = []          # compact: rows [0, n_active)
        self.queue: collections.deque = collections.deque()       # _Request
        self._inflight: collections.deque = collections.deque()  # _Prefilling
        self._ready: collections.deque = collections.deque()     # _Ready
        self._evicted: collections.deque = collections.deque()   # _Evicted
        self._sessions: dict = {}             # sid -> next token (int)
        self._spilled: dict = {}              # sid -> HostSpill (idle, kept)
        self._last_used: dict = {}            # sid -> step last scheduled
        self._next_rid = 0
        self._step_no = 0
        self._samp = {
            "temp": np.zeros((max_batch,), np.float32),
            "top_p": np.ones((max_batch,), np.float32),
            "top_k": np.zeros((max_batch,), np.int64),
            "seed": np.zeros((max_batch,), np.int64),
        }
        if admission not in ("raise", "shed"):
            raise ValueError(f"admission must be 'raise' or 'shed', "
                             f"got {admission!r}")
        self.admission = admission
        self.evict = evict
        self.ship_retries = max(int(ship_retries), 0)
        self._now = time.monotonic if clock is None else clock
        if guard is None and faults is not None \
                and faults.sigterm_at is not None:
            guard = ft.PreemptionGuard()     # simulate-only, not installed
        self.guard = guard
        self.draining = False
        self._injector = None
        if faults is not None:
            self._injector = FaultInjector(faults, guard=guard)
            self.pool.fault_hook = self._injector.on_reserve
            if self.prefill_pool is not None:
                self.prefill_pool.fault_hook = self._injector.on_reserve
            engine.dispatch_hook = self._injector.on_dispatch
        self.counters = {"shed": 0, "expired": 0, "cancelled": 0,
                         "evicted": 0, "evict_resumed": 0,
                         "ship_retries": 0, "ship_failures": 0,
                         "alloc_retries": 0}
        # engine dispatches this scheduler made: prefill calls (one-shot
        # or one window each) and decode steps (n_steps per chunk)
        self.dispatches = {"prefill": 0, "decode_steps": 0}

    # -- request intake -----------------------------------------------------

    def submit(self, prompt, max_new: int, *,
               sampling: sampling_lib.SamplingParams = sampling_lib.GREEDY,
               session=None, keep: bool = False,
               deadline_s: float | None = None,
               queue_ttl_s: float | None = None):
        """Queue a request; returns its rid (or a ``Rejected``).

        ``prompt=None`` resumes a kept session (``session`` required):
        generation continues from the session's stored state, replaying
        the exact token stream a single longer request would produce.

        ``deadline_s`` bounds the request's TOTAL lifetime (queue wait +
        prefill + decode) on the scheduler clock; ``queue_ttl_s`` bounds
        only the wait before prefill starts. An expired request frees
        its pages and appears in ``StepEvents.expired`` — it never
        completes. In ``admission="shed"`` mode, overload/draining
        refusals return ``Rejected(rid, reason)`` instead of raising.
        """
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        sampling.validate()
        if prompt is None:
            if session not in self._sessions:
                raise KeyError(f"unknown or released session {session!r}")
            kv_len = (self._spilled[session].length
                      if session in self._spilled
                      else self.pool.length(session))
            need = kv_len + max_new
        else:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            if len(prompt) < 1:
                raise ValueError("empty prompt")
            need = len(prompt) + max_new
        if need > self.capacity:
            raise ValueError(f"request needs {need} cache slots, capacity "
                             f"is {self.capacity}")
        reason = None
        if self.draining:
            reason = "draining"
        elif len(self.queue) >= self.max_queue:
            reason = "queue_full"
        if reason is not None:
            rid = self._next_rid
            self._next_rid += 1
            if self.admission == "shed":
                self.counters["shed"] += 1
                return Rejected(rid, reason)
            raise RuntimeError(
                "admission refused: draining after preemption signal"
                if reason == "draining" else
                f"admission refused: {self.max_queue} requests already "
                "queued")
        rid = self._next_rid
        self._next_rid += 1
        now = self._now()
        self.queue.append(_Request(
            rid=rid, prompt=prompt, max_new=max_new, samp=sampling,
            session=session, keep=keep, t_submit=now,
            queue_ttl=queue_ttl_s,
            deadline=None if deadline_s is None else now + deadline_s))
        return rid

    def release(self, session) -> None:
        """Free a kept session's pages (it can no longer be resumed)."""
        del self._sessions[session]
        if self._spilled.pop(session, None) is None:
            self.pool.free(session)
        self._last_used.pop(session, None)

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is; frees its pages. -> found?

        Covers every lane: waiting in the queue, mid chunked prefill,
        ready-to-join, active in the decode batch (the row is synced
        out and swap-removed, so the batch stays compact), or evicted
        to host. Cancelling a *resume* request leaves the kept session
        itself intact. Unknown / already-finished rids return False.
        """
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self.counters["cancelled"] += 1
                return True
        for pf in list(self._inflight):
            if pf.rid == rid:
                self._inflight.remove(pf)
                (self.prefill_pool if self.disaggregate
                 else self.pool).free(pf.sid)
                self.counters["cancelled"] += 1
                return True
        for r in list(self._ready):
            if r.slot.rid == rid:
                self._ready.remove(r)
                self._discard_slot_pages(r.slot, shipped=r.ship)
                self.counters["cancelled"] += 1
                return True
        for e in list(self._evicted):
            if e.slot.rid == rid:
                self._evicted.remove(e)   # pages already freed at evict
                self._sessions.pop(e.slot.sid, None)
                self.counters["cancelled"] += 1
                return True
        for b, slot in enumerate(self.slots):
            if slot.rid == rid:
                self._drop_row(b)
                self.counters["cancelled"] += 1
                return True
        return False

    def _discard_slot_pages(self, slot: _Slot, *, shipped: bool) -> None:
        """Free a not-yet-joined slot's pages (cancel/expiry).

        A resume of a kept session holds the SESSION's pages — those
        survive the request; only fresh allocations are freed.
        """
        pool = self.prefill_pool if shipped else self.pool
        if slot.sid in self._sessions and slot.emitted == []:
            return                        # a resume request: keep the session
        pool.free(slot.sid)
        self._sessions.pop(slot.sid, None)

    def _drop_row(self, b: int) -> None:
        """Remove decode row ``b`` without completing it; frees pages."""
        slot = self.slots[b]
        self.pool.free(slot.sid)
        self._sessions.pop(slot.sid, None)
        self._last_used.pop(slot.sid, None)
        self._compact_remove(b)

    @property
    def shipped_bytes(self) -> int:
        """Bytes of KV pages shipped prefill pool -> decode pool."""
        return self.pool.shipped_bytes_in

    def warm(self) -> None:
        """Run every decode-chunk shape this scheduler can dispatch once
        — pow2 chunk lengths × pow2 row buckets, an enumerable set — so
        a serving process pays each shape's first call (kernel loads,
        library heuristics, allocator growth) at startup instead of
        mid-traffic, where it would show up as a TTFT outlier for every
        request in flight. Runs on
        the empty working cache (garbage rows are fully rewritten at
        join), so it must be called before any session is active."""
        if self.slots:
            raise RuntimeError("warm() requires an empty decode batch")
        samp = self._samp_tensors(0)
        active = torch.zeros(self.max_batch, dtype=torch.bool,
                             device=self.device)
        # mirror step()'s clamp formulas exactly, including the non-pow2
        # decode_chunk / max_batch edge (the min() can land off-pow2)
        steps = sorted({min(self.decode_chunk, next_pow2(n))
                        for n in range(1, self.decode_chunk + 1)})
        buckets = sorted({min(next_pow2(n), self.max_batch)
                          for n in range(1, self.max_batch + 1)}) \
            if self.bucket_batch else [self.max_batch]
        for n in steps:
            for b in buckets:
                toks, self.cache = self.engine.decode_chunk(
                    self._toks, self.cache, active, samp,
                    n_steps=n, bucket=b)
                self.dispatches["decode_steps"] += n
                self._toks[:b] = toks[-1]

    def _samp_tensors(self, n_active: int) -> dict:
        """The slots' sampling knobs on the device, and whether the live
        rows are all greedy (decided on the host, from the knobs)."""
        out = {k: torch.from_numpy(v).to(self.device)
               for k, v in self._samp.items()}
        out["greedy"] = bool((self._samp["temp"][:n_active] <= 0).all())
        return out

    # -- decode-batch internals ---------------------------------------------

    def _join(self, slot: _Slot, tok: int) -> None:
        b = len(self.slots)
        k, v, pos, length = self.pool.load(slot.sid, self.capacity)
        _write_slot(self.cache, b, k, v, pos, length, tok, self._toks)
        for name, val in zip(self._samp,
                             (slot.samp.temperature, slot.samp.top_p,
                              slot.samp.top_k, slot.samp.seed)):
            self._samp[name][b] = val
        self.slots.append(slot)
        self._last_used[slot.sid] = self._step_no

    def _compact_remove(self, b: int) -> None:
        """Swap-remove decode row ``b`` (cache + sampling arrays + slots)."""
        last = len(self.slots) - 1
        if b != last:
            _move_slot(self.cache, last, b, self._toks)
            for arr in self._samp.values():
                arr[b] = arr[last]
            self.slots[b] = self.slots[last]
        self.slots.pop()

    def _leave(self, b: int) -> Completion:
        slot = self.slots[b]
        if slot.keep:
            k, v = _read_slot(self.cache, b)
            self.pool.store(slot.sid, k, v, slot.t_true)
            self._sessions[slot.sid] = int(slot.emitted[-1])
            self._last_used[slot.sid] = self._step_no
        else:
            self.pool.free(slot.sid)
            self._sessions.pop(slot.sid, None)
            self._last_used.pop(slot.sid, None)
        self._compact_remove(b)
        return Completion(rid=slot.rid, session=slot.sid,
                          tokens=np.asarray(slot.emitted, np.int32),
                          prompt_len=slot.prompt_len,
                          n_new=len(slot.emitted), kept=slot.keep)

    # -- page-pressure degradation (evict / spill / resume) -----------------

    def _with_pages(self, fn, *args, protect=frozenset(), evictable=True):
        """Run a pool operation, degrading instead of dying on pressure.

        One immediate retry absorbs transient (injected) exhaustion —
        the pool's own state is untouched by a failed reserve. After
        that, each retry first evicts an LRU victim (never one in
        ``protect``); the MemoryError propagates only when there is
        nothing left to evict. ``evictable=False`` (prefill-pool ops —
        evicting decode sessions cannot free prefill pages) keeps just
        the transient-fault retry.
        """
        try:
            return fn(*args)
        except MemoryError:
            self.counters["alloc_retries"] += 1
        while True:
            try:
                return fn(*args)
            except MemoryError:
                if not (evictable and self.evict
                        and self._evict_one(protect=protect)):
                    raise

    def _evict_one(self, protect=frozenset()) -> bool:
        """Evict one LRU victim to host: idle kept sessions first (no
        row to sync), else the least-recently-scheduled decode row."""
        return (self._evict_idle_lru(protect=protect)
                or self._evict_row_lru(protect=protect))

    def _evict_idle_lru(self, protect=frozenset()) -> bool:
        busy = ({s.sid for s in self.slots}
                | {r.slot.sid for r in self._ready}
                | {pf.sid for pf in self._inflight})
        cands = [sid for sid in self.pool.sessions()
                 if sid in self._sessions and sid not in busy
                 and sid not in protect]
        if not cands:
            return False
        sid = min(cands, key=lambda s: (self._last_used.get(s, -1), repr(s)))
        self._spilled[sid] = self.pool.spill(sid, capacity=self.capacity)
        self.counters["evicted"] += 1
        return True

    def _evict_row_lru(self, protect=frozenset()) -> bool:
        cands = [b for b, s in enumerate(self.slots) if s.sid not in protect]
        if not cands:
            return False
        b = min(cands, key=lambda i: (
            self._last_used.get(self.slots[i].sid, -1), self.slots[i].rid))
        slot = self.slots[b]
        # sync the working row back to pages (reservation already covers
        # t_true, so this store cannot itself hit pressure), spill, and
        # compact — the request parks in _evicted until pages free up
        k, v = _read_slot(self.cache, b)
        self.pool.store(slot.sid, k, v, slot.t_true)
        tok = int(self._toks[b])
        spill = self.pool.spill(slot.sid, capacity=self.capacity)
        self._compact_remove(b)
        self._evicted.append(_Evicted(slot=slot, spill=spill, tok=tok))
        self.counters["evicted"] += 1
        return True

    def _resume_evicted(self, events: StepEvents) -> bool:
        """Restore the oldest evicted row if its pages fit now.

        The full prompt+output reservation must fit before anything
        mutates; idle kept sessions may be evicted to make room, but a
        resume never evicts another active row (that would livelock).
        """
        e = self._evicted[0]
        need = e.slot.t_true + e.slot.rem
        while not self.pool.can_admit(need):
            if not (self.evict
                    and self._evict_idle_lru(protect={e.slot.sid})):
                return False
        try:
            self._with_pages(self.pool.restore_spill, e.spill,
                             protect={e.slot.sid})
        except MemoryError:
            return False
        self._evicted.popleft()
        self._with_pages(self.pool.extend, e.slot.sid, need,
                         protect={e.slot.sid})
        self._ready.append(_Ready(e.slot, e.tok, False))
        self.counters["evict_resumed"] += 1
        return True

    # -- prefill lane -------------------------------------------------------

    def _next_admissible(self):
        """Pop the first waiting request whose pages fit (bounded scan).

        FIFO among admissible requests; a page-starved head is looked
        past (up to ``admit_window`` deep), so small requests are not
        head-of-line blocked by a large one waiting on capacity. When
        NOTHING in the window fits and eviction is on, one idle kept
        session spills to host and the window rescans — sessions a
        queued resume refers to are never the victim.
        """
        if (len(self.slots) + len(self._ready) + len(self._inflight)
                + len(self._evicted)
                >= self.max_batch + self._admit_ahead):
            return None
        for attempt in (0, 1):
            for i in range(min(self.admit_window, len(self.queue))):
                req = self.queue[i]
                if req.prompt is None:
                    if req.session in self._spilled:
                        ok = self.pool.can_admit(
                            self._spilled[req.session].length + req.max_new)
                    else:
                        ok = self.pool.can_extend(
                            req.session,
                            self.pool.length(req.session) + req.max_new)
                elif self.disaggregate:
                    ok = self.prefill_pool.can_admit(len(req.prompt))
                else:
                    ok = self.pool.can_admit(len(req.prompt) + req.max_new)
                if ok:
                    del self.queue[i]
                    return req
            if attempt or not (self.evict and self.queue):
                return None
            referenced = {q.session for q in self.queue
                          if q.session is not None}
            if not self._evict_idle_lru(protect=referenced):
                return None
        return None

    def _start(self, req: _Request, events: StepEvents) -> None:
        """Spend one prefill-lane unit starting ``req``."""
        rid, max_new, samp = req.rid, req.max_new, req.samp
        session, keep = req.session, req.keep
        if req.prompt is None:                   # resume a kept session
            if session in self._spilled:         # evicted while idle
                sp = self._spilled.pop(session)
                try:
                    self._with_pages(self.pool.restore_spill, sp,
                                     protect={session})
                except MemoryError:
                    self._spilled[session] = sp
                    raise
            kv_len = self.pool.length(session)
            self._with_pages(self.pool.extend, session, kv_len + max_new,
                             protect={session})
            slot = _Slot(rid=rid, sid=session, samp=samp, rem=max_new,
                         t_true=kv_len, emitted=[], keep=keep,
                         prompt_len=kv_len, deadline=req.deadline)
            self._ready.append(_Ready(slot, self._sessions[session], False))
            return
        S = len(req.prompt)
        sid = session if session is not None else ("r", rid)
        if self.disaggregate:
            self._with_pages(self.prefill_pool.alloc, sid, S,
                             protect={sid}, evictable=False)
        else:
            self._with_pages(self.pool.alloc, sid, S + max_new,
                             protect={sid})
        s_bucket = min(max(self.page_size, next_pow2(S)), self.capacity)
        padded = np.zeros((1, s_bucket), np.int64)
        padded[0, :S] = req.prompt
        events.prefill_started.append(rid)
        if self.prefill_chunk is None:           # one-shot prefill
            tok0, k, v = self.engine.prefill_session(
                torch.from_numpy(padded), S,
                sampling_lib.params_arrays([samp], self.device))
            self.dispatches["prefill"] += 1
            (self.prefill_pool if self.disaggregate
             else self.pool).store(sid, k, v, S)
            self._finish_prefill(rid, sid, S, max_new, samp, keep,
                                 int(tok0[0]), events, req.deadline)
            return
        pf = _Prefilling(
            rid=rid, sid=sid, prompt=padded, S=S, max_new=max_new,
            samp=samp, keep=keep,
            cache=self.engine.api.init_cache(self.engine.params, 1,
                                             s_bucket),
            deadline=req.deadline)
        self._inflight.append(pf)
        self._advance(pf, events)                # first window, same unit

    def _advance(self, pf: _Prefilling, events: StepEvents) -> None:
        """Run one fixed-shape prefill window of an inflight prompt."""
        w = min(self.prefill_chunk, pf.prompt.shape[1])
        window = torch.from_numpy(pf.prompt[:, pf.offset:pf.offset + w])
        tok, pf.cache = self.engine.prefill_chunk(
            window, pf.offset, pf.S, pf.cache,
            sampling_lib.params_arrays([pf.samp], self.device))
        self.dispatches["prefill"] += 1
        pf.offset += w
        if pf.offset < pf.S:
            return                               # more windows to go
        self._inflight.remove(pf)
        (self.prefill_pool if self.disaggregate else self.pool).store(
            pf.sid, pf.cache.kv.k[:, 0], pf.cache.kv.v[:, 0], pf.S)
        pf.cache = None                          # drop the B=1 carrier
        self._finish_prefill(pf.rid, pf.sid, pf.S, pf.max_new, pf.samp,
                             pf.keep, int(tok[0]), events, pf.deadline)

    def _finish_prefill(self, rid, sid, S, max_new, samp, keep, tok0,
                        events: StepEvents, deadline=None) -> None:
        events.prefilled.append(rid)
        events.tokens.setdefault(rid, []).append(tok0)
        slot = _Slot(rid=rid, sid=sid, samp=samp, rem=max_new - 1,
                     t_true=S, emitted=[tok0], keep=keep, prompt_len=S,
                     deadline=deadline)
        self._ready.append(_Ready(slot, tok0, self.disaggregate))

    def _prefill_one(self, events: StepEvents) -> bool:
        """One prefill-lane unit: advance the oldest inflight window,
        resume an evicted row, else start a new admission. False when
        the lane has no work. While draining, in-flight work still
        advances but the queue stays untouched."""
        if self._inflight:
            self._advance(self._inflight[0], events)
            return True
        if self._evicted:
            # an evicted row blocks new admissions until it resumes —
            # otherwise fresh traffic could starve it of pages forever
            return self._resume_evicted(events)
        if self.draining:
            return False
        req = self._next_admissible()
        if req is None:
            return False
        try:
            self._start(req, events)
        except MemoryError:
            # pages vanished between the admission check and the alloc
            # (injected fault past its retry, or an eviction race):
            # requeue at the head and retry next step — the request is
            # not lost and FIFO order is preserved
            self.queue.appendleft(req)
            return False
        return True

    # -- ready -> decode-batch handoff --------------------------------------

    def _ship(self, sid) -> None:
        """Ship a session prefill pool -> decode pool, with retries.

        A transient transfer failure (``ShipFault``, fired by the
        injector before any pool mutates — matching ``ship_pages``'s
        dst-alloc-first contract, under which a real failure also
        leaves the source intact) re-drives the ship up to
        ``ship_retries`` times with backoff; the final failure
        propagates for the caller to park the session until next step.
        """
        def attempt():
            if self._injector is not None:
                self._injector.on_ship()
            return ship_pages(self.prefill_pool, self.pool, sid,
                              capacity=self.capacity)

        def note(i, e):
            self.counters["ship_retries"] += 1

        ft.retry(attempt, retries=self.ship_retries, base_delay=0.001,
                 max_delay=0.05, retry_on=(ShipFault,), on_retry=note)

    def _join_ready(self, events: StepEvents) -> None:
        """Join prefilled sessions to the decode batch, FIFO, shipping
        pages out of the prefill pool first when disaggregated. Stops at
        the first session that must wait (no slot / no decode pages /
        ship down)."""
        while self._ready:
            r = self._ready[0]
            slot = r.slot
            if slot.rem == 0:
                # single-token request: never joins the decode batch —
                # its pages hold exactly the prompt KV, so there is no
                # working row to sync back
                if slot.keep:
                    if r.ship:
                        if not self.pool.can_admit(slot.t_true):
                            break                # wait for decode pages
                        try:
                            self._with_pages(self._ship, slot.sid,
                                             protect={slot.sid})
                        except ShipFault:
                            self.counters["ship_failures"] += 1
                            break                # transport down: wait
                        except MemoryError:
                            break                # wait for decode pages
                    self._sessions[slot.sid] = r.tok
                else:
                    (self.prefill_pool if r.ship
                     else self.pool).free(slot.sid)
                events.completed.append(Completion(
                    rid=slot.rid, session=slot.sid,
                    tokens=np.asarray(slot.emitted, np.int32),
                    prompt_len=slot.prompt_len, n_new=1, kept=slot.keep))
                self._ready.popleft()
                continue
            if len(self.slots) >= self.max_batch:
                break                            # wait for a decode slot
            if r.ship:
                need = slot.t_true + slot.rem + 1    # prompt + output
                if not self.pool.can_admit(need):
                    # make room by spilling idle kept sessions; if none,
                    # wait — shipping must not evict active rows (the
                    # shipped session would just re-pressure them)
                    if not (self.evict and self._evict_idle_lru(
                            protect={slot.sid})):
                        break                    # wait for decode pages
                    continue
                try:
                    self._with_pages(self._ship, slot.sid,
                                     protect={slot.sid})
                except ShipFault:
                    self.counters["ship_failures"] += 1
                    break                        # retry next step
                except MemoryError:
                    break                        # wait for decode pages
                self._with_pages(self.pool.extend, slot.sid, need,
                                 protect={slot.sid})
            self._ready.popleft()
            self._join(slot, r.tok)

    # -- deadlines ----------------------------------------------------------

    def _expire(self, events: StepEvents, now: float) -> None:
        """Drop every request past its deadline/TTL, freeing its pages."""
        for req in list(self.queue):
            ttl_hit = (req.queue_ttl is not None
                       and now - req.t_submit > req.queue_ttl)
            if ttl_hit or (req.deadline is not None
                           and now > req.deadline):
                self.queue.remove(req)
                self.counters["expired"] += 1
                events.expired.append(req.rid)
        for pf in list(self._inflight):
            if pf.deadline is not None and now > pf.deadline:
                self._inflight.remove(pf)
                (self.prefill_pool if self.disaggregate
                 else self.pool).free(pf.sid)
                self.counters["expired"] += 1
                events.expired.append(pf.rid)
        for r in list(self._ready):
            if r.slot.deadline is not None and now > r.slot.deadline:
                self._ready.remove(r)
                self._discard_slot_pages(r.slot, shipped=r.ship)
                self.counters["expired"] += 1
                events.expired.append(r.slot.rid)
        for e in list(self._evicted):
            if e.slot.deadline is not None and now > e.slot.deadline:
                self._evicted.remove(e)   # pages already freed at evict
                self._sessions.pop(e.slot.sid, None)
                self.counters["expired"] += 1
                events.expired.append(e.slot.rid)
        for b in range(len(self.slots) - 1, -1, -1):
            slot = self.slots[b]
            if slot.deadline is not None and now > slot.deadline:
                self._drop_row(b)
                self.counters["expired"] += 1
                events.expired.append(slot.rid)

    # -- the step loop ------------------------------------------------------

    def step(self) -> StepEvents:
        """One scheduler step: expiry sweep, up to ``prefill_budget``
        prefill-lane units, ready-session joins, then one decode
        chunk."""
        self._step_no += 1
        if self._injector is not None:
            self._injector.begin_step(self._step_no)
        if self.guard is not None and self.guard.should_save:
            self.draining = True
        events = StepEvents(prefilled=[], tokens={}, completed=[],
                            n_active=0, n_queued=0)
        self._expire(events, self._now())
        t0 = time.perf_counter()
        for _ in range(self.prefill_budget):
            if not self._prefill_one(events):
                break
        t1 = time.perf_counter()
        events.prefill_lane_s = t1 - t0
        # shipping scatters into the decode pool, so it bills decode
        self._join_ready(events)
        n_active = len(self.slots)
        if n_active:
            # clamp to the pow2 bucket of the largest remaining budget —
            # exact clamping would give up to decode_chunk distinct
            # chunk shapes; the bucket keeps it to log2 like the batch
            # dimension, while a tail of short requests stops paying for
            # whole chunks of discarded steps
            n_steps = min(self.decode_chunk,
                          next_pow2(max(s.rem for s in self.slots)))
            bucket = min(next_pow2(n_active), self.max_batch) \
                if self.bucket_batch else self.max_batch
            active = torch.arange(self.max_batch,
                                  device=self.device) < n_active
            toks, self.cache = self.engine.decode_chunk(
                self._toks, self.cache, active,
                self._samp_tensors(n_active), n_steps=n_steps,
                bucket=bucket)
            self.dispatches["decode_steps"] += n_steps
            self._toks[:bucket] = toks[-1]
            host = toks.cpu().numpy()            # (n_steps, bucket)
            for b, slot in enumerate(self.slots):
                m = min(n_steps, slot.rem)
                events.wasted_decode_tokens += n_steps - m
                new = host[:m, b].tolist()
                slot.emitted.extend(new)
                slot.rem -= m
                slot.t_true += m
                self._last_used[slot.sid] = self._step_no
                events.tokens.setdefault(slot.rid, []).extend(new)
            # leave in reverse so swap-remove never disturbs an earlier
            # finished row we have yet to process
            for b in range(len(self.slots) - 1, -1, -1):
                if self.slots[b].rem == 0:
                    events.completed.append(self._leave(b))
        events.n_active = len(self.slots)
        events.n_queued = (len(self.queue) + len(self._inflight)
                           + len(self._ready) + len(self._evicted))
        events.decode_lane_s = time.perf_counter() - t1
        return events

    @property
    def idle(self) -> bool:
        return not (self.queue or self.slots or self._inflight
                    or self._ready or self._evicted)

    @property
    def drained(self) -> bool:
        """Draining finished: every in-flight request ran to completion
        (queued-but-unstarted requests stay queued — they were never
        admitted and hold no pages)."""
        return self.draining and not (self.slots or self._inflight
                                      or self._ready or self._evicted)

    def shutdown(self) -> dict:
        """Preemption-safe exit once drained (or idle): spill every
        kept session to host and return ``{sid: HostSpill}`` — after
        this both pools hold zero pages (the leak gate of the chaos
        bench) and the spills are the state a restart would restore."""
        if self.slots or self._inflight or self._ready or self._evicted:
            raise RuntimeError("shutdown with requests still in flight "
                               "(drain first)")
        for sid in list(self.pool.sessions()):
            self._spilled[sid] = self.pool.spill(sid,
                                                 capacity=self.capacity)
        if self.prefill_pool is not None:
            for sid in list(self.prefill_pool.sessions()):
                self._spilled[sid] = self.prefill_pool.spill(
                    sid, capacity=self.capacity)
        return dict(self._spilled)

    def run_until_idle(self, max_steps: int = 100_000) -> dict:
        """Drain queue + batch; returns {rid: Completion}. Stops early
        when a preemption drain completes (queued requests remain)."""
        done: dict = {}
        for _ in range(max_steps):
            if self.idle or self.drained:
                return done
            for c in self.step().completed:
                done[c.rid] = c
        raise RuntimeError(f"not idle after {max_steps} steps "
                           f"({len(self.queue)} queued, "
                           f"{len(self.slots)} active)")
