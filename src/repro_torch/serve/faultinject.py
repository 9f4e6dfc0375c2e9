"""Deterministic fault injection for the serving stack.

Chaos testing is only useful when a failing run can be replayed exactly,
so faults here are *scheduled*, not sampled at runtime: a ``FaultPlan``
names the scheduler steps and call ordinals at which things break, and a
``FaultInjector`` is the stateful driver the scheduler threads through
its hooks. The same plan against the same workload produces the same
fault sequence every run — the chaos CI gate (zero leaked pages,
bitwise-equal completed streams vs the fault-free run) depends on it.

Injection points (see ``serve.scheduler``):

* ``begin_step``  — called at the top of every scheduler step; arms the
  step's faults (pool exhaustion, slow dispatch) and delivers the
  simulated SIGTERM (``PreemptionGuard.simulate``) that flips the
  scheduler into draining mode.
* ``on_reserve``  — installed as ``PagedKVCache.fault_hook``; an armed
  exhaustion raises ``MemoryError`` from the next page reservation, the
  exact error a genuinely full pool raises, so the scheduler's
  evict/retry path is exercised on the real exception type.
* ``on_ship``     — called before every ``ship_pages`` attempt; a
  planned ordinal raises ``ShipFault`` *before* any pool mutates (the
  transfer-failed case), so ``runtime.fault_tolerance.retry`` re-drives
  the ship against intact source pages.
* ``on_dispatch`` — installed as ``ServeEngine.dispatch_hook``; a
  planned slow step sleeps inside the engine's timed dispatch region,
  so injected latency lands in the lane timings the load generator
  measures (a straggler, not a scheduler artifact).

``FaultPlan.chaos(seed)`` draws a representative plan (exhaustions +
ship failures + a slow step + a late SIGTERM) from a seeded rng — the
seed IS the plan, which is what a reproducible chaos sweep wants.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


class ShipFault(RuntimeError):
    """A transient inter-pool page transfer failure (retryable)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected serving faults.

    Args:
        exhaust_pool_at: scheduler step numbers (1-based) at which the
            NEXT page reservation raises ``MemoryError`` — each listed
            step arms exactly one failure, consumed by the first
            alloc/extend that actually needs pages.
        fail_ship: 1-based ``ship_pages`` attempt ordinals that raise
            ``ShipFault`` before any pool state changes; a retry is a
            new ordinal, so a single listed ordinal is a transient
            failure the retry wrapper absorbs.
        slow_steps: ``(step, seconds)`` pairs — the first engine
            dispatch of that scheduler step sleeps ``seconds`` first
            (an injected straggler).
        sigterm_at: scheduler step at which a simulated SIGTERM is
            delivered through the scheduler's ``PreemptionGuard``
            (drain: stop admitting, finish in-flight, exit clean).
    """

    exhaust_pool_at: tuple = ()
    fail_ship: tuple = ()
    slow_steps: tuple = ()
    sigterm_at: int | None = None

    @classmethod
    def chaos(cls, seed: int, *, n_steps: int = 48, exhausts: int = 2,
              ship_fails: int = 1, slow: int = 1,
              sigterm: bool = True) -> "FaultPlan":
        """A seeded everything-at-once plan for chaos runs.

        Faults land in the first two thirds of the window and the
        SIGTERM in the final third, so in-flight traffic sees the
        failures and the drain still has requests to finish.
        """
        rng = np.random.default_rng(seed)
        lo, hi = 2, max(3, (2 * n_steps) // 3)
        pick = lambda n: tuple(
            sorted(int(x) for x in rng.choice(
                np.arange(lo, hi), size=min(n, hi - lo), replace=False)))
        return cls(
            exhaust_pool_at=pick(exhausts),
            fail_ship=tuple(sorted(
                int(x) + 1 for x in rng.choice(
                    6, size=min(ship_fails, 6), replace=False))),
            slow_steps=tuple((s, 0.002 + 0.003 * float(rng.random()))
                             for s in pick(slow)),
            sigterm_at=(int(rng.integers(hi, n_steps)) if sigterm
                        else None),
        )

    def describe(self) -> str:
        parts = []
        if self.exhaust_pool_at:
            parts.append(f"exhaust@{list(self.exhaust_pool_at)}")
        if self.fail_ship:
            parts.append(f"ship-fail#{list(self.fail_ship)}")
        if self.slow_steps:
            parts.append(f"slow@{[s for s, _ in self.slow_steps]}")
        if self.sigterm_at is not None:
            parts.append(f"sigterm@{self.sigterm_at}")
        return " ".join(parts) or "no-faults"


class FaultInjector:
    """Stateful driver of a ``FaultPlan`` through the scheduler hooks.

    One injector per scheduler run: it tracks the current step, counts
    ship attempts, and records every fault it fires in ``log`` as
    ``(step, kind)`` pairs — a chaos test can assert the plan actually
    fired instead of silently passing on an idle schedule.
    """

    def __init__(self, plan: FaultPlan, *, guard=None, sleep=time.sleep):
        self.plan = plan
        self.guard = guard
        self._sleep = sleep
        self._slow = dict(plan.slow_steps)
        self.step_no = 0
        self.ship_calls = 0
        self._armed_exhaust = 0
        self._slow_pending = 0.0
        self.log: list = []

    def begin_step(self, step_no: int) -> None:
        """Arm this step's faults; deliver a planned SIGTERM."""
        self.step_no = step_no
        if step_no in self.plan.exhaust_pool_at:
            self._armed_exhaust += 1
        self._slow_pending = self._slow.get(step_no, 0.0)
        if (self.plan.sigterm_at is not None
                and step_no == self.plan.sigterm_at
                and self.guard is not None):
            self.guard.simulate()
            self.log.append((step_no, "sigterm"))

    def on_reserve(self, pool, need: int) -> None:
        """``PagedKVCache.fault_hook``: armed exhaustion fires here."""
        if self._armed_exhaust > 0:
            self._armed_exhaust -= 1
            self.log.append((self.step_no, "exhaust"))
            raise MemoryError(
                f"injected pool exhaustion at step {self.step_no} "
                f"(need {need} pages)")

    def on_ship(self) -> None:
        """Called before every ship attempt; planned ordinals fail."""
        self.ship_calls += 1
        if self.ship_calls in self.plan.fail_ship:
            self.log.append((self.step_no, "ship"))
            raise ShipFault(
                f"injected page-transfer failure (ship attempt "
                f"{self.ship_calls}, step {self.step_no})")

    def on_dispatch(self, phase: str) -> None:
        """``ServeEngine.dispatch_hook``: planned slow steps sleep."""
        if self._slow_pending:
            s, self._slow_pending = self._slow_pending, 0.0
            self.log.append((self.step_no, "slow"))
            self._sleep(s)

    def fired(self, kind: str) -> int:
        return sum(1 for _, k in self.log if k == kind)
