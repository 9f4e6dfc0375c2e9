"""Fault tolerance: retries, heartbeats, preemption, stragglers.

* ``retry`` wraps restartable host-side work: the pruning executor's
  group checkpoint writes, the train launcher's checkpoint I/O, the
  serving scheduler's page shipping.
* ``Heartbeat`` pings a per-host liveness file from a thread; the
  monitor side (``dead_hosts``) declares a host dead after ``timeout``.
  One host runs it here; a multi-host job would restart with the
  survivors (ROADMAP A5).
* ``PreemptionGuard`` turns SIGTERM / SIGINT into a flag that the train
  loop polls (save and exit) and the serving scheduler polls (drain).
* ``StragglerMonitor`` keeps a per-host EWMA of step times and flags a
  host slower than ``factor`` x the median; on one host it flags and logs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from pathlib import Path
from typing import Callable


def retry(fn: Callable, *args, retries: int = 5, base_delay: float = 0.1,
          max_delay: float = 10.0, retry_on: tuple = (OSError,),
          on_retry: Callable[[int, Exception], None] | None = None, **kw):
    """Call ``fn(*args, **kw)``; on an exception in ``retry_on`` wait with
    exponential backoff and try again, ``retries`` times at most, then
    re-raise."""
    delay = base_delay
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kw)
        except retry_on as e:  # noqa: PERF203
            if attempt == retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(delay)
            delay = min(delay * 2, max_delay)


@dataclasses.dataclass
class Heartbeat:
    """Liveness pings to a shared directory; the monitor side detects
    death."""

    dir: str | Path
    host: int = 0
    interval: float = 5.0
    _stop: threading.Event = dataclasses.field(default_factory=threading.Event)
    _thread: threading.Thread | None = None

    def _path(self, host: int) -> Path:
        return Path(self.dir) / f"heartbeat_{host}.json"

    def ping(self, step: int = -1):
        Path(self.dir).mkdir(parents=True, exist_ok=True)
        tmp = self._path(self.host).with_suffix(".tmp")
        tmp.write_text(json.dumps({"t": time.time(), "step": step}))
        os.replace(tmp, self._path(self.host))

    def start(self):
        def loop():
            while not self._stop.wait(self.interval):
                self.ping()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def dead_hosts(self, expected: list[int],
                   timeout: float = 30.0) -> list[int]:
        now = time.time()
        dead = []
        for h in expected:
            try:
                t = json.loads(self._path(h).read_text())["t"]
                if now - t > timeout:
                    dead.append(h)
            except (OSError, json.JSONDecodeError, KeyError):
                dead.append(h)
        return dead


class PreemptionGuard:
    """checkpoint-on-signal: install, then poll ``should_save`` per step."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def should_save(self) -> bool:
        return self._flag.is_set()

    def simulate(self):
        """Tests: behave as if SIGTERM arrived."""
        self._flag.set()


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracking; flags hosts slower than factor x median."""

    factor: float = 2.0
    alpha: float = 0.2
    ewma: dict = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_time: float):
        prev = self.ewma.get(host)
        self.ewma[host] = (step_time if prev is None
                           else self.alpha * step_time
                           + (1 - self.alpha) * prev)

    def median(self) -> float:
        vals = sorted(self.ewma.values())
        return vals[len(vals) // 2] if vals else 0.0

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return [h for h, v in self.ewma.items() if v > self.factor * med]
