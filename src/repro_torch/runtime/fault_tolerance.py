"""Fault tolerance: retries of restartable host-side work, and
checkpoint-on-signal.

``retry`` wraps the pruning executor's group checkpoint writes and the
serving scheduler's page shipping; ``PreemptionGuard`` turns SIGTERM into
a flag the serving scheduler polls to drain. Heartbeats and straggler
monitoring come with training (ROADMAP A3).
"""
from __future__ import annotations

import signal
import threading
import time
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
