"""Fault tolerance: retries of restartable host-side work.

Only ``retry`` is ported, which the pruning executor wraps its group
checkpoint writes in; heartbeats, preemption guards and straggler
monitoring come with training (ROADMAP A3).
"""
from __future__ import annotations

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
