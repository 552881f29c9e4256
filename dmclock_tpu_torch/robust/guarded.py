"""Bounded retry with exponential backoff (the port's copy of
``retry_with_backoff`` from ``dmclock_tpu/robust/guarded.py``).

The pull queue wraps every device launch in :func:`retry_with_backoff`.
Launches are pure (state rebinds only from a returned value), so a
failed attempt commits nothing.

Only transport-level failures are retried: ``OSError`` (which covers
``ConnectionError``) and ``TimeoutError``.  The JAX set adds its device
runtime error; PyTorch has no counterpart to add.  A CUDA error is
sticky in a process -- every later call on that context fails too -- so
a retry cannot clear it: it is never caught here, and nothing falls
back to the CPU.  Plain ``RuntimeError`` is not retried either: a
generic host error is a caller bug.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

RECOVERABLE_ERRORS = (OSError, TimeoutError)


def retry_with_backoff(fn: Callable, *, retries: int = 3,
                       base_s: float = 0.05, factor: float = 2.0,
                       max_s: float = 2.0,
                       recoverable=RECOVERABLE_ERRORS,
                       on_retry: Optional[Callable[[int, BaseException],
                                                   None]] = None,
                       sleep: Callable[[float], None] = _time.sleep,
                       jitter_seed: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       clock: Callable[[], float] = _time.monotonic):
    """Call ``fn()``; on a recoverable error sleep
    ``min(base_s * factor**i, max_s)`` and retry, at most ``retries``
    times, then re-raise the last error.  ``on_retry(attempt, exc)``
    observes each retry.  ``fn`` must be idempotent.

    ``jitter_seed`` scales every sleep by a deterministic per-seed
    multiplier in ``[0.5, 1.5)`` (numpy PCG64), so callers retrying
    after one shared failure spread out.  ``deadline_s`` bounds the
    total time measured by ``clock()``: once spent, the next
    recoverable error re-raises even with retries left, and a final
    sleep is cut to the remaining budget."""
    rng = None
    if jitter_seed is not None:
        import numpy as np
        rng = np.random.Generator(np.random.PCG64(int(jitter_seed)))
    t0 = clock() if deadline_s is not None else 0.0
    attempt = 0
    while True:
        try:
            return fn()
        except recoverable as e:
            if attempt >= retries:
                raise
            if deadline_s is not None and clock() - t0 >= deadline_s:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = min(base_s * (factor ** attempt), max_s)
            if rng is not None:
                delay *= 0.5 + rng.random()
            if deadline_s is not None:
                delay = min(delay, max(deadline_s - (clock() - t0), 0.0))
            sleep(delay)
            attempt += 1
