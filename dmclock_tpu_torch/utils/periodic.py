"""Periodic background job thread (the port's copy of
``dmclock_tpu/utils/periodic.py``).

Equivalent of the reference's ``RunEvery`` (``support/src/run_every.h:32-80``,
``support/src/run_every.cc:61-94``): a thread that waits ``period`` between
invocations of ``body``, supports live period updates (``try_update``),
and joins cleanly on destruction/stop.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class PeriodicTask:
    """Run ``body()`` every ``period_s`` seconds on a daemon thread.

    ``try_update(new_period_s)`` only shortens the *next* wait if the
    new period is smaller, mirroring ``RunEvery::try_update``
    (run_every.cc:77-81) which resets the wait window.
    """

    def __init__(self, period_s: float, body: Callable[[], None],
                 start: bool = True):
        self._period_s = float(period_s)
        self._body = body
        self._finishing = False
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dmclock-periodic")
            self._thread.start()

    def try_update(self, new_period_s: float) -> None:
        with self._cv:
            self._period_s = float(new_period_s)
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._finishing = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # join-on-delete mirrors RunEvery's destructor (run_every.cc:61-74)
    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.stop()
        except Exception:
            pass

    def _run(self) -> None:
        import time as _time
        with self._cv:
            deadline = _time.monotonic() + self._period_s
            while not self._finishing:
                remaining = deadline - _time.monotonic()
                if remaining > 0:
                    # woken early by try_update/stop: recompute deadline
                    # against the (possibly shortened) period and re-wait
                    self._cv.wait(timeout=remaining)
                    deadline = min(deadline, _time.monotonic() + self._period_s)
                    continue
                if self._finishing:
                    return
                # run the body outside the lock so body() may call
                # try_update without deadlocking
                self._cv.release()
                try:
                    self._body()
                finally:
                    self._cv.acquire()
                deadline = _time.monotonic() + self._period_s
