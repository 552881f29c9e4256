"""Profiling accumulators (counterpart of ``dmclock_tpu/utils/profile.py``).

The reference's ``support/src/profile.h``: start/stop timers
accumulating count / sum / sum of squares / min / max (for mean and
standard deviation), and a combiner that merges timers collected on
different threads or servers (``ProfileCombiner``, profile.h:100-120).
"""

from __future__ import annotations

import math
import time as _walltime


class _ProfileBase:
    def __init__(self):
        self.count = 0
        self.sum_ns = 0
        self.sum_sq_ns = 0.0
        self.low_ns = None
        self.high_ns = None

    def _accumulate(self, duration_ns: int) -> None:
        self.count += 1
        self.sum_ns += duration_ns
        self.sum_sq_ns += float(duration_ns) * duration_ns
        if self.low_ns is None or duration_ns < self.low_ns:
            self.low_ns = duration_ns
        if self.high_ns is None or duration_ns > self.high_ns:
            self.high_ns = duration_ns

    def mean_ns(self) -> float:
        return self.sum_ns / self.count if self.count else 0.0

    def std_dev_ns(self) -> float:
        # same estimator as reference ProfileBase (profile.h:43-51)
        if self.count < 2:
            return 0.0
        mean = self.mean_ns()
        var = (self.sum_sq_ns - self.count * mean * mean) / (self.count - 1)
        return math.sqrt(max(0.0, var))


class ProfileTimer(_ProfileBase):
    """ns-resolution start/stop accumulator (profile.h:61-97)."""

    def __init__(self):
        super().__init__()
        self._start_ns = None
        # start() calls that found the timer already running: the
        # in-flight interval is abandoned and the timer restarts
        # cleanly (under PYTHONOPTIMIZE the old assert stripped and
        # the discard was SILENT -- a reentrant caller deflated its
        # own count/sum without a trace)
        self.reentries = 0

    def start(self) -> None:
        if self._start_ns is not None:
            self.reentries += 1
        self._start_ns = _walltime.perf_counter_ns()

    def stop(self) -> None:
        assert self._start_ns is not None, "timer not started"
        self._accumulate(_walltime.perf_counter_ns() - self._start_ns)
        self._start_ns = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class ProfileCombiner(_ProfileBase):
    """Merge timers from multiple sources (profile.h:100-120)."""

    def combine(self, timer: _ProfileBase) -> None:
        if timer.count == 0:
            return
        self.count += timer.count
        self.sum_ns += timer.sum_ns
        self.sum_sq_ns += timer.sum_sq_ns
        if self.low_ns is None or (timer.low_ns is not None
                                   and timer.low_ns < self.low_ns):
            self.low_ns = timer.low_ns
        if self.high_ns is None or (timer.high_ns is not None
                                    and timer.high_ns > self.high_ns):
            self.high_ns = timer.high_ns
