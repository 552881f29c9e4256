"""Steady-state tracing watchdog.

Counterpart of ``dmclock_tpu/obs/watchdog.py``; host code only, so the
port keeps its own copy.  A background sampler over a
:class:`~.spans.SpanTracer` (and optionally the metrics registry) that
turns the span stream into structured health warnings while a run is
still going:

- **launch-cadence stall**: no ``dispatch``-category span has completed
  for longer than ``stall_after_s`` while at least one had before -- the
  serve loop stopped launching.  Streaming-aware: an OPEN
  dispatch/device_compute span (a stream chunk legitimately runs for
  seconds per launch), bounded by ``in_flight_max_s``, or a recent
  drain-category heartbeat counts as a live cadence, never a stall;
- **dispatch share**: over the last judged window, host ``dispatch``
  self-time exceeds ``dispatch_share_warn`` of the
  dispatch+device_compute total -- the run pays more to launch work
  than to do it;
- **retrace storm** (when a ``compile_plane`` is attached,
  ``obs/compile_plane.py``): one program's cache entry captured again
  >= ``retrace_storm_k`` times inside ``retrace_window_s`` -- an
  argument signature is churning (a shape bug, an un-padded dynamic
  dimension) and every churn pays a warm-up and a capture.  First
  captures are not retraces, so capturing each chunk length ahead of
  the timed chains can never fire this.

Warnings are structured: one JSON line on ``log`` (default stderr,
prefixed ``# watchdog:``), a bump of the
``dmclock_watchdog_warnings_total`` registry counter when a registry
is attached, and an entry in :attr:`Watchdog.warnings`.
``poll_once()`` is the deterministic seam -- the thread just calls it
on an interval.  Telemetry must never kill the run it observes: the
sampler catches and counts its own failures.
"""

from __future__ import annotations

import json
import sys
import threading
import time as _walltime
from typing import Callable, List, Optional

from .spans import SpanTracer


def _stderr_log(line: str) -> None:
    print(line, file=sys.stderr)


class Watchdog:
    """Background steady-state monitor over a span tracer.

    ``interval_s`` is the sampling period; ``stall_after_s`` the
    silence (no completed dispatch span) that counts as a stalled
    launch cadence; ``dispatch_share_warn`` the windowed
    dispatch/(dispatch+device_compute) self-time share past which the
    run is dispatch-tax-bound.  ``min_window_ns`` gates the share
    check on enough observed time to be meaningful.  ``clock_ns`` is
    injectable for deterministic tests (must be the same clock domain
    as the tracer's, and the attached ``compile_plane``'s)."""

    def __init__(self, tracer: SpanTracer, *,
                 interval_s: float = 1.0,
                 stall_after_s: float = 5.0,
                 dispatch_share_warn: float = 0.6,
                 min_window_ns: int = 1_000_000,
                 in_flight_max_s: Optional[float] = None,
                 registry=None,
                 compile_plane=None,
                 retrace_storm_k: int = 4,
                 retrace_window_s: float = 120.0,
                 log: Callable[[str], None] = _stderr_log,
                 clock_ns: Callable[[], int] =
                 _walltime.perf_counter_ns):
        self.tracer = tracer
        self.interval_s = float(interval_s)
        self.stall_after_ns = int(stall_after_s * 1e9)
        # how long an OPEN dispatch/device_compute span may suppress
        # the stall warning: a fused stream chunk legitimately runs
        # far past stall_after_s inside one launch, but a launch the
        # runtime wedged INSIDE must still surface -- default 10x the
        # stall threshold
        self.in_flight_max_ns = int(
            (10.0 * stall_after_s if in_flight_max_s is None
             else in_flight_max_s) * 1e9)
        self.dispatch_share_warn = float(dispatch_share_warn)
        self.min_window_ns = int(min_window_ns)
        self._log = log
        self._clock = clock_ns
        self.warnings: List[dict] = []
        self.polls = 0
        self.poll_errors = 0
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "dmclock_watchdog_warnings_total",
                "structured warnings emitted by the tracing watchdog "
                "(launch-cadence stalls, dispatch-share breaches; "
                "docs/OBSERVABILITY.md)")
        self._prev_count = tracer.category_counts()
        # the share check keeps its OWN baseline, advanced only when a
        # window is actually judged: skipped (mid-chain) windows must
        # accumulate their dispatch time into the next judged window,
        # not vanish from it
        self._share_prev = tracer.category_totals()
        self._share_prev_count = dict(self._prev_count)
        # retrace-storm check: the plane's event clock must share this
        # watchdog's clock domain (both default perf_counter_ns; tests
        # inject one fake into both)
        self._cplane = compile_plane
        self.retrace_storm_k = int(retrace_storm_k)
        self.retrace_window_ns = int(retrace_window_s * 1e9)
        self._stall_warned = False
        self._share_warned = False
        self._retrace_warned = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the deterministic seam ---------------------------------------
    def poll_once(self, now_ns: Optional[int] = None) -> List[dict]:
        """One sampling pass; returns the warnings it emitted."""
        self.polls += 1
        if now_ns is None:
            now_ns = self._clock()
        out: List[dict] = []
        totals = self.tracer.category_totals()
        counts = self.tracer.category_counts()

        # launch-cadence stall: dispatch spans have happened before,
        # none since, and the last one ended too long ago.  Two
        # streaming-mode exceptions (docs/OBSERVABILITY.md), or every
        # healthy fused stream chunk would fire this:
        #  - in-flight awareness: an OPEN dispatch/device_compute span
        #    means a launch is dispatched or the host is blocked on
        #    its result -- a chunk running for seconds is work, not
        #    silence.  BOUNDED by in_flight_max_ns: a launch the
        #    runtime wedged INSIDE (the original failure mode this
        #    check exists for) stops suppressing once the open span
        #    outlives the wedge threshold;
        #  - stream heartbeat: the serve loop emits a drain-category
        #    instant at every drain point, so recent drain activity
        #    proves the loop is alive between launches.
        last = self.tracer.last_end_ns("dispatch")
        open_t0 = self.tracer.oldest_open_ns()
        launch_in_flight = open_t0 is not None and \
            now_ns - open_t0 <= self.in_flight_max_ns
        hb = self.tracer.last_end_ns("drain")
        hb_recent = hb is not None and \
            now_ns - hb <= self.stall_after_ns
        if last is not None and \
                not launch_in_flight and not hb_recent and \
                counts.get("dispatch", 0) == \
                self._prev_count.get("dispatch", 0) and \
                now_ns - last > self.stall_after_ns:
            if not self._stall_warned:    # once per stall episode
                out.append({"kind": "launch_stall",
                            "silent_ms": (now_ns - last) / 1e6,
                            "launches": counts.get("dispatch", 0)})
            self._stall_warned = True
        else:
            self._stall_warned = False

        # dispatch share over the window since the LAST JUDGED poll.
        # A window is judged only when it saw at least one device span
        # COMPLETE: the chained-launch wiring records device time once
        # per chain (the digest sync), so a poll landing mid-chain
        # sees dispatch-only deltas that measure span placement, not
        # the dispatch tax.  Skipped windows keep the share baseline
        # where it was -- their dispatch time accumulates into the
        # next judged window instead of vanishing from it (otherwise
        # a long chain's mid-chain dispatch would never be judged at
        # all).  Once per breach episode, like the stall.
        d_disp = totals.get("dispatch", 0) - \
            self._share_prev.get("dispatch", 0)
        d_dev = totals.get("device_compute", 0) - \
            self._share_prev.get("device_compute", 0)
        dev_seen = counts.get("device_compute", 0) > \
            self._share_prev_count.get("device_compute", 0)
        window = d_disp + d_dev
        if dev_seen and window >= self.min_window_ns:
            share = d_disp / window
            if share > self.dispatch_share_warn:
                if not self._share_warned:
                    out.append({"kind": "dispatch_share",
                                "share": round(share, 4),
                                "dispatch_ms": d_disp / 1e6,
                                "device_ms": d_dev / 1e6,
                                "threshold": self.dispatch_share_warn})
                self._share_warned = True
            else:
                self._share_warned = False
            self._share_prev = totals
            self._share_prev_count = counts
        self._prev_count = counts

        # retrace storm: the SAME cache entry captured again >= K times
        # in the window.  First captures never count (a retrace is the
        # second and later signature on one entry), so capturing each
        # chunk length ahead of the chains is invisible here.  Once per
        # episode; a window with no entry at storm level re-arms.
        if self._cplane is not None and self.retrace_storm_k > 0:
            lo = now_ns - self.retrace_window_ns
            per: dict = {}
            for t_ns, entry in self._cplane.retrace_events():
                if t_ns >= lo:
                    per[entry] = per.get(entry, 0) + 1
            worst = max(per.items(), key=lambda kv: kv[1],
                        default=(None, 0))
            if worst[1] >= self.retrace_storm_k:
                if not self._retrace_warned:
                    out.append({"kind": "retrace_storm",
                                "entry": worst[0],
                                "retraces": worst[1],
                                "window_s":
                                    self.retrace_window_ns / 1e9})
                self._retrace_warned = True
            else:
                self._retrace_warned = False

        for w in out:
            self.warnings.append(w)
            if self._counter is not None:
                self._counter.inc()
            self._log("# watchdog: " +
                      json.dumps(w, separators=(",", ":")))
        return out

    def external_warning(self, obj: dict) -> None:
        """Route a structured warning from another monitor (the SLO
        burn-rate evaluator, ``obs.alerts``) through this watchdog's
        stream: appended to :attr:`warnings`, counted in the registry
        counter, logged in the same one-JSON-line format -- one
        warning stream (and one counter) for the whole run."""
        self.warnings.append(obj)
        if self._counter is not None:
            self._counter.inc()
        self._log("# watchdog: " +
                  json.dumps(obj, separators=(",", ":")))

    # -- the thread ----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:   # never kill the run being observed
                self.poll_errors += 1

    def start(self) -> "Watchdog":
        assert self._thread is None, "watchdog already started"
        self._thread = threading.Thread(target=self._run,
                                        name="span-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
