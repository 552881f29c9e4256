"""Client-side distributed service tracking.

Equivalent of the reference's ``src/dmclock_client.h``: a client keeps
global completion counters (delta = all completions, rho =
reservation-phase completions) plus one per-server tracker; each request
to server S carries the counter movement since the previous request to
S, minus the client's own contribution there -- the entire "distributed
protocol" of dmClock.  Two accounting policies are provided, mirroring
``OrigTracker`` (:39-84) and ``BorrowingTracker`` (:90-154).

The port's copy of ``dmclock_tpu/core/tracker.py``; phases are the
port's own ``core.recs.Phase``.  The device version of the same
contract (per-(server, client) counters, the global counters a sum over
the server axis) lives in ``parallel.tracker``.
"""

from __future__ import annotations

import threading
import time as _walltime
from collections import deque
from typing import Callable, Deque, Dict, Generic, Tuple, TypeVar

from .recs import Phase, ReqParams
from ..utils.periodic import PeriodicTask

S = TypeVar("S")  # server id type
# monotone completion counters and per-request cost
# (reference dmclock_recs.h:25, :31)
Counter = int
Cost = int


class OrigTracker:
    """Best-effort original dmClock delta/rho accounting
    (reference dmclock_client.h:39-84)."""

    __slots__ = ("delta_prev_req", "rho_prev_req", "my_delta", "my_rho")

    def __init__(self, global_delta: Counter, global_rho: Counter):
        self.delta_prev_req = global_delta
        self.rho_prev_req = global_rho
        self.my_delta = 0
        self.my_rho = 0

    @classmethod
    def create(cls, the_delta: Counter, the_rho: Counter) -> "OrigTracker":
        return cls(the_delta, the_rho)

    def prepare_req(self, counters: "GlobalCounters") -> ReqParams:
        delta_out = counters.delta - self.delta_prev_req - self.my_delta
        rho_out = counters.rho - self.rho_prev_req - self.my_rho
        self.delta_prev_req = counters.delta
        self.rho_prev_req = counters.rho
        self.my_delta = 0
        self.my_rho = 0
        return ReqParams(int(delta_out), int(rho_out))

    def resp_update(self, phase: Phase, counters: "GlobalCounters",
                    cost: Cost) -> None:
        counters.delta += cost
        self.my_delta += cost
        if phase is Phase.RESERVATION:
            counters.rho += cost
            self.my_rho += cost

    def get_last_delta(self) -> Counter:
        return self.delta_prev_req


class BorrowingTracker:
    """Always-positive delta/rho accounting by borrowing future replies
    (reference dmclock_client.h:90-154)."""

    __slots__ = ("delta_prev_req", "rho_prev_req", "delta_borrow",
                 "rho_borrow")

    def __init__(self, global_delta: Counter, global_rho: Counter):
        self.delta_prev_req = global_delta
        self.rho_prev_req = global_rho
        self.delta_borrow = 0
        self.rho_borrow = 0

    @classmethod
    def create(cls, the_delta: Counter, the_rho: Counter) -> "BorrowingTracker":
        return cls(the_delta, the_rho)

    @staticmethod
    def _calc_with_borrow(global_c: Counter, previous: Counter,
                          borrow: int) -> Tuple[Counter, int]:
        # reference calc_with_borrow (:110-129)
        result = global_c - previous
        if result == 0:
            return 1, borrow + 1
        if result > borrow:
            return result - borrow, 0
        return 1, borrow - result + 1

    def prepare_req(self, counters: "GlobalCounters") -> ReqParams:
        delta_out, self.delta_borrow = self._calc_with_borrow(
            counters.delta, self.delta_prev_req, self.delta_borrow)
        rho_out, self.rho_borrow = self._calc_with_borrow(
            counters.rho, self.rho_prev_req, self.rho_borrow)
        self.delta_prev_req = counters.delta
        self.rho_prev_req = counters.rho
        return ReqParams(int(delta_out), int(rho_out))

    def resp_update(self, phase: Phase, counters: "GlobalCounters",
                    cost: Cost) -> None:
        counters.delta += cost
        if phase is Phase.RESERVATION:
            counters.rho += cost

    def get_last_delta(self) -> Counter:
        return self.delta_prev_req


class GlobalCounters:
    """The client's global completion counters.

    Start at 1 because 0 is reserved by the cleaning logic
    (reference dmclock_client.h:191-198)."""

    __slots__ = ("delta", "rho")

    def __init__(self):
        self.delta: Counter = 1
        self.rho: Counter = 1


class ServiceTracker(Generic[S]):
    """Per-client distributed state across servers
    (reference ServiceTracker, dmclock_client.h:157-287).

    tracker_cls plugs in the accounting policy (OrigTracker default).
    """

    def __init__(self, tracker_cls=OrigTracker,
                 clean_every_s: float = 300.0,
                 clean_age_s: float = 600.0,
                 run_gc_thread: bool = True,
                 monotonic_clock: Callable[[], float] = _walltime.monotonic):
        self._tracker_cls = tracker_cls
        self.counters = GlobalCounters()
        self.server_map: Dict[S, object] = {}
        self.data_mtx = threading.Lock()
        self.clean_age_s = clean_age_s
        self._clean_mark_points: Deque[Tuple[float, Counter]] = deque()
        self._monotonic = monotonic_clock
        self._cleaning_job: PeriodicTask | None = None
        if run_gc_thread:
            self._cleaning_job = PeriodicTask(clean_every_s, self.do_clean)

    def shutdown(self) -> None:
        if self._cleaning_job is not None:
            self._cleaning_job.stop()
            self._cleaning_job = None

    def track_resp(self, server_id: S, phase: Phase,
                   request_cost: Cost = 1) -> None:
        """Incorporate a response (reference track_resp :221-236).

        Self-heals by creating a tracker if a response arrives for an
        unknown (possibly GC'd) server.
        """
        with self.data_mtx:
            t = self.server_map.get(server_id)
            if t is None:
                t = self._tracker_cls.create(self.counters.delta,
                                             self.counters.rho)
                self.server_map[server_id] = t
            t.resp_update(phase, self.counters, request_cost)

    def get_req_params(self, server: S) -> ReqParams:
        """ReqParams to piggyback on the next request to ``server``
        (reference get_req_params :241-251)."""
        with self.data_mtx:
            t = self.server_map.get(server)
            if t is None:
                self.server_map[server] = self._tracker_cls.create(
                    self.counters.delta, self.counters.rho)
                return ReqParams(1, 1)
            return t.prepare_req(self.counters)

    def do_clean(self) -> None:
        """GC server records unused for clean_age
        (reference do_clean :263-286)."""
        now = self._monotonic()
        with self.data_mtx:
            self._clean_mark_points.append((now, self.counters.delta))
            earliest = 0
            while self._clean_mark_points and \
                    self._clean_mark_points[0][0] <= now - self.clean_age_s:
                earliest = self._clean_mark_points[0][1]
                self._clean_mark_points.popleft()
            if earliest > 0:
                for key in list(self.server_map.keys()):
                    if self.server_map[key].get_last_delta() <= earliest:
                        del self.server_map[key]
