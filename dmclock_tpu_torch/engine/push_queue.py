"""Push-mode surface over the device engine (the port of
``dmclock_tpu/engine/push_queue.py``).

Equivalent of the reference ``PushPriorityQueue``
(``dmclock_server.h:1504-1797``) redesigned for a batched device
engine: the queue drives the server by invoking ``handle_f(client,
request, phase, cost)`` whenever ``can_handle_f()`` is true and a
request is eligible, with timed wakeups for future-eligible requests on
a dedicated sched-ahead thread (reference ``run_sched_ahead``
:1760-1786), or, in the virtual-time embedding, through the embedder's
``sched_at_f``.

Batch-boundary sched_ahead: a scheduling pass pulls a BATCH of
decisions in one launch -- sized by the embedder's ``capacity_f()``
when provided, else one at a time so the ``can_handle_f`` gate is
consulted before every dispatch exactly like the reference.  The
sched-ahead timer is armed once per batch from the batch-terminal
FUTURE decision.  ``**pull_kwargs`` (``device=`` among them) go to the
underlying ``TpuPullPriorityQueue``, whose readbacks run under its
``data_mtx`` on the default stream.
"""

from __future__ import annotations

import threading
import time as _walltime
from typing import Any, Callable, Optional

from ..core.qos import ClientInfo
from ..core.recs import Phase, ReqParams
from ..core.timebase import NS_PER_SEC, TIME_ZERO, sec_to_ns
from .queue import TpuPullPriorityQueue

ClientInfoFunc = Callable[[Any], Optional[ClientInfo]]


class TpuPushPriorityQueue:
    """Queue-drives-server mode on the batched device engine."""

    def __init__(self, client_info_f: ClientInfoFunc,
                 can_handle_f: Callable[[], bool],
                 handle_f: Callable[[Any, Any, Phase, int], None],
                 *,
                 capacity_f: Optional[Callable[[], int]] = None,
                 # capacity_f CONTRACT: when provided, can_handle_f()
                 # must be equivalent to capacity_f() > 0.  A batch pops
                 # up to capacity_f() requests from device state before
                 # the handle_f calls run, re-consulting can_handle_f
                 # only between batches -- so a gate that can close
                 # mid-batch for reasons other than slot exhaustion
                 # would see dispatches it meant to refuse (the
                 # reference consults can_handle before every dispatch;
                 # omit capacity_f to get that per-dispatch behavior).
                 batch_max: int = 64,
                 now_ns_f: Optional[Callable[[], int]] = None,
                 sched_at_f: Optional[Callable[[int], None]] = None,
                 **pull_kwargs):
        self._q = TpuPullPriorityQueue(client_info_f, **pull_kwargs)
        self.can_handle_f = can_handle_f
        self.handle_f = handle_f
        self.capacity_f = capacity_f
        self.batch_max = batch_max
        # virtual-time embedding (see the host PushPriorityQueue): the
        # injected clock feeds scheduling decisions and default arrival
        # stamps; sched_at_f must arrange a sched_ahead_fire() call at
        # the given virtual time, and no sched-ahead thread is spawned
        self._now_ns_f = now_ns_f or (lambda: sec_to_ns(_walltime.time()))
        self._sched_at_f = sched_at_f
        self._finishing = False
        # serializes scheduling passes so handle_f invocations are
        # totally ordered (the oracle holds data_mtx across the whole
        # pass; here pull_batch only locks per launch)
        self._dispatch_mtx = threading.Lock()
        self._sched_cv = threading.Condition()
        self._sched_when = TIME_ZERO  # ns; 0 = unarmed
        self._sched_thd = None
        if sched_at_f is None:
            self._sched_thd = threading.Thread(
                target=self._run_sched_ahead, daemon=True,
                name="dmclock-torch-sched-ahead")
            self._sched_thd.start()

    # ------------------------------------------------------------------
    # embedder API (mirrors oracle PushPriorityQueue)
    # ------------------------------------------------------------------
    def add_request(self, request: Any, client_id: Any,
                    req_params: ReqParams = ReqParams(),
                    time_ns: Optional[int] = None, cost: int = 1) -> int:
        if time_ns is None:
            time_ns = self._now_ns_f()
        r = self._q.add_request(request, client_id, req_params,
                                time_ns=time_ns, cost=cost)
        if r == 0:
            self._schedule_request()
        return r

    def request_completed(self) -> None:
        """Server signals a finished op (reference request_completed
        :1651-1660): capacity may have opened, so re-evaluate."""
        self._schedule_request()

    def shutdown(self) -> None:
        self._finishing = True
        with self._sched_cv:
            self._sched_cv.notify_all()
        if self._sched_thd is not None:
            self._sched_thd.join()
        self._q.shutdown()

    # pass-through inspection / maintenance surface
    def empty(self) -> bool:
        return self._q.empty()

    def client_count(self) -> int:
        return self._q.client_count()

    def request_count(self) -> int:
        return self._q.request_count()

    def update_client_info(self, client_id: Any) -> None:
        self._q.update_client_info(client_id)

    def do_clean(self) -> None:
        self._q.do_clean()

    @property
    def reserv_sched_count(self) -> int:
        return self._q.reserv_sched_count

    @property
    def prop_sched_count(self) -> int:
        return self._q.prop_sched_count

    @property
    def limit_break_sched_count(self) -> int:
        return self._q.limit_break_sched_count

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _schedule_request(self) -> None:
        """One scheduling pass (reference schedule_request :1741-1755 +
        next_request's can_handle gate :1729-1737), batched."""
        with self._dispatch_mtx:
            self._schedule_locked()

    def _schedule_locked(self) -> None:
        while True:
            if self._finishing or not self.can_handle_f():
                return
            if self.capacity_f is not None:
                n = min(self.capacity_f(), self.batch_max)
                if n <= 0:
                    return
            else:
                n = 1  # consult can_handle_f before every dispatch
            now_ns = self._now_ns_f()
            batch = self._q.pull_batch(now_ns, n)
            dispatched = 0
            for pr in batch:
                if pr.is_retn():
                    self.handle_f(pr.client, pr.request, pr.phase,
                                  pr.cost)
                    dispatched += 1
                elif pr.is_future():
                    self._sched_at(pr.when_ready)
                    return
                else:
                    return
            if dispatched < n:
                # fewer decisions than requested: queue went NONE/FUTURE
                # inside the launch; nothing more is eligible right now
                return
            # full batch served -- more may be eligible; loop re-checks
            # the can_handle gate before pulling again

    def _sched_at(self, when_ns: int) -> None:
        # reference sched_at (:1789-1796); the armed-deadline dedup
        # also gates the virtual sched_at_f path
        with self._sched_cv:
            if self._finishing:
                return
            if self._sched_when == TIME_ZERO or \
                    when_ns < self._sched_when:
                self._sched_when = when_ns
                if self._sched_at_f is not None:
                    self._sched_at_f(when_ns)
                else:
                    self._sched_cv.notify_all()

    def sched_ahead_fire(self) -> None:
        """Virtual-time embedding: the ``sched_at_f`` callback landed --
        disarm and re-evaluate scheduling at the (virtual) now."""
        with self._sched_cv:
            if self._finishing:
                return
            self._sched_when = TIME_ZERO
        self._schedule_request()

    def _run_sched_ahead(self) -> None:
        # reference run_sched_ahead (:1760-1786): the armed deadline is
        # only consumed once it has passed; early wakeups re-evaluate
        with self._sched_cv:
            while not self._finishing:
                if self._sched_when == TIME_ZERO:
                    self._sched_cv.wait()
                    continue
                delay_s = (self._sched_when
                           - self._now_ns_f()) / NS_PER_SEC
                if delay_s > 0:
                    self._sched_cv.wait(timeout=delay_s)
                    continue
                self._sched_when = TIME_ZERO
                if self._finishing:
                    return
                self._sched_cv.release()
                try:
                    self._schedule_request()
                finally:
                    self._sched_cv.acquire()
