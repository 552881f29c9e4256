"""Simple-scheduler (FIFO) baseline (the port's copy of
``dmclock_tpu/sim/ssched.py``).

Equivalent of the reference's ssched comparison scheduler
(``sim/src/ssched/ssched_server.h:35-192`` SimpleQueue FIFO,
``ssched_client.h:25-49`` no-op tracker): same add/pull surface as the
dmclock queues so it drops into the same sim harness as a baseline.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Optional, Tuple

from ..core.recs import Phase, ReqParams
from ..core.scheduler import NextReqType, PullReq


class NullServiceTracker:
    """No-op tracker (reference ssched_client.h:26-49)."""

    def get_req_params(self, server: Any) -> ReqParams:
        return ReqParams(0, 0)

    def track_resp(self, server: Any, phase: Phase, cost: int = 1) -> None:
        pass


class SimpleQueue:
    """Strict-FIFO queue with both the pull and push interfaces
    (reference SimpleQueue, ssched_server.h:36-192: pull_request :154
    and the push-mode schedule_request :184 driven by handle_f under a
    can_handle gate -- the same dual surface the dmclock queues have,
    so ssched can A/B either path)."""

    def __init__(self, can_handle_f=None, handle_f=None):
        self._queue: Deque[Tuple[Any, Any, int]] = deque()
        self.can_handle_f = can_handle_f
        self.handle_f = handle_f

    def add_request(self, request: Any, client_id: Any,
                    req_params: ReqParams = ReqParams(),
                    time_ns: Optional[int] = None, cost: int = 1) -> int:
        self._queue.append((client_id, request, cost))
        if self.handle_f is not None:
            self.schedule_request()
        return 0

    # -- push mode (reference ssched_server.h:184-191) -----------------
    def request_completed(self) -> None:
        if self.handle_f is not None:
            self.schedule_request()

    def schedule_request(self) -> None:
        # at most ONE dispatch per call, like the reference: pacing is
        # one request per add/completion event
        if self._queue and \
                (self.can_handle_f is None or self.can_handle_f()):
            client, request, cost = self._queue.popleft()
            self.handle_f(client, request, Phase.PRIORITY, cost)

    def pull_request(self, now_ns: Optional[int] = None) -> PullReq:
        if not self._queue:
            return PullReq(NextReqType.NONE)
        client, request, cost = self._queue.popleft()
        return PullReq(NextReqType.RETURNING, client=client,
                       request=request, phase=Phase.PRIORITY, cost=cost)

    def request_count(self) -> int:
        return len(self._queue)

    def empty(self) -> bool:
        return not self._queue
