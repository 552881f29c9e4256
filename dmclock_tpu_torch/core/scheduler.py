"""The queue API's result and policy types (the port's copy of
``AtLimit``, ``NextReqType`` and ``PullReq`` from
``dmclock_tpu/core/scheduler.py``; reference ``dmclock_server.h:74-84``
and ``PullReq``, :1286-1306).

The JAX package's oracle queues (``PriorityQueueBase``,
``PullPriorityQueue``, ``PushPriorityQueue``, the host heaps) are not
ported: the port's queues (``engine.queue``, ``engine.push_queue``)
serve from the device engine, and the oracle stays the JAX package's
test reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional

from .recs import Phase


class AtLimit(enum.Enum):
    """Over-limit policy (reference dmclock_server.h:74-84)."""

    WAIT = 0    # hold over-limit requests until the limit tag passes
    ALLOW = 1   # limit-break when nothing else is eligible
    REJECT = 2  # add_request returns EAGAIN for over-limit requests


class NextReqType(enum.Enum):
    RETURNING = 0
    FUTURE = 1
    NONE = 2


@dataclass
class PullReq:
    """Result of a pull (reference PullReq, :1286-1306).  ``tag`` stays
    None: the device engine does not materialize per-decision tags."""

    type: NextReqType
    client: Any = None
    request: Any = None
    phase: Optional[Phase] = None
    cost: int = 0
    when_ready: Optional[int] = None  # ns
    tag: Any = None

    def is_none(self) -> bool:
        return self.type is NextReqType.NONE

    def is_retn(self) -> bool:
        return self.type is NextReqType.RETURNING

    def is_future(self) -> bool:
        return self.type is NextReqType.FUTURE
