"""Core dmClock types for the PyTorch port (own copies; the port imports
nothing from ``dmclock_tpu``): the int64-ns time/tag constants
(``timebase``), ``ClientInfo`` (``qos``), ``Phase``/``ReqParams``
(``recs``), the tag algebra (``tags``), the oracle queues with the queue
API's ``AtLimit``, ``NextReqType`` and ``PullReq`` (``scheduler``) and
the client-side ``ServiceTracker`` (``tracker``)."""

from .qos import ClientInfo
from .recs import Cost, Counter, Phase, ReqParams
from .scheduler import (AtLimit, ClientRec, ClientReq, HeapId, NextReq,
                        NextReqType, PriorityQueueBase, PullPriorityQueue,
                        PullReq, PushPriorityQueue)
from .tags import RequestTag, ZERO_TAG, tag_calc
from .timebase import (MAX_TAG, MIN_TAG, NS_PER_SEC, TIME_MAX, TIME_ZERO,
                       format_tag, min_not_0_time, ns_to_sec,
                       rate_to_inv_ns, sec_to_ns)
from .tracker import (BorrowingTracker, GlobalCounters, OrigTracker,
                      ServiceTracker)

__all__ = [
    "ClientInfo", "Cost", "Counter", "Phase", "ReqParams",
    "AtLimit", "ClientRec", "ClientReq", "HeapId", "NextReq",
    "NextReqType", "PriorityQueueBase", "PullPriorityQueue", "PullReq",
    "PushPriorityQueue",
    "RequestTag", "ZERO_TAG", "tag_calc",
    "MAX_TAG", "MIN_TAG", "NS_PER_SEC", "TIME_MAX", "TIME_ZERO",
    "format_tag", "min_not_0_time", "ns_to_sec", "rate_to_inv_ns",
    "sec_to_ns",
    "BorrowingTracker", "GlobalCounters", "OrigTracker", "ServiceTracker",
]
