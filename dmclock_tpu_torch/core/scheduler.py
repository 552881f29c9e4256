"""Oracle (host, pure-Python) dmClock scheduler, and the queue API's
result and policy types.

The port's own copy of ``dmclock_tpu/core/scheduler.py``: a complete,
deterministic re-implementation of the reference server-side engine
(``src/dmclock_server.h``): the two-phase reservation-then-weight
selection of ``do_next_request`` (:1115-1186), delayed/immediate tag
calculation (:878-907), AtLimit policies {Wait, Allow, Reject}
(:74-93), anticipation, idle-reactivation prop_delta (:937-985),
tick-mark GC (:1206-1255), and the Pull/Push queue surfaces
(:1279-1797).

Like the JAX package's oracle it defines a TOTAL order per selection
axis -- the reference's ``ClientCompare`` semantics (:722-757) extended
with a creation-index tie-break -- and selects by linear scan.  The
device engine (``engine.queue``, ``engine.push_queue``) and the native
runtime (``native``) implement the same total order, so their decision
streams equal this oracle's op for op.  It is the host reference model
of the simulators (``models``: ``dmclock``, ``dmclock-delayed``).

``AtLimit``, ``NextReqType`` and ``PullReq`` are the one copy of the
queue API's types every queue of the port returns; the device engine
leaves ``PullReq.tag`` None, the oracle fills it.

All times/tags are int64 nanoseconds (see ``timebase``).
"""

from __future__ import annotations

import enum
import errno
import threading
import time as _walltime
from collections import deque
from dataclasses import dataclass
from typing import (Any, Callable, Deque, Dict, Generic, List, Optional,
                    Tuple, TypeVar, Union)

from .qos import ClientInfo
from .recs import Cost, Phase, ReqParams
from .tags import RequestTag, ZERO_TAG
from .timebase import (LOWEST_PROP_TAG_TRIGGER, MAX_TAG, NS_PER_SEC,
                       TIME_MAX, TIME_ZERO, min_not_0_time, sec_to_ns)
from ..utils.periodic import PeriodicTask

C = TypeVar("C")  # client id type
R = TypeVar("R")  # request payload type

ClientInfoFunc = Callable[[Any], Optional[ClientInfo]]

# GC defaults (reference dmclock_server.h:68-72)
STANDARD_IDLE_AGE_S = 300.0
STANDARD_ERASE_AGE_S = 600.0
STANDARD_CHECK_TIME_S = 60.0
AGGRESSIVE_CHECK_TIME_S = 5.0
STANDARD_ERASE_MAX = 2000


class AtLimit(enum.Enum):
    """Over-limit policy (reference dmclock_server.h:74-84)."""

    WAIT = 0    # hold over-limit requests until the limit tag passes
    ALLOW = 1   # limit-break when nothing else is eligible
    REJECT = 2  # add_request returns EAGAIN for over-limit requests


class NextReqType(enum.Enum):
    RETURNING = 0
    FUTURE = 1
    NONE = 2


class HeapId(enum.Enum):
    RESERVATION = 0
    READY = 1


@dataclass
class NextReq:
    """Outcome of a scheduling decision (reference NextReq, :512-538)."""

    type: NextReqType
    heap_id: Optional[HeapId] = None
    when_ready: Optional[int] = None  # ns

    @staticmethod
    def none() -> "NextReq":
        return NextReq(NextReqType.NONE)

    @staticmethod
    def returning(heap_id: HeapId) -> "NextReq":
        return NextReq(NextReqType.RETURNING, heap_id=heap_id)

    @staticmethod
    def future(when_ns: int) -> "NextReq":
        return NextReq(NextReqType.FUTURE, when_ready=when_ns)


@dataclass
class ClientReq(Generic[R]):
    """One queued request (reference ClientReq, :311-335)."""

    tag: RequestTag
    client_id: Any
    request: Any


class ClientRec(Generic[C, R]):
    """Per-client scheduler record (reference ClientRec, :355-499).

    ``order`` is the creation index used as the deterministic tie-break
    in every selection -- this framework's replacement for the
    reference's arbitrary heap tie ordering.
    """

    __slots__ = ("client", "order", "prev_tag", "requests", "prop_delta",
                 "info", "idle", "last_tick", "cur_rho", "cur_delta")

    def __init__(self, client: Any, info: Optional[ClientInfo],
                 current_tick: int, order: int):
        self.client = client
        self.order = order
        self.prev_tag = ZERO_TAG.copy()
        self.requests: Deque[ClientReq] = deque()
        self.prop_delta = 0  # ns shift applied in ready comparisons
        self.info = info
        self.idle = True
        self.last_tick = current_tick
        self.cur_rho = 1
        self.cur_delta = 1

    # -- request queue ------------------------------------------------
    def has_request(self) -> bool:
        return bool(self.requests)

    def next_request(self) -> ClientReq:
        return self.requests[0]

    def pop_request(self) -> None:
        self.requests.popleft()

    def request_count(self) -> int:
        return len(self.requests)

    def add_request(self, tag: RequestTag, request: Any) -> None:
        self.requests.append(ClientReq(tag, self.client, request))

    # -- prev-tag maintenance (reference :399-412) --------------------
    def update_req_tag(self, tag: RequestTag, tick: int) -> None:
        # sentinels (pinned tags) are never copied into prev_tag
        if tag.reservation != MAX_TAG and tag.reservation != -MAX_TAG:
            self.prev_tag.reservation = tag.reservation
        if tag.limit != MAX_TAG and tag.limit != -MAX_TAG:
            self.prev_tag.limit = tag.limit
        if tag.proportion != MAX_TAG and tag.proportion != -MAX_TAG:
            self.prev_tag.proportion = tag.proportion
        self.prev_tag.arrival = tag.arrival
        self.last_tick = tick

    # -- filtered removal (reference :440-480) ------------------------
    def remove_by_req_filter(self, filter_accum: Callable[[Any], bool],
                             visit_backwards: bool) -> bool:
        any_removed = False
        idxs = range(len(self.requests) - 1, -1, -1) if visit_backwards \
            else range(len(self.requests))
        keep: List[Optional[ClientReq]] = list(self.requests)
        for i in idxs:
            if filter_accum(keep[i].request):
                any_removed = True
                keep[i] = None
        if any_removed:
            self.requests = deque(r for r in keep if r is not None)
        return any_removed


class PriorityQueueBase(Generic[C, R]):
    """Core engine shared by pull/push queues
    (reference PriorityQueueBase, dmclock_server.h:283-1276).

    Selection axes (reference's three heaps + ClientCompare :722-757),
    expressed as total-order sort keys over clients:

      reservation: (has_request DESC, head.reservation ASC, order ASC)
      limit:       (has_request DESC, head.ready ASC,
                    head.limit ASC, order ASC)          # ready lowers
      ready:       (has_request DESC, head.ready DESC,
                    head.proportion + prop_delta ASC, order ASC)
    """

    def __init__(self,
                 client_info_f: ClientInfoFunc,
                 *,
                 delayed_tag_calc: bool = False,
                 dynamic_cli_info: bool = False,
                 at_limit: Union[AtLimit, int, float] = AtLimit.WAIT,
                 anticipation_timeout_ns: int = 0,
                 idle_age_s: float = STANDARD_IDLE_AGE_S,
                 erase_age_s: float = STANDARD_ERASE_AGE_S,
                 check_time_s: float = STANDARD_CHECK_TIME_S,
                 erase_max: int = STANDARD_ERASE_MAX,
                 run_gc_thread: bool = True,
                 monotonic_clock: Callable[[], float] = _walltime.monotonic):
        self.client_info_f = client_info_f
        self.delayed_tag_calc = delayed_tag_calc
        self.is_dynamic_cli_info_f = dynamic_cli_info
        # a bare number passed for at_limit is a RejectThreshold and
        # implies AtLimit.Reject (reference AtLimitParam, :89-93,829-846)
        if isinstance(at_limit, AtLimit):
            self.at_limit = at_limit
            self.reject_threshold_ns = 0
        else:
            self.at_limit = AtLimit.REJECT
            self.reject_threshold_ns = int(at_limit)
        self.anticipation_timeout_ns = int(anticipation_timeout_ns)
        # AtLimit::Reject needs accurate tags at add time
        # (reference assert, :856-857)
        assert not (self.at_limit is AtLimit.REJECT
                    and self.delayed_tag_calc), \
            "AtLimit.REJECT requires immediate tag calculation"
        assert erase_age_s >= idle_age_s
        assert check_time_s < idle_age_s

        self.data_mtx = threading.Lock()
        self.client_map: Dict[Any, ClientRec] = {}
        self.finishing = False
        self.tick = 0
        self._next_order = 0

        # scheduling counters (reference :810-812)
        self.reserv_sched_count = 0
        self.prop_sched_count = 0
        self.limit_break_sched_count = 0

        # GC state (reference :814-821, do_clean :1206-1255)
        self.idle_age_s = idle_age_s
        self.erase_age_s = erase_age_s
        self.check_time_s = check_time_s
        self.erase_max = erase_max
        self.last_erase_point = 0
        self._clean_mark_points: Deque[Tuple[float, int]] = deque()
        self._monotonic = monotonic_clock
        self._cleaning_job: Optional[PeriodicTask] = None
        if run_gc_thread:
            self._cleaning_job = PeriodicTask(check_time_s, self.do_clean)

    # ------------------------------------------------------------------
    # public inspection API (reference :545-564)
    # ------------------------------------------------------------------
    def empty(self) -> bool:
        with self.data_mtx:
            top = self._resv_top()
            return top is None or not top.has_request()

    def client_count(self) -> int:
        with self.data_mtx:
            return len(self.client_map)

    def request_count(self) -> int:
        with self.data_mtx:
            return sum(c.request_count() for c in self.client_map.values())

    # ------------------------------------------------------------------
    # removal / info-update API (reference :567-648)
    # ------------------------------------------------------------------
    def remove_by_req_filter(self, filter_accum: Callable[[Any], bool],
                             visit_backwards: bool = False) -> bool:
        with self.data_mtx:
            any_removed = False
            for rec in self.client_map.values():
                if rec.remove_by_req_filter(filter_accum, visit_backwards):
                    any_removed = True
            return any_removed

    def remove_by_client(self, client: Any, reverse: bool = False,
                         accum: Optional[Callable[[Any], None]] = None
                         ) -> None:
        with self.data_mtx:
            rec = self.client_map.get(client)
            if rec is None:
                return
            reqs = reversed(rec.requests) if reverse else iter(rec.requests)
            if accum is not None:
                for r in reqs:
                    accum(r.request)
            rec.requests.clear()

    def update_client_info(self, client_id: Any) -> None:
        with self.data_mtx:
            rec = self.client_map.get(client_id)
            if rec is not None:
                rec.info = self.client_info_f(client_id)

    def update_client_infos(self) -> None:
        with self.data_mtx:
            for rec in self.client_map.values():
                rec.info = self.client_info_f(rec.client)

    def shutdown(self) -> None:
        self.finishing = True
        if self._cleaning_job is not None:
            self._cleaning_job.stop()
            self._cleaning_job = None

    # ------------------------------------------------------------------
    # selection axes (reference heaps + ClientCompare :722-797)
    # ------------------------------------------------------------------
    def _resv_key(self, c: ClientRec):
        if c.has_request():
            return (0, c.next_request().tag.reservation, c.order)
        return (1, 0, c.order)

    def _limit_key(self, c: ClientRec):
        if c.has_request():
            t = c.next_request().tag
            return (0, 1 if t.ready else 0, t.limit, c.order)
        return (1, 0, 0, c.order)

    def _ready_key(self, c: ClientRec):
        if c.has_request():
            t = c.next_request().tag
            return (0, 0 if t.ready else 1, t.proportion + c.prop_delta,
                    c.order)
        return (1, 0, 0, c.order)

    def _resv_top(self) -> Optional[ClientRec]:
        if not self.client_map:
            return None
        return min(self.client_map.values(), key=self._resv_key)

    def _limit_top(self) -> Optional[ClientRec]:
        if not self.client_map:
            return None
        return min(self.client_map.values(), key=self._limit_key)

    def _ready_top(self) -> Optional[ClientRec]:
        if not self.client_map:
            return None
        return min(self.client_map.values(), key=self._ready_key)

    # ------------------------------------------------------------------
    # tag helpers
    # ------------------------------------------------------------------
    def _get_cli_info(self, client: ClientRec) -> Optional[ClientInfo]:
        # reference get_cli_info (:870-875)
        if self.is_dynamic_cli_info_f:
            client.info = self.client_info_f(client.client)
        return client.info

    def _initial_tag(self, client: ClientRec, params: ReqParams,
                     time_ns: int, cost: int) -> RequestTag:
        if self.delayed_tag_calc:
            # reference initial_tag(DelayedTagCalc) :878-893: only tag
            # for real if the request goes straight to the queue head
            if not client.has_request():
                info = self._get_cli_info(client)
                assert info is not None
                tag = RequestTag.from_prev(client.prev_tag, info,
                                           params.delta, params.rho,
                                           time_ns, cost,
                                           self.anticipation_timeout_ns)
                client.update_req_tag(tag, self.tick)
                return tag
            return RequestTag(reservation=0, proportion=0, limit=0,
                              arrival=time_ns, delta=0, rho=0, cost=cost)
        # reference initial_tag(ImmediateTagCalc) :896-907
        info = self._get_cli_info(client)
        assert info is not None
        tag = RequestTag.from_prev(client.prev_tag, info,
                                   params.delta, params.rho, time_ns,
                                   cost, self.anticipation_timeout_ns)
        client.update_req_tag(tag, self.tick)
        return tag

    # ------------------------------------------------------------------
    # core: add (reference do_add_request :913-1018)
    # ------------------------------------------------------------------
    def _do_add_request(self, request: Any, client_id: Any,
                        req_params: ReqParams, time_ns: int,
                        cost: int = 1) -> int:
        self.tick += 1

        rec = self.client_map.get(client_id)
        if rec is None:
            info = self.client_info_f(client_id)
            rec = ClientRec(client_id, info, self.tick, self._next_order)
            self._next_order += 1
            self.client_map[client_id] = rec

        if rec.idle:
            # Idle-reactivation (reference :937-985): shift the
            # returning client's effective proportion tag next to the
            # lowest active one so it competes fairly rather than
            # replaying a stale low tag.
            lowest_prop_tag = None
            for other in self.client_map.values():
                if other.idle:
                    continue  # self is still marked idle here too
                if other.has_request():
                    p = other.next_request().tag.proportion + other.prop_delta
                else:
                    p = other.prev_tag.proportion + other.prop_delta
                if lowest_prop_tag is None or p < lowest_prop_tag:
                    lowest_prop_tag = p
            if lowest_prop_tag is not None and \
                    lowest_prop_tag < LOWEST_PROP_TAG_TRIGGER:
                rec.prop_delta = lowest_prop_tag - time_ns
            rec.idle = False

        tag = self._initial_tag(rec, req_params, time_ns, cost)

        if self.at_limit is AtLimit.REJECT and \
                tag.limit > time_ns + self.reject_threshold_ns:
            # over-limit: reject without taking ownership
            # (reference :989-993)
            return errno.EAGAIN

        rec.add_request(tag, request)
        rec.cur_rho = req_params.rho
        rec.cur_delta = req_params.delta
        return 0

    # ------------------------------------------------------------------
    # core: decide (reference do_next_request :1115-1186)
    # ------------------------------------------------------------------
    def _do_next_request(self, now_ns: int) -> NextReq:
        if not self.client_map:
            return NextReq.none()

        # constraint (reservation) phase
        reserv = self._resv_top()
        if reserv.has_request() and \
                reserv.next_request().tag.reservation <= now_ns:
            return NextReq.returning(HeapId.RESERVATION)

        # promote newly within-limit requests to ready
        # (reference :1135-1144); the loop takes the minimum-limit
        # non-ready client each time, so it marks exactly the clients
        # with head limit <= now
        while True:
            limits = self._limit_top()
            if not (limits.has_request()
                    and not limits.next_request().tag.ready
                    and limits.next_request().tag.limit <= now_ns):
                break
            limits.next_request().tag.ready = True

        # weight (proportion) phase
        readys = self._ready_top()
        if readys.has_request() and readys.next_request().tag.ready and \
                readys.next_request().tag.proportion < MAX_TAG:
            return NextReq.returning(HeapId.READY)

        # limit-break (reference :1157-1165); unlike the reference
        # (whose limit_break_sched_count is declared but never bumped)
        # we actually count these
        if self.at_limit is AtLimit.ALLOW:
            if readys.has_request() and \
                    readys.next_request().tag.proportion < MAX_TAG:
                self.limit_break_sched_count += 1
                return NextReq.returning(HeapId.READY)
            if reserv.has_request() and \
                    reserv.next_request().tag.reservation < MAX_TAG:
                self.limit_break_sched_count += 1
                return NextReq.returning(HeapId.RESERVATION)

        # nothing schedulable now: compute the next wake-up time
        # (reference :1170-1185)
        next_call = TIME_MAX
        if reserv.has_request():
            next_call = min_not_0_time(
                next_call, reserv.next_request().tag.reservation)
        limits = self._limit_top()
        if limits.has_request():
            nxt = limits.next_request().tag
            assert not nxt.ready or nxt.proportion >= MAX_TAG
            next_call = min_not_0_time(next_call, nxt.limit)
        if next_call < TIME_MAX:
            return NextReq.future(next_call)
        return NextReq.none()

    # ------------------------------------------------------------------
    # core: pop (reference pop_process_request :1046-1073,
    #            update_next_tag :1021-1041)
    # ------------------------------------------------------------------
    def _pop_process_request(self, heap_id: HeapId,
                             process: Callable[[Any, Cost, Any], None]
                             ) -> RequestTag:
        top = self._resv_top() if heap_id is HeapId.RESERVATION \
            else self._ready_top()
        head = top.next_request()
        request_cost = head.tag.cost
        request = head.request
        tag = head.tag
        top.pop_request()

        if self.delayed_tag_calc and top.has_request():
            # tag the new head with the latest rho/delta, using the
            # just-popped tag as the recurrence predecessor
            nxt = top.next_request()
            info = self._get_cli_info(top)
            assert info is not None
            nxt.tag = RequestTag.from_prev(tag, info, top.cur_delta,
                                           top.cur_rho, nxt.tag.arrival,
                                           nxt.tag.cost,
                                           self.anticipation_timeout_ns)
            top.update_req_tag(nxt.tag, self.tick)

        process(top.client, request_cost, request)
        return tag

    # reference reduce_reservation_tags (:1077-1111): weight-phase
    # service also pays down reservation debt
    def _reduce_reservation_tags(self, client_id: Any,
                                 tag: RequestTag) -> None:
        rec = self.client_map.get(client_id)
        assert rec is not None, "client GC'd while being scheduled"
        offset = rec.info.reservation_inv_ns * (tag.cost + tag.rho)
        if self.delayed_tag_calc:
            if rec.requests:
                rec.requests[0].tag.reservation -= offset
        else:
            for r in rec.requests:
                r.tag.reservation -= offset
        rec.prev_tag.reservation -= offset

    # ------------------------------------------------------------------
    # GC (reference do_clean :1206-1255)
    # ------------------------------------------------------------------
    def do_clean(self) -> None:
        now = self._monotonic()
        with self.data_mtx:
            self._clean_mark_points.append((now, self.tick))

            erase_point = self.last_erase_point
            while self._clean_mark_points and \
                    self._clean_mark_points[0][0] <= now - self.erase_age_s:
                self.last_erase_point = self._clean_mark_points[0][1]
                erase_point = self.last_erase_point
                self._clean_mark_points.popleft()

            idle_point = 0
            for t, tick in self._clean_mark_points:
                if t <= now - self.idle_age_s:
                    idle_point = tick
                else:
                    break

            erased_num = 0
            if erase_point > 0 or idle_point > 0:
                for key in list(self.client_map.keys()):
                    rec = self.client_map[key]
                    if erase_point and erased_num < self.erase_max and \
                            rec.last_tick <= erase_point:
                        del self.client_map[key]
                        erased_num += 1
                    elif idle_point and rec.last_tick <= idle_point:
                        rec.idle = True
                if erased_num >= self.erase_max:
                    if self._cleaning_job is not None:
                        self._cleaning_job.try_update(AGGRESSIVE_CHECK_TIME_S)
                else:
                    self.last_erase_point = 0
                    if self._cleaning_job is not None:
                        self._cleaning_job.try_update(self.check_time_s)

    # ------------------------------------------------------------------
    # observability (obs.registry wiring)
    # ------------------------------------------------------------------
    def register_metrics(self, registry, labels=None) -> None:
        """Expose the scheduling counters (reference :810-812) as
        callback gauges -- read lazily at drain time, so the hot path
        pays nothing."""
        for name, attr in (
                ("dmclock_sched_reservation_total", "reserv_sched_count"),
                ("dmclock_sched_priority_total", "prop_sched_count"),
                ("dmclock_sched_limit_break_total",
                 "limit_break_sched_count")):
            registry.gauge(name, "scheduling decisions by phase",
                           labels=labels).set_function(
                lambda a=attr: getattr(self, a))
        registry.gauge("dmclock_clients", "tracked client records",
                       labels=labels).set_function(
            lambda: len(self.client_map))

    # debugging dump (reference display_queues :676-697)
    def display_queues(self) -> str:
        with self.data_mtx:
            lines = []
            for name, key in (("RESER", self._resv_key),
                              ("LIMIT", self._limit_key),
                              ("READY", self._ready_key)):
                order = sorted(self.client_map.values(), key=key)
                lines.append(name + ": " + " | ".join(
                    f"{c.client}:"
                    f"{c.next_request().tag if c.has_request() else 'noreq'}"
                    for c in order))
            return "\n".join(lines)


@dataclass
class PullReq(Generic[C, R]):
    """Result of a pull (reference PullReq, :1286-1306).

    ``tag`` is the served request's tag triple when the backend
    materializes per-decision tags on the host (the oracle queues do;
    the device engine leaves it None) -- consumed by the decision trace
    (``obs.trace``), never by scheduling.
    """

    type: NextReqType
    client: Any = None
    request: Any = None
    phase: Optional[Phase] = None
    cost: int = 0
    when_ready: Optional[int] = None  # ns
    tag: Optional[RequestTag] = None

    def is_none(self) -> bool:
        return self.type is NextReqType.NONE

    def is_retn(self) -> bool:
        return self.type is NextReqType.RETURNING

    def is_future(self) -> bool:
        return self.type is NextReqType.FUTURE


def _now_ns() -> int:
    return sec_to_ns(_walltime.time())


class PullPriorityQueue(PriorityQueueBase[C, R]):
    """Server-polls mode (reference PullPriorityQueue, :1279-1501)."""

    def add_request(self, request: Any, client_id: Any,
                    req_params: ReqParams = ReqParams(),
                    time_ns: Optional[int] = None, cost: int = 1) -> int:
        if time_ns is None:
            time_ns = _now_ns()
        with self.data_mtx:
            return self._do_add_request(request, client_id, req_params,
                                        time_ns, cost)

    def pull_request(self, now_ns: Optional[int] = None) -> PullReq:
        if now_ns is None:
            now_ns = _now_ns()
        result: PullReq = PullReq(NextReqType.NONE)
        with self.data_mtx:
            nxt = self._do_next_request(now_ns)
            result.type = nxt.type
            if nxt.type is NextReqType.NONE:
                return result
            if nxt.type is NextReqType.FUTURE:
                result.when_ready = nxt.when_ready
                return result

            def process(client, cost, request):
                result.client = client
                result.request = request
                result.cost = cost

            if nxt.heap_id is HeapId.RESERVATION:
                result.phase = Phase.RESERVATION
                result.tag = self._pop_process_request(
                    HeapId.RESERVATION, process)
                self.reserv_sched_count += 1
            else:
                result.phase = Phase.PRIORITY
                tag = self._pop_process_request(HeapId.READY, process)
                self._reduce_reservation_tags(result.client, tag)
                result.tag = tag
                self.prop_sched_count += 1
            return result


class PushPriorityQueue(PriorityQueueBase[C, R]):
    """Queue-drives-server mode (reference PushPriorityQueue, :1504-1797).

    ``handle_f(client, request, phase, cost)`` is invoked whenever
    ``can_handle_f()`` is true and a request is eligible; timed wakeups
    for future-eligible requests run on a dedicated sched-ahead thread
    (reference run_sched_ahead :1760-1786).

    Virtual-time embedding (the discrete-event sim): pass ``now_ns_f``
    (the simulated clock) and ``sched_at_f`` (schedules a callback that
    must invoke ``sched_ahead_fire()`` at the given virtual time -- it
    disarms the deduplicated deadline before re-evaluating); no
    sched-ahead thread is spawned then, and scheduling decisions and
    default arrival stamps read the virtual clock.
    """

    def __init__(self, client_info_f: ClientInfoFunc,
                 can_handle_f: Callable[[], bool],
                 handle_f: Callable[[Any, Any, Phase, Cost], None],
                 now_ns_f: Optional[Callable[[], int]] = None,
                 sched_at_f: Optional[Callable[[int], None]] = None,
                 **kwargs):
        super().__init__(client_info_f, **kwargs)
        self.can_handle_f = can_handle_f
        self.handle_f = handle_f
        self._now_ns_f = now_ns_f or _now_ns
        self._sched_at_f = sched_at_f
        self._sched_ahead_cv = threading.Condition()
        self._sched_ahead_when = TIME_ZERO  # ns
        self._sched_ahead_thd = None
        if sched_at_f is None:
            self._sched_ahead_thd = threading.Thread(
                target=self._run_sched_ahead, daemon=True,
                name="dmclock-sched-ahead")
            self._sched_ahead_thd.start()

    def shutdown(self) -> None:
        super().shutdown()
        with self._sched_ahead_cv:
            self._sched_ahead_cv.notify_all()
        if self._sched_ahead_thd is not None:
            self._sched_ahead_thd.join()

    def add_request(self, request: Any, client_id: Any,
                    req_params: ReqParams = ReqParams(),
                    time_ns: Optional[int] = None, cost: int = 1) -> int:
        if time_ns is None:
            time_ns = self._now_ns_f()
        with self.data_mtx:
            r = self._do_add_request(request, client_id, req_params,
                                     time_ns, cost)
            if r == 0:
                self._schedule_request()
            return r

    def request_completed(self) -> None:
        with self.data_mtx:
            self._schedule_request()

    # -- internals (data_mtx held) ------------------------------------
    def _submit_request(self, heap_id: HeapId) -> None:
        # reference submit_top_request/submit_request (:1674-1715)
        meta: Dict[str, Any] = {}

        def process(client, cost, request):
            meta["client"] = client
            self.handle_f(client, request,
                          Phase.RESERVATION if heap_id is HeapId.RESERVATION
                          else Phase.PRIORITY, cost)

        tag = self._pop_process_request(heap_id, process)
        if heap_id is HeapId.RESERVATION:
            self.reserv_sched_count += 1
        else:
            self._reduce_reservation_tags(meta["client"], tag)
            self.prop_sched_count += 1

    def _schedule_request(self) -> None:
        # reference schedule_request (:1741-1755) + can_handle gate
        # (next_request :1729-1737)
        if not self.can_handle_f():
            return
        nxt = self._do_next_request(self._now_ns_f())
        if nxt.type is NextReqType.RETURNING:
            self._submit_request(nxt.heap_id)
        elif nxt.type is NextReqType.FUTURE:
            self._sched_at(nxt.when_ready)

    def _sched_at(self, when_ns: int) -> None:
        # reference sched_at (:1789-1796); with a virtual sched_at_f
        # the armed-deadline dedup still applies, and the embedder's
        # timed callback must invoke sched_ahead_fire()
        with self._sched_ahead_cv:
            if self.finishing:
                return
            if self._sched_ahead_when == TIME_ZERO or \
                    when_ns < self._sched_ahead_when:
                self._sched_ahead_when = when_ns
                if self._sched_at_f is not None:
                    self._sched_at_f(when_ns)
                else:
                    self._sched_ahead_cv.notify_all()

    def sched_ahead_fire(self) -> None:
        """Virtual-time embedding: the ``sched_at_f`` callback landed --
        disarm and re-evaluate scheduling at the (virtual) now."""
        with self._sched_ahead_cv:
            if self.finishing:
                return
            self._sched_ahead_when = TIME_ZERO
        with self.data_mtx:
            self._schedule_request()

    def _run_sched_ahead(self) -> None:
        # reference run_sched_ahead (:1760-1786); the armed deadline is
        # only consumed once it has actually passed -- an early wakeup
        # (a newer, earlier deadline from _sched_at) just re-evaluates
        # the wait, so timed wakeups can't be dropped
        with self._sched_ahead_cv:
            while not self.finishing:
                if self._sched_ahead_when == TIME_ZERO:
                    self._sched_ahead_cv.wait()
                    continue
                delay_s = (self._sched_ahead_when
                           - self._now_ns_f()) / NS_PER_SEC
                if delay_s > 0:
                    self._sched_ahead_cv.wait(timeout=delay_s)
                    continue
                self._sched_ahead_when = TIME_ZERO
                if self.finishing:
                    return
                self._sched_ahead_cv.release()
                try:
                    with self.data_mtx:
                        self._schedule_request()
                finally:
                    self._sched_ahead_cv.acquire()
