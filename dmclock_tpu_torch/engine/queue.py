"""Host wrapper: the device engine behind the standard pull-queue API.

The port of ``dmclock_tpu/engine/queue.py``.  ``TpuPullPriorityQueue``
speaks the interface of the reference ``PullPriorityQueue``
(``dmclock_server.h:1279-1501``), so the sim harness and embedders drive
it like any other backend.  The host owns what a dense device pass
cannot: client-id <-> slot mapping, the request payload FIFOs, op
batching, capacity growth and GC bookkeeping.  Everything
per-request-hot runs on the device: ingest (``kernels.ingest``) and the
exact serial engine (``kernels.engine_run``); neither launches the
port's CUDA kernels K1 or K2.

Restrictions (as in the JAX package):
- DelayedTagCalc only: the head-only device representation *is* the
  delayed optimization (reference :277-280).
- AtLimit::Reject is offered as a hybrid: the host keeps an
  immediate-mode mirror of the limit axis (``prev_limit``/
  ``prev_arrival`` evolve only on adds, accepted or rejected,
  :989-993), computed with ``core.tags.tag_calc``, so EAGAIN returns
  with no device round trip; scheduling of admitted requests stays
  delayed-tagged on the device.

Device discipline: every state update is out of place (the speculative
buffer keeps the pre-batch state by reference and replays from it), and
each launch copies its decisions to the host once, as one int64 array.

Every launch is a program of the module cache ``queue`` (``_JIT_CACHE``,
``_jit_cached``), under the JAX package's six keys and factories, shared
by every queue of the process: ``ingest``, ``run``, ``run_h``,
``run_stream``, ``ingest_run_stream`` and ``ingest_run``.  Each is a
``compile_plane.StagedJit``: its serial legs are captured
``kernels.serial_leg`` blocks, its ingest leg (segmented on the host
from the packed ops' host image, ``kernels.upload_ops``) and the
decisions' packing run eagerly around them.  The ops enter a program as
one int64 ``[10, B]`` tensor, ``B`` padded to a power of two as in JAX;
a capacity or ring growth changes the state's shapes, so the next call
of an entry is a retrace.  Nothing is donated: the speculative buffer
and a retried launch read the caller's state after the call.
"""

from __future__ import annotations

import errno
import threading
import time as _walltime
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.qos import ClientInfo
from ..core.recs import Phase, ReqParams
from ..core.scheduler import AtLimit, NextReqType, PullReq
from ..core.tags import tag_calc
from ..core.timebase import MAX_TAG, MIN_TAG, sec_to_ns
from ..device import DEFAULT_DEVICE, resolve_device
from ..obs import compile_plane
from ..obs import histograms as _led
from ..obs import slo as _W
from ..obs import spans as _spans
from ..robust.guarded import RECOVERABLE_ERRORS, retry_with_backoff
from . import kernels
from .kernels import FUTURE, OP_ADD, OP_CREATE, RETURNING
from .state import EngineState, grow_state, init_state

ClientInfoFunc = Callable[[Any], Optional[ClientInfo]]


# the programs of every queue in the process, by the JAX package's keys
_JIT_CACHE: Dict[Tuple, Any] = {}


def _jit_cached(key: Tuple, fn):
    if key not in _JIT_CACHE:
        _JIT_CACHE[key] = compile_plane.StagedJit(fn, cache="queue",
                                                  entry=key)
    return _JIT_CACHE[key]


def _pack_decisions(dec) -> torch.Tensor:
    """The decision columns as one int64 [6, steps] tensor, so a launch
    copies its decisions to the host once."""
    return torch.stack([
        dec.type.to(torch.int64), dec.slot.to(torch.int64),
        dec.phase.to(torch.int64), dec.cost, dec.when,
        dec.limit_break.to(torch.int64)])


def _leg(steps: int, allow: bool, anticipation_ns: int, **kw):
    return kernels.serial_leg(steps, allow_limit_break=allow,
                              anticipation_ns=anticipation_ns, **kw)


def _shared_jit_ingest(anticipation_ns: int):
    def ingest_packed(s, packed):
        return kernels.ingest(s, packed, anticipation_ns=anticipation_ns)
    return _jit_cached(("ingest", anticipation_ns), ingest_packed)


def _shared_jit_run(steps: int, advance_now: bool, allow: bool,
                    anticipation_ns: int):
    leg = _leg(steps, allow, anticipation_ns, advance_now=advance_now)

    def run(s, t):
        s, _, dec = leg(s, t)
        return s, _pack_decisions(dec)
    return _jit_cached(("run", steps, advance_now, allow,
                        anticipation_ns), run)


def _shared_jit_run_horizon(steps: int, allow: bool,
                            anticipation_ns: int):
    leg = _leg(steps, allow, anticipation_ns, with_horizon=True)

    def run(s, t):
        s, _, dec, hz = leg(s, t)
        return s, _pack_decisions(dec), hz
    return _jit_cached(("run_h", steps, allow, anticipation_ns), run)


def _stream_windows(s, t0, dt, *, steps: int, chunks: int, allow: bool,
                    anticipation_ns: int):
    """``chunks`` consecutive serial windows: window ``c`` serves up to
    ``steps`` decisions at ``t0 + c * dt``, each on the state the
    previous one left -- what ``chunks`` sequential ``pull_batch``
    launches compute.  The one window body of both streaming programs.
    Returns the state and the ``[chunks, 6, steps]`` packed
    decisions."""
    leg = _leg(steps, allow, anticipation_ns)
    packs = []
    for c in range(chunks):
        s, _, dec = leg(s, t0 + c * dt)
        packs.append(_pack_decisions(dec))
    return s, torch.stack(packs)


def _shared_jit_run_stream(steps: int, chunks: int, allow: bool,
                           anticipation_ns: int):
    def run(s, t0, dt):
        return _stream_windows(
            s, t0, dt, steps=steps, chunks=chunks, allow=allow,
            anticipation_ns=anticipation_ns)
    return _jit_cached(("run_stream", steps, chunks, allow,
                        anticipation_ns), run)


def _shared_jit_ingest_run_stream(steps: int, chunks: int, allow: bool,
                                  anticipation_ns: int):
    """The pending op rows ingested once before window 0, then the
    windows: one program where the sequential form pays ``1 +
    chunks``."""
    def fused(s, packed, t0, dt):
        s = kernels.ingest(s, packed, anticipation_ns=anticipation_ns)
        return _stream_windows(
            s, t0, dt, steps=steps, chunks=chunks, allow=allow,
            anticipation_ns=anticipation_ns)
    return _jit_cached(("ingest_run_stream", steps, chunks, allow,
                        anticipation_ns), fused)


def _shared_jit_ingest_run(steps: int, advance_now: bool, allow: bool,
                           anticipation_ns: int):
    leg = _leg(steps, allow, anticipation_ns, advance_now=advance_now)

    def fused(s, packed, t):
        s = kernels.ingest(s, packed, anticipation_ns=anticipation_ns)
        s, _, dec = leg(s, t)
        return s, _pack_decisions(dec)
    return _jit_cached(("ingest_run", steps, advance_now, allow,
                        anticipation_ns), fused)


class TpuPullPriorityQueue:
    """Pull-mode dmClock queue on the batched device engine."""

    def __init__(self,
                 client_info_f: ClientInfoFunc,
                 *,
                 at_limit=AtLimit.WAIT,
                 anticipation_timeout_ns: int = 0,
                 # initial sizes only -- both grow by doubling on demand;
                 # every launch is a dense pass over [capacity] (+ rings)
                 capacity: int = 128,
                 ring_capacity: int = 16,
                 delayed_tag_calc: bool = True,
                 idle_age_s: float = 300.0,
                 erase_age_s: float = 600.0,
                 erase_max: int = 2000,
                 # speculative decision buffer: pull_request() serves
                 # from a prefetched batch of up to this size while
                 # provably valid (see _pull_spec); 0 = one launch a pull
                 speculative_batch: int = 0,
                 # transient launch failures (robust.guarded) are retried
                 # this many times with exponential backoff from
                 # retry_base_s before raising; state rebinds on success
                 device_retries: int = 3,
                 retry_base_s: float = 0.05,
                 retry_sleep: Callable[[float], None] = None,
                 monotonic_clock: Callable[[], float] =
                 _walltime.monotonic,
                 # obs.spans.SpanTracer: host spans around launches,
                 # adds, fetches and folds (None = off)
                 tracer=None,
                 device: str | torch.device = DEFAULT_DEVICE):
        if not delayed_tag_calc:
            raise ValueError("the device engine is DelayedTagCalc by "
                             "construction")
        # a bare number passed for at_limit is a RejectThreshold and
        # implies AtLimit.Reject (reference AtLimitParam :89-93)
        if isinstance(at_limit, AtLimit):
            self.at_limit = at_limit
            self.reject_threshold_ns = 0
        else:
            self.at_limit = AtLimit.REJECT
            self.reject_threshold_ns = int(at_limit)
        self.client_info_f = client_info_f
        self.tracer = tracer
        self.anticipation_timeout_ns = int(anticipation_timeout_ns)
        self._allow = self.at_limit is AtLimit.ALLOW
        # host immediate-mode limit mirror (REJECT admission)
        self._lim_prev: Dict[int, int] = {}
        self._lim_prev_arr: Dict[int, int] = {}
        self._lim_inv: Dict[int, int] = {}

        self.data_mtx = threading.Lock()
        self.device = resolve_device(device)
        self.state: EngineState = init_state(capacity, ring_capacity,
                                             device=self.device)
        # host mirror of state.idle (every write to it goes through this
        # queue), so ingest needs no read back to find reactivations
        self._idle = np.ones(capacity, dtype=bool)

        # host bookkeeping
        self._slot_of: Dict[Any, int] = {}
        self._client_of: Dict[int, Any] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._payloads: Dict[int, Deque[Tuple[Any, int, int]]] = {}
        #   slot -> deque of (request, arrival_ns, cost), tracking the
        #   device queue so payload pops follow device pops exactly
        self._next_order = 0
        self._pending: List[Tuple] = []  # buffered IngestOps rows
        self._last_tick: Dict[int, int] = {}
        self.tick = 0

        # GC bookkeeping (reference :1206-1255): the host owns the
        # policy, the device gets idle/deactivate scatters; embedders
        # call do_clean()
        self.idle_age_s = idle_age_s
        self.erase_age_s = erase_age_s
        self.erase_max = erase_max
        self._monotonic = monotonic_clock
        self._clean_mark_points: Deque[Tuple[float, int]] = deque()
        self._last_erase_point = 0

        # scheduling counters (reference :810-812)
        self.reserv_sched_count = 0
        self.prop_sched_count = 0
        self.limit_break_sched_count = 0
        # ingest segments applied (kernels.ingest_segments)
        self.ingest_segments = 0

        # host per-slot conformance ledger (LED_* columns): ops, resv
        # and limit-break exact; tardiness stays 0 (engine_run emits no
        # per-decision tags)
        self._ledger = np.zeros((capacity, _led.LED_COLS), dtype=np.int64)
        # host SLO window mirror (W_* columns): countable columns exact,
        # tardiness 0; slot creation and real ClientInfo changes bump
        # the per-slot contract epoch
        self._slo_win = np.zeros((capacity, _W.W_FIELDS), dtype=np.int64)
        self._slo_cepoch = np.zeros(capacity, dtype=np.int64)
        self.slo_window_rolls = 0
        # last-applied QoS inverses per slot (an unchanged refresh must
        # not bump the contract epoch)
        self._qos_inv: Dict[int, Tuple[int, int, int]] = {}

        self.device_retries = int(device_retries)
        self.retry_base_s = float(retry_base_s)
        self._retry_sleep = retry_sleep or _walltime.sleep
        self.guard_retries = 0
        self.launch_failures = 0
        self.invalid_cost_rejects = 0
        # erased clients free their slot; the final ledger row goes to
        # the departed-clients report before the recycle zeroes it
        self.slot_recycles = 0
        self._departed: List[Tuple[Any, np.ndarray]] = []

        # speculative decision buffer (see _pull_spec)
        self._spec = int(speculative_batch)
        self._spec_size = 1 if self._spec else 0  # adaptive, <= _spec
        self.spec_hits = 0        # pulls served launch-free
        self.spec_refills = 0
        self.spec_settles = 0     # invalidations with unconsumed tail
        self.spec_replays = 0     # settle replays (incl. mixed-drain)
        self._buf: Deque[Tuple] = deque()
        self._buf_slots: Dict[int, int] = {}
        self._buf_horizon = 0
        self._spec_pre: Optional[EngineState] = None
        self._spec_t0 = 0
        self._spec_consumed = 0
        self._spec_exact = True   # post-batch state == handed-out state
        self._host_idle: set = set()

    # ------------------------------------------------------------------
    # device launches: the module cache's programs
    # ------------------------------------------------------------------
    def _jit_ingest(self):
        return _shared_jit_ingest(self.anticipation_timeout_ns)

    def _jit_run(self, steps: int, advance_now: bool):
        return _shared_jit_run(steps, advance_now, self._allow,
                               self.anticipation_timeout_ns)

    def _jit_ingest_run(self, steps: int, advance_now: bool):
        """Ingest and serve in one program (one launch a pull where the
        sequential form pays two)."""
        return _shared_jit_ingest_run(steps, advance_now, self._allow,
                                      self.anticipation_timeout_ns)

    def _launch(self, fn, *args):
        """One device launch under the guarded-commit contract:
        transient failures retry with bounded exponential backoff
        (``robust.guarded``).  Launches are pure, so a failed attempt
        commits nothing; a launch that exhausts its retries bumps
        ``launch_failures`` before re-raising."""
        def on_retry(_attempt, _exc):
            self.guard_retries += 1
            _spans.instant(self.tracer, "queue.retry", "retry",
                           error=type(_exc).__name__)

        def one_attempt():
            # one attempt's call, never the backoff sleeps between them
            with _spans.span(self.tracer, "queue.launch", "dispatch"):
                return fn(*args)

        try:
            return retry_with_backoff(
                one_attempt, retries=self.device_retries,
                base_s=self.retry_base_s, on_retry=on_retry,
                sleep=self._retry_sleep)
        except RECOVERABLE_ERRORS:
            self.launch_failures += 1
            raise

    def _drain_and_launch(self, fused_fn, plain_fn, *args):
        """Drain the pending op rows and run ``fused_fn(state, ops,
        *args)``, or ``plain_fn(state, *args)`` when nothing is pending
        (``None``: no launch).  A failed launch restores the drained
        rows, so a later attempt still applies them."""
        rows = self._pending
        with _spans.span(self.tracer, "queue.pack_ops", "host_prep"):
            ops = self._build_ops()
        if ops is None:
            if plain_fn is None:
                return None
            return self._launch(plain_fn, self.state, *args)
        packed = kernels.upload_ops(ops, self.device, idle=self._idle)
        try:
            res = self._launch(fused_fn, self.state, packed, *args)
        except Exception:
            self._pending = rows + self._pending
            raise
        self.ingest_segments += len(kernels.ingest_segments(ops[0], ops[1]))
        self._idle[ops[1][ops[0] == OP_CREATE]] = True
        self._idle[ops[1][ops[0] == OP_ADD]] = False
        return res

    # ------------------------------------------------------------------
    # capacity management
    # ------------------------------------------------------------------
    def _grow_capacity(self) -> None:
        self._settle_spec()
        old_n = self.state.capacity
        new_n = old_n * 2
        # new slots equal freshly initialized ones (state.grow_state)
        self.state = grow_state(self.state, new_n)
        self._idle = np.concatenate([self._idle,
                                     np.ones(new_n - old_n, dtype=bool)])
        self._ledger = np.vstack(
            [self._ledger,
             np.zeros((new_n - old_n, _led.LED_COLS), dtype=np.int64)])
        self._slo_win = np.vstack(
            [self._slo_win,
             np.zeros((new_n - old_n, _W.W_FIELDS), dtype=np.int64)])
        self._slo_cepoch = np.concatenate(
            [self._slo_cepoch, np.zeros(new_n - old_n, dtype=np.int64)])
        self._free.extend(range(new_n - 1, old_n - 1, -1))

    def _grow_ring(self) -> None:
        """Double ring capacity, unrolling each row so q_head becomes 0
        (ring positions are modulo ring_capacity, which changes): one
        gather at ``(arange(Q) + q_head) % Q`` per ring."""
        self._settle_spec()
        self._flush()
        st = self.state
        q = st.ring_capacity
        idx = torch.remainder(
            torch.arange(q, dtype=torch.int64, device=self.device)[None, :]
            + st.q_head.to(torch.int64)[:, None], q)

        def unroll(rows):
            return torch.cat([torch.gather(rows, 1, idx),
                              torch.zeros_like(rows)], dim=1)

        self.state = st._replace(
            q_head=torch.zeros_like(st.q_head),
            q_arrival=unroll(st.q_arrival), q_cost=unroll(st.q_cost))

    # ------------------------------------------------------------------
    # op buffering
    # ------------------------------------------------------------------
    def _build_ops(self) -> Optional[np.ndarray]:
        """Drain buffered rows into one int64 [10, B] array (None if
        empty), ``B`` padded with NOP rows to a power of two to bound
        the programs' shapes, as in JAX; it is uploaded in one copy."""
        if not self._pending:
            return None
        rows = self._pending
        self._pending = []
        n = len(rows)
        padded = 1
        while padded < n:
            padded *= 2
        packed = np.zeros((10, padded), dtype=np.int64)
        packed[:, :n] = np.asarray(rows, dtype=np.int64).T
        return packed

    def _flush(self) -> None:
        res = self._drain_and_launch(self._jit_ingest(), None)
        if res is not None:
            self.state = res

    # ------------------------------------------------------------------
    # public API (the reference PullPriorityQueue's)
    # ------------------------------------------------------------------
    def add_request(self, request: Any, client_id: Any,
                    req_params: ReqParams = ReqParams(),
                    time_ns: Optional[int] = None, cost: int = 1) -> int:
        # an invalid cost would poison the tag algebra: commit nothing
        # (no tick, no create, no limit mirror advance), return EINVAL
        try:
            cost = int(cost)
        except (TypeError, ValueError):
            cost = 0
        if cost < 1:
            with self.data_mtx:
                self.invalid_cost_rejects += 1
            return errno.EINVAL
        if time_ns is None:
            time_ns = sec_to_ns(_walltime.time())
        with _spans.span(self.tracer, "queue.add", "ingest"), \
                self.data_mtx:
            self.tick += 1
            slot = self._slot_of.get(client_id)
            created = slot is None
            if created:
                info = self.client_info_f(client_id)
                if info is None:
                    raise KeyError(f"no ClientInfo for client "
                                   f"{client_id!r}")
                if not self._free:
                    self._grow_capacity()
                slot = self._free.pop()
                self._slot_of[client_id] = slot
                self._client_of[slot] = client_id
                self._payloads[slot] = deque()
                self._pending.append(
                    (OP_CREATE, slot, 0, 0, 0, 0,
                     info.reservation_inv_ns, info.weight_inv_ns,
                     info.limit_inv_ns, self._next_order))
                self._next_order += 1
                self._lim_inv[slot] = info.limit_inv_ns
                self._lim_prev[slot] = 0
                self._lim_prev_arr[slot] = 0
                # a fresh tenancy is a fresh contract version; the
                # per-slot counter is monotone across recycling
                self._slo_cepoch[slot] += 1
                self._slo_win[slot] = 0
                self._slo_win[slot, _W.W_CEPOCH] = self._slo_cepoch[slot]
                self._qos_inv[slot] = (info.reservation_inv_ns,
                                       info.weight_inv_ns,
                                       info.limit_inv_ns)
            if self.at_limit is AtLimit.REJECT:
                # host immediate-mode limit mirror (module docstring); a
                # rejected add still advances it.  Known divergence from
                # the reference: a REJECTED add does not un-idle the
                # client (the device sees no op)
                ant = self.anticipation_timeout_ns
                pa = self._lim_prev_arr[slot]
                t_eff = time_ns - ant if ant and (time_ns - ant) < pa \
                    else time_ns
                lim = tag_calc(t_eff, self._lim_prev[slot],
                               self._lim_inv[slot], req_params.delta,
                               False, cost)
                if lim != MAX_TAG and lim != MIN_TAG:
                    self._lim_prev[slot] = lim
                self._lim_prev_arr[slot] = time_ns
                self._last_tick[slot] = self.tick
                if lim > time_ns + self.reject_threshold_ns:
                    return errno.EAGAIN
            if len(self._payloads[slot]) >= self.state.ring_capacity:
                self._grow_ring()
            self._payloads[slot].append((request, time_ns, cost))
            self._last_tick[slot] = self.tick
            self._pending.append(
                (OP_ADD, slot, time_ns, cost, req_params.rho,
                 req_params.delta, 0, 0, 0, 0))
            if self._buf:
                # only a pure tail append to a non-idle client with no
                # remaining buffered serve keeps the buffer valid
                fresh = created or len(self._payloads[slot]) == 1
                if fresh or slot in self._buf_slots or \
                        slot in self._host_idle:
                    self._settle_spec()
            self._host_idle.discard(slot)
            return 0

    def _decision_to_pullreq(self, dtype: int, dslot: int, dphase: int,
                             dcost: int, dwhen: int,
                             dlimit_break: int) -> PullReq:
        if dtype == RETURNING:
            client = self._client_of[dslot]
            request, _arr, _cost = self._payloads[dslot].popleft()
            led = self._ledger[dslot]
            win = self._slo_win[dslot]
            led[_led.LED_OPS] += 1
            win[_W.W_OPS] += 1
            win[_W.W_COST] += dcost
            if dphase == 0:
                self.reserv_sched_count += 1
                led[_led.LED_RESV_OPS] += 1
                win[_W.W_RESV_OPS] += 1
                phase = Phase.RESERVATION
            else:
                self.prop_sched_count += 1
                phase = Phase.PRIORITY
            if dlimit_break:
                self.limit_break_sched_count += 1
                led[_led.LED_LIMIT_BREAKS] += 1
                win[_W.W_LB_OPS] += 1
            self._last_tick[dslot] = self.tick
            return PullReq(NextReqType.RETURNING, client=client,
                           request=request, phase=phase, cost=dcost)
        if dtype == FUTURE:
            return PullReq(NextReqType.FUTURE, when_ready=dwhen)
        return PullReq(NextReqType.NONE)

    def _traced_copy(self, packed: torch.Tensor) -> list:
        """``packed`` copied to the host as nested lists.  With a tracer
        the wait for the device and the copy are separate spans
        (``queue.device_wait``, ``queue.fetch``); without one this is
        the plain copy."""
        if self.tracer is None:
            return packed.cpu().tolist()
        with self.tracer.span("queue.device_wait", "device_compute"):
            if packed.device.type == "cuda":
                torch.cuda.synchronize(packed.device)
        with self.tracer.span("queue.fetch", "fetch"):
            return packed.cpu().tolist()

    def _fetch(self, packed: torch.Tensor) -> List[Tuple[int, ...]]:
        """One device->host copy; the decisions as Python int tuples."""
        return list(zip(*self._traced_copy(packed)))

    def pull_request(self, now_ns: Optional[int] = None) -> PullReq:
        if now_ns is None:
            now_ns = sec_to_ns(_walltime.time())
        with self.data_mtx:
            if self._spec:
                return self._pull_spec(now_ns)
            self.state, dec = self._drain_and_launch(
                self._jit_ingest_run(1, False), self._jit_run(1, False),
                now_ns)
            d = self._fetch(dec)[0]
            with _spans.span(self.tracer, "queue.fold", "drain"):
                return self._decision_to_pullreq(*d)

    # ------------------------------------------------------------------
    # speculative decision buffer
    #
    # One launch computes a BATCH of decisions at time t0 plus a validity
    # horizon: the earliest reservation/limit tag strictly past t0 in
    # any intermediate state (engine_run with_horizon).  Decisions depend
    # on `now` only through `tag <= now` tests, so for any later pull at
    # t in [t0, horizon) the buffered decision IS the one a fresh launch
    # would return.  Everything else falls back to exact recomputation:
    #
    # - `self.state` holds the POST-batch state, `_spec_pre` the
    #   pre-batch state (kept by reference: every update is out of
    #   place).  When the buffer is dropped with unconsumed entries, or
    #   drained after a MIXED batch whose trailing FUTURE/NONE steps
    #   made promotions never handed out (`_spec_exact`), _settle_spec
    #   replays exactly the consumed prefix from _spec_pre at t0.
    # - adds invalidate the buffer UNLESS provably non-interfering: a
    #   tail append (client already queued) for a client with no
    #   remaining buffered serve and not idle-marked.
    # - every other mutator / state reader settles first.
    # ------------------------------------------------------------------
    def _consume_buf_entry(self) -> PullReq:
        self.spec_hits += 1
        d = self._buf.popleft()
        self._spec_consumed += 1
        slot = d[1]
        left = self._buf_slots.get(slot, 0) - 1
        if left <= 0:
            self._buf_slots.pop(slot, None)
        else:
            self._buf_slots[slot] = left
        return self._decision_to_pullreq(*d)

    def _pull_spec(self, now_ns: int) -> PullReq:
        if self._buf and self._spec_t0 <= now_ns < self._buf_horizon:
            return self._consume_buf_entry()
        self.spec_refills += 1
        # adaptive sizing: a fully-drained buffer doubles the next
        # prefetch (up to speculative_batch); an early invalidation
        # resets it to 1 (see _settle_spec)
        if self._spec_pre is not None and not self._buf:
            self._spec_size = min(self._spec_size * 2, self._spec)
        self._settle_spec()
        self._flush()
        pre = self.state
        size = self._spec_size
        st, dec, hz = self._launch(_shared_jit_run_horizon(
            size, self._allow, self.anticipation_timeout_ns), pre, now_ns)
        self.state = st
        # decisions and horizon in one copy
        flat = self._traced_copy(torch.cat([dec.reshape(-1),
                                            hz.reshape(1)]))
        horizon = flat.pop()
        d = list(zip(*(flat[i * size:(i + 1) * size] for i in range(6))))
        first = d[0]
        self._spec_pre = pre
        self._spec_t0 = now_ns
        self._spec_consumed = 1 if first[0] == RETURNING else 0
        self._buf_horizon = horizon
        n_ret = 0
        while n_ret < size and d[n_ret][0] == RETURNING:
            n_ret += 1
        # the post-batch state equals the handed-out state only when the
        # batch is all RETURNING or non-RETURNING from step 0; a MIXED
        # batch's trailing FUTURE/NONE steps promote heads that were
        # never handed out, so _settle_spec must replay
        self._spec_exact = n_ret in (0, size)
        for i in range(1, n_ret):
            self._buf.append(d[i])
            slot = d[i][1]
            self._buf_slots[slot] = self._buf_slots.get(slot, 0) + 1
        return self._decision_to_pullreq(*first)

    def _settle_spec(self) -> None:
        """Restore `self.state` to the logical state: the pre-batch
        state advanced by exactly the handed-out decisions (replayed at
        t0; engine_run at a fixed now composes exactly)."""
        if self._spec_pre is not None:
            if self._buf:
                # early invalidation with an unconsumed tail: reset the
                # adaptive prefetch size
                self.spec_settles += 1
                self._spec_size = 1
            if self._buf or not self._spec_exact:
                self.spec_replays += 1
                # power-of-two chunks, as in JAX: at most
                # log2(speculative_batch) replay programs
                st = self._spec_pre
                n = self._spec_consumed
                while n:
                    p = 1 << (n.bit_length() - 1)
                    st, _ = self._launch(self._jit_run(p, False), st,
                                         self._spec_t0)
                    n -= p
                self.state = st
        self._spec_pre = None
        self._spec_consumed = 0
        self._spec_exact = True
        self._buf.clear()
        self._buf_slots.clear()
        self._buf_horizon = 0

    def flush(self) -> None:
        """Apply the buffered adds now (they otherwise apply at the next
        launch)."""
        with self.data_mtx:
            self._settle_spec()
            self._flush()

    def settle(self) -> None:
        """Make `self.state` reflect exactly the decisions handed out so
        far (drops any speculative prefetch).  Call before reading
        `state` from outside."""
        with self.data_mtx:
            self._settle_spec()

    def pull_batch(self, now_ns: int, max_decisions: int,
                   advance_now: bool = False) -> List[PullReq]:
        """Up to ``max_decisions`` pulls in one launch: RETURNING entries
        in service order, ended by the first FUTURE/NONE (with
        ``advance_now`` the clock jumps over FUTUREs, so only a trailing
        NONE ends the list)."""
        with self.data_mtx:
            out: List[PullReq] = []
            if self._spec and not advance_now:
                # the still-valid speculative prefix first: exactly the
                # pulls a launch at this now would return
                while (len(out) < max_decisions and self._buf and
                       self._spec_t0 <= now_ns < self._buf_horizon):
                    out.append(self._consume_buf_entry())
                if len(out) == max_decisions:
                    return out
            max_decisions -= len(out)
            self._settle_spec()
            self.state, dec = self._drain_and_launch(
                self._jit_ingest_run(max_decisions, advance_now),
                self._jit_run(max_decisions, advance_now), now_ns)
            for d in self._fetch(dec):
                pr = self._decision_to_pullreq(*d)
                if pr.is_retn():
                    out.append(pr)
                elif advance_now and pr.is_future():
                    continue
                else:
                    out.append(pr)
                    break
            return out

    def pull_batch_stream(self, t0_ns: int, dt_ns: int, chunks: int,
                          max_decisions: int) -> List[List[PullReq]]:
        """``chunks`` consecutive ``pull_batch`` windows with one copy
        to the host: window ``c`` serves up to ``max_decisions`` at
        ``t0 + c * dt`` on the state window ``c - 1`` left; pending adds
        ingest first.  Equal to ``chunks`` sequential ``pull_batch``
        calls with no adds between them.  Returns one decision list per
        window, each ended like ``pull_batch``'s."""
        if chunks < 1 or max_decisions < 1:
            raise ValueError("chunks and max_decisions must be >= 1")
        ant = self.anticipation_timeout_ns
        with self.data_mtx:
            self._settle_spec()
            self.state, packs = self._drain_and_launch(
                _shared_jit_ingest_run_stream(max_decisions, chunks,
                                              self._allow, ant),
                _shared_jit_run_stream(max_decisions, chunks, self._allow,
                                       ant),
                t0_ns, dt_ns)
            out: List[List[PullReq]] = []
            for win in self._traced_copy(packs):  # [chunks][6][steps]
                rows: List[PullReq] = []
                for d in zip(*win):
                    pr = self._decision_to_pullreq(*d)
                    rows.append(pr)
                    if not pr.is_retn():
                        break
                out.append(rows)
            return out

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def register_metrics(self, registry, labels=None) -> None:
        """Expose the scheduling counters and the speculative-buffer
        telemetry as callback gauges on ``registry`` (anything with a
        ``gauge(name, help, labels=...)`` returning an object with
        ``set_function``), under the JAX package's metric names and
        help texts, so the exposition is the JAX queue's."""
        rows = (
            ("dmclock_sched_reservation_total", "reserv_sched_count",
             "scheduling decisions by phase"),
            ("dmclock_sched_priority_total", "prop_sched_count",
             "scheduling decisions by phase"),
            ("dmclock_sched_limit_break_total",
             "limit_break_sched_count", "scheduling decisions by phase"),
            ("dmclock_spec_hits_total", "spec_hits",
             "pulls served launch-free from the speculative buffer"),
            ("dmclock_spec_refills_total", "spec_refills",
             "speculative buffer refill launches"),
            ("dmclock_spec_settles_total", "spec_settles",
             "speculative invalidations with an unconsumed tail"),
            ("dmclock_spec_replays_total", "spec_replays",
             "settle replays (incl. mixed-drain)"),
            ("dmclock_guard_retries_total", "guard_retries",
             "device launches retried after a transient failure "
             "(guarded-commit contract, docs/ROBUSTNESS.md)"),
            ("dmclock_launch_failures_total", "launch_failures",
             "device launches that exhausted their bounded retries "
             "(degradation-ladder escalation signal)"),
            ("dmclock_invalid_cost_rejects_total",
             "invalid_cost_rejects",
             "adds rejected for a non-positive cost (EINVAL, "
             "nothing committed)"),
            ("dmclock_slot_recycles_total", "slot_recycles",
             "client slots erased and freed for a future tenant "
             "(do_clean erase; the final ledger row folds into the "
             "departed-clients report before it is zeroed)"),
        )
        for name, attr, help_text in rows:
            registry.gauge(name, help_text, labels=labels).set_function(
                lambda a=attr: getattr(self, a))
        registry.gauge("dmclock_clients", "tracked client records",
                       labels=labels).set_function(
            lambda: len(self._slot_of))
        for col, cname in ((_led.LED_OPS, "ops"),
                           (_led.LED_RESV_OPS, "resv_ops"),
                           (_led.LED_LIMIT_BREAKS, "limit_breaks")):
            registry.gauge(f"dmclock_ledger_{cname}",
                           "host conformance-ledger column total "
                           "(pull-queue mirror of the device ledger "
                           "schema; docs/OBSERVABILITY.md)",
                           labels=labels).set_function(
                lambda c=col: self._ledger_total(c))

    def _ledger_total(self, col: int) -> int:
        """A ledger column total read under the data lock (the serve
        path writes rows and growth swaps the array under it)."""
        with self.data_mtx:
            return int(self._ledger[:, col].sum())

    def departed_report(self, drain: bool = True
                        ) -> List[Tuple[Any, np.ndarray]]:
        """``(client id, int64[5] final ledger row)`` for every client
        erased since the last drain, in eviction order (LED_* columns).
        ``drain=False`` peeks without clearing."""
        with self.data_mtx:
            out = list(self._departed)
            if drain:
                self._departed.clear()
            return out

    def ledger_rows(self) -> Dict[Any, np.ndarray]:
        """Client id -> int64[5] ledger row (LED_* columns): ops, resv
        and limit breaks exact, tardiness columns 0."""
        with self.data_mtx:
            return {cid: self._ledger[slot].copy()
                    for cid, slot in self._slot_of.items()}

    def slo_window_rows(self) -> Dict[Any, np.ndarray]:
        """The open SLO window per live client (W_* columns): countable
        columns exact, tardiness columns 0."""
        with self.data_mtx:
            return {cid: self._slo_win[slot].copy()
                    for cid, slot in self._slot_of.items()}

    def roll_slo_windows(self) -> List[dict]:
        """Close the open window of every live client with activity:
        ``[{client, contract_epoch, ops, cost, resv_ops, lb_ops}]`` in
        slot order; the counters zero, the contract epoch stays."""
        with self.data_mtx:
            out = []
            for cid, slot in sorted(self._slot_of.items(),
                                    key=lambda kv: kv[1]):
                row = self._slo_win[slot]
                if not row[:_W.W_CEPOCH].any():
                    continue
                out.append({"client": cid,
                            "contract_epoch": int(row[_W.W_CEPOCH]),
                            "ops": int(row[_W.W_OPS]),
                            "cost": int(row[_W.W_COST]),
                            "resv_ops": int(row[_W.W_RESV_OPS]),
                            "lb_ops": int(row[_W.W_LB_OPS])})
                row[:_W.W_CEPOCH] = 0
            self.slo_window_rolls += 1
            return out

    # ------------------------------------------------------------------
    # inspection (host mirrors; reference :545-564)
    # ------------------------------------------------------------------
    def empty(self) -> bool:
        with self.data_mtx:
            return all(not q for q in self._payloads.values()) \
                and not any(op[0] == OP_ADD for op in self._pending)

    def client_count(self) -> int:
        with self.data_mtx:
            return len(self._slot_of)

    def request_count(self) -> int:
        with self.data_mtx:
            return sum(len(q) for q in self._payloads.values())

    def display_queues(self) -> str:
        """Debug dump of the three selection orders from device state
        (reference :676-697): one line per 'heap', clients in that
        heap's order, head tags as R/P/L/ready (P the raw proportion
        tag; the READY order sorts by it plus prop_delta)."""
        with self.data_mtx:
            self._settle_spec()
            self._flush()
            st = {f: getattr(self.state, f).cpu().tolist() for f in (
                "active", "depth", "order", "head_resv", "head_prop",
                "prop_delta", "head_limit", "head_ready")}
            rows = []
            for cid, slot in self._slot_of.items():
                has_req = st["active"][slot] and st["depth"][slot] > 0
                raw_p = st["head_prop"][slot]
                rows.append((
                    cid, st["order"][slot], has_req,
                    st["head_resv"][slot], raw_p + st["prop_delta"][slot],
                    st["head_limit"][slot], st["head_ready"][slot], raw_p))

            def fmt(r):
                cid, _o, has_req, rt, _eff, lt, ready, pt = r
                return f"{cid}:" + (
                    f"R{rt}/P{pt}/L{lt}/{'ready' if ready else 'wait'}"
                    if has_req else "noreq")

            def section(name, key):
                order = sorted(rows, key=key)
                return name + ": " + " | ".join(fmt(r) for r in order)

            # requestless clients sort last by creation order
            return "\n".join([
                section("RESER",
                        lambda r: (not r[2], r[3] if r[2] else 0, r[1])),
                section("LIMIT",
                        lambda r: (not r[2], r[6] if r[2] else False,
                                   r[5] if r[2] else 0, r[1])),
                section("READY",
                        lambda r: (not r[2],
                                   (not r[6]) if r[2] else False,
                                   r[4] if r[2] else 0, r[1])),
            ])

    # ------------------------------------------------------------------
    # removal / info updates (reference :567-648)
    # ------------------------------------------------------------------
    def _set_slot(self, arr: torch.Tensor, slot: int, value) -> torch.Tensor:
        """``arr`` with row ``slot`` replaced by ``value`` (out of
        place)."""
        idx = torch.full((1,), slot, dtype=torch.int64, device=self.device)
        v = torch.as_tensor(value, dtype=arr.dtype).to(self.device)
        return arr.index_put((idx,), v.reshape((1,) + arr.shape[1:]))

    def update_client_info(self, client_id: Any) -> None:
        with self.data_mtx:
            slot = self._slot_of.get(client_id)
            if slot is None:
                return
            # flush first: a buffered OP_CREATE for this slot would
            # otherwise replay stale inverses over the update
            self._settle_spec()
            self._flush()
            info = self.client_info_f(client_id)
            st = self.state
            self.state = st._replace(
                resv_inv=self._set_slot(st.resv_inv, slot,
                                        info.reservation_inv_ns),
                weight_inv=self._set_slot(st.weight_inv, slot,
                                          info.weight_inv_ns),
                limit_inv=self._set_slot(st.limit_inv, slot,
                                         info.limit_inv_ns))
            # a real ClientInfo change is a new contract version; a
            # refresh with the same triple is not
            triple = (info.reservation_inv_ns, info.weight_inv_ns,
                      info.limit_inv_ns)
            if self._qos_inv.get(slot) != triple:
                self._qos_inv[slot] = triple
                self._slo_cepoch[slot] += 1
                self._slo_win[slot, _W.W_CEPOCH] = self._slo_cepoch[slot]

    def update_client_infos(self) -> None:
        for client_id in list(self._slot_of):
            self.update_client_info(client_id)

    def remove_by_client(self, client: Any, reverse: bool = False,
                         accum: Optional[Callable[[Any], None]] = None
                         ) -> None:
        with self.data_mtx:
            slot = self._slot_of.get(client)
            if slot is None:
                return
            self._settle_spec()
            self._flush()
            q = self._payloads[slot]
            items = list(reversed(q)) if reverse else list(q)
            if accum is not None:
                for request, _a, _c in items:
                    accum(request)
            q.clear()
            self.state = self.state._replace(
                depth=self._set_slot(self.state.depth, slot, 0))

    def remove_by_req_filter(self, filter_accum: Callable[[Any], bool],
                             visit_backwards: bool = False) -> bool:
        """Filtered removal (reference :567-605); rewrites the affected
        clients' device queues."""
        with self.data_mtx:
            self._settle_spec()
            self._flush()
            any_removed = False
            for slot, q in self._payloads.items():
                if not q:
                    continue
                entries = list(q)
                idxs = range(len(entries) - 1, -1, -1) if visit_backwards \
                    else range(len(entries))
                removed = [False] * len(entries)
                for i in idxs:
                    if filter_accum(entries[i][0]):
                        removed[i] = True
                        any_removed = True
                if not any(removed):
                    continue
                kept = [e for e, r in zip(entries, removed) if not r]
                self._payloads[slot] = deque(kept)
                self._resync_client(slot, head_removed=removed[0],
                                    kept=kept)
            return any_removed

    def _resync_client(self, slot: int, head_removed: bool,
                       kept: List[Tuple[Any, int, int]]) -> None:
        """Rewrite one client's device queue after host-side removal.
        Surviving requests keep their current tags: the old head keeps
        its real tag; a promoted former-tail request carries the
        delayed-calc zero tag until it is tagged at pop time."""
        st = self.state
        ring = st.ring_capacity
        arrs = np.zeros(ring, dtype=np.int64)
        costs = np.zeros(ring, dtype=np.int64)
        for i, (_req, a, c) in enumerate(kept[1:]):
            arrs[i], costs[i] = a, c
        updates = dict(
            depth=self._set_slot(st.depth, slot, len(kept)),
            q_head=self._set_slot(st.q_head, slot, 0),
            q_arrival=self._set_slot(st.q_arrival, slot, arrs),
            q_cost=self._set_slot(st.q_cost, slot, costs),
        )
        if head_removed and kept:
            _req, a, c = kept[0]
            updates.update(
                head_resv=self._set_slot(st.head_resv, slot, 0),
                head_prop=self._set_slot(st.head_prop, slot, 0),
                head_limit=self._set_slot(st.head_limit, slot, 0),
                head_arrival=self._set_slot(st.head_arrival, slot, a),
                head_cost=self._set_slot(st.head_cost, slot, c),
                head_rho=self._set_slot(st.head_rho, slot, 0),
                head_ready=self._set_slot(st.head_ready, slot, False),
            )
        self.state = st._replace(**updates)

    def do_clean(self) -> None:
        """Idle-mark / erase long-inactive clients (reference
        :1206-1255), freeing slots for reuse."""
        now = self._monotonic()
        with self.data_mtx:
            self._settle_spec()
            self._flush()
            self._clean_mark_points.append((now, self.tick))

            erase_point = self._last_erase_point
            while self._clean_mark_points and \
                    self._clean_mark_points[0][0] <= now - self.erase_age_s:
                self._last_erase_point = self._clean_mark_points[0][1]
                erase_point = self._last_erase_point
                self._clean_mark_points.popleft()

            idle_point = 0
            for t, tick in self._clean_mark_points:
                if t <= now - self.idle_age_s:
                    idle_point = tick
                else:
                    break

            if not (erase_point or idle_point):
                return
            erase_slots: List[int] = []
            idle_slots: List[int] = []
            for slot, last in list(self._last_tick.items()):
                if erase_point and len(erase_slots) < self.erase_max \
                        and last <= erase_point:
                    erase_slots.append(slot)
                elif idle_point and last <= idle_point:
                    idle_slots.append(slot)
            if idle_slots:
                self.state = kernels.mark_idle(self.state, idle_slots)
                self._idle[idle_slots] = True
                # a later add to an idle client reactivates (prop_delta
                # shift): the speculative buffer must not survive it
                self._host_idle.update(idle_slots)
            if erase_slots:
                self.state = kernels.deactivate(self.state, erase_slots)
                for slot in erase_slots:
                    client = self._client_of.pop(slot)
                    del self._slot_of[client]
                    del self._payloads[slot]
                    del self._last_tick[slot]
                    self._host_idle.discard(slot)
                    # the evicted client's final ledger row goes to the
                    # departed-clients report before the recycle zeroes
                    # it; the open SLO window goes with the tenancy
                    self.slot_recycles += 1
                    self._departed.append((client,
                                           self._ledger[slot].copy()))
                    self._ledger[slot] = 0
                    self._slo_win[slot] = 0
                    self._free.append(slot)
            if len(erase_slots) < self.erase_max:
                self._last_erase_point = 0

    def shutdown(self) -> None:
        pass
