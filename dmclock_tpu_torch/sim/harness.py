"""Discrete-event QoS simulation harness (the port's copy of
``dmclock_tpu/sim/harness.py``).

Equivalent of the reference simulation framework
(``sim/src/simulate.h``, ``sim_server.h``, ``sim_client.h``): generic
over the queue/tracker pair, so the port's device-engine queues and the
ssched FIFO baseline plug in.  Phases are the port's own
``core.recs.Phase``; server selection draws from ``random.Random(seed)``
exactly as the JAX harness does, so a run's decision stream is the JAX
harness's with the same queues.

Architectural departure from the reference (deliberate): the reference
models time by *sleeping real threads* (server worker sleeps
``op_time*cost``, sim_server.h:222; clients rate-limit with
``wait_until``, sim_client.h:260-263) so a run takes as long as the
simulated workload.  Here the same client/server state machines advance
a virtual int64-ns clock through an event heap: deterministic
(seq-numbered ties), reproducible, and able to simulate hours of QoS
traffic in milliseconds -- which is also what lets the device backend be
driven batch-at-a-time.
"""

from __future__ import annotations

import heapq
import random
import time as _walltime
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.qos import ClientInfo
from ..core.recs import Phase, ReqParams
from ..core.timebase import NS_PER_SEC
from ..obs import spans as _spans
from ..obs.registry import MetricsRegistry
from ..utils.profile import ProfileCombiner, ProfileTimer
from .config import ClientGroup, SimConfig


# ----------------------------------------------------------------------
# event loop
# ----------------------------------------------------------------------

class EventLoop:
    """Virtual-time event loop; ties broken by schedule order."""

    def __init__(self):
        self.now_ns = 0
        self._heap: List[Tuple[int, int, Callable[[], None]]] = []
        self._seq = 0

    def at(self, time_ns: int, fn: Callable[[], None]) -> None:
        assert time_ns >= self.now_ns, "scheduling into the past"
        heapq.heappush(self._heap, (time_ns, self._seq, fn))
        self._seq += 1

    def after(self, delay_ns: int, fn: Callable[[], None]) -> None:
        self.at(self.now_ns + delay_ns, fn)

    def run(self, until_ns: Optional[int] = None) -> None:
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if until_ns is not None and t > until_ns:
                self.now_ns = until_ns
                return
            self.now_ns = t
            fn()


# ----------------------------------------------------------------------
# server
# ----------------------------------------------------------------------

@dataclass
class ServerStats:
    """Per-server accounting (reference server_data
    test_dmclock_main.cc:285-316 + InternalStats sim_server.h:55-70)."""

    ops_completed: int = 0
    reservation_ops: int = 0
    priority_ops: int = 0
    per_client_phase: Dict[Any, List[int]] = field(default_factory=dict)
    # per-client [tardiness_sum_ns, tardiness_max_ns, resv_tag_ops]:
    # the host half of the device conformance-ledger schema
    # (obs.histograms LED_TARD_*), measurable only when the backend
    # materializes tags (the oracle queues do; the device engine's
    # ledger carries its own)
    per_client_tard: Dict[Any, List[int]] = field(default_factory=dict)
    add_request_timer: ProfileTimer = field(default_factory=ProfileTimer)
    request_complete_timer: ProfileTimer = field(default_factory=ProfileTimer)


def _op_time_ns(threads: int, iops: float) -> int:
    """Per-op service time; the reference rounds to whole microseconds
    (sim_server.h:137-139)."""
    return int(0.5 + threads * 1e6 / iops) * 1000


def _record_service(server, client, phase: Phase, cost: int,
                    tag=None) -> None:
    """Shared serve bookkeeping (trace row + per-phase stats) for both
    server drive modes -- pull/push trace equality depends on the two
    modes recording identically."""
    if server.trace is not None:
        server.trace.append((server.loop.now_ns, server.id, client,
                             int(phase), cost))
    if server.decision_trace is not None:
        server.decision_trace.record(
            server.loop.now_ns, server.id, client, int(phase), cost,
            tag=(tag.reservation, tag.proportion, tag.limit)
            if tag is not None else None)
    phase_idx = server.stats.per_client_phase.setdefault(client, [0, 0])
    phase_idx[int(phase)] += 1
    server.stats.ops_completed += 1
    if phase is Phase.RESERVATION:
        server.stats.reservation_ops += 1
        # reservation tardiness when the backend materializes tags
        # (the device-ledger entry-head semantics, host side): how far
        # past its reservation deadline the serve landed
        if tag is not None:
            tard = max(server.loop.now_ns - tag.reservation, 0)
            row = server.stats.per_client_tard.setdefault(
                client, [0, 0, 0])
            row[0] += tard
            row[1] = max(row[1], tard)
            row[2] += 1
            if server.tard_hist is not None:
                server.tard_hist.observe(tard)
    else:
        server.stats.priority_ops += 1


class SimulatedServer:
    """Service station behind a QoS queue
    (reference SimulatedServer, sim_server.h:31-242).

    ``threads`` service slots each take ``op_time * cost`` of virtual
    time per op, with op_time = threads/iops so aggregate service rate
    is ``iops`` (reference ctor, sim_server.h:136-139).
    """

    def __init__(self, server_id: Any, iops: float, threads: int,
                 queue, loop: EventLoop,
                 client_resp_f: Callable[[Any, Any, Phase, int, Any], None],
                 trace: Optional[list] = None,
                 decision_trace=None, tracer=None):
        self.id = server_id
        self.queue = queue
        self.loop = loop
        self.client_resp_f = client_resp_f
        self.threads = threads
        self.op_time_ns = _op_time_ns(threads, iops)
        self.busy = 0
        self.stats = ServerStats()
        self.trace = trace
        self.decision_trace = decision_trace
        self.tracer = tracer     # obs.spans tracer (None = off)
        self.tard_hist = None    # registry histogram, set by Simulation
        self._wake_at: Optional[int] = None

    # the "network" seam: a client submits a request here
    # (reference SimulatedServer::post, sim_server.h:162-177)
    def post(self, request: Any, client_id: Any, req_params: ReqParams,
             cost: int) -> None:
        t = self.stats.add_request_timer
        t.start()
        with _spans.span(self.tracer, "sim.add", "ingest"):
            self.queue.add_request(request, client_id, req_params,
                                   time_ns=self.loop.now_ns, cost=cost)
        t.stop()
        self._dispatch()

    def _dispatch(self) -> None:
        while self.busy < self.threads:
            free = self.threads - self.busy
            with _spans.span(self.tracer, "sim.pull", "dispatch",
                             server=self.id):
                if free > 1 and hasattr(self.queue, "pull_batch"):
                    # batched consumption: pull_batch(now, n) is
                    # defined as n successive pulls at the SAME now --
                    # exactly this loop -- so the trace is identical
                    # with fewer device launches (reference free-slot
                    # count has_avail_thread, sim_server.h:179)
                    batch = self.queue.pull_batch(self.loop.now_ns,
                                                  free)
                else:
                    batch = [self.queue.pull_request(self.loop.now_ns)]
            done = False
            for pr in batch:
                if pr.is_retn():
                    self.busy += 1
                    self._start_service(pr)
                elif pr.is_future():
                    when = pr.when_ready
                    if self._wake_at is None or when < self._wake_at:
                        self._wake_at = when
                        self.loop.at(max(when, self.loop.now_ns),
                                     self._wake)
                    done = True
                else:
                    done = True
            if done:
                break

    def _wake(self) -> None:
        self._wake_at = None
        self._dispatch()

    def _start_service(self, pr) -> None:
        _record_service(self, pr.client, pr.phase, pr.cost,
                        tag=getattr(pr, "tag", None))

        def complete(client=pr.client, request=pr.request,
                     phase=pr.phase, cost=pr.cost):
            self.busy -= 1
            self.client_resp_f(client, request, phase, cost, self.id)
            t = self.stats.request_complete_timer
            t.start()
            # (push-mode queues would get request_completed() here; the
            # pull driver simply re-polls)
            t.stop()
            self._dispatch()

        self.loop.after(self.op_time_ns * pr.cost, complete)


class PushSimulatedServer:
    """Push-mode service station: the QUEUE drives dispatch through
    ``handle_f`` under a ``can_handle`` gate, with timed wakeups via the
    queue's sched-ahead seam -- the mode the reference's dmc_sim
    actually runs (``test_dmclock.h:38-56`` binds PushPriorityQueue;
    server glue ``sim_server.h:162-241``).

    Dispatch pacing follows the reference: one dispatch per trigger
    (add, completion, sched-ahead wakeup).  With ``threads == 1`` the
    decision stream is identical to the pull server's; with more
    threads a same-instant burst may serve one request per trigger
    instead of greedily draining, exactly like the reference.
    """

    def __init__(self, server_id: Any, iops: float, threads: int,
                 make_queue, loop: EventLoop,
                 client_resp_f: Callable[[Any, Any, Phase, int, Any], None],
                 trace: Optional[list] = None,
                 decision_trace=None, tracer=None):
        self.id = server_id
        self.loop = loop
        self.client_resp_f = client_resp_f
        self.threads = threads
        self.op_time_ns = _op_time_ns(threads, iops)
        self.busy = 0
        self.stats = ServerStats()
        self.trace = trace
        self.decision_trace = decision_trace
        self.tracer = tracer     # obs.spans tracer (None = off)
        self.tard_hist = None    # registry histogram, set by Simulation
        # make_queue(can_handle_f, handle_f, now_ns_f, sched_at_f,
        # capacity_f); capacity_f is the free-slot count (reference
        # has_avail_thread, sim_server.h:179) -- batch-capable queues
        # (device) size a dispatch pass by it, host queues ignore it
        self.queue = make_queue(
            can_handle_f=lambda: self.busy < self.threads,
            handle_f=self._handle,
            now_ns_f=lambda: self.loop.now_ns,
            sched_at_f=self._sched_at,
            capacity_f=lambda: self.threads - self.busy)

    def post(self, request: Any, client_id: Any, req_params: ReqParams,
             cost: int) -> None:
        t = self.stats.add_request_timer
        t.start()
        with _spans.span(self.tracer, "sim.add", "ingest"):
            # push-mode adds DISPATCH from inside add_request (the
            # queue drives handle_f); the ingest span covers both --
            # the push sim's per-add cost is the unit of interest
            self.queue.add_request(request, client_id, req_params,
                                   time_ns=self.loop.now_ns, cost=cost)
        t.stop()

    def _sched_at(self, when_ns: int) -> None:
        self.loop.at(max(when_ns, self.loop.now_ns),
                     self.queue.sched_ahead_fire)

    # invoked BY the queue (under its lock) when it dispatches a request
    def _handle(self, client: Any, request: Any, phase: Phase,
                cost: int) -> None:
        self.busy += 1
        _record_service(self, client, phase, cost)

        def complete():
            self.busy -= 1
            self.client_resp_f(client, request, phase, cost, self.id)
            t = self.stats.request_complete_timer
            t.start()
            self.queue.request_completed()
            t.stop()

        self.loop.after(self.op_time_ns * cost, complete)


# ----------------------------------------------------------------------
# client
# ----------------------------------------------------------------------

@dataclass
class ClientStats:
    """Per-client accounting (reference InternalStats sim_client.h:80-95
    + per-interval op counts, simulate.h:214-270)."""

    ops_requested: int = 0
    ops_completed: int = 0
    reservation_ops: int = 0
    priority_ops: int = 0
    completion_times_ns: List[int] = field(default_factory=list)
    finish_time_ns: Optional[int] = None
    get_req_params_timer: ProfileTimer = field(default_factory=ProfileTimer)
    track_resp_timer: ProfileTimer = field(default_factory=ProfileTimer)


class SimulatedClient:
    """Closed-loop load generator
    (reference SimulatedClient, sim_client.h:76-336): rate-limited to
    ``iops_goal`` with at most ``outstanding_ops`` in flight, after an
    initial ``wait``."""

    def __init__(self, client_id: Any, group: ClientGroup, tracker,
                 loop: EventLoop,
                 server_select_f: Callable[[int], Any],
                 submit_f: Callable[[Any, Any, Any, ReqParams, int], None],
                 on_done: Callable[[Any], None]):
        self.id = client_id
        self.group = group
        self.tracker = tracker
        self.loop = loop
        self.server_select_f = server_select_f
        self.submit_f = submit_f
        self.on_done = on_done
        self.stats = ClientStats()
        # reference rounds the inter-request gap to whole microseconds
        # (CliInst ctor, sim_client.h:66-68)
        self.gap_ns = int(0.5 + 1e6 / group.client_iops_goal) * 1000
        self.total_ops = group.client_total_ops
        self.max_outstanding = group.client_outstanding_ops
        self.cost = group.client_req_cost
        self.outstanding = 0
        self.sent = 0
        self._window_blocked = False
        loop.at(int(group.client_wait_s * NS_PER_SEC), self._attempt_send)

    def _attempt_send(self) -> None:
        if self.sent >= self.total_ops:
            return
        if self.outstanding >= self.max_outstanding:
            # window full: the op fires as soon as a response frees it
            # (reference run_req window wait, sim_client.h:234-236)
            self._window_blocked = True
            return
        server = self.server_select_f(self.sent)
        t = self.stats.get_req_params_timer
        t.start()
        rp = self.tracker.get_req_params(server)
        t.stop()
        self.submit_f(server, (self.id, self.sent), self.id, rp, self.cost)
        self.sent += 1
        self.outstanding += 1
        self.stats.ops_requested += 1
        if self.sent < self.total_ops:
            self.loop.after(self.gap_ns, self._attempt_send)

    # response delivery (reference receive_response + run_resp,
    # sim_client.h:204-212, :276-335)
    def receive_response(self, request: Any, phase: Phase, cost: int,
                         server: Any) -> None:
        t = self.stats.track_resp_timer
        t.start()
        self.tracker.track_resp(server, phase, cost)
        t.stop()
        self.outstanding -= 1
        self.stats.ops_completed += 1
        if phase is Phase.RESERVATION:
            self.stats.reservation_ops += 1
        else:
            self.stats.priority_ops += 1
        self.stats.completion_times_ns.append(self.loop.now_ns)
        if self._window_blocked:
            self._window_blocked = False
            self._attempt_send()
        if self.sent >= self.total_ops and self.outstanding == 0:
            self.stats.finish_time_ns = self.loop.now_ns
            self.on_done(self.id)


# ----------------------------------------------------------------------
# simulation orchestrator
# ----------------------------------------------------------------------

class Simulation:
    """Build servers+clients from a SimConfig and run to completion
    (reference Simulation, simulate.h:33-445).

    queue_factory(server_id, client_info_f, anticipation_timeout_ns,
                  soft_limit) -> queue with add_request/pull_request
    tracker_factory() -> tracker with get_req_params/track_resp
    """

    def __init__(self, cfg: SimConfig, queue_factory, tracker_factory,
                 seed: int = 12345, record_trace: bool = False,
                 server_mode: str = "pull",
                 registry: Optional[MetricsRegistry] = None,
                 decision_trace=None, tracer=None):
        assert server_mode in ("pull", "push")
        self.server_mode = server_mode
        self.cfg = cfg
        self.loop = EventLoop()
        self.trace: Optional[list] = [] if record_trace else None
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.decision_trace = decision_trace
        # time-domain tracing (obs.spans.SpanTracer or None): the
        # servers record ingest (add_request) and dispatch (pull)
        # spans, so `dmc_sim --trace-out` yields a Perfetto timeline
        # of where the sim's wall time went; decisions bit-identical
        self.tracer = tracer
        self._rng = random.Random(seed)
        self._done_clients = set()

        # client-id -> group index; ids are dense ints (servers too)
        self.client_group_of: Dict[int, int] = {}
        cid = 0
        for gi, g in enumerate(cfg.cli_group):
            for _ in range(g.client_count):
                self.client_group_of[cid] = gi
                cid += 1
        self.n_clients = cid

        self.server_group_of: Dict[int, int] = {}
        sid = 0
        for gi, g in enumerate(cfg.srv_group):
            for _ in range(g.server_count):
                self.server_group_of[sid] = gi
                sid += 1
        self.n_servers = sid

        self._infos = [ClientInfo(g.client_reservation, g.client_weight,
                                  g.client_limit,
                                  client=f"client-group-{gi}")
                       for gi, g in enumerate(cfg.cli_group)]

        def client_info_f(c):
            return self._infos[self.client_group_of[c]]

        self.servers: Dict[int, Any] = {}
        anticipation_ns = int(cfg.anticipation_timeout_s * NS_PER_SEC)
        for s in range(self.n_servers):
            g = cfg.srv_group[self.server_group_of[s]]
            if server_mode == "push":
                # queue_factory here has the push signature:
                # (server_id, info_f, ant_ns, soft, *, can_handle_f,
                #  handle_f, now_ns_f, sched_at_f) -> push queue
                def make_queue(s=s, **cb):
                    return queue_factory(s, client_info_f,
                                         anticipation_ns,
                                         cfg.server_soft_limit, **cb)
                self.servers[s] = PushSimulatedServer(
                    s, g.server_iops, g.server_threads, make_queue,
                    self.loop, self._client_resp, trace=self.trace,
                    decision_trace=self.decision_trace,
                    tracer=self.tracer)
            else:
                q = queue_factory(s, client_info_f, anticipation_ns,
                                  cfg.server_soft_limit)
                self.servers[s] = SimulatedServer(
                    s, g.server_iops, g.server_threads, q, self.loop,
                    self._client_resp, trace=self.trace,
                    decision_trace=self.decision_trace,
                    tracer=self.tracer)
            self._register_server_metrics(s)

        self.clients: Dict[int, SimulatedClient] = {}
        for c in range(self.n_clients):
            g = cfg.cli_group[self.client_group_of[c]]
            select = self._make_server_select(c, g)
            self.clients[c] = SimulatedClient(
                c, g, tracker_factory(), self.loop, select,
                self._submit, self._client_done)

        # aggregate callback gauges: read lazily at drain time, so the
        # event loop's hot path never touches the registry
        reg = self.registry
        reg.gauge("sim_ops_completed_total",
                  "client ops completed (all clients)").set_function(
            lambda: sum(c.stats.ops_completed
                        for c in self.clients.values()))
        reg.gauge("sim_reservation_ops_total",
                  "constraint-phase completions").set_function(
            lambda: sum(c.stats.reservation_ops
                        for c in self.clients.values()))
        reg.gauge("sim_priority_ops_total",
                  "weight-phase completions").set_function(
            lambda: sum(c.stats.priority_ops
                        for c in self.clients.values()))
        reg.gauge("sim_virtual_time_ns",
                  "virtual clock").set_function(lambda: self.loop.now_ns)
        reg.timer("sim_client_get_req_params_ns",
                  "tracker get_req_params latency (all clients)")
        reg.timer("sim_client_track_resp_ns",
                  "tracker track_resp latency (all clients)")
        for c in self.clients.values():
            reg.timer("sim_client_get_req_params_ns",
                      source=c.stats.get_req_params_timer)
            reg.timer("sim_client_track_resp_ns",
                      source=c.stats.track_resp_timer)

        self._wall_start = None
        self._wall_elapsed_s = None

    def _register_server_metrics(self, s: int) -> None:
        """Per-server hot-path stats: the host-call timers as merged
        summaries, the queue's scheduling counters via its own
        ``register_metrics`` when the backend offers one."""
        from ..obs.histograms import BUCKET_BOUNDS

        server = self.servers[s]
        labels = {"server": str(s)}
        # one shared log2 tardiness histogram across servers (the
        # device-histogram bucket layout, so sims and bench report
        # the same families -- docs/OBSERVABILITY.md)
        server.tard_hist = self.registry.histogram(
            "sim_resv_tardiness_ns",
            "reservation tardiness of constraint-phase serves "
            "(log2 buckets; backends that materialize tags only)",
            buckets=BUCKET_BOUNDS)
        self.registry.timer("sim_server_add_request_ns",
                            "queue add_request latency", labels=labels,
                            source=server.stats.add_request_timer)
        self.registry.timer("sim_server_request_complete_ns",
                            "completion-path latency", labels=labels,
                            source=server.stats.request_complete_timer)
        self.registry.gauge("sim_server_ops_completed",
                            "decisions served", labels=labels
                            ).set_function(
            lambda st=server.stats: st.ops_completed)
        queue = getattr(server, "queue", None)
        if queue is not None and hasattr(queue, "register_metrics"):
            queue.register_metrics(self.registry, labels=labels)

    # -- server-selection policies (reference simulate.h:398-444) -----
    def _make_server_select(self, client_idx: int, g: ClientGroup):
        servers_per = min(g.client_server_select_range, self.n_servers)
        factor = self.n_servers / max(1, self.n_clients)
        if self.cfg.server_random_selection:
            def select(seed: int) -> int:
                offset = self._rng.randrange(servers_per)
                return (int(0.5 + client_idx * factor) + offset) \
                    % self.n_servers
        else:
            def select(seed: int) -> int:
                offset = seed % servers_per
                return (int(0.5 + client_idx * factor) + offset) \
                    % self.n_servers
        return select

    # -- the callback "network" (reference test_dmclock_main.cc:146-188)
    def _submit(self, server, request, client_id, rp, cost):
        self.servers[server].post(request, client_id, rp, cost)

    def _client_resp(self, client, request, phase, cost, server):
        self.clients[client].receive_response(request, phase, cost, server)

    def _client_done(self, client_id):
        self._done_clients.add(client_id)

    def run(self) -> None:
        """Run to completion (reference Simulation::run, simulate.h:159-178)."""
        self._wall_start = _walltime.perf_counter()
        self.loop.run()
        self._wall_elapsed_s = _walltime.perf_counter() - self._wall_start
        assert len(self._done_clients) == self.n_clients, \
            f"only {len(self._done_clients)}/{self.n_clients} clients finished"

    # -- reporting (reference display_stats, simulate.h:181-395) -------
    def report(self) -> "SimReport":
        return SimReport(self)


class SimReport:
    """Aggregated results with a text table in the spirit of the
    reference's display_stats output."""

    def __init__(self, sim: Simulation):
        self.sim = sim
        self.virtual_duration_s = sim.loop.now_ns / NS_PER_SEC
        self.wall_seconds = sim._wall_elapsed_s
        self.total_ops = sum(c.stats.ops_completed
                             for c in sim.clients.values())
        self.total_reservation_ops = sum(c.stats.reservation_ops
                                         for c in sim.clients.values())
        self.total_priority_ops = sum(c.stats.priority_ops
                                      for c in sim.clients.values())

    # -- per-client QoS conformance (delivered vs contracted) ----------
    def conformance(self, tol: float = 0.05) -> List[dict]:
        """Per-client QoS conformance rows: delivered rate over the
        client's own active window vs its reservation / weight / limit
        contract (the reference sim's per-client breakdown,
        simulate.h:214-270, extended with met/violated verdicts).

        A closed-loop client can deliver under its reservation simply
        by not asking, so ``resv_met`` judges against
        ``min(reservation, demand_rate)``; ``limit_ok`` judges the
        delivered rate against the limit cap.  ``tol`` is the relative
        slack both verdicts allow.
        """
        sim = self.sim
        tard = self._client_tardiness()
        rows = []
        for cid in sorted(sim.clients):
            c = sim.clients[cid]
            g = sim.cfg.cli_group[sim.client_group_of[cid]]
            start_ns = int(g.client_wait_s * NS_PER_SEC)
            end_ns = c.stats.finish_time_ns or sim.loop.now_ns
            window_s = max((end_ns - start_ns) / NS_PER_SEC, 1e-9)
            rate = c.stats.ops_completed / window_s
            demand = c.stats.ops_requested / window_s
            resv_floor = min(g.client_reservation, demand)
            t_sum, t_max, t_n = tard.get(cid, (0, 0, 0))
            rows.append({
                "tardiness_mean_ns": t_sum / max(t_n, 1),
                "tardiness_max_ns": t_max,
                "client": cid,
                "group": sim.client_group_of[cid],
                "reservation": g.client_reservation,
                "weight": g.client_weight,
                "limit": g.client_limit,
                "ops": c.stats.ops_completed,
                "reservation_ops": c.stats.reservation_ops,
                "priority_ops": c.stats.priority_ops,
                "rate": rate,
                "demand_rate": demand,
                "resv_met": (rate >= resv_floor * (1.0 - tol))
                if g.client_reservation > 0 else True,
                "limit_ok": (rate <= g.client_limit * (1.0 + tol))
                if g.client_limit > 0 else True,
            })
        return rows

    def _client_tardiness(self) -> Dict[Any, Tuple[int, int, int]]:
        """Per-client (tardiness_sum, tardiness_max, resv_tag_ops)
        merged across servers -- the host half of the device ledger's
        tardiness columns (zeros for backends without tags)."""
        out: Dict[Any, List[int]] = {}
        for s in self.sim.servers.values():
            for cid, (t_sum, t_max, t_n) in \
                    s.stats.per_client_tard.items():
                row = out.setdefault(cid, [0, 0, 0])
                row[0] += t_sum
                row[1] = max(row[1], t_max)
                row[2] += t_n
        return {cid: tuple(v) for cid, v in out.items()}

    def tardiness_percentiles(self) -> Optional[dict]:
        """p50/p90/p99 reservation tardiness from the shared log2
        histogram the servers observe into -- packed into a device-
        histogram block row so ``obs.histograms.hist_percentile`` is
        THE quantization math (one implementation; sims and bench
        cannot drift).  None when no constraint-phase serve carried a
        tag."""
        import numpy as np

        from ..obs import histograms as obshist

        h = self.sim.registry.histogram("sim_resv_tardiness_ns")
        if h.count == 0:
            return None
        block = np.zeros((obshist.NUM_HISTS, obshist.NUM_BUCKETS + 1),
                         dtype=np.int64)
        fam = obshist.HIST_RESV_TARDINESS
        block[fam, :obshist.NUM_BUCKETS] = h.counts
        block[fam, obshist.HIST_SUM_COL] = int(h.sum)
        return {"count": h.count,
                "mean_ns": obshist.hist_mean(block, fam),
                "p50_ns": obshist.hist_percentile(block, fam, 0.50),
                "p90_ns": obshist.hist_percentile(block, fam, 0.90),
                "p99_ns": obshist.hist_percentile(block, fam, 0.99)}

    def ledger_check(self) -> Optional[dict]:
        """Cross-check backend conformance ledgers against the
        harness's own host-recomputed per-client stats -- the
        device-truth-vs-host-recount gate at sim scale.

        Sums ``ledger_rows()`` over every queue backend that exposes
        one (``engine.queue.TpuPullPriorityQueue``) and compares ops /
        reservation-ops per client against the servers'
        ``per_client_phase`` tables.  Only clients the backend STILL
        tracks are judged: an erased/recycled slot's ledger row is
        deliberately zeroed by the queue (a new tenant must not
        inherit it), so those clients are reported under
        ``recycled_clients`` instead of failing the gate.  Returns
        ``{"clients", "ops", "recycled_clients", "mismatches": [...]}``
        or None when no backend exposes a ledger (the oracle queues
        recompute host-side only)."""
        ledgers: Dict[Any, List[int]] = {}
        found = False
        for s in self.sim.servers.values():
            queue = getattr(s, "queue", None)
            if queue is None or not hasattr(queue, "ledger_rows"):
                continue
            found = True
            for cid, row in queue.ledger_rows().items():
                acc = ledgers.setdefault(cid, [0, 0])
                acc[0] += int(row[0])
                acc[1] += int(row[1])
        if not found:
            return None
        host: Dict[Any, List[int]] = {}
        for s in self.sim.servers.values():
            for cid, (res, prio) in s.stats.per_client_phase.items():
                acc = host.setdefault(cid, [0, 0])
                acc[0] += res + prio
                acc[1] += res
        mismatches = []
        for cid in sorted(ledgers):
            led = ledgers[cid]
            hst = host.get(cid, [0, 0])
            if led != hst:
                mismatches.append({"client": cid,
                                   "ledger_ops": led[0],
                                   "host_ops": hst[0],
                                   "ledger_resv": led[1],
                                   "host_resv": hst[1]})
        # device phase-counter cross-check (trace schema v2
        # satellite, docs/OBSERVABILITY.md): the backends' running
        # reservation/priority counters are the host mirror of the
        # device MET_RESV/MET_PROP rows -- they must equal the
        # harness's own per-phase recount exactly, or decisions were
        # dropped/duplicated/mis-phased somewhere on the way up
        resv_dev = prop_dev = 0
        have_counters = False
        for s in self.sim.servers.values():
            queue = getattr(s, "queue", None)
            if queue is not None and \
                    hasattr(queue, "reserv_sched_count"):
                have_counters = True
                resv_dev += int(queue.reserv_sched_count)
                prop_dev += int(queue.prop_sched_count)
        out = {"clients": len(ledgers),
               "ops": sum(v[0] for v in ledgers.values()),
               "recycled_clients": len(set(host) - set(ledgers)),
               "mismatches": mismatches}
        if have_counters:
            resv_host, prop_host = self.phase_totals()
            out["phase_counters"] = {"reservation": resv_dev,
                                     "priority": prop_dev}
            if (resv_dev, prop_dev) != (resv_host, prop_host):
                mismatches.append({
                    "phase_counters": {"reservation": resv_dev,
                                       "priority": prop_dev},
                    "host": {"reservation": resv_host,
                             "priority": prop_host}})
        return out

    def phase_totals(self) -> Tuple[int, int]:
        """(reservation, priority) decision totals from the host
        per-phase recount -- what the device ``MET_RESV``/``MET_PROP``
        counters (and a decision trace's ``per_phase`` summary) must
        match exactly."""
        resv = sum(s.stats.reservation_ops
                   for s in self.sim.servers.values())
        prop = sum(s.stats.priority_ops
                   for s in self.sim.servers.values())
        return resv, prop

    def slo_window_check(self) -> Optional[dict]:
        """The queue backends' SLO window mirror vs their own ledger
        (docs/OBSERVABILITY.md "SLO plane"): a sim never rolls the
        mirror, so every client's OPEN window must equal its
        cumulative ledger row on the countable columns (ops /
        resv-ops / limit-breaks) and carry a nonzero contract epoch.
        Returns ``{"clients", "windows_ops", "mismatches": [...]}`` or
        None when no backend exposes the mirror."""
        from ..obs import slo as obsslo

        found = False
        mismatches = []
        clients = 0
        ops = 0
        for s in self.sim.servers.values():
            queue = getattr(s, "queue", None)
            if queue is None or not hasattr(queue,
                                            "slo_window_rows"):
                continue
            found = True
            leds = queue.ledger_rows()
            for cid, win in queue.slo_window_rows().items():
                clients += 1
                ops += int(win[obsslo.W_OPS])
                led = leds[cid]
                bad = (int(win[obsslo.W_OPS]) != int(led[0])
                       or int(win[obsslo.W_RESV_OPS]) != int(led[1])
                       or int(win[obsslo.W_LB_OPS]) != int(led[2])
                       or (int(win[obsslo.W_OPS]) > 0
                           and int(win[obsslo.W_CEPOCH]) < 1))
                if bad:
                    mismatches.append({
                        "client": cid,
                        "window": [int(x) for x in win],
                        "ledger": [int(x) for x in led]})
        if not found:
            return None
        return {"clients": clients, "windows_ops": ops,
                "mismatches": mismatches}

    def format_conformance(self, tol: float = 0.05) -> str:
        rows = self.conformance(tol=tol)
        lines = ["-- per-client QoS conformance --",
                 f"{'client':>6} {'grp':>3} {'resv':>8} {'wght':>6} "
                 f"{'limit':>8} {'ops':>8} {'res/prop':>13} "
                 f"{'rate':>9} {'verdict':>10}"]
        for r in rows:
            verdict = ("ok" if r["resv_met"] else "RESV-MISS") + \
                ("" if r["limit_ok"] else "+LIMIT-EXCESS")
            lines.append(
                f"{r['client']:>6} {r['group']:>3} "
                f"{r['reservation']:>8.1f} {r['weight']:>6.1f} "
                f"{r['limit']:>8.1f} {r['ops']:>8} "
                f"{r['reservation_ops']:>6}/{r['priority_ops']:<6} "
                f"{r['rate']:>9.2f} {verdict:>10}")
        total = sum(r["ops"] for r in rows)
        misses = sum(1 for r in rows if not r["resv_met"])
        excess = sum(1 for r in rows if not r["limit_ok"])
        soft = " (allowed: server_soft_limit serves past the limit " \
            "when capacity is spare)" \
            if self.sim.cfg.server_soft_limit and excess else ""
        lines.append(f"total ops {total} | reservation misses {misses} "
                     f"| limit excesses {excess}{soft}")
        return "\n".join(lines)

    def client_interval_ops(self, interval_s: float = 1.0) -> Dict[int, List[int]]:
        out = {}
        step = int(interval_s * NS_PER_SEC)
        for cid, c in self.sim.clients.items():
            if not c.stats.completion_times_ns:
                out[cid] = []
                continue
            hi = max(c.stats.completion_times_ns)
            buckets = [0] * (hi // step + 1)
            for t in c.stats.completion_times_ns:
                buckets[t // step] += 1
            out[cid] = buckets
        return out

    def format(self, show_intervals: bool = False) -> str:
        sim = self.sim
        lines = []
        lines.append(f"=== simulation report ===")
        lines.append(f"clients: {sim.n_clients}  servers: {sim.n_servers}")
        lines.append(f"virtual duration: {self.virtual_duration_s:.3f} s; "
                     f"wall: {self.wall_seconds:.3f} s")
        lines.append(f"total ops: {self.total_ops} "
                     f"(reservation {self.total_reservation_ops}, "
                     f"priority {self.total_priority_ops})")

        # per-client-group summary
        lines.append("-- client groups --")
        for gi, g in enumerate(sim.cfg.cli_group):
            cids = [c for c, gg in sim.client_group_of.items() if gg == gi]
            ops = sum(sim.clients[c].stats.ops_completed for c in cids)
            res = sum(sim.clients[c].stats.reservation_ops for c in cids)
            prop = sum(sim.clients[c].stats.priority_ops for c in cids)
            finish = max((sim.clients[c].stats.finish_time_ns or 0)
                         for c in cids) / NS_PER_SEC
            rate = ops / finish if finish else 0.0
            lines.append(
                f"group {gi}: {len(cids)} clients  r={g.client_reservation}"
                f" w={g.client_weight} l={g.client_limit}"
                f" | ops {ops} (res {res} / prop {prop})"
                f" | done @ {finish:.2f}s | average {rate:.2f} ops/s")

        # host-call latency averages (the numbers the reference
        # benchmark greps, simulate.h:306-395), merged with the
        # reference's ProfileCombiner semantics (profile.h:100-120) so
        # stddev/min/max survive the multi-server merge
        add_t = ProfileCombiner()
        for s in sim.servers.values():
            add_t.combine(s.stats.add_request_timer)
        gr_t = ProfileCombiner()
        tr_t = ProfileCombiner()
        for c in sim.clients.values():
            gr_t.combine(c.stats.get_req_params_timer)
            tr_t.combine(c.stats.track_resp_timer)
        lines.append("-- server internal stats --")
        lines.append(f"average add_request: {add_t.mean_ns():.0f} ns "
                     f"(stddev {add_t.std_dev_ns():.0f})")
        lines.append("-- client internal stats --")
        lines.append(f"average get_req_params: {gr_t.mean_ns():.0f} ns "
                     f"(stddev {gr_t.std_dev_ns():.0f})")
        lines.append(f"average track_resp: {tr_t.mean_ns():.0f} ns "
                     f"(stddev {tr_t.std_dev_ns():.0f})")

        if show_intervals:
            lines.append("-- per-client interval ops/sec --")
            for cid, buckets in self.client_interval_ops().items():
                lines.append(f"client {cid}: " +
                             " ".join(str(b) for b in buckets))
        return "\n".join(lines)
