"""The port's ``TpuPushPriorityQueue`` (the cases of
``tests/test_tpu_push_queue.py``) and the JAX package's simulator driving
the port's queues: the sim trace equals the oracle's (``dmclock-delayed``)
and the JAX engine's (``dmclock-tpu``), in pull and push server mode."""

import threading
import time

import pytest

from dmclock_tpu.core import ClientInfo as JaxClientInfo
from dmclock_tpu.core import PushPriorityQueue
from dmclock_tpu.core import ReqParams as JaxReqParams
from dmclock_tpu.core.recs import Phase as JaxPhase
from dmclock_tpu.models import _dmclock_tracker
from dmclock_tpu.sim import ClientGroup, ServerGroup, SimConfig
from dmclock_tpu.sim.dmc_sim import run_sim
from dmclock_tpu.sim.harness import Simulation
from dmclock_tpu_torch.core.qos import ClientInfo
from dmclock_tpu_torch.core.recs import Phase, ReqParams
from dmclock_tpu_torch.core.scheduler import AtLimit
from dmclock_tpu_torch.core.timebase import sec_to_ns
from dmclock_tpu_torch.engine.push_queue import TpuPushPriorityQueue


def wait_until(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def push_queue(info_f, can_handle_f, handle_f, **kw):
    return TpuPushPriorityQueue(info_f, can_handle_f, handle_f,
                                device="cpu", **kw)


# ----------------------------------------------------------------------
# tests/test_tpu_push_queue.py:24-139
# ----------------------------------------------------------------------

def test_immediate_dispatch():
    handled = []
    q = push_queue(lambda c: ClientInfo(0, 1, 0), lambda: True,
                   lambda c, r, p, cost: handled.append((c, r, p, cost)))
    try:
        q.add_request("req1", 7, ReqParams())
        assert wait_until(lambda: len(handled) == 1)
        assert handled[0][0] == 7
        assert handled[0][2] is Phase.PRIORITY
        assert q.prop_sched_count == 1
    finally:
        q.shutdown()


def test_can_handle_gates_dispatch():
    handled = []
    gate = {"open": False}
    q = push_queue(lambda c: ClientInfo(0, 1, 0), lambda: gate["open"],
                   lambda c, r, p, cost: handled.append(r))
    try:
        q.add_request("r", 1, ReqParams())
        time.sleep(0.05)
        assert handled == []
        gate["open"] = True
        q.request_completed()
        assert wait_until(lambda: handled == ["r"])
    finally:
        q.shutdown()


def test_capacity_batch_dispatch():
    handled = []
    q = push_queue(lambda c: ClientInfo(0, 1, 0), lambda: True,
                   lambda c, r, p, cost: handled.append((c, r)),
                   capacity_f=lambda: 8)
    try:
        now = sec_to_ns(time.time())
        for i in range(6):
            q.add_request(f"r{i}", i % 2, ReqParams(), time_ns=now)
        assert wait_until(lambda: len(handled) == 6)
        assert sorted(r for _c, r in handled) == [f"r{i}" for i in range(6)]
    finally:
        q.shutdown()


def test_sched_ahead_timed_wakeup():
    """A limited request becomes eligible 0.1 s later and is dispatched
    by the sched-ahead thread without further prompting."""
    handled = []
    q = push_queue(lambda c: ClientInfo(0, 1, 10), lambda: True,
                   lambda c, r, p, cost: handled.append(r),
                   at_limit=AtLimit.WAIT)
    try:
        now = sec_to_ns(time.time())
        q.add_request("a", 1, ReqParams(), time_ns=now)
        q.add_request("b", 1, ReqParams(), time_ns=now)
        assert wait_until(lambda: len(handled) == 2)
        assert handled == ["a", "b"]
    finally:
        q.shutdown()


def test_shutdown_joins_thread():
    q = push_queue(lambda c: ClientInfo(0, 1, 0), lambda: False,
                   lambda *a: None)
    q.shutdown()
    q._sched_thd.join(timeout=5)
    assert not q._sched_thd.is_alive()


def test_dispatch_order_parity_with_oracle():
    """Same weighted backlog, same arrival times: the port's push queue
    hands requests to handle_f in the oracle push queue's order (weights
    1:2 under a gate that admits one dispatch per completion)."""
    def run(make, info_cls, params):
        handled = []
        gate = {"tokens": 0}
        lock = threading.Lock()

        def can_handle():
            with lock:
                return gate["tokens"] > 0

        def handle(c, r, p, cost):
            with lock:
                gate["tokens"] -= 1
            handled.append((c, r, int(p)))

        q = make(lambda c: info_cls(0, 1.0 if c == 1 else 2.0, 0),
                 can_handle, handle)
        try:
            now = sec_to_ns(time.time())
            for i in range(6):
                q.add_request(f"a{i}", 1, params(), time_ns=now)
                q.add_request(f"b{i}", 2, params(), time_ns=now)
            for i in range(12):
                with lock:
                    gate["tokens"] += 1
                q.request_completed()
                assert wait_until(lambda: len(handled) == i + 1), \
                    f"stalled at dispatch {i} ({handled})"
        finally:
            q.shutdown()
        return handled

    oracle = run(lambda f, ch, h: PushPriorityQueue(f, ch, h,
                                                    run_gc_thread=False),
                 JaxClientInfo, JaxReqParams)
    port = run(push_queue, ClientInfo, ReqParams)
    assert oracle == port
    first6 = [c for c, _r, _p in port[:6]]
    assert first6.count(2) == 2 * first6.count(1)


# ----------------------------------------------------------------------
# the JAX package's simulator on the port's queues
# ----------------------------------------------------------------------

class _HarnessPhases:
    """The harness tells phases apart by identity with its own ``Phase``
    (``sim/harness.py``, ``core/tracker.py``), so the port's decisions
    cross into it as the JAX package's enum, by value."""

    def __init__(self, q):
        self._q = q

    def __getattr__(self, name):
        return getattr(self._q, name)

    @staticmethod
    def _fix(pr):
        if pr.phase is not None:
            pr.phase = JaxPhase(int(pr.phase))
        return pr

    def pull_request(self, now_ns=None):
        return self._fix(self._q.pull_request(now_ns))

    def pull_batch(self, now_ns, max_decisions, advance_now=False):
        return [self._fix(p) for p in
                self._q.pull_batch(now_ns, max_decisions, advance_now)]


def _port_pull_factory(server_id, client_info_f, anticipation_ns,
                       soft_limit):
    from dmclock_tpu_torch.engine.queue import TpuPullPriorityQueue

    return _HarnessPhases(TpuPullPriorityQueue(
        client_info_f, at_limit=AtLimit.ALLOW if soft_limit
        else AtLimit.WAIT, anticipation_timeout_ns=anticipation_ns,
        speculative_batch=4, device="cpu"))


def _port_push_factory(server_id, client_info_f, anticipation_ns,
                       soft_limit, *, can_handle_f, handle_f, now_ns_f,
                       sched_at_f, capacity_f=None):
    return TpuPushPriorityQueue(
        client_info_f, can_handle_f,
        lambda c, r, p, cost: handle_f(c, r, JaxPhase(int(p)), cost),
        now_ns_f=now_ns_f, sched_at_f=sched_at_f, capacity_f=capacity_f,
        at_limit=AtLimit.ALLOW if soft_limit else AtLimit.WAIT,
        anticipation_timeout_ns=anticipation_ns, device="cpu")


def _cfg(clients, servers, **kw):
    return SimConfig(client_groups=len(clients),
                     server_groups=len(servers), cli_group=clients,
                     srv_group=servers, **kw)


SHAPES = {
    # tests/test_sim_tpu_parity.py's scaled shapes
    "example": lambda: _cfg([
        ClientGroup(client_count=1, client_total_ops=60, client_wait_s=0,
                    client_iops_goal=200, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=0.0,
                    client_weight=1.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=60, client_wait_s=1,
                    client_iops_goal=200, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=40.0,
                    client_weight=1.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=60, client_wait_s=2,
                    client_iops_goal=200, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=50.0,
                    client_weight=2.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=40, client_wait_s=0,
                    client_iops_goal=100, client_outstanding_ops=16,
                    client_reservation=0.0, client_limit=0.0,
                    client_weight=1.0, client_req_cost=3,
                    client_server_select_range=1)],
        [ServerGroup(server_count=1, server_iops=160, server_threads=1)],
        server_soft_limit=False),
    "100th": lambda: _cfg([
        ClientGroup(client_count=2, client_total_ops=50,
                    client_iops_goal=100, client_outstanding_ops=16,
                    client_reservation=20.0, client_limit=60.0,
                    client_weight=1.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=40,
                    client_iops_goal=100, client_outstanding_ops=16,
                    client_reservation=10.0, client_limit=0.0,
                    client_weight=2.0, client_req_cost=3,
                    client_server_select_range=1)],
        [ServerGroup(server_count=1, server_iops=120, server_threads=2)],
        server_soft_limit=True),
    "multi_server": lambda: _cfg([
        ClientGroup(client_count=3, client_total_ops=60,
                    client_iops_goal=120, client_outstanding_ops=8,
                    client_reservation=15.0, client_limit=0.0,
                    client_weight=1.0, client_server_select_range=2)],
        [ServerGroup(server_count=2, server_iops=80, server_threads=1)],
        server_soft_limit=False),
}


def _port_sim(cfg, mode, seed=7):
    factory = _port_push_factory if mode == "push" else _port_pull_factory
    sim = Simulation(cfg, factory, _dmclock_tracker, seed=seed,
                     record_trace=True, server_mode=mode)
    sim.run()
    return sim


def _assert_same_run(got, want):
    assert len(got.trace) == len(want.trace) > 0
    for i, (a, b) in enumerate(zip(got.trace, want.trace)):
        assert a == b, f"trace diverges at op {i}: port={a} ref={b}"
    for cid in want.clients:
        ca, cb = got.clients[cid].stats, want.clients[cid].stats
        assert (ca.reservation_ops, ca.priority_ops) == \
            (cb.reservation_ops, cb.priority_ops)


@pytest.mark.parametrize("mode", ["pull", "push"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sim_trace_equals_the_oracle(shape, mode):
    cfg = SHAPES[shape]()
    got = _port_sim(cfg, mode)
    _assert_same_run(got, run_sim(cfg, model="dmclock-delayed", seed=7,
                                  record_trace=True, server_mode=mode))
    if mode == "pull":
        # the port queues' host ledgers agree with the harness recount
        from dmclock_tpu.sim.harness import SimReport

        check = SimReport(got).ledger_check()
        assert check is not None and check["mismatches"] == []
        assert SimReport(got).slo_window_check()["mismatches"] == []


@pytest.mark.parametrize("mode", ["pull", "push"])
def test_sim_trace_equals_the_jax_engine(mode):
    cfg = SHAPES["multi_server"]()
    _assert_same_run(_port_sim(cfg, mode),
                     run_sim(cfg, model="dmclock-tpu", seed=7,
                             record_trace=True, server_mode=mode))
