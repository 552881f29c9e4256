"""The port's ``TpuPullPriorityQueue`` against the JAX package's and
against the oracle, exactly.

Each scenario drives the queue API of one backend -- the oracle
``core.scheduler.PullPriorityQueue`` (delayed tags), the JAX package's
``engine.TpuPullPriorityQueue``, or the port's on the CPU -- through its
own ``ClientInfo``/``ReqParams`` types, and returns what came out: every
``PullReq`` (type, client, request, phase by value, cost, FUTURE time),
the counters, and where the backends have them the ledger, SLO and
departed rows and the final ``EngineState``.  The cases follow
``tests/test_tpu_engine.py``, ``tests/test_spec_buffer.py`` and
``tests/test_stream.py``.
"""

import errno
import random
from types import SimpleNamespace

import pytest
import torch

from dmclock_tpu.core import ClientInfo as JaxClientInfo
from dmclock_tpu.core import ReqParams as JaxReqParams
from dmclock_tpu.core.scheduler import AtLimit as JaxAtLimit
from dmclock_tpu.core.scheduler import PullPriorityQueue
from dmclock_tpu.engine import TpuPullPriorityQueue as JaxQueue
from dmclock_tpu.obs.registry import MetricsRegistry
from dmclock_tpu.obs.spans import SpanTracer as JaxSpanTracer
from dmclock_tpu_torch.core.qos import ClientInfo
from dmclock_tpu_torch.core.recs import Phase, ReqParams
from dmclock_tpu_torch.core.scheduler import AtLimit
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine.queue import TpuPullPriorityQueue
from dmclock_tpu_torch.obs.registry import MetricsRegistry as PortRegistry
from dmclock_tpu_torch.obs.spans import SpanTracer

from test_torch_support import S, assert_np_equal, jax_to_np

ORACLE = SimpleNamespace(
    name="oracle", ClientInfo=JaxClientInfo, ReqParams=JaxReqParams,
    AtLimit=JaxAtLimit,
    make=lambda f, at_limit=JaxAtLimit.WAIT, anticipation_timeout_ns=0,
    **_: PullPriorityQueue(f, delayed_tag_calc=True, at_limit=at_limit,
                           anticipation_timeout_ns=anticipation_timeout_ns,
                           run_gc_thread=False))
JAX = SimpleNamespace(name="jax", ClientInfo=JaxClientInfo,
                      ReqParams=JaxReqParams, AtLimit=JaxAtLimit,
                      make=lambda f, **kw: JaxQueue(f, **kw))
PORT = SimpleNamespace(name="port", ClientInfo=ClientInfo,
                       ReqParams=ReqParams, AtLimit=AtLimit,
                       make=lambda f, **kw: TpuPullPriorityQueue(
                           f, device="cpu", **kw))


def norm(pr):
    """A PullReq as a comparable tuple (phase by value)."""
    return (pr.type.name, pr.client, pr.request,
            None if pr.phase is None else int(pr.phase), pr.cost,
            pr.when_ready)


def counters(q):
    return (q.reserv_sched_count, q.prop_sched_count,
            q.limit_break_sched_count, q.client_count(),
            q.request_count(), q.empty())


def device_view(q):
    """What only the device queues have: spec counters, host rows and
    the settled final state as numpy."""
    q.settle()
    state = bridge.state_to_numpy(q.state) \
        if isinstance(q.state.active, torch.Tensor) else jax_to_np(q.state)
    return dict(
        spec=(q.spec_hits, q.spec_refills, q.spec_settles, q.spec_replays,
              q.slot_recycles, q.invalid_cost_rejects),
        ledger={k: v.tolist() for k, v in q.ledger_rows().items()},
        slo={k: v.tolist() for k, v in q.slo_window_rows().items()},
        departed=[(c, r.tolist()) for c, r in q.departed_report()],
        state=state)


def assert_device_views_equal(a, b):
    sa, sb = a.pop("state"), b.pop("state")
    assert a == b
    for f in sa:
        assert_np_equal(f, sa[f], sb[f])


# ----------------------------------------------------------------------
# scenarios (tests/test_tpu_engine.py:60-345)
# ----------------------------------------------------------------------

def sc_weight_ratio(b):
    infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 2, 0)}
    q = b.make(lambda c: infos[c], capacity=64, ring_capacity=64)
    t = S
    for i in range(6):
        q.add_request(("r", 1, i), 1, b.ReqParams(), time_ns=t)
        q.add_request(("r", 2, i), 2, b.ReqParams(), time_ns=t)
    return q, [norm(q.pull_request(t + S)) for _ in range(7)]


def sc_reservation_ratio(b):
    infos = {1: b.ClientInfo(2, 0, 0), 2: b.ClientInfo(1, 0, 0)}
    q = b.make(lambda c: infos[c])
    t = 100 * S
    for i in range(6):
        q.add_request(("r", 1, i), 1, b.ReqParams(), time_ns=t)
        q.add_request(("r", 2, i), 2, b.ReqParams(), time_ns=t)
    return q, [norm(q.pull_request(t + 100 * S)) for _ in range(7)]


def sc_none_and_future(b):
    q = b.make(lambda c: b.ClientInfo(1, 1, 1))
    out = [norm(q.pull_request(S))]
    q.add_request("a", 1, b.ReqParams(), time_ns=10 * S)
    out.append(norm(q.pull_request(10 * S)))
    q.add_request("b", 1, b.ReqParams(), time_ns=10 * S)
    out.append(norm(q.pull_request(10 * S)))
    return q, out


def sc_allow_limit_break(b):
    q = b.make(lambda c: b.ClientInfo(0, 1, 1), at_limit=b.AtLimit.ALLOW)
    t = 50 * S
    q.add_request("a", 1, b.ReqParams(), time_ns=t)
    q.add_request("b", 1, b.ReqParams(), time_ns=t)
    return q, [norm(q.pull_request(t)) for _ in range(3)]


def sc_batch(b):
    """pull_batch(12) (device queues) == 12 sequential pulls (oracle)."""
    infos = {1: b.ClientInfo(1, 1, 0), 2: b.ClientInfo(0, 3, 0)}
    q = b.make(lambda c: infos[c])
    t = 7 * S
    for i in range(5):
        for c in (1, 2):
            q.add_request(("r", c, i), c, b.ReqParams(), time_ns=t)
    now = t + 3 * S
    if b is ORACLE:
        out = []
        for _ in range(12):
            out.append(norm(q.pull_request(now)))
            if out[-1][0] != "RETURNING":
                break
        return q, out
    return q, [norm(p) for p in q.pull_batch(now, 12)]


def sc_idle_reactivation(b):
    infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 1, 0)}
    q = b.make(lambda c: infos[c])
    out = []
    for i in range(4):
        q.add_request(("a", i), 1, b.ReqParams(), time_ns=S)
    out += [norm(q.pull_request(2 * S)) for _ in range(4)]
    q.add_request(("b", 0), 2, b.ReqParams(), time_ns=1000 * S)
    q.add_request(("b", 1), 2, b.ReqParams(), time_ns=1000 * S)
    out += [norm(q.pull_request(1000 * S)) for _ in range(3)]
    return q, out


def sc_remove(b):
    infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 1, 0)}
    q = b.make(lambda c: infos[c])
    t = 3 * S
    for i in range(4):
        q.add_request(("x", 1, i), 1, b.ReqParams(), time_ns=t)
        q.add_request(("y", 2, i), 2, b.ReqParams(), time_ns=t)
    got = []
    q.remove_by_client(1, accum=got.append)
    removed = q.remove_by_req_filter(lambda r: r[2] % 2 == 0)
    out = [got, removed, q.request_count()]
    out += [norm(q.pull_request(t + S)) for _ in range(3)]
    return q, out


def sc_update_before_flush(b):
    infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 1, 0)}
    q = b.make(lambda c: infos[c])
    t = 5 * S
    for i in range(5):
        q.add_request(("r", 1, i), 1, b.ReqParams(), time_ns=t)
        q.add_request(("r", 2, i), 2, b.ReqParams(), time_ns=t)
    infos[2].update(0, 4, 0)
    q.update_client_info(2)
    return q, [norm(q.pull_request(t + S)) for _ in range(11)]


def sc_update_client_info(b):
    infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 1, 0)}
    q = b.make(lambda c: infos[c])
    t = 5 * S
    for i in range(6):
        q.add_request(("r", 1, i), 1, b.ReqParams(), time_ns=t)
        q.add_request(("r", 2, i), 2, b.ReqParams(), time_ns=t)
    out = [norm(q.pull_request(t + 1))]
    infos[2].update(0, 4, 0)
    q.update_client_info(2)
    q.update_client_info(2)           # an unchanged refresh
    out += [norm(q.pull_request(t + S)) for _ in range(9)]
    return q, out


def sc_ring_growth(b):
    infos = {0: b.ClientInfo(1, 1, 0), 1: b.ClientInfo(0, 2, 0)}
    q = b.make(lambda c: infos[c], ring_capacity=4)
    t = 2 * S
    for i in range(40):
        for c in (0, 1):
            q.add_request((c, i), c, b.ReqParams(), time_ns=t + i)
    out = []
    now = t
    while len(out) < 90:
        now += S
        out.append(norm(q.pull_request(now)))
        if out[-1][0] == "NONE":
            break
    return q, out


def sc_capacity_growth(b):
    infos = {c: b.ClientInfo(0, 1 + (c % 3), 0) for c in range(40)}
    q = b.make(lambda c: infos[c], capacity=8)
    for c in range(40):
        q.add_request(("r", c), c, b.ReqParams(), time_ns=S)
    return q, [norm(q.pull_request(2 * S)) for _ in range(41)]


BEHAVIOR = [sc_weight_ratio, sc_reservation_ratio, sc_none_and_future,
            sc_allow_limit_break, sc_batch, sc_idle_reactivation,
            sc_remove, sc_update_before_flush, sc_update_client_info,
            sc_ring_growth, sc_capacity_growth]


@pytest.mark.parametrize("scenario", BEHAVIOR, ids=lambda f: f.__name__)
def test_queue_behavior_matches_oracle(scenario):
    qo, want = scenario(ORACLE)
    qp, got = scenario(PORT)
    assert got == want
    assert counters(qp) == counters(qo)


@pytest.mark.parametrize("scenario", [sc_allow_limit_break, sc_batch,
                                      sc_remove, sc_update_client_info,
                                      sc_ring_growth, sc_capacity_growth],
                         ids=lambda f: f.__name__)
def test_queue_behavior_matches_jax_queue(scenario):
    """Decisions, counters, host rows and the final state against the
    JAX queue (ring and capacity growth included)."""
    qj, want = scenario(JAX)
    qp, got = scenario(PORT)
    assert got == want
    assert counters(qp) == counters(qj)
    assert_device_views_equal(device_view(qp), device_view(qj))


def _random_infos(b, rng, n):
    infos = {}
    for c in range(n):
        kind = rng.randrange(4)
        if kind == 0:
            infos[c] = b.ClientInfo(rng.uniform(0.5, 4), 0, 0)
        elif kind == 1:
            infos[c] = b.ClientInfo(0, rng.uniform(0.5, 4), 0)
        elif kind == 2:
            infos[c] = b.ClientInfo(rng.uniform(0.5, 2),
                                    rng.uniform(0.5, 4),
                                    rng.uniform(3, 8))
        else:
            infos[c] = b.ClientInfo(rng.uniform(0.5, 2),
                                    rng.uniform(0.5, 4), 0)
    return infos


def sc_random_workload(b, seed, allow, anticipation_s, spec=0, steps=200):
    """tests/test_tpu_engine.py's differential fuzz: random adds and
    pulls at an advancing now, then a drain."""
    rng = random.Random(seed)
    n = rng.randint(2, 12)
    infos = _random_infos(b, rng, n)
    kw = dict(at_limit=b.AtLimit.ALLOW if allow else b.AtLimit.WAIT,
              anticipation_timeout_ns=int(anticipation_s * S))
    if b is not ORACLE:
        kw.update(capacity=16, ring_capacity=16, speculative_batch=spec)
    q = b.make(lambda c: infos[c], **kw)
    out, now = [], S
    for step in range(steps):
        now += rng.randint(0, S // 2)
        if rng.random() < 0.55:
            c = rng.randrange(n)
            delta = rng.randint(1, 5)
            rho = rng.randint(1, delta)
            out.append(q.add_request(("req", c, step), c,
                                     b.ReqParams(delta, rho), time_ns=now,
                                     cost=rng.randint(1, 3)))
        else:
            out.append(norm(q.pull_request(now)))
    for _ in range(800):
        now += 4 * S
        out.append(norm(q.pull_request(now)))
        if q.request_count() == 0:
            break
    return q, out


@pytest.mark.parametrize("seed, allow, ant", [
    (1, False, 0.0), (2, False, 0.0), (3, True, 0.0), (4, True, 0.0),
    (5, False, 0.1), (6, True, 0.05)])
def test_random_workload_matches_oracle(seed, allow, ant):
    qo, want = sc_random_workload(ORACLE, seed, allow, ant)
    qp, got = sc_random_workload(PORT, seed, allow, ant)
    assert got == want
    assert counters(qp) == counters(qo)
    assert sum(1 for o in got if o and o[0] == "RETURNING") > 50


@pytest.mark.parametrize("seed, allow, ant", [(2, False, 0.0),
                                              (6, True, 0.05)])
def test_random_workload_with_spec_buffer_matches_jax_queue(seed, allow,
                                                            ant):
    qj, want = sc_random_workload(JAX, seed, allow, ant, spec=8, steps=120)
    qp, got = sc_random_workload(PORT, seed, allow, ant, spec=8, steps=120)
    assert got == want
    assert counters(qp) == counters(qj)
    vp, vj = device_view(qp), device_view(qj)
    assert vp["spec"][0] > 0
    assert_device_views_equal(vp, vj)


# ----------------------------------------------------------------------
# speculative buffer (tests/test_spec_buffer.py:32-201)
# ----------------------------------------------------------------------

def run_interleaving(seed, spec, n_clients=8, steps=300):
    rng = random.Random(seed)
    infos = {}
    for c in range(n_clients):
        kind = rng.randrange(4)
        if kind == 0:
            infos[c] = ClientInfo(rng.uniform(0.5, 3), 0, 0)
        elif kind == 1:
            infos[c] = ClientInfo(0, rng.uniform(0.5, 3), 0)
        elif kind == 2:
            infos[c] = ClientInfo(rng.uniform(0.5, 2), rng.uniform(0.5, 3),
                                  rng.uniform(2, 6))
        else:
            infos[c] = ClientInfo(0, 2, 0)
    q = TpuPullPriorityQueue(lambda c: infos[c], capacity=16,
                             ring_capacity=16, speculative_batch=spec,
                             device="cpu")
    out, t, seq = [], S, 0
    for _ in range(steps):
        t += rng.randint(0, S // 3)
        op = rng.random()
        if op < 0.45:
            c = rng.randrange(n_clients)
            delta = rng.randint(1, 5)
            q.add_request(("r", c, seq), c,
                          ReqParams(delta, rng.randint(1, delta)),
                          time_ns=t, cost=rng.randint(1, 3))
            seq += 1
        elif op < 0.95:
            out.append(norm(q.pull_request(t)))
        else:
            q.update_client_info(rng.randrange(n_clients))
    t += 10_000 * S
    for _ in range(n_clients * 40):
        pr = q.pull_request(t)
        out.append(norm(pr))
        if not pr.is_retn():
            break
    return out, counters(q), bridge.state_to_numpy(q.state), q


@pytest.mark.parametrize("seed", [41, 42, 43, 44, 45, 46, 47, 48])
def test_spec_buffer_stream_matches_unbuffered(seed):
    a = run_interleaving(seed, spec=0)
    b = run_interleaving(seed, spec=8)
    assert a[:2] == b[:2], f"seed {seed}: buffered stream diverges"
    b[3].settle()
    for f, x in bridge.state_to_numpy(b[3].state).items():
        assert_np_equal(f, x, a[2][f])


def _single_client_runs(spec, b=PORT):
    infos = {0: b.ClientInfo(0, 1, 0), 1: b.ClientInfo(0, 3, 0)}
    q = b.make(lambda c: infos[c], capacity=8, ring_capacity=32,
               speculative_batch=spec)
    out, t = [], S
    for i in range(20):
        q.add_request(("r", 0, i), 0, b.ReqParams(1, 1), time_ns=t, cost=1)
    for i in range(30):
        t += S // 10
        if i == 10:
            q.add_request(("r", 1, 0), 1, b.ReqParams(1, 1), time_ns=t,
                          cost=1)
        out.append(norm(q.pull_request(t)))
    return q, out


def _idle_reactivation_runs(spec, b=PORT):
    infos = {c: b.ClientInfo(0, 1 + c % 2, 0) for c in range(4)}
    clock = [0.0]
    q = b.make(lambda c: infos[c], capacity=8, ring_capacity=16,
               speculative_batch=spec, idle_age_s=10.0, erase_age_s=1e6,
               monotonic_clock=lambda: clock[0])
    out, t = [], S
    for i in range(6):
        for c in range(4):
            q.add_request(("r", c, i), c, b.ReqParams(1, 1), time_ns=t,
                          cost=1)
    for _ in range(12):
        t += S // 5
        out.append(norm(q.pull_request(t)))
    q.do_clean()
    clock[0] += 20.0
    q.do_clean()          # marks everything idle
    t += 100 * S
    q.add_request(("r", 0, 99), 0, b.ReqParams(1, 1), time_ns=t, cost=1)
    for _ in range(16):
        t += S // 5
        out.append(norm(q.pull_request(t)))
    return q, out


def _mixed_batch_runs(spec, b=PORT):
    """A MIXED prefetch batch (RETURNING prefix then FUTURE steps) that
    drains fully: settle() must leave the state equal to the
    launch-per-pull twin's (the trailing steps promote a limited
    zero-weight client no handed-out pull promotes)."""
    infos = {"Z": b.ClientInfo(0.1, 0, 10), "A": b.ClientInfo(1, 0, 0),
             "B": b.ClientInfo(1, 0, 0)}
    q = b.make(lambda c: infos[c], capacity=8, ring_capacity=16,
               speculative_batch=spec)
    for c in ("Z", "A", "B"):
        for i in range(2):
            q.add_request(("r", c, i), c, b.ReqParams(1, 1), time_ns=S,
                          cost=1)
    return q, [norm(q.pull_request(5 * S)) for _ in range(4)]


@pytest.mark.parametrize("runs", [_single_client_runs,
                                  _idle_reactivation_runs,
                                  _mixed_batch_runs],
                         ids=lambda f: f.__name__.strip("_"))
def test_spec_buffer_cases(runs):
    """Each buffered run equals the unbuffered port run and the JAX
    buffered run: decisions, counters, spec counters and the settled
    state."""
    q0, a = runs(0)
    q8, b = runs(8)
    qj, c = runs(8, JAX)
    assert a == b == c
    v0, v8, vj = device_view(q0), device_view(q8), device_view(qj)
    for f in v0["state"]:
        assert_np_equal(f, v8["state"][f], v0["state"][f])
    assert_device_views_equal(v8, vj)


# ----------------------------------------------------------------------
# streaming, GC, REJECT, display, metrics
# ----------------------------------------------------------------------

def test_pull_batch_stream_matches_sequential_and_jax():
    """tests/test_stream.py:266: ``chunks`` sequential pull_batch calls
    == one pull_batch_stream, decision for decision, host mirrors
    included; and the JAX queue's stream equals the port's."""
    def build(b):
        infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 2, 0),
                 3: b.ClientInfo(5, 1, 0)}
        q = b.make(lambda c: infos[c], capacity=8, ring_capacity=16)
        for c in infos:
            for j in range(6):
                q.add_request(("r", c, j), c, b.ReqParams(1, 1),
                              time_ns=1000 + j, cost=1)
        return q

    t0, dt, chunks, k = S, S // 10, 3, 4
    qa, qb, qj = build(PORT), build(PORT), build(JAX)
    streamed = [[norm(p) for p in w]
                for w in qa.pull_batch_stream(t0, dt, chunks, k)]
    sequential = [[norm(p) for p in qb.pull_batch(t0 + c * dt, k)]
                  for c in range(chunks)]
    jax_stream = [[norm(p) for p in w]
                  for w in qj.pull_batch_stream(t0, dt, chunks, k)]
    assert streamed == sequential == jax_stream
    assert len(streamed) == chunks
    va, vb, vj = device_view(qa), device_view(qb), device_view(qj)
    assert counters(qa) == counters(qb) == counters(qj)
    assert_device_views_equal(dict(va), vb)
    assert_device_views_equal(va, vj)


def sc_gc(b, clock):
    """Idle marks, erases, slot recycling and the departed report under
    an injected monotonic clock (tests/test_tpu_engine.py:209)."""
    infos = {1: b.ClientInfo(1, 1, 0), 2: b.ClientInfo(1, 1, 0),
             3: b.ClientInfo(0, 2, 0)}
    q = b.make(lambda c: infos[c], capacity=8, idle_age_s=10.0,
               erase_age_s=20.0, monotonic_clock=lambda: clock[0])
    out = []
    q.add_request("a", 1, b.ReqParams(), time_ns=S)
    q.add_request("c", 3, b.ReqParams(), time_ns=S)
    out.append(norm(q.pull_request(2 * S)))
    for i in range(31):
        clock[0] = float(i)
        if i == 15:
            q.add_request("c2", 3, b.ReqParams(), time_ns=20 * S)
            out.append(norm(q.pull_request(21 * S)))
        q.do_clean()
        out.append(q.client_count())
    q.add_request("b", 2, b.ReqParams(), time_ns=40 * S)
    out.append(norm(q.pull_request(41 * S)))
    return q, out


def test_gc_idle_erase_and_recycle_match_jax():
    qp, a = sc_gc(PORT, [0.0])
    qj, b = sc_gc(JAX, [0.0])
    assert a == b
    vp, vj = device_view(qp), device_view(qj)
    # client 1 went quiet first and was erased; its slot went to 2
    assert [c for c, _ in vp["departed"]][:1] == [1]
    assert vp["spec"][4] >= 1 and a[-1][:2] == ("RETURNING", 2)
    assert_device_views_equal(vp, vj)


def test_reject_at_limit():
    q = TpuPullPriorityQueue(lambda c: ClientInfo(0, 1, 1),
                             at_limit=AtLimit.REJECT, device="cpu")
    got = [q.add_request(r, 52, ReqParams(), time_ns=t) for r, t in (
        ("a", S), ("b", 2 * S), ("c", 3 * S), ("d", int(3.9 * S)),
        ("e", 4 * S), ("f", 6 * S))]
    assert got == [0, 0, 0, errno.EAGAIN, errno.EAGAIN, 0]
    assert [norm(q.pull_request(100 * S))[0] for _ in range(5)] == \
        ["RETURNING"] * 4 + ["NONE"]
    q = TpuPullPriorityQueue(lambda c: ClientInfo(0, 1, 1), at_limit=3 * S,
                             device="cpu")
    assert q.at_limit is AtLimit.REJECT and q.reject_threshold_ns == 3 * S
    got = [q.add_request("x", 52, ReqParams(), time_ns=t)
           for t in (S, S, S, S, S, 3 * S)]
    assert got == [0, 0, 0, 0, errno.EAGAIN, 0]


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("threshold_s", [0, 2])
def test_reject_admission_matches_oracle(seed, threshold_s):
    """The EAGAIN pattern equals the oracle immediate-mode queue's, add
    for add, with pulls interleaved."""
    def run(b, make):
        rng = random.Random(seed)
        infos = {c: b.ClientInfo(0, 1.0 + c % 2,
                                 rng.choice([0.5, 1.0, 2.0]))
                 for c in range(6)}
        at = b.AtLimit.REJECT if threshold_s == 0 else threshold_s * S
        q = make(lambda c: infos[c], at)
        t, out = S, []
        for i in range(200):
            c = rng.randrange(6)
            t += rng.randint(0, S // 3)
            delta = rng.randint(1, 3)
            out.append(q.add_request(("r", i), c,
                                     b.ReqParams(delta,
                                                 rng.randint(1, delta)),
                                     time_ns=t, cost=rng.randint(1, 2)))
            if rng.random() < 0.2:
                out.append(norm(q.pull_request(t))[:2])
        return out

    want = run(ORACLE, lambda f, at: PullPriorityQueue(
        f, delayed_tag_calc=False, at_limit=at, run_gc_thread=False))
    got = run(PORT, lambda f, at: TpuPullPriorityQueue(f, at_limit=at,
                                                       device="cpu"))
    adds = [o for o in want if isinstance(o, int)]
    assert errno.EAGAIN in adds and 0 in adds
    # admission decisions match add for add; the oracle serves with
    # immediate tags, so only its admission pattern is compared
    assert [o for o in got if isinstance(o, int)] == adds


def test_invalid_cost_commits_nothing():
    q = TpuPullPriorityQueue(lambda c: ClientInfo(0, 1, 0), device="cpu")
    assert q.add_request("x", 1, ReqParams(), time_ns=S, cost=0) \
        == errno.EINVAL
    assert q.add_request("x", 1, ReqParams(), time_ns=S, cost="a") \
        == errno.EINVAL
    assert q.invalid_cost_rejects == 2 and q.client_count() == 0
    assert q.tick == 0 and q.empty()


def test_display_queues_equals_jax():
    def dump(b):
        infos = {1: b.ClientInfo(0, 1, 0), 2: b.ClientInfo(0, 2, 0),
                 3: b.ClientInfo(2, 1, 5)}
        q = b.make(lambda c: infos[c], capacity=8, ring_capacity=8)
        for c in (1, 2, 3):
            q.add_request(("a", c), c, b.ReqParams(), time_ns=0)
            q.add_request(("b", c), c, b.ReqParams(), time_ns=0)
        out = [q.display_queues()]
        q.pull_request(10**9)
        out.append(q.display_queues())
        return out

    got, want = dump(PORT), dump(JAX)
    assert got == want
    assert got[0].startswith("RESER: ")


def test_register_metrics_with_the_jax_registry():
    """The JAX package's MetricsRegistry takes the port's gauges (duck
    typed) and reads the same values as the JAX queue's."""
    snaps = []
    for b in (PORT, JAX):
        q, _ = sc_random_workload(b, 4, True, 0.0, spec=4, steps=80)
        reg = MetricsRegistry()
        q.register_metrics(reg, labels={"server": "0"})
        snaps.append({k: [(tuple(sorted(v["labels"].items())), v["kind"],
                           v["value"]) for v in rows]
                      for k, rows in reg.snapshot().items()})
    assert snaps[0] == snaps[1]
    assert snaps[0]["dmclock_ledger_ops"][0][2] > 0


def test_register_metrics_with_the_port_registry():
    """The port's own MetricsRegistry takes the port queue's gauges, and
    its exposition equals the JAX registry's over the JAX queue's."""
    texts = []
    for b, registry in ((PORT, PortRegistry), (JAX, MetricsRegistry)):
        q, _ = sc_random_workload(b, 4, True, 0.0, spec=4, steps=80)
        reg = registry()
        q.register_metrics(reg, labels={"server": "0"})
        texts.append(reg.prometheus())
    assert texts[0] == texts[1]
    assert "dmclock_ledger_ops" in texts[0]


def _traced_run(b, tracer_cls, **kw):
    """A short queue run under a tracer on a clock that ticks once per
    read: adds that grow the capacity and the ring, a pull, a batch, a
    stream of windows, then adds and pulls interleaved."""
    clock = iter(range(0, 10 ** 9, 7))
    tr = tracer_cls(clock_ns=lambda: next(clock))
    q = b.make(lambda c: b.ClientInfo(1, 1 + c % 3, 0), capacity=4,
               ring_capacity=2, tracer=tr, **kw)
    for i in range(12):
        q.add_request(i, i % 5, b.ReqParams(), time_ns=S)
    q.pull_request(2 * S)
    q.pull_batch(2 * S, 3)
    q.pull_batch_stream(2 * S, S // 10, 2, 2)
    for i in range(4):
        q.add_request(100 + i, i, b.ReqParams(), time_ns=2 * S)
    out = [norm(q.pull_request(3 * S)) for _ in range(3)]
    return ([(r["name"], r["cat"], r["depth"], r["dur"]) for r in tr.rows()],
            tr.summary(), out)


@pytest.mark.parametrize("spec", [0, 4])
def test_queue_spans_equal_jax(spec):
    """With one injected clock the port's queue emits the JAX queue's
    spans (queue.add, queue.pack_ops, queue.launch, queue.device_wait,
    queue.fetch, queue.fold) in the same order, nesting and durations,
    and serves the same decisions."""
    got = _traced_run(PORT, SpanTracer, speculative_batch=spec)
    want = _traced_run(JAX, JaxSpanTracer, speculative_batch=spec)
    assert got == want
    names = {r[0] for r in got[0]}
    assert {"queue.add", "queue.pack_ops", "queue.launch",
            "queue.device_wait", "queue.fetch"} <= names


def test_slo_windows_roll_like_jax():
    def run(b):
        q, _ = sc_update_client_info(b)
        rows = q.roll_slo_windows()
        after = {k: v.tolist() for k, v in q.slo_window_rows().items()}
        return rows, after, q.slo_window_rolls

    got, want = run(PORT), run(JAX)
    assert got == want
    assert got[0] and got[0][1]["contract_epoch"] == 2


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TpuPullPriorityQueue(lambda c: ClientInfo(0, 1, 0))
    # the tracer is taken (it was refused before obs.spans was ported)
    tracer = SpanTracer()
    q = TpuPullPriorityQueue(lambda c: ClientInfo(0, 1, 0), device="cpu",
                             tracer=tracer)
    assert q.tracer is tracer


def test_phase_is_an_int_enum():
    assert Phase.RESERVATION == 0 and Phase.PRIORITY == 1
    assert int(Phase.PRIORITY) == 1
