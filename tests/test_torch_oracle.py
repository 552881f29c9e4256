"""The port's oracle queues (``core.scheduler``), tag algebra and host
reference models against the JAX package's, exactly.

Each scenario is written once against a package's ``core`` and run on
both: the same seeded ``add_request`` / ``pull_request`` /
``update_client_info`` / ``remove_by_client`` / ``remove_by_req_filter`` /
``do_clean`` sequence must give equal ``PullReq`` rows (tags included),
equal add return codes, counters and queue dumps.  The scenarios are
those of ``tests/test_scheduler.py`` and the AtLimit cases of
``tests/test_native_parity.py`` (WAIT, ALLOW, REJECT with and without a
threshold; immediate and delayed tags; anticipation), plus seeded
differential runs.  Then the simulators: ``run_sim`` with ``dmclock`` and
``dmclock-delayed`` in pull and push mode equals the JAX package's on
``tests/test_push_sim.py``'s config cut, and the port's ``dmclock-torch``
on the CPU equals its ``dmclock-delayed`` (``tests/test_sim_tpu_parity.py``
's gate)."""

import dataclasses
import errno
import os
import random

import pytest

import dmclock_tpu.core as jcore
import dmclock_tpu.core.tags as jtags
import dmclock_tpu.core.timebase as jtb
import dmclock_tpu_torch.core as tcore
import dmclock_tpu_torch.core.tags as ttags
import dmclock_tpu_torch.core.timebase as ttb
from dmclock_tpu.sim.config import parse_config_file as jparse
from dmclock_tpu.sim.dmc_sim import run_sim as jrun_sim
from dmclock_tpu_torch.sim.config import parse_config_file as tparse
from dmclock_tpu_torch.sim.dmc_sim import run_sim as trun_sim

S = 1_000_000_000
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def tag_row(tag):
    return None if tag is None else dataclasses.astuple(tag)


def pr_row(pr):
    """A PullReq as a comparable tuple, its tag triple and metadata
    included (phase by value)."""
    return (pr.type.value, pr.client, pr.request,
            None if pr.phase is None else int(pr.phase), pr.cost,
            pr.when_ready, tag_row(pr.tag))


def queue_state(q):
    return (q.reserv_sched_count, q.prop_sched_count,
            q.limit_break_sched_count, q.client_count(), q.request_count(),
            q.empty(), q.display_queues(), q.tick,
            sorted((c, r.prop_delta, r.idle, r.last_tick,
                    dataclasses.astuple(r.prev_tag))
                   for c, r in q.client_map.items()))


def make_queue(core, infos, **kw):
    kw.setdefault("run_gc_thread", False)
    return core.PullPriorityQueue(lambda c: infos[c], **kw)


def drain(q, now, out, max_pulls=10_000):
    for _ in range(max_pulls):
        pr = q.pull_request(now)
        out.append(pr_row(pr))
        if not pr.is_retn():
            break


def info(core, r, w, lim):
    return core.ClientInfo(r, w, lim)


# ----------------------------------------------------------------------
# scenarios of tests/test_scheduler.py and tests/test_native_parity.py,
# each a function of the package's core returning its observations
# ----------------------------------------------------------------------

def sc_weight_ratio(core):
    infos = {1: info(core, 0, 1, 0), 2: info(core, 0, 2, 0)}
    q = make_queue(core, infos)
    out = []
    for i in range(60):
        out.append(q.add_request(("a", i), 1, core.ReqParams(), time_ns=0))
        out.append(q.add_request(("b", i), 2, core.ReqParams(), time_ns=0))
    drain(q, 100 * S, out)
    return out, queue_state(q)


def sc_reservation_ratio(core):
    infos = {1: info(core, 10, 1, 0), 2: info(core, 30, 1, 0)}
    q = make_queue(core, infos)
    out = []
    for i in range(50):
        q.add_request(i, 1, core.ReqParams(), time_ns=0)
        q.add_request(i, 2, core.ReqParams(), time_ns=0)
    for t in range(1, 40):
        out.append(pr_row(q.pull_request(t * S // 20)))
    return out, queue_state(q)


def sc_cost_weighting(core):
    infos = {1: info(core, 0, 1, 0), 2: info(core, 0, 1, 0)}
    q = make_queue(core, infos)
    out = []
    for i in range(30):
        q.add_request(i, 1, core.ReqParams(), time_ns=0, cost=1)
        q.add_request(i, 2, core.ReqParams(), time_ns=0, cost=3)
    drain(q, 1000 * S, out)
    return out, queue_state(q)


def sc_future_and_none(core):
    infos = {1: info(core, 0, 1, 1)}
    q = make_queue(core, infos)
    out = [pr_row(q.pull_request(0))]
    for i in range(3):
        q.add_request(i, 1, core.ReqParams(), time_ns=0)
    for t in (0, S // 2, S, 2 * S, 3 * S, 4 * S):
        out.append(pr_row(q.pull_request(t)))
    return out, queue_state(q)


@pytest.fixture(params=["weight", "reservation"])
def lb_axis(request):
    return request.param


def sc_limit_break(core, axis):
    r, w = (0, 1) if axis == "weight" else (1, 0)
    infos = {1: info(core, r, w, 1)}
    q = make_queue(core, infos, at_limit=core.AtLimit.ALLOW)
    out = []
    for i in range(6):
        q.add_request(i, 1, core.ReqParams(), time_ns=0)
    for t in (0, 1, S // 4, S // 2):
        out.append(pr_row(q.pull_request(t)))
    return out, queue_state(q)


def sc_wait_at_limit(core):
    infos = {1: info(core, 0, 1, 10), 2: info(core, 0, 1, 0)}
    q = make_queue(core, infos, at_limit=core.AtLimit.WAIT)
    out = []
    for i in range(40):
        q.add_request(i, 1, core.ReqParams(), time_ns=0)
        q.add_request(i, 2, core.ReqParams(), time_ns=0)
    for step in range(60):
        out.append(pr_row(q.pull_request(step * S // 50)))
    return out, queue_state(q)


@pytest.fixture(params=[0, S // 2])
def reject_threshold(request):
    return request.param


def sc_reject(core, threshold):
    infos = {1: info(core, 0, 1, 2)}
    at = core.AtLimit.REJECT if threshold == 0 else threshold
    q = make_queue(core, infos, at_limit=at)
    out = []
    for i in range(8):
        rc = q.add_request(i, 1, core.ReqParams(), time_ns=i * S // 8)
        out.append(rc)
    out.append(errno.EAGAIN in out)
    drain(q, 10 * S, out)
    return out, queue_state(q)


def sc_reject_refuses_delayed(core):
    with pytest.raises(AssertionError):
        make_queue(core, {1: info(core, 0, 1, 1)},
                   at_limit=core.AtLimit.REJECT, delayed_tag_calc=True)
    return [], None


def sc_delayed_tags(core):
    infos = {1: info(core, 1, 1, 0)}
    q = make_queue(core, infos, delayed_tag_calc=True)
    out = []
    for i in range(4):
        q.add_request(i, 1, core.ReqParams(i, min(i, 1)), time_ns=i * S)
    out.append([tag_row(r.tag) for r in q.client_map[1].requests])
    for t in (0, S, 2 * S, 10 * S, 20 * S):
        out.append(pr_row(q.pull_request(t)))
        out.append([tag_row(r.tag) for r in q.client_map[1].requests])
    return out, queue_state(q)


def sc_reduce_reservation(core):
    infos = {1: info(core, 1, 1, 0), 2: info(core, 0, 1, 0)}
    q = make_queue(core, infos)
    out = []
    for i in range(5):
        q.add_request(i, 1, core.ReqParams(), time_ns=0)
        q.add_request(i, 2, core.ReqParams(), time_ns=0)
    for t in (0, 0, 0, S // 2, S, 5 * S):
        out.append(pr_row(q.pull_request(t)))
        out.append([tag_row(r.tag) for r in q.client_map[1].requests])
    return out, queue_state(q)


def sc_removal(core):
    infos = {c: info(core, 0, 1, 0) for c in range(3)}
    q = make_queue(core, infos)
    out = []
    for i in range(12):
        q.add_request(i, i % 3, core.ReqParams(), time_ns=0)
    seen = []
    out.append(q.remove_by_req_filter(lambda r: r % 4 == 0))
    out.append(q.remove_by_req_filter(lambda r: (seen.append(r), r == 5)[1],
                                      visit_backwards=True))
    out.append(list(seen))
    acc = []
    q.remove_by_client(1, reverse=True, accum=acc.append)
    q.remove_by_client(99)
    out.append(acc)
    drain(q, 100 * S, out)
    return out, queue_state(q)


def sc_update_info(core):
    infos = {1: info(core, 0, 1, 0), 2: info(core, 0, 1, 0)}
    q = make_queue(core, infos)
    out = []
    for i in range(20):
        q.add_request(i, 1, core.ReqParams(), time_ns=0)
        q.add_request(i, 2, core.ReqParams(), time_ns=0)
    for _ in range(4):
        out.append(pr_row(q.pull_request(10 * S)))
    infos[2] = info(core, 0, 4, 0)
    q.update_client_info(2)
    q.update_client_info(99)
    for i in range(20, 30):
        q.add_request(i, 2, core.ReqParams(), time_ns=S)
    infos[1] = info(core, 5, 1, 0)
    q.update_client_infos()
    drain(q, 100 * S, out)
    return out, queue_state(q)


def sc_dynamic_info(core):
    calls = []
    a, b = info(core, 0, 1, 0), info(core, 0, 4, 0)

    def info_f(c):
        calls.append(c)
        return a if len(calls) <= 2 else b

    q = core.PullPriorityQueue(info_f, dynamic_cli_info=True,
                               run_gc_thread=False)
    q.add_request("a", 1, core.ReqParams(), time_ns=0)
    out = [pr_row(q.pull_request(10 * S))]
    q.add_request("b", 1, core.ReqParams(), time_ns=0)
    out.append(tag_row(q.client_map[1].requests[-1].tag))
    out.append(len(calls))
    return out, queue_state(q)


def sc_idle_reactivation(core):
    infos = {1: info(core, 0, 1, 0), 2: info(core, 0, 1, 0)}
    q = make_queue(core, infos)
    out = []
    for i in range(100):
        q.add_request(("c1", i), 1, core.ReqParams(), time_ns=0)
    for _ in range(50):
        out.append(pr_row(q.pull_request(1000 * S)))
    q.add_request(("c2", 0), 2, core.ReqParams(), time_ns=0)
    out.append(q.client_map[2].prop_delta)
    for _ in range(4):
        out.append(pr_row(q.pull_request(1000 * S)))
    return out, queue_state(q)


def sc_gc(core):
    state = {"t": 0.0}
    q = make_queue(core, {i: info(core, 1, 1, 0) for i in range(10)},
                   idle_age_s=10, erase_age_s=20, check_time_s=5,
                   erase_max=3, monotonic_clock=lambda: state["t"])
    out = []
    for i in range(10):
        q.add_request("r", i, core.ReqParams(), time_ns=0)
        out.append(pr_row(q.pull_request(10 * S)))
    for t in (0.0, 12.0, 25.0, 26.0, 27.0, 60.0):
        state["t"] = t
        q.do_clean()
        out.append((q.client_count(), q.last_erase_point,
                    sorted((c, r.idle) for c, r in q.client_map.items())))
    q.add_request("x", 3, core.ReqParams(), time_ns=100 * S)
    drain(q, 200 * S, out)
    return out, queue_state(q)


SCENARIOS = {
    "weight_ratio": sc_weight_ratio,
    "reservation_ratio": sc_reservation_ratio,
    "cost_weighting": sc_cost_weighting,
    "future_and_none": sc_future_and_none,
    "wait_at_limit": sc_wait_at_limit,
    "reject_refuses_delayed": sc_reject_refuses_delayed,
    "delayed_tags": sc_delayed_tags,
    "reduce_reservation": sc_reduce_reservation,
    "removal": sc_removal,
    "update_info": sc_update_info,
    "dynamic_info": sc_dynamic_info,
    "idle_reactivation": sc_idle_reactivation,
    "gc": sc_gc,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name):
    got = SCENARIOS[name](tcore)
    want = SCENARIOS[name](jcore)
    assert got == want
    assert got[0] or name == "reject_refuses_delayed"


def test_limit_break_equals_jax(lb_axis):
    assert sc_limit_break(tcore, lb_axis) == sc_limit_break(jcore, lb_axis)


def test_reject_equals_jax(reject_threshold):
    got = sc_reject(tcore, reject_threshold)
    assert got == sc_reject(jcore, reject_threshold)
    assert errno.EAGAIN in got[0]


# ----------------------------------------------------------------------
# seeded differential runs (tests/test_native_parity.py's fuzz)
# ----------------------------------------------------------------------

def differential(core, seed, at_limit, delayed, anticipation_ns):
    rng = random.Random(seed)
    infos = {c: info(core, rng.choice([0, 0, 2, 5, 20]),
                     rng.choice([1, 2, 3]), rng.choice([0, 0, 30, 50]))
             for c in range(6)}
    at = getattr(core.AtLimit, at_limit)
    q = make_queue(core, infos, at_limit=at, delayed_tag_calc=delayed,
                   anticipation_timeout_ns=anticipation_ns)
    out = []
    now = 0
    for step in range(400):
        now += rng.randrange(0, S // 20)
        op = rng.random()
        c = rng.randrange(6)
        if op < 0.5:
            d = rng.randrange(0, 3)
            out.append(q.add_request(step, c, core.ReqParams(d, rng.randrange(
                0, d + 1)), time_ns=now, cost=rng.randrange(1, 4)))
        elif op < 0.9:
            out.append(pr_row(q.pull_request(now)))
        elif op < 0.95:
            infos[c] = info(core, rng.choice([0, 4]), rng.choice([1, 5]),
                            rng.choice([0, 10, 25]))
            q.update_client_info(c)
        else:
            acc = []
            q.remove_by_client(c, accum=acc.append)
            out.append(acc)
    drain(q, now + 100 * S, out)
    return out, queue_state(q)


DIFF_CASES = [(seed, at, delayed, ant)
              for seed in range(3)
              for at in ("WAIT", "ALLOW", "REJECT")
              for delayed in (False, True)
              for ant in (0, S // 10)
              if not (at == "REJECT" and delayed)]


@pytest.mark.parametrize("seed,at_limit,delayed,anticipation_ns",
                         DIFF_CASES)
def test_differential_equals_jax(seed, at_limit, delayed, anticipation_ns):
    got = differential(tcore, seed, at_limit, delayed, anticipation_ns)
    want = differential(jcore, seed, at_limit, delayed, anticipation_ns)
    assert got == want
    assert any(isinstance(x, tuple) and x[0] == 0 for x in got[0])


# ----------------------------------------------------------------------
# the push queue behind a virtual clock, and the tag helpers
# ----------------------------------------------------------------------

def push_run(core, delayed):
    clock = {"t": 0}
    handled, timers = [], []
    busy = {"n": 0}

    def handle(client, request, phase, cost):
        handled.append((clock["t"], client, request, int(phase), cost))
        busy["n"] += 1

    infos = {1: info(core, 2, 1, 5), 2: info(core, 0, 2, 0),
             3: info(core, 1, 1, 0)}
    q = core.PushPriorityQueue(
        lambda c: infos[c], lambda: busy["n"] < 2, handle,
        now_ns_f=lambda: clock["t"], sched_at_f=timers.append,
        delayed_tag_calc=delayed, run_gc_thread=False)
    for i in range(30):
        clock["t"] = i * S // 40
        q.add_request(i, 1 + i % 3, core.ReqParams(), cost=1 + i % 2)
        if i % 3 == 0 and busy["n"]:
            busy["n"] -= 1
            q.request_completed()
    for _ in range(200):
        if busy["n"]:
            busy["n"] -= 1
            clock["t"] += S // 100
            q.request_completed()
        elif timers:
            clock["t"] = max(clock["t"], timers.pop(0))
            q.sched_ahead_fire()
        else:
            break
    q.shutdown()
    return handled, list(timers), queue_state(q)


@pytest.mark.parametrize("delayed", [False, True])
def test_push_queue_equals_jax(delayed):
    got = push_run(tcore, delayed)
    assert got == push_run(jcore, delayed)
    assert len(got[0]) > 20


def test_tags_and_timebase_equal_jax():
    ti = tcore.ClientInfo(3, 2, 7)
    ji = jcore.ClientInfo(3, 2, 7)
    tprev, jprev = ttags.ZERO_TAG, jtags.ZERO_TAG
    for i in range(20):
        kw = dict(delta=i % 3, rho=i % 2, time_ns=i * S // 7,
                  cost=1 + i % 3, anticipation_timeout_ns=S // 5)
        tprev = ttags.RequestTag.from_prev(tprev, ti, **kw)
        jprev = jtags.RequestTag.from_prev(jprev, ji, **kw)
        assert dataclasses.astuple(tprev) == dataclasses.astuple(jprev)
        assert str(tprev) == str(jprev)
    assert dataclasses.astuple(ttags.ZERO_TAG) == \
        dataclasses.astuple(jtags.ZERO_TAG)
    for v in (0, 1, 12345, ttb.MAX_TAG, ttb.MIN_TAG, 5 * S + 17):
        assert ttb.format_tag(v) == jtb.format_tag(v)
        assert ttb.ns_to_sec(v) == jtb.ns_to_sec(v)
        for p in (0, 3, v):
            assert ttb.min_not_0_time(v, p) == jtb.min_not_0_time(v, p)


# ----------------------------------------------------------------------
# the simulators: run_sim traces on tests/test_push_sim.py's config cut
# ----------------------------------------------------------------------

def _cut(parse, total_ops):
    cfg = parse(os.path.join(CONFIGS, "dmc_sim_example.conf"))
    for g in cfg.cli_group:
        g.client_total_ops = total_ops
    return cfg


def _sim_rows(sim):
    return (list(sim.trace),
            {cid: (c.stats.reservation_ops, c.stats.priority_ops)
             for cid, c in sim.clients.items()})


@pytest.mark.parametrize("model", ["dmclock", "dmclock-delayed"])
@pytest.mark.parametrize("mode", ["pull", "push"])
def test_run_sim_equals_jax(model, mode):
    got = _sim_rows(trun_sim(_cut(tparse, 150), model=model, seed=7,
                             record_trace=True, server_mode=mode,
                             device="cpu"))
    want = _sim_rows(jrun_sim(_cut(jparse, 150), model=model, seed=7,
                              record_trace=True, server_mode=mode))
    assert len(got[0]) == 600
    assert got == want


def test_device_model_equals_delayed_oracle():
    """``dmclock-torch`` on the CPU serves the oracle's op stream
    (``dmclock-delayed``), op for op, with each client's phase split."""
    cfg = _cut(tparse, 60)
    got = _sim_rows(trun_sim(cfg, model="dmclock-torch", seed=7,
                             record_trace=True, device="cpu"))
    want = _sim_rows(trun_sim(_cut(tparse, 60), model="dmclock-delayed",
                              seed=7, record_trace=True, device="cpu"))
    assert len(got[0]) == 240
    assert got == want
