"""The port's client trackers against the JAX package's: the host
``ServiceTracker`` (Orig and Borrowing accounting, GC) on seeded
request/response sequences over several servers, and every function of
``parallel.tracker`` on seeded ``[S, C]`` inputs with repeated slots.
Every value is an integer: equality is exact."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.core import tracker as jtr
from dmclock_tpu.core.recs import Phase as JaxPhase
from dmclock_tpu.obs.registry import MetricsRegistry as JaxRegistry
from dmclock_tpu.parallel import tracker as jpt
from dmclock_tpu.utils.periodic import PeriodicTask as JaxPeriodicTask
from dmclock_tpu_torch.core import tracker as ttr
from dmclock_tpu_torch.core.recs import Phase
from dmclock_tpu_torch.obs.registry import MetricsRegistry
from dmclock_tpu_torch.parallel import tracker as tpt
from dmclock_tpu_torch.utils.periodic import PeriodicTask

S, C, Q = 4, 24, 40


# ----------------------------------------------------------------------
# the host ServiceTracker
# ----------------------------------------------------------------------

def _ops(seed: int, n: int = 400, servers: int = 5):
    """A seeded interleaving of requests and responses over ``servers``
    servers: ("req", s) or ("resp", s, reservation?, cost)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, servers))
        if rng.random() < 0.45:
            out.append(("req", s))
        else:
            out.append(("resp", s, bool(rng.random() < 0.3),
                        int(rng.integers(1, 4))))
    return out


@pytest.mark.parametrize("policy", ["orig", "borrowing"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_service_tracker_equals_jax(policy, seed):
    cls_t = ttr.OrigTracker if policy == "orig" else ttr.BorrowingTracker
    cls_j = jtr.OrigTracker if policy == "orig" else jtr.BorrowingTracker
    t = ttr.ServiceTracker(tracker_cls=cls_t, run_gc_thread=False)
    j = jtr.ServiceTracker(tracker_cls=cls_j, run_gc_thread=False)
    for op in _ops(seed):
        if op[0] == "req":
            a, b = t.get_req_params(op[1]), j.get_req_params(op[1])
            assert (a.delta, a.rho) == (b.delta, b.rho), op
        else:
            _, s, resv, cost = op
            t.track_resp(s, Phase.RESERVATION if resv else Phase.PRIORITY,
                         cost)
            j.track_resp(s, JaxPhase.RESERVATION if resv
                         else JaxPhase.PRIORITY, cost)
        assert (t.counters.delta, t.counters.rho) == \
            (j.counters.delta, j.counters.rho)
    assert sorted(t.server_map) == sorted(j.server_map)
    for s in t.server_map:
        assert [getattr(t.server_map[s], f) for f in cls_t.__slots__] == \
            [getattr(j.server_map[s], f) for f in cls_j.__slots__]


def test_service_tracker_gc_equals_jax():
    """do_clean with an injected clock drops the same server records."""
    now = [0.0]
    kw = dict(run_gc_thread=False, clean_age_s=10.0,
              monotonic_clock=lambda: now[0])
    t, j = ttr.ServiceTracker(**kw), jtr.ServiceTracker(**kw)
    for step, op in enumerate(_ops(5, n=300, servers=8)):
        if op[0] == "req":
            t.get_req_params(op[1])
            j.get_req_params(op[1])
        else:
            _, s, resv, cost = op
            t.track_resp(s, Phase.PRIORITY, cost)
            j.track_resp(s, JaxPhase.PRIORITY, cost)
        if step % 25 == 0:
            now[0] += 4.0
            t.do_clean()
            j.do_clean()
            assert sorted(t.server_map) == sorted(j.server_map)
    assert len(t.server_map) < 8


def test_phase_is_the_ports_own():
    """The port's trackers count rho on the port's own Phase."""
    t = ttr.ServiceTracker(run_gc_thread=False)
    t.get_req_params("a")
    t.track_resp("b", Phase.RESERVATION, 2)
    p = t.get_req_params("a")
    assert (p.delta, p.rho) == (2, 2)


def test_periodic_task_runs_and_stops():
    for cls in (PeriodicTask, JaxPeriodicTask):
        hit = threading.Event()
        task = cls(0.01, hit.set)
        assert hit.wait(5.0)
        task.try_update(0.005)
        task.stop()
        assert task._thread is None


# ----------------------------------------------------------------------
# parallel.tracker on [S, C]
# ----------------------------------------------------------------------

def _jax_of(state) -> dict:
    return {f: np.asarray(v) for f, v in zip(state._fields, state)}


def _torch_of(state) -> dict:
    return {f: v.numpy() for f, v in zip(state._fields, state)}


def _same(port, jax_state):
    a, b = _torch_of(port), _jax_of(jax_state)
    assert a.keys() == b.keys()
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        assert np.array_equal(a[f], b[f]), f


def _batch(rng):
    """[S, Q] decision-stream rows with repeated slots (and -1 where
    unserved, as engine_run emits)."""
    served = rng.random((S, Q)) < 0.7
    slots = rng.integers(0, C // 3, (S, Q)).astype(np.int32)
    slots = np.where(served, slots, -1).astype(np.int32)
    costs = rng.integers(1, 5, (S, Q)).astype(np.int64)
    phases = rng.integers(0, 2, (S, Q)).astype(np.int32)
    return slots, costs, phases, served


def _vmap_jax(fn, *args, in_axes=0):
    return jax.vmap(fn, in_axes=in_axes)(*args)


@pytest.mark.parametrize("kind", ["orig", "borrowing"])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_tracker_rounds_equal_jax(kind, seed):
    """Rounds of prepare (a random requesting set) and track (repeated
    slots) on a stacked [S, C] tracker equal the JAX functions vmapped
    over servers, state and outputs, after every call."""
    rng = np.random.default_rng(seed)
    if kind == "orig":
        t = tpt.init_tracker(C, n_servers=S, device="cpu")
        one = jpt.init_tracker(C)
        prep_t, prep_j = tpt.tracker_prepare, jpt.tracker_prepare
        track_t, track_j = tpt.tracker_track, jpt.tracker_track
    else:
        t = tpt.init_borrow_tracker(C, n_servers=S, device="cpu")
        one = jpt.init_borrow_tracker(C)
        prep_t, prep_j = tpt.borrow_tracker_prepare, \
            jpt.borrow_tracker_prepare
        track_t, track_j = tpt.borrow_tracker_track, \
            jpt.borrow_tracker_track
    j = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape), one)
    _same(t, j)
    for _ in range(6):
        gd_t, gr_t = tpt.global_counters(t)
        gd_j, gr_j = jpt.global_counters(j, lambda x: x.sum(axis=0))
        assert np.array_equal(gd_t.numpy(), np.asarray(gd_j))
        assert np.array_equal(gr_t.numpy(), np.asarray(gr_j))
        req = rng.random((S, C)) < 0.5
        t, d_t, r_t = prep_t(t, torch.from_numpy(req), gd_t, gr_t)
        j, d_j, r_j = _vmap_jax(prep_j, j, jnp.asarray(req), gd_j, gr_j,
                                in_axes=(0, 0, None, None))
        _same(t, j)
        assert np.array_equal(d_t.numpy(), np.asarray(d_j))
        assert np.array_equal(r_t.numpy(), np.asarray(r_j))
        slots, costs, phases, served = _batch(rng)
        t = track_t(t, *(torch.from_numpy(x) for x in
                         (slots, costs, phases, served)))
        j = _vmap_jax(track_j, j, *(jnp.asarray(x) for x in
                                    (slots, costs, phases, served)))
        _same(t, j)
    assert int(t.completed_delta.sum()) > 0


def test_one_server_shard_equals_jax():
    """A [C] shard (no server axis) takes the same functions."""
    rng = np.random.default_rng(3)
    t = tpt.init_tracker(C, device="cpu")
    j = jpt.init_tracker(C)
    slots, costs, phases, served = (x[0] for x in _batch(rng))
    t = tpt.tracker_track(t, *(torch.from_numpy(x) for x in
                               (slots, costs, phases, served)))
    j = jpt.tracker_track(j, *(jnp.asarray(x) for x in
                               (slots, costs, phases, served)))
    _same(t, j)
    ident = (lambda x: x)
    gd_t, gr_t = tpt.global_counters(t, ident)
    gd_j, gr_j = jpt.global_counters(j, ident)
    req = rng.random(C) < 0.5
    t, d_t, r_t = tpt.tracker_prepare(t, torch.from_numpy(req), gd_t, gr_t)
    j, d_j, r_j = jpt.tracker_prepare(j, jnp.asarray(req), gd_j, gr_j)
    _same(t, j)
    assert np.array_equal(d_t.numpy(), np.asarray(d_j))
    assert np.array_equal(r_t.numpy(), np.asarray(r_j))


def test_track_counts_and_counter_helpers_equal_jax():
    rng = np.random.default_rng(4)
    t = tpt.init_tracker(C, n_servers=S, device="cpu")
    j = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape),
                     jpt.init_tracker(C))
    srv = rng.integers(0, 9, (S, C)).astype(np.int32)
    rsv = np.minimum(srv, rng.integers(0, 9, (S, C))).astype(np.int32)
    cost = rng.integers(1, 4, C).astype(np.int64)
    t = tpt.tracker_track_counts(t, torch.from_numpy(srv),
                                 torch.from_numpy(rsv),
                                 torch.from_numpy(cost))
    j = jpt.tracker_track_counts(j, jnp.asarray(srv), jnp.asarray(rsv),
                                 jnp.asarray(cost))
    _same(t, j)
    a = tpt.global_counters_from(t.completed_delta, t.completed_rho)
    b = jpt.global_counters_from(j.completed_delta, j.completed_rho,
                                 lambda x: x.sum(axis=0))
    for x, y in zip(a, b):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert tpt.counter_view_bytes(100_000) == \
        jpt.counter_view_bytes(100_000)
    for args in ((10, 3), (10, 3, 5), (0, 4), (7, 0, 2), (64, 4, 63)):
        assert tpt.exchange_schedule(*args) == jpt.exchange_schedule(*args)


@pytest.mark.parametrize("kind", ["orig", "borrowing"])
def test_snapshot_and_metrics_equal_jax(kind):
    rng = np.random.default_rng(6)
    if kind == "orig":
        t = tpt.init_tracker(C, n_servers=S, device="cpu")
        j = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape),
                         jpt.init_tracker(C))
        prep_t, prep_j = tpt.tracker_prepare, jpt.tracker_prepare
    else:
        t = tpt.init_borrow_tracker(C, n_servers=S, device="cpu")
        j = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape),
                         jpt.init_borrow_tracker(C))
        prep_t, prep_j = tpt.borrow_tracker_prepare, \
            jpt.borrow_tracker_prepare
    slots, costs, phases, served = _batch(rng)
    t = tpt.tracker_track(t, *(torch.from_numpy(x) for x in
                               (slots, costs, phases, served)))
    j = _vmap_jax(jpt.tracker_track, j, *(jnp.asarray(x) for x in
                                          (slots, costs, phases, served)))
    req = rng.random((S, C)) < 0.5
    gd_t, gr_t = tpt.global_counters(t)
    gd_j, gr_j = jpt.global_counters(j, lambda x: x.sum(axis=0))
    t, _, _ = prep_t(t, torch.from_numpy(req), gd_t, gr_t)
    j, _, _ = _vmap_jax(prep_j, j, jnp.asarray(req), gd_j, gr_j,
                        in_axes=(0, 0, None, None))
    assert tpt.tracker_snapshot(t) == jpt.tracker_snapshot(j)
    rt, rj = MetricsRegistry(), JaxRegistry()
    tpt.register_tracker_metrics(rt, lambda: t, labels={"server": "0"})
    jpt.register_tracker_metrics(rj, lambda: j, labels={"server": "0"})
    assert rt.prometheus() == rj.prometheus()


def test_device_tracker_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tpt.init_tracker(4)
    with pytest.raises(RuntimeError, match="cuda"):
        tpt.init_borrow_tracker(4, n_servers=2)
