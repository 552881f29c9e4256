"""The port's placement map (``lifecycle/placement.py``) and the p2c
mesh churn jobs of its supervisor against the JAX package's, exactly:
the counterparts of ``tests/test_placement.py``'s unit and supervisor
tests (its migration cases are in ``test_torch_migration.py``).  Both
maps get the same calls and must agree on every assignment,
counter and deferral, and their ``pm_*`` leaves load in either
package."""

import numpy as np
import pytest

from dmclock_tpu.lifecycle import churn as jchurn
from dmclock_tpu.lifecycle import placement as JP
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.lifecycle import churn as tchurn
from dmclock_tpu_torch.lifecycle import placement as TP
from dmclock_tpu_torch.robust import supervisor as TS

from test_torch_supervisor import assert_results_equal


def _pair(*a, **kw):
    return TP.PlacementMap(*a, **kw), JP.PlacementMap(*a, **kw)


def _assert_maps_equal(t, j):
    assert np.array_equal(t.assign, j.assign)
    assert t.counters == j.counters
    assert t.deferred == j.deferred
    assert t.snapshot() == j.snapshot()
    for k in ("pm_assign", "pm_rng", "pm_counters", "pm_moves",
              "pm_deferred"):
        a, b = t.encode()[k], j.encode()[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_parse_placement():
    for spec in (None, "static", "p2c", {"mode": "p2c",
                                         "overrides": {"37": 2}}):
        assert TP.parse_placement(spec) == JP.parse_placement(spec)
    with pytest.raises(ValueError):
        TP.parse_placement("zipf")


@pytest.mark.parametrize("seed", [7, 8])
def test_p2c_equals_jax_and_is_seeded(seed):
    t, j = _pair(4, 32, mode="p2c", seed=seed)
    backlog = np.zeros(4, dtype=np.int64)
    assert t.place_batch(list(range(32)), backlog=backlog) == \
        j.place_batch(list(range(32)), backlog=backlog)
    _assert_maps_equal(t, j)
    other = TP.PlacementMap(4, 32, mode="p2c", seed=seed + 100)
    other.place_batch(list(range(32)), backlog=backlog)
    assert not np.array_equal(t.assign, other.assign)


def test_p2c_prefers_lower_backlog():
    t, j = _pair(2, 64, mode="p2c", seed=1)
    backlog = np.asarray([10 ** 6, 0], dtype=np.int64)
    t.place_batch(list(range(64)), backlog=backlog)
    j.place_batch(list(range(64)), backlog=backlog)
    _assert_maps_equal(t, j)
    assert (t.assign == 1).sum() > (t.assign == 0).sum()


def test_pins_overrides_and_unpinned_scenarios():
    spec = tchurn.make_spec("shard_skew", total_ids=32)
    pins = TP.placement_pins(spec, 4)
    assert pins.all()
    assert np.array_equal(
        pins, JP.placement_pins(jchurn.make_spec("shard_skew",
                                                 total_ids=32), 4))
    assert not TP.placement_pins(
        tchurn.make_spec("flash_crowd", total_ids=32), 4).any()
    t, j = _pair(4, 32, mode="p2c", seed=7, pins=pins)
    zero = np.zeros(4, dtype=np.int64)
    t.place_batch(list(range(32)), backlog=zero)
    j.place_batch(list(range(32)), backlog=zero)
    _assert_maps_equal(t, j)
    assert np.array_equal(t.assign, np.arange(32) % 4)
    assert t.counters["p2c_draws"] == 0
    t, j = _pair(4, 32, mode="p2c", seed=7, pins=pins,
                 overrides={8: 3, 9: 2})
    t.place_batch(list(range(32)), backlog=zero)
    j.place_batch(list(range(32)), backlog=zero)
    _assert_maps_equal(t, j)
    assert t.shard_of(8) == 3 and t.shard_of(9) == 2
    assert t.shard_of(12) == 0 and t.counters["overrides"] == 2
    with pytest.raises(ValueError):
        TP.PlacementMap(4, 32, overrides={1: 4})


def test_down_shards_reroute_and_defer():
    t, j = _pair(2, 128, mode="p2c", seed=3)
    up = np.asarray([True, False])
    zero = np.zeros(2, dtype=np.int64)
    placed = t.place_batch(list(range(128)), backlog=zero, up=up)
    assert placed == j.place_batch(list(range(128)), backlog=zero, up=up)
    _assert_maps_equal(t, j)
    assert placed and all(t.shard_of(c) == 0 for c in placed)
    assert t.counters["reroutes"] > 0
    assert t.counters["defers"] == 128 - len(placed)
    assert t.take_deferred() == j.take_deferred()
    # both down: every registration defers, and places one boundary on
    t, j = _pair(2, 8, mode="p2c", seed=3)
    down = np.asarray([False, False])
    assert t.place_batch(list(range(8)), backlog=zero, up=down) == []
    j.place_batch(list(range(8)), backlog=zero, up=down)
    deferred = t.take_deferred()
    assert deferred == j.take_deferred() == list(range(8))
    assert t.take_deferred() == []
    assert t.place_batch(deferred, backlog=zero) == \
        j.place_batch(deferred, backlog=zero) == deferred
    _assert_maps_equal(t, j)


def test_rng_parity_reroute_vs_clean():
    """A down shard changes the destination, never the draw count."""
    a = TP.PlacementMap(2, 64, mode="p2c", seed=9)
    b = TP.PlacementMap(2, 64, mode="p2c", seed=9)
    zero = np.zeros(2, dtype=np.int64)
    a.place_batch(list(range(32)), backlog=zero)
    b.place_batch(list(range(32)), backlog=zero,
                  up=np.asarray([True, False]))
    assert a.counters["p2c_draws"] == b.counters["p2c_draws"]
    a.place_batch([40], backlog=zero)
    b.place_batch([40], backlog=zero)
    assert a.assign[40] == b.assign[40]


def test_encode_load_round_trip_across_packages():
    """A map's ``pm_*`` leaves restore in either package and the
    restored RNG continues the original stream; a snapshot that carries
    migrations restores its move log, in either package."""
    t, j = _pair(4, 32, mode="p2c", seed=7)
    zero = np.zeros(4, dtype=np.int64)
    t.place_batch(list(range(16)), backlog=zero,
                  up=np.asarray([True, False, False, True]))
    j.place_batch(list(range(16)), backlog=zero,
                  up=np.asarray([True, False, False, True]))
    t2 = TP.PlacementMap(4, 32, mode="p2c", seed=0)
    t2.load(j.encode())
    j2 = JP.PlacementMap(4, 32, mode="p2c", seed=0)
    j2.load(t.encode())
    _assert_maps_equal(t2, j)
    _assert_maps_equal(t, j2)
    assert t2.place_batch([20, 21], backlog=zero) == \
        j2.place_batch([20, 21], backlog=zero)
    _assert_maps_equal(t2, j2)
    t3 = TP.PlacementMap(4, 32, mode="p2c", seed=0)
    t3.load(TP.empty_leaves())                # a payload without a map
    assert (t3.assign < 0).all()
    moved = dict(t.encode(), pm_moves=np.asarray([[1, 2, 0, 1]]))
    t3.load(moved)
    j3 = JP.PlacementMap(4, 32, mode="p2c", seed=0)
    j3.load(moved)
    assert t3.move_log() == j3.move_log() == [[1, 2, 0, 1]]
    _assert_maps_equal(t3, j3)


def test_publish_gauges():
    from dmclock_tpu_torch.obs.registry import MetricsRegistry

    t = TP.PlacementMap(2, 8, mode="p2c", seed=3)
    t.place_batch(list(range(8)), backlog=np.zeros(2, dtype=np.int64))
    reg = MetricsRegistry()
    t.publish(reg)
    text = reg.prometheus()
    assert "dmclock_placement_total 8" in text
    assert "dmclock_migration_last_boundary -1" in text


# ----------------------------------------------------------------------
# the supervisor: validation, S=1 neutrality, p2c under chaos
# ----------------------------------------------------------------------

JOB = dict(engine="prefix", k=16, select_impl="sort", n=96, depth=6,
           ring=10, epochs=8, m=2, seed=5, arrival_lam=1.0, waves=2,
           ckpt_every=2, engine_loop="mesh", n_shards=1)


def _spec(scenario="flash_crowd", **kw):
    return (tchurn.make_spec(scenario, total_ids=32, **kw),
            jchurn.make_spec(scenario, total_ids=32, **kw))


def test_p2c_requires_mesh_churn():
    with pytest.raises(ValueError, match="placement"):
        TS.run_job(TS.EpochJob(**dict(JOB, engine_loop="stream",
                                      placement="p2c")), device="cpu")
    with pytest.raises(ValueError, match="placement"):
        TS.run_job(TS.EpochJob(**dict(JOB, placement="p2c")),
                   device="cpu")


def test_static_chaos_rejection_still_loud():
    spec, _ = _spec()
    with pytest.raises(ValueError, match="p2c"):
        TS.run_job(TS.EpochJob(**dict(
            JOB, n_shards=4, churn=spec,
            fault_plan={"seed": 11, "p_dropout": 0.3})), device="cpu")


def test_s1_p2c_is_loop_neutral():
    """p2c over one shard can only pick shard 0: digest, state, metrics
    and the lifecycle snapshot equal the static path; both equal JAX."""
    spec, jspec = _spec()
    a = TS.run_job(TS.EpochJob(**dict(JOB, churn=spec)), device="cpu")
    b = TS.run_job(TS.EpochJob(**dict(JOB, churn=spec, placement="p2c")),
                   device="cpu")
    assert a.digest == b.digest and a.state_digest == b.state_digest
    assert np.array_equal(a.metrics, b.metrics)
    assert a.lifecycle == b.lifecycle
    assert b.placement == "p2c" and a.placement is None
    assert b.migrations == 0 and b.migration_log == []
    jb = JS.run_job(JS.EpochJob(**dict(JOB, churn=jspec,
                                       placement="p2c")))
    assert_results_equal(b, jb)


@pytest.mark.parametrize("scenario", ["flash_crowd", "shard_skew"])
def test_p2c_chaos_job_equals_jax(scenario):
    """S=4 p2c under a fault plan that takes shards down at boundaries
    (re-routes and deferrals happen): every result field, the placement
    counters among them, equals the JAX supervisor's."""
    kw = dict(n_shards=4) if scenario == "shard_skew" else {}
    spec, jspec = _spec(scenario, seed=3, **kw)
    over = dict(n_shards=4, placement="p2c",
                fault_plan={"seed": 5, "p_dropout": 0.4,
                            "mean_outage_steps": 2.0})
    got = TS.run_job(TS.EpochJob(**dict(JOB, churn=spec, **over)),
                     device="cpu")
    want = JS.run_job(JS.EpochJob(**dict(JOB, churn=jspec, **over)))
    assert_results_equal(got, want)
    assert got.placement_counters["placements"] > 0
    if scenario == "flash_crowd":
        pc = got.placement_counters
        assert pc["reroutes"] + pc["defers"] > 0, pc
