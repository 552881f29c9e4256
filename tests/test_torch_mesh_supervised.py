"""The port's supervised mesh (``EpochJob(engine_loop="mesh")`` in
``robust/supervisor.py``) against the JAX supervisor on its 8 forced CPU
devices, exactly: the counterparts of ``tests/test_mesh.py``'s identity
gate (S=1 equal to the round and stream loops on the three engines),
the composition refusals, collective skipping, the zero-host-fault gate,
SIGKILL at 0.35 and 0.75 of the decisions, the chaos counters against
the plan's oracle, and the chaos and churn kill matrix; S=4 and S=8
jobs equal to the JAX loop field for field (counters, views, fallbacks
and placement counters included); one spawn-mode job; and the port's
deliberate difference: more shards than devices run on the one
device."""

import jax
import numpy as np
import pytest

from dmclock_tpu.lifecycle import churn as jchurn
from dmclock_tpu.robust import faults as JF
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.lifecycle import churn as tchurn
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

from test_torch_supervisor import assert_results_equal

BASE = dict(n=96, depth=6, ring=10, epochs=5, m=2, seed=5,
            arrival_lam=1.0, waves=2, ckpt_every=2)
JOBS = {
    "prefix-sort": dict(engine="prefix", k=16, select_impl="sort"),
    "chain": dict(engine="chain", chain_depth=3, k=8),
    "calendar-minstop": dict(engine="calendar", k=4,
                             calendar_impl="minstop"),
}
CHAOS_SPEC = {"seed": 11, "p_dropout": 0.3, "mean_outage_steps": 2.0,
              "p_delay": 0.2, "p_dup": 0.2, "max_skew_ns": 1000}

_REFS: dict = {}


def kw_of(name, loop="mesh", **over):
    return dict(BASE, **JOBS[name], engine_loop=loop, **over)


def port(name, loop="mesh", **over):
    key = ("port", name, loop, repr(sorted(over.items())))
    if key not in _REFS:
        _REFS[key] = TS.run_job(TS.EpochJob(**kw_of(name, loop, **over)),
                                device="cpu")
    return _REFS[key]


def jaxrun(name, loop="mesh", **over):
    key = ("jax", name, loop, repr(sorted(over.items())))
    if key not in _REFS:
        _REFS[key] = JS.run_job(JS.EpochJob(**kw_of(name, loop, **over)))
    return _REFS[key]


def assert_core_equal(a, b):
    assert a.digest == b.digest, "decision digest diverged"
    assert a.state_digest == b.state_digest, "final state diverged"
    assert a.decisions == b.decisions
    assert np.array_equal(np.asarray(a.metrics), np.asarray(b.metrics))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_s1_mesh_equals_round_stream_and_jax(name):
    m = port(name)
    assert m.decisions > 0
    assert_core_equal(m, port(name, "round"))
    assert_core_equal(m, port(name, "stream"))
    assert m.mesh_counters.shape == (2, 1, BASE["n"])
    assert m.mesh_fallbacks == 0
    assert_results_equal(m, jaxrun(name))


def test_s1_telemetry_planes_equal_the_stream_loop():
    tele = dict(with_hists=True, with_ledger=True, with_slo=True,
                with_prov=True, flight_records=16)
    s = port("prefix-sort", "stream", **tele)
    m = port("prefix-sort", **tele)
    assert_core_equal(m, s)
    for f in ("hists", "ledger", "slo_window", "slo_ring", "slo_cepoch",
              "prov_margin_hist", "prov_scal", "prov_last_served",
              "flight_buf"):
        assert np.array_equal(getattr(m, f), getattr(s, f)), f
    assert m.slo == s.slo and m.flight_seq == s.flight_seq


@pytest.mark.parametrize("S, over", [
    (4, dict(with_hists=True, with_ledger=True, with_slo=True,
             with_prov=True, flight_records=16)),
    (8, dict(counter_sync_every=2)),
])
def test_sharded_job_equals_jax(S, over):
    got = port("prefix-sort", n_shards=S, **over)
    assert got.mesh_counters.shape == (2, S, BASE["n"])
    assert_results_equal(got, jaxrun("prefix-sort", n_shards=S, **over))


def test_no_ingest_mesh():
    assert_core_equal(port("prefix-sort", arrival_lam=0.0),
                      port("prefix-sort", "round", arrival_lam=0.0))


def test_mesh_composition_refusals():
    spec = tchurn.make_spec("flash_crowd", total_ids=32)
    cases = [
        (dict(churn=spec, with_slo=True), ValueError, "with_slo"),
        (dict(churn=spec, fault_plan={"seed": 1}), ValueError,
         "fault_plan"),
        (dict(fault_plan={"bogus_key": 1}), ValueError, "spec"),
        (dict(fault_plan="chaos-label"), ValueError, "did not parse"),
        (dict(n_shards=2, churn=tchurn.make_spec(
            "shard_skew", total_ids=32, n_shards=4)), ValueError,
         "shard_skew"),
        (dict(n_shards=0), ValueError, "n_shards"),
        (dict(controller={"no_such_knob": 1}), AssertionError,
         "unknown controller spec keys"),
    ]
    for over, err, match in cases:
        with pytest.raises(err, match=match):
            TS.run_job(TS.EpochJob(**kw_of("prefix-sort", **over)),
                       device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        TS.run_job(TS.EpochJob(**kw_of("prefix-sort", "stream",
                                       fault_plan={"seed": 1})),
                   device="cpu")


def test_more_shards_than_devices_run_on_one_device():
    """The deliberate difference from the JAX loop, which needs a device
    a shard: the port stacks the shards on one device, so 12 shards run
    on the CPU (the JAX package sees 8 devices there and refuses)."""
    S = len(jax.devices()) + 4
    got = port("prefix-sort", n_shards=S, epochs=2)
    assert got.mesh_counters.shape == (2, S, BASE["n"])
    assert got.decisions > 0
    with pytest.raises(ValueError, match="devices"):
        JS.run_job(JS.EpochJob(**kw_of("prefix-sort", n_shards=S,
                                       epochs=2)))


def test_grouped_chunks_equal_flat():
    """K=2 chunks on the sync grid run the grouped program (resolved per
    chunk) and equal K=1 bit for bit."""
    k2 = port("prefix-sort", n_shards=2, epochs=4, counter_sync_every=2)
    k1 = port("prefix-sort", n_shards=2, epochs=4, counter_sync_every=1)
    assert k2.digest == k1.digest and k2.state_digest == k1.state_digest
    assert np.array_equal(k2.mesh_counters, k1.mesh_counters)


def test_zero_host_fault_gate(tmp_path):
    ref = port("prefix-sort", n_shards=4, with_slo=True)
    sup = TS.run_supervised(TS.EpochJob(**kw_of(
        "prefix-sort", n_shards=4, with_slo=True)), tmp_path / "wd",
        TH.zero_host_plan(), device="cpu")
    TS.assert_crash_equivalent(sup, ref)
    assert_results_equal(sup, ref)
    assert sup.restarts == 0


@pytest.mark.parametrize("frac", [0.35, 0.75])
def test_sigkill_mid_mesh_resumes_bit_identical(tmp_path, frac):
    over = dict(n_shards=4, with_slo=True, with_hists=True,
                with_ledger=True)
    ref = port("prefix-sort", **over)
    plan = TH.HostFaultPlan(kill_at_decisions=(int(ref.decisions * frac),))
    sup = TS.run_supervised(TS.EpochJob(**kw_of("prefix-sort", **over)),
                            tmp_path / "wd", plan, device="cpu")
    assert sup.restarts >= 1
    TS.assert_crash_equivalent(sup, ref)


def test_chaos_counters_match_the_oracle():
    r = port("prefix-sort", n_shards=4, fault_plan=CHAOS_SPEC)
    plan = JF.plan_from_spec(JF.parse_fault_spec(dict(CHAOS_SPEC)),
                             BASE["epochs"], 4)
    ev = JF.plan_events(plan)
    md = tobs.metrics_dict(r.metrics)
    for key in ("server_dropouts", "tracker_resyncs", "faults_injected"):
        assert md[key] == ev[key], key
    clean = port("prefix-sort", n_shards=4)
    assert 0 < r.decisions < clean.decisions
    assert_results_equal(r, jaxrun("prefix-sort", n_shards=4,
                                   fault_plan=CHAOS_SPEC))


def test_chaos_fallback_replays_on_the_host_loop():
    """A tag32 trip during chaos chunks replays the same schedule on
    the host loop, counted as chaos fallbacks, equal to the JAX loop."""
    trip = dict(n_shards=2, tag_width=32, tag_spread_ns=1 << 33,
                fault_plan=CHAOS_SPEC)
    a = port("prefix-sort", **trip)
    assert a.mesh_chaos_fallbacks > 0
    assert a.mesh_chaos_fallbacks == a.mesh_fallbacks
    assert_results_equal(a, jaxrun("prefix-sort", **trip))


def _churn_job(name, **over):
    spec = tchurn.make_spec("churn_storm", total_ids=32, seed=3)
    return TS.EpochJob(**kw_of(name, n_shards=4, churn=spec, epochs=8,
                               **over))


@pytest.mark.parametrize("mode, frac", [("chaos", 0.35), ("churn", 0.6),
                                        ("churn_p2c_chaos", 0.5)])
def test_sigkill_matrix(tmp_path, mode, frac):
    if mode == "chaos":
        job = TS.EpochJob(**kw_of("prefix-sort", n_shards=4,
                                  fault_plan=CHAOS_SPEC))
    elif mode == "churn":
        job = _churn_job("prefix-sort")
    else:
        job = _churn_job("prefix-sort", placement="p2c",
                         fault_plan=CHAOS_SPEC)
    ref = TS.run_job(job, device="cpu")
    plan = TH.HostFaultPlan(
        kill_at_decisions=(max(int(ref.decisions * frac), 1),))
    sup = TS.run_supervised(job, tmp_path / "wd", plan, device="cpu")
    assert sup.restarts >= 1
    TS.assert_crash_equivalent(sup, ref)
    if mode != "chaos":
        spec = jchurn.make_spec("churn_storm", total_ids=32, seed=3)
        want = JS.run_job(JS.EpochJob(**dict(job.to_json(), churn=spec)))
        assert_results_equal(ref, want)


def test_kill_during_save_mid_chaos(tmp_path):
    job = TS.EpochJob(**kw_of("prefix-sort", n_shards=4,
                              fault_plan=CHAOS_SPEC))
    ref = port("prefix-sort", n_shards=4, fault_plan=CHAOS_SPEC)
    plan = TH.HostFaultPlan(kill_at_save=((1, "data_written"),))
    sup = TS.run_supervised(job, tmp_path / "wd", plan, device="cpu")
    assert sup.restarts >= 1
    TS.assert_crash_equivalent(sup, ref)


def test_spawn_sigkill_mid_mesh(tmp_path):
    """Spawn mode: a real SIGKILL of a child interpreter, and the mesh
    and placement fields through the result file."""
    spec = tchurn.make_spec("flash_crowd", total_ids=32, seed=3)
    job = TS.EpochJob(**kw_of("prefix-sort", n_shards=2, churn=spec,
                              placement="p2c", fault_plan=CHAOS_SPEC,
                              epochs=6))
    ref = TS.run_job(job, device="cpu")
    plan = TH.HostFaultPlan(kill_at_decisions=(int(ref.decisions * 0.5),))
    sup = TS.run_supervised(job, tmp_path / "wd", plan, mode="spawn",
                            device="cpu")
    assert sup.restarts >= 1
    TS.assert_crash_equivalent(sup, ref)
    assert np.array_equal(sup.mesh_views, ref.mesh_views)
    assert sup.mesh_chaos_fallbacks == ref.mesh_chaos_fallbacks
    assert sup.placement_counters == ref.placement_counters
