"""The port's closed-loop controller (``dmclock_tpu_torch/control/`` and
its wiring into ``robust/supervisor.py``) against the JAX package,
exactly: the counterparts of ``tests/test_controller.py`` (the signals'
digest tiers, the migrate rule's two skew reads, the policy table, the
decision journal, the spec and the admission clamp, off equal to bare,
forced actuation, the cross-loop trajectory, the kill matrix at every
controller stage, churn with provenance), each also held against the
JAX package's answer on the same inputs; and the controller-on jobs
themselves on the round, stream and mesh loops, equal to the JAX
supervisor field for field.  The JAX file's slow cases are slow here
too."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dmclock_tpu import control as jctl
from dmclock_tpu.control import journal as jjournal
from dmclock_tpu.control import policy as jpol
from dmclock_tpu.control import signals as jsigs
from dmclock_tpu.lifecycle import make_spec as jmake_spec
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch import control as tctl
from dmclock_tpu_torch.control import journal as tjournal
from dmclock_tpu_torch.control import policy as tpol
from dmclock_tpu_torch.control import signals as tsigs
from dmclock_tpu_torch.lifecycle import make_spec as tmake_spec
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

from test_torch_supervisor import assert_results_equal


def mk_sig(sigs=tsigs, epoch=2, **kw):
    """A synthetic all-quiet boundary snapshot of either package."""
    base = dict(epoch=epoch, backlog=0, live=0, capacity=0,
                resv_miss_d=0, limit_break_d=0, share_skew_d=0,
                violations_d=0, guard_trips_d=0, ingest_drops_d=0,
                ladder_steps_d=0, starvation_ns=0)
    base.update(kw)
    base.setdefault("press_backlog", base["backlog"])
    return sigs.ControlSignals(**base)


SPEC = dict(tpol.DEFAULT_SPEC, backlog_hi=100, occ_floor=4, ladder_max=3)
FORCED = {"backlog_hi": 1}
JOB = dict(engine="prefix", n=96, depth=6, ring=10, epochs=8, m=2, k=16,
           seed=5, arrival_lam=1.0, waves=2, ckpt_every=2)

_REFS: dict = {}


def port(loop="round", controller=True):
    key = ("port", loop, repr(controller))
    if key not in _REFS:
        _REFS[key] = TS.run_job(TS.EpochJob(
            **JOB, engine_loop=loop, controller=controller), device="cpu")
    return _REFS[key]


def jaxrun(loop="round", controller=True):
    key = ("jax", loop, repr(controller))
    if key not in _REFS:
        _REFS[key] = JS.run_job(JS.EpochJob(
            **JOB, engine_loop=loop, controller=controller))
    return _REFS[key]


def both_step(ps, knobs, sig_kw, spec):
    """One policy step in both packages; asserts they agree."""
    got = tpol.step(ps, knobs, mk_sig(tsigs, **sig_kw), spec)
    want = jpol.step(ps, knobs, mk_sig(jsigs, **sig_kw), spec)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    return got


# ----------------------------------------------------------------------
# signals
# ----------------------------------------------------------------------

def test_digest_reads_deterministic_tier_only():
    a = mk_sig(backlog=7, resv_miss_d=1)
    b = a._replace(retraces=9, compile_ms=3.5, bound_class="hbm",
                   dispatch_share=0.4, fallbacks=2)
    assert tsigs.digest(a) == tsigs.digest(b)
    assert tsigs.digest(a) == jsigs.digest(mk_sig(jsigs, backlog=7,
                                                  resv_miss_d=1))
    assert tsigs.DETERMINISTIC_FIELDS == jsigs.DETERMINISTIC_FIELDS
    assert tsigs.ControlSignals._fields == jsigs.ControlSignals._fields


def test_digest_changes_on_deterministic_field():
    a = mk_sig(backlog=7)
    assert tsigs.digest(a) != tsigs.digest(a._replace(backlog=8))
    assert tsigs.digest(a) != tsigs.digest(a._replace(epoch=3))
    for kw in (dict(backlog=8), dict(epoch=3), dict(press_peak=4)):
        assert tsigs.digest(mk_sig(**kw)) == jsigs.digest(
            mk_sig(jsigs, **kw))


# ----------------------------------------------------------------------
# the migrate rule's two skew reads
# ----------------------------------------------------------------------

MSPEC = dict(tpol.DEFAULT_SPEC, hysteresis=1, migrate_skew_hi=1.5,
             migrate_shards=4)


def _fires(**sig_kw):
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    _, dec = both_step(ps, [1, 0, 100, 0, 0], sig_kw, MSPEC)
    return [r for r, _k in dec]


def test_peaks_arm_with_zero_boundary_depth():
    assert "migrate" in _fires(backlog=0, press_peak=12, backlog_peak=12)


def test_depth_read_still_arms_without_peaks():
    assert "migrate" in _fires(backlog=8, press_backlog=8)


def test_balanced_peaks_stay_quiet():
    assert "migrate" not in _fires(backlog=0, press_peak=3,
                                   backlog_peak=12)


def test_defaults_keep_peak_branch_inert():
    sig = mk_sig(backlog=0)
    assert sig.press_peak == 0 and sig.backlog_peak == 0
    assert "migrate" not in _fires(backlog=0)


def test_peaks_ride_the_deterministic_digest():
    a = mk_sig(press_peak=5, backlog_peak=9)
    assert tsigs.digest(a) != tsigs.digest(a._replace(press_peak=6))
    assert "press_peak" in tsigs.DETERMINISTIC_FIELDS
    assert "backlog_peak" in tsigs.DETERMINISTIC_FIELDS


def test_collect_reduces_per_shard_peaks():
    from dmclock_tpu_torch.obs import provenance as tprov

    press = np.zeros((4, tprov.PRESS_FIELDS), dtype=np.int64)
    press[:, tprov.PRESS_BACKLOG] = (9, 1, 2, 0)
    got = tctl.Controller(dict(MSPEC), n=8, ring=4, n_shards=4) \
        .collect(2, press=press)
    want = jctl.Controller(dict(MSPEC), n=8, ring=4, n_shards=4) \
        .collect(2, press=press)
    assert got.press_peak == 9 and got.backlog_peak == 12
    assert tuple(got) == tuple(want)


def test_collect_reads_depth_and_starvation_in_one_copy():
    """The boundary read on a stacked state and a provenance block:
    backlog, the hottest shard and the starvation watermark equal the
    JAX collect's on the same arrays."""
    import jax.numpy as jnp

    from dmclock_tpu.obs import provenance as jprov
    from dmclock_tpu_torch.obs import provenance as tprov

    depth = np.asarray([[3, 0, 4], [1, 1, 0]], dtype=np.int32)
    scal = np.zeros((2, tprov.PS_FIELDS), dtype=np.int64)
    scal[:, tprov.PS_STARVE_MAX] = (17, 40)
    tstate = type("S", (), {"depth": torch.from_numpy(depth)})()
    jstate = type("S", (), {"depth": jnp.asarray(depth)})()
    tp = tprov.ProvBlock(None, torch.from_numpy(scal), None)
    jp = jprov.ProvBlock(None, jnp.asarray(scal), None)
    got = tctl.Controller(dict(MSPEC), n=3, ring=4, n_shards=2) \
        .collect(4, state=tstate, prov=tp)
    want = jctl.Controller(dict(MSPEC), n=3, ring=4, n_shards=2) \
        .collect(4, state=jstate, prov=jp)
    assert (got.backlog, got.press_backlog, got.starvation_ns) == \
        (9, 7, 40)
    assert tuple(got) == tuple(want)


# ----------------------------------------------------------------------
# the policy table
# ----------------------------------------------------------------------

def test_down_rule_fires_first_triggering_boundary():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    _, dec = both_step(ps, [4, 0, 100, 0, 0], dict(resv_miss_d=1), SPEC)
    assert dec == [("staleness_down", [1, 0, 100, 0, 0])]


def test_up_rule_needs_clean_streak():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    ps, dec = both_step(ps, [1, 0, 100, 0, 0], {}, SPEC)
    assert dec == []
    ps, dec = both_step(ps, [1, 0, 100, 0, 0], dict(epoch=4), SPEC)
    assert dec == [("staleness_up", [2, 0, 100, 0, 0])]


def test_dirty_boundary_resets_the_streak():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    ps, _ = both_step(ps, [1, 0, 100, 0, 0], {}, SPEC)
    ps, dec = both_step(ps, [1, 0, 100, 0, 0],
                        dict(epoch=4, guard_trips_d=1), SPEC)
    assert ("staleness_up", [2, 0, 100, 0, 0]) not in dec
    ps, dec = both_step(ps, [1, 0, 100, 0, 0], dict(epoch=6), SPEC)
    assert dec == []


def test_cooldown_inert_then_refires():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    knobs = [1, 0, 100, 0, 0]
    fired = []
    for e in (2, 4, 6, 8):
        ps, dec = both_step(ps, knobs, dict(epoch=e, guard_trips_d=1),
                            SPEC)
        for _rule, new in dec:
            knobs = new
        fired.append([r for r, _ in dec])
    assert fired == [["ladder_down"], [], [], ["ladder_down"]]
    assert knobs[tpol.KNOB_LADDER] == 2


def test_fixed_order_knob_chaining():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    _, dec = both_step(ps, [4, 0, 100, 0, 0],
                       dict(resv_miss_d=1, guard_trips_d=1,
                            limit_break_d=1), SPEC)
    assert [r for r, _ in dec] == \
        ["staleness_down", "ladder_down", "clamp_down"]
    assert [new for _, new in dec] == \
        [[1, 0, 100, 0, 0], [1, 1, 100, 0, 0], [1, 1, 75, 0, 0]]


def test_clamp_floor_and_ladder_ceiling():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    _, dec = both_step(ps, [1, 3, 25, 0, 0],
                       dict(limit_break_d=1, guard_trips_d=1), SPEC)
    assert dec == []


def test_compact_on_sparse_occupancy():
    ps = np.zeros(2 * tpol.NUM_RULES, dtype=np.int64)
    sig = dict(live=3, capacity=16)
    ps, dec = both_step(ps, [8, 0, 100, 0, 0], sig, SPEC)
    assert dec == []
    _, dec = both_step(ps, [8, 0, 100, 0, 0], dict(sig, epoch=4), SPEC)
    assert dec == [("compact", [8, 0, 100, 1, 0])]


def test_overlay_chains_ladder_rungs():
    from dmclock_tpu_torch.robust.guarded import LADDER_RUNGS

    knob, fast, safe = LADDER_RUNGS[0]
    assert tpol.overlay({knob: fast}, 0) == {knob: fast}
    assert tpol.overlay({knob: fast}, 1)[knob] == safe
    assert tpol.overlay({knob: fast}, 2)[knob] == "minstop"
    assert tpol.overlay({"select_impl": "sort"}, 4) \
        == {"select_impl": "sort"}
    for level in range(len(LADDER_RUNGS) + 1):
        cfg = {"select_impl": "radix", "tag_width": 32,
               "calendar_impl": "wheel"}
        assert tpol.overlay(cfg, level) == jpol.overlay(cfg, level)
    assert tpol.ladder_max_default() == jpol.ladder_max_default()


# ----------------------------------------------------------------------
# the decision journal
# ----------------------------------------------------------------------

def _ent(seq, epoch=2):
    return {"seq": seq, "epoch": epoch, "rule": "clamp_down",
            "digest": "x", "old": [1, 0, 100, 0, 0],
            "new": [1, 0, 75, 0, 0]}


def test_journal_append_asserts_sequential_seq(tmp_path):
    j = tjournal.DecisionJournal(tmp_path)
    j.append(_ent(0))
    with pytest.raises(AssertionError):
        j.append({"seq": 2, "epoch": 4, "rule": "clamp_down",
                  "digest": "x", "old": [], "new": []})


def test_journal_reload_and_entry_at_across_packages(tmp_path):
    j = tjournal.DecisionJournal(tmp_path)
    for s in range(3):
        j.append(_ent(s, 2 * (s + 1)))
    for cls in (tjournal.DecisionJournal, jjournal.DecisionJournal):
        k = cls(tmp_path)
        assert len(k) == 3
        assert k.entry_at(1)["epoch"] == 4
        assert k.entry_at(3) is None
    assert tjournal.FILENAME == jjournal.FILENAME


def test_journal_torn_tail_truncated_on_open(tmp_path):
    j = tjournal.DecisionJournal(tmp_path)
    j.append(_ent(0))
    with open(j.path, "a") as fh:
        fh.write('{"seq": 1, "epo')
    k = tjournal.DecisionJournal(tmp_path)
    assert len(k) == 1
    with open(k.path) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["seq"] == 0


# ----------------------------------------------------------------------
# the spec and the admission clamp
# ----------------------------------------------------------------------

def test_as_spec_normalization():
    assert tctl.as_spec(None) is None
    assert tctl.as_spec(False) is None
    assert tctl.as_spec({"enabled": False}) is None
    full = tctl.as_spec(True)
    assert full["hysteresis"] == 2 and full["ladder_max"] > 0
    assert full == jctl.as_spec(True)
    assert tctl.as_spec(tctl.ControllerConfig(clamp_min=10))[
        "clamp_min"] == 10
    assert dataclasses.asdict(tctl.ControllerConfig()) == \
        dataclasses.asdict(jctl.ControllerConfig())
    with pytest.raises(AssertionError, match="unknown"):
        tctl.as_spec({"no_such_knob": 1})


def test_clamp_counts_rng_neutral_cap():
    ctl = tctl.Controller(tctl.as_spec(True), n=4, ring=4)
    counts = np.array([5, 0, 9, 1], dtype=np.int64)
    assert ctl.clamp_counts(counts, 4) is counts
    for pct, want in ((50, [2, 0, 2, 1]), (25, [1, 0, 1, 1])):
        ctl.knobs[tpol.KNOB_CLAMP] = pct
        got = ctl.clamp_counts(counts, 4)
        assert got.tolist() == want
        # a tensor (a chunk's counts on the card) takes the same cap on
        # its own device and dtype
        t = ctl.clamp_counts(torch.from_numpy(counts.astype(np.int32)), 4)
        assert t.dtype == torch.int32 and t.tolist() == want
        j = jctl.Controller(jctl.as_spec(True), n=4, ring=4)
        j.knobs[jpol.KNOB_CLAMP] = pct
        assert np.asarray(j.clamp_counts(counts, 4)).tolist() == want


def test_encode_load_and_publish():
    """The ``ctl_*`` leaves have the JAX shapes, round-trip, and the
    registry families are the JAX package's."""
    from dmclock_tpu_torch.obs.registry import MetricsRegistry

    ctl = tctl.Controller(tctl.as_spec(True), n=4, ring=4)
    ctl.knobs = [2, 1, 75, 0, 0]
    ctl.applied = 3
    enc = ctl.encode()
    empty = tctl.Controller.empty_leaves()
    jempty = jctl.Controller.empty_leaves()
    for k in enc:
        assert enc[k].shape == empty[k].shape == jempty[k].shape
    other = tctl.Controller(tctl.as_spec(True), n=4, ring=4)
    other.load(enc)
    assert other.knobs == [2, 1, 75, 0, 0] and other.applied == 3
    reg = MetricsRegistry()
    tctl.publish_controller(reg, ctl)
    snap = reg.snapshot()
    knobs = {m["labels"]["knob"]: m["value"]
             for m in snap["dmclock_controller_knob"]}
    assert knobs["clamp_pct"] == 75.0
    assert "dmclock_controller_decisions_total" in snap
    assert "dmclock_controller_journal_replays_total" in snap


# ----------------------------------------------------------------------
# the controller in the supervisor
# ----------------------------------------------------------------------

@pytest.mark.parametrize("loop", ["round", "stream"])
def test_off_equals_bare(loop):
    bare = port(loop, controller=None)
    off = port(loop, controller=False)
    assert_results_equal(off, bare)
    assert off.controller_decisions == 0
    assert off.controller_knobs is None
    assert off.controller_trajectory is None


@pytest.mark.parametrize("loop", ["round", "stream", "mesh"])
@pytest.mark.parametrize("controller", [True, FORCED],
                         ids=["default", "forced"])
def test_controller_job_equals_jax(loop, controller):
    """The controller-on job, every field of the result (trajectory,
    knobs, decisions, digest, state, metrics) equal to the JAX
    supervisor's."""
    got, want = port(loop, controller), jaxrun(loop, controller)
    assert got.controller_decisions > 0
    assert_results_equal(got, want)


def test_clamp_down_fires_and_shapes_the_run():
    on = port("round", FORCED)
    off = port("round", None)
    assert on.controller_decisions > 0
    rules = [row[2] for row in on.controller_trajectory]
    assert "clamp_down" in rules
    assert on.controller_knobs[tpol.KNOB_CLAMP] < 100
    assert on.state_digest != off.state_digest
    assert on.controller_trajectory[0][1] == JOB["ckpt_every"]


def test_quiet_controller_decides_but_never_clamps_rng():
    on = port("round", True)
    off = port("round", None)
    assert on.digest == off.digest
    assert on.controller_knobs is not None


@pytest.mark.parametrize("loop", [
    "stream", pytest.param("mesh", marks=pytest.mark.slow)])
def test_trajectory_identical_across_loops(loop):
    r, o = port("round", FORCED), port(loop, FORCED)
    assert o.digest == r.digest
    assert o.state_digest == r.state_digest
    assert o.controller_trajectory == r.controller_trajectory
    assert o.controller_knobs == r.controller_knobs


@pytest.mark.parametrize("loop", [
    "round", "stream", pytest.param("mesh", marks=pytest.mark.slow)])
@pytest.mark.parametrize("stage", TH.CONTROLLER_STAGES)
def test_kill_at_stage_resumes_exact(tmp_path, loop, stage):
    job = TS.EpochJob(**JOB, engine_loop=loop, controller=FORCED)
    ref = port(loop, FORCED)
    assert ref.controller_decisions > 0
    epoch = 2 * JOB["ckpt_every"]
    assert any(row[1] == epoch for row in ref.controller_trajectory)
    plan = TH.HostFaultPlan(kill_at_controller=((epoch, stage),))
    res = TS.run_supervised(job, tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1
    if stage == "before_journal":
        assert res.controller_replays == 0
    else:
        assert res.controller_replays >= 1


def test_exactly_once_with_two_kills(tmp_path):
    job = TS.EpochJob(**JOB, controller=FORCED)
    ref = port("round", FORCED)
    plan = TH.HostFaultPlan(kill_at_controller=(
        (JOB["ckpt_every"], "after_journal"),
        (2 * JOB["ckpt_every"], "after_apply")))
    res = TS.run_supervised(job, tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 2
    seqs = [row[0] for row in res.controller_trajectory]
    assert seqs == sorted(set(seqs))


def test_journal_resumes_across_packages(tmp_path):
    """A JAX run killed after its journal write resumes in the port: the
    snapshot's ``ctl_*`` leaves and the journal are the JAX package's,
    and the port replays the journaled decision."""
    from dmclock_tpu.robust import host_faults as JH

    jjob = JS.EpochJob(**JOB, controller=FORCED)
    plan = JH.HostFaultPlan(
        kill_at_controller=((2 * JOB["ckpt_every"], "after_journal"),))
    with pytest.raises(JH.HostKill):
        JS._job_loop(jjob, str(tmp_path),
                     JH.HostFaultInjector(plan, str(tmp_path),
                                          kill_mode="raise"))
    res = TS.run_supervised(TS.EpochJob(**JOB, controller=FORCED),
                            tmp_path, TH.zero_host_plan(), device="cpu")
    TS.assert_crash_equivalent(res, port("round", FORCED))
    assert res.controller_replays >= 1


@pytest.mark.slow
@pytest.mark.parametrize("stage", TH.CONTROLLER_STAGES)
def test_spawned_kill_mid_actuation(tmp_path, stage):
    job = TS.EpochJob(**JOB, controller=FORCED)
    ref = port("round", FORCED)
    plan = TH.HostFaultPlan(
        kill_at_controller=((2 * JOB["ckpt_every"], stage),))
    res = TS.run_supervised(job, tmp_path, plan, mode="spawn",
                            device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1
    if stage == "before_journal":
        assert res.controller_replays == 0
    else:
        assert res.controller_replays >= 1


def _churn_prov_job(make_spec, cls, loop="round", **over):
    spec = make_spec("churn_storm", total_ids=16, base_lam=1.5,
                     compact_every=1, gens=4, stride=4, life=2,
                     capacity0=4)
    return cls(engine="prefix", churn=spec, epochs=12, m=2, k=8, ring=16,
               waves=4, ckpt_every=2, seed=11, engine_loop=loop,
               with_prov=True, **over)


def test_churn_round_equals_stream_with_prov_arrays():
    r = TS.run_job(_churn_prov_job(tmake_spec, TS.EpochJob), device="cpu")
    s = TS.run_job(_churn_prov_job(tmake_spec, TS.EpochJob, "stream"),
                   device="cpu")
    assert r.digest == s.digest
    assert r.prov_scal is not None
    for f in ("prov_margin_hist", "prov_scal", "prov_last_served"):
        assert np.array_equal(getattr(r, f), getattr(s, f)), f


def test_churn_crash_equivalent_through_compaction(tmp_path):
    job = _churn_prov_job(tmake_spec, TS.EpochJob)
    ref = TS.run_job(job, device="cpu")
    plan = TH.HostFaultPlan(
        kill_at_decisions=(max(ref.decisions // 2, 1),))
    res = TS.run_supervised(job, tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1


@pytest.mark.parametrize("loop", ["round", "stream"])
def test_churn_controller_compacts_equal_to_jax(loop):
    """A churn job whose controller fires ``compact`` (occupancy under
    ``occ_lo``) with provenance riding the compaction: equal to the JAX
    supervisor field for field."""
    ctl = {"occ_lo": 0.9, "hysteresis": 1, "cooldown": 0}
    got = TS.run_job(_churn_prov_job(tmake_spec, TS.EpochJob, loop,
                                     controller=ctl), device="cpu")
    want = JS.run_job(_churn_prov_job(jmake_spec, JS.EpochJob, loop,
                                      controller=ctl))
    assert "compact" in [row[2] for row in got.controller_trajectory]
    assert_results_equal(got, want)


# keys that hold wall clocks, in bench's run and the port's alike
_WALL = ("dps", "dps_on", "dps_off", "wall_s_on", "wall_s_off",
         "recovered_dps")


@pytest.mark.parametrize("sides", ["both", "on"])
def test_controller_row_equals_bench(sides):
    """``serve.controller_row`` at bench's CPU shape (96 ids, 32 epochs)
    against ``bench.bench_controller``: the same rows and keys, every
    value but the wall clocks equal (decisions, SLO burn, knobs and the
    controller's trajectory among them)."""
    import bench
    from dmclock_tpu_torch import serve as tserve

    shape = dict(total_ids=96, epochs=32, sides=sides)
    got = tserve.controller_row(device="cpu", **shape)
    want = bench.bench_controller(**shape)
    assert set(got) == set(want)
    for name, row in want.items():
        assert set(got[name]) == set(row), name
        for key, value in row.items():
            if key not in _WALL:
                assert got[name][key] == value, (name, key)
    assert any(r["controller_decisions"] for r in got.values())
