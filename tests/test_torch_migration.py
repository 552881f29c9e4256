"""Live migration on the port's mesh (``_mesh_migrate`` in
``robust/supervisor.py``, ``PlacementMap.plan_moves`` and the plane's
``migrate_out``/``migrate_in``) against the JAX package, exactly: the
counterparts of ``tests/test_placement.py``'s migration cases (the rule
fires and logs, the cold-pick twin gate, crash equivalence at every
stage of the move, p2c chaos with the source down, the wheel reslot of
a moved client equal to a rebuild, the calendar pressure peaks arming
the rule) and of its explain cases, each run also held against the JAX
supervisor field for field: the migration log, the per-shard decisions,
the digest and every plane."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmclock_tpu.lifecycle import churn as jchurn
from dmclock_tpu.lifecycle import placement as JP
from dmclock_tpu.lifecycle.plane import LifecyclePlane as JPlane
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.lifecycle import churn as tchurn
from dmclock_tpu_torch.lifecycle import placement as TP
from dmclock_tpu_torch.lifecycle.plane import LifecyclePlane as TPlane
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

from test_torch_supervisor import assert_results_equal

REPO = Path(__file__).resolve().parent.parent

# the migrate rule alone: sync pinned, clamp and compact parked, a long
# cooldown between fires, cold (quiet-since-start) movers
GATE_CTL = dict(sync_max=1, backlog_hi=10**9, occ_lo=0.0, hysteresis=1,
                cooldown=8, migrate_skew_hi=1.5, migrate_pick="cold",
                migrate_max=4)
BASE = dict(engine="prefix", k=16, select_impl="sort", n=96, depth=6,
            ring=10, epochs=8, m=2, seed=5, arrival_lam=1.0, waves=2,
            ckpt_every=2, engine_loop="mesh", n_shards=4, placement="p2c",
            controller=GATE_CTL)
WHEEL = dict(engine="calendar", k=4, calendar_impl="wheel",
             ladder_levels=2)


def _kw(churn_mod, **over):
    spec = churn_mod.make_spec("shard_skew", total_ids=64, seed=3,
                               cold_frac=0.5, cold_until=10**9)
    return dict(BASE, churn=spec, **over)


def tjob(**over):
    return TS.EpochJob(**_kw(tchurn, **over))


def jjob(**over):
    return JS.EpochJob(**_kw(jchurn, **over))


_REFS: dict = {}


def ref(pkg="port", **over):
    key = (pkg, repr(sorted(over.items())))
    if key not in _REFS:
        _REFS[key] = TS.run_job(tjob(**over), device="cpu") \
            if pkg == "port" else JS.run_job(jjob(**over))
    return _REFS[key]


@pytest.mark.parametrize("engine", ["prefix", "wheel"])
def test_migration_equals_jax(engine):
    """The migrating run, every result field equal to the JAX
    supervisor's: migration log, placement counters, per-shard
    counters (the decisions each shard served), digest, state."""
    over = WHEEL if engine == "wheel" else {}
    got, want = ref(**over), ref("jax", **over)
    assert got.migrations > 0
    assert_results_equal(got, want)
    per_shard = np.asarray(got.mesh_counters[0]).sum(axis=1)
    assert np.array_equal(per_shard,
                          np.asarray(want.mesh_counters[0]).sum(axis=1))


def test_migration_fires_and_logs():
    res = ref()
    assert res.placement == "p2c"
    assert res.migrations == len(res.migration_log)
    assert res.placement_counters["migrations"] == res.migrations
    for _bnd, cid, src, dst in res.migration_log:
        assert src == 0
        assert dst in (1, 2, 3)
        assert cid % 4 == 0


def _twin(job, log):
    ov = {str(cid): dst for _b, cid, _s, dst in log}
    off = dict(GATE_CTL, migrate_skew_hi=0.0)
    return dataclasses.replace(
        job, placement={"mode": "p2c", "overrides": ov}, controller=off), ov


def test_migration_twin_gate():
    """The moved run's chain digest equals the run that placed the movers
    on their destinations from epoch 0 (overrides from the move log, the
    rule disarmed); the twin equals the JAX twin too."""
    a = ref()
    twin, ov = _twin(tjob(), a.migration_log)
    b = TS.run_job(twin, device="cpu")
    assert b.migrations == 0
    assert a.digest == b.digest
    assert b.placement_counters["overrides"] == len(ov)
    jtwin, _ = _twin(jjob(), a.migration_log)
    assert_results_equal(b, JS.run_job(jtwin))


@pytest.mark.parametrize("stage", ["evicted", "handoff", "registered"])
def test_migration_crash_equivalence(stage, tmp_path):
    """A kill at any stage of the two-sided move (the in-place row writes
    half done) replays the same run from the previous checkpoint."""
    want = ref()
    fired = []

    def hook(s):
        if s == stage and not fired:
            fired.append(1)
            raise TH.HostKill(f"mid-migration:{stage}")

    old = TP._migrate_hook
    TP._migrate_hook = hook
    try:
        res = TS.run_supervised(tjob(), tmp_path, TH.zero_host_plan(),
                                device="cpu")
    finally:
        TP._migrate_hook = old
    assert fired, f"migrate hook never reached at {stage}"
    TS.assert_crash_equivalent(res, want)
    assert res.restarts == 1
    assert res.migration_log == want.migration_log


@pytest.mark.parametrize("stage", ["evicted", "registered"])
def test_wheel_migration_crash_equivalence(stage, tmp_path):
    """The same on the wheel calendar mesh, where the pressure peaks pick
    the source."""
    want = ref(**WHEEL)
    fired = []

    def hook(s):
        if s == stage and not fired:
            fired.append(1)
            raise TH.HostKill(f"mid-migration:{stage}")

    old = TP._migrate_hook
    TP._migrate_hook = hook
    try:
        res = TS.run_supervised(tjob(**WHEEL), tmp_path,
                                TH.zero_host_plan(), device="cpu")
    finally:
        TP._migrate_hook = old
    assert fired
    TS.assert_crash_equivalent(res, want)


def test_p2c_chaos_composes_and_source_down_is_masked():
    """Migration under a fault plan whose hot shard is down at the first
    migrate boundary: accepted, deterministic, never through a down
    shard, and equal to the JAX run."""
    from dmclock_tpu_torch.robust import faults as F

    fault = None
    for seed in range(64):
        spec = {"seed": seed, "p_dropout": 0.5, "mean_outage_steps": 2.0}
        plan = F.plan_from_spec(F.parse_fault_spec(spec), 8, 4)
        if not plan.up[4, 0]:
            fault = spec
            break
    assert fault is not None
    a = TS.run_job(tjob(fault_plan=fault), device="cpu")
    b = TS.run_job(tjob(fault_plan=fault), device="cpu")
    assert a.digest == b.digest
    assert a.migration_log == b.migration_log
    plan = F.plan_from_spec(F.parse_fault_spec(fault), 8, 4)
    for bnd, _cid, src, dst in a.migration_log:
        row = plan.up[min(bnd, plan.up.shape[0] - 1)]
        assert row[src] and row[dst], "moved through a DOWN shard"
    assert_results_equal(a, JS.run_job(jjob(fault_plan=fault)))


def test_calendar_pressure_peaks_arm_migrate_rule():
    """On the wheel calendar the boundary depth is drained; the chunk's
    mid-epoch peaks arm the rule, every move leaves the hot shard, and
    the twin gate holds."""
    a = ref(**WHEEL)
    assert a.migrations > 0
    assert a.migrations == len(a.migration_log)
    for _bnd, _cid, src, dst in a.migration_log:
        assert src == 0
        assert dst in (1, 2, 3)
    twin, _ = _twin(tjob(**WHEEL), a.migration_log)
    b = TS.run_job(twin, device="cpu")
    assert b.migrations == 0
    assert a.digest == b.digest


def test_hot_pick_moves_served_clients_equal_to_jax():
    """Bench's pick (the largest served demand first) at bench's
    controller spec: equal to the JAX run."""
    ctl = dict(GATE_CTL, migrate_pick="hot", cooldown=2)
    got = TS.run_job(tjob(controller=ctl), device="cpu")
    want = JS.run_job(jjob(controller=ctl))
    assert got.migrations > 0
    assert_results_equal(got, want)


# ----------------------------------------------------------------------
# the pieces: plan_moves, the plane halves, the wheel
# ----------------------------------------------------------------------

def test_plan_moves_and_move_log_equal_jax():
    t = TP.PlacementMap(4, 32, mode="p2c", seed=9)
    j = JP.PlacementMap(4, 32, mode="p2c", seed=9)
    backlog = np.asarray([9, 1, 4, 0], dtype=np.int64)
    for m in (t, j):
        m.place_batch(list(range(32)), backlog=backlog)
    up = np.asarray([True, True, False, True])
    for b in (4, 8):
        got = t.plan_moves(b, src=0, candidates=[0, 4, 8, 12, 16],
                           backlog=backlog, up=up, max_moves=3)
        want = j.plan_moves(b, src=0, candidates=[0, 4, 8, 12, 16],
                            backlog=backlog, up=up, max_moves=3)
        assert got == want
    assert t.move_log() == j.move_log()
    for k in ("pm_assign", "pm_rng", "pm_counters", "pm_moves"):
        assert np.array_equal(t.encode()[k], j.encode()[k]), k
    # the moves leaf round-trips, in either package
    other = TP.PlacementMap(4, 32, mode="p2c", seed=0)
    other.load(j.encode())
    assert other.move_log() == j.move_log()
    back = JP.PlacementMap(4, 32, mode="p2c", seed=0)
    back.load(t.encode())
    assert back.move_log() == t.move_log()


def test_plane_halves_equal_jax_with_slo():
    """``migrate_out`` on a source plane and ``migrate_in`` on a
    destination: the returned slot and QoS triple, the op rows, the
    departed report, the counters and the SLO plane's contract epochs
    (the REGISTER bumps the mover's) equal the JAX planes'."""
    import jax.numpy as jnp

    from dmclock_tpu.obs import slo as jslo
    from dmclock_tpu_torch.obs import slo as tslo

    spec_t = tchurn.make_spec("flash_crowd", total_ids=16, capacity0=8)
    spec_j = jchurn.make_spec("flash_crowd", total_ids=16, capacity0=8)
    tp = [TPlane(spec_t, shard=(s, 2)) for s in range(2)]
    jp = [JPlane(spec_j, shard=(s, 2)) for s in range(2)]
    ts = [tslo.SloPlane(8, dt_epoch_ns=10**8) for _ in range(2)]
    js = [jslo.SloPlane(8, dt_epoch_ns=10**8) for _ in range(2)]
    for planes, slos in ((tp, ts), (jp, js)):
        for p, sp in zip(planes, slos):
            p.attach_slo(sp)
        for cid in (2, 4, 6):
            planes[0]._register_row({"op": "register", "cid": cid,
                                     "r": 10.0, "w": 2.0, "l": 0.0})
    led = np.arange(8 * 5, dtype=np.int64).reshape(8, 5)
    got = tp[0].migrate_out(4, torch.from_numpy(led))
    want = jp[0].migrate_out(4, jnp.asarray(led))
    assert got == want
    assert tp[0].migrate_out(99, None) is None
    assert tp[1].migrate_in(4, got[1]) == jp[1].migrate_in(4, want[1])
    for a, b in zip(tp, jp):
        assert a.counters == b.counters
        assert [(c, r.tolist()) for c, r in a.departed] == \
            [(c, np.asarray(r).tolist()) for c, r in b.departed]
    for a, b in zip(ts, js):
        for k, v in a.encode().items():
            assert np.array_equal(v, b.encode()[k]), k


def test_migration_reslot_adjust_equals_rebuild():
    """The two wheel halves of a move at a fixed now: the source wheel
    adjusted over the departing slot equals the rebuild of the evicted
    state, the destination's adjusted over the recycled slot (now with
    the mover's QoS) the rebuild of the registered state; both equal
    the JAX adjust."""
    import jax.numpy as jnp

    from dmclock_tpu.engine import fastpath as jfp
    from dmclock_tpu_torch.engine import bridge
    from dmclock_tpu_torch.engine import fastpath as tfp

    from test_calendar_bucketed import zipf64_state
    from test_torch_support import S, to_jax, to_torch

    jstate = zipf64_state(n=10, depth=32)
    state = to_torch(jstate)
    now = 500 * S
    c = 4
    onehot = torch.arange(state.capacity) == c
    evicted = state._replace(active=state.active.clone().index_fill_(
        0, torch.tensor([c]), False),
        depth=state.depth.clone().index_fill_(0, torch.tensor([c]), 0))
    w_src = tfp.wheel_build(state, now, False)
    adj_out = tfp.wheel_adjust(w_src, evicted, now, False, onehot)
    rebuilt = tfp.wheel_build(evicted, now, False)
    for f in ("origin", "cnt", "bmin", "slot", "key"):
        assert torch.equal(getattr(adj_out, f), getattr(rebuilt, f)), f
    assert int(adj_out.slot[c]) == 3 * tfp._WHEEL_BUCKETS
    wi = evicted.weight_inv.clone()
    wi[c] = wi[c] * 2
    registered = evicted._replace(
        active=evicted.active.clone().index_fill_(0, torch.tensor([c]),
                                                  True),
        weight_inv=wi)
    adj_in = tfp.wheel_adjust(adj_out, registered, now, False, onehot)
    rebuilt = tfp.wheel_build(registered, now, False)
    want = jfp.wheel_adjust(
        jfp.wheel_adjust(jfp.wheel_build(jstate, jnp.int64(now), False),
                         to_jax(bridge.state_to_numpy(evicted)),
                         jnp.int64(now), False, jnp.asarray(onehot.numpy())),
        to_jax(bridge.state_to_numpy(registered)), jnp.int64(now), False,
        jnp.asarray(onehot.numpy()))
    for f in ("origin", "cnt", "bmin", "slot", "key"):
        assert torch.equal(getattr(adj_in, f), getattr(rebuilt, f)), f
        assert np.array_equal(getattr(adj_in, f).numpy(),
                              np.asarray(getattr(want, f))), f


# ----------------------------------------------------------------------
# a migrated client's SLO log through scripts/explain.py
# ----------------------------------------------------------------------

def _explain():
    spec = importlib.util.spec_from_file_location(
        "explain", REPO / "scripts" / "explain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows():
    """A migrated client's window log: two contract epochs (the
    destination REGISTER bumps it), limit-capped in both."""
    rows = []
    for seq, cep in ((0, 1), (1, 1), (2, 2), (3, 2)):
        rows.append({"client": 7, "seq": seq, "contract_epoch": cep,
                     "ops": 40, "rate": 40.0, "limit": 40.0,
                     "reservation": 5.0, "share": 0.5,
                     "entitled_share": 0.5, "share_err": 0.0,
                     "backlog": 12, "resv_ops": 4, "tardy_ops": 0,
                     "resv_deficit": 0.0, "resv_miss": False})
    rows.append({"client": 9, "seq": 0, "contract_epoch": 1, "ops": 0,
                 "rate": 0.0, "backlog": 0})
    return rows


def test_attribution_survives_contract_epoch_bump():
    mod = _explain()
    wins = mod.client_windows(_rows(), 7)
    assert len(wins) == 4
    assert {w["contract_epoch"] for w in wins} == {1, 2}
    att = mod.attribute(wins)
    assert att["cause"] == "limit_capped"
    assert att["scores"]["no_demand"] == 0.0
    pre = mod.attribute([w for w in wins if w["contract_epoch"] == 1])
    post = mod.attribute([w for w in wins if w["contract_epoch"] == 2])
    assert pre["scores"] == post["scores"]


def test_migrated_client_slo_log_explains(tmp_path):
    """A client moved between two of the port's SLO planes: its windows
    before and after the move, exported by the port as JSONL, read back
    by ``scripts/explain.py`` as one client across two contract epochs
    (and an absent client exits 2)."""
    from dmclock_tpu_torch.obs import slo as tslo

    log = tmp_path / "slo.jsonl"
    plane = tslo.SloPlane(4, dt_epoch_ns=10**8, ring_depth=8)
    plane.register(2, 5.0, 1.0, 40.0)
    block = plane.stamp(tslo.window_zero(4, "cpu"))
    for w0, w1, cep_bump in ((0, 4, False), (4, 8, True), (8, 12, False)):
        if cep_bump:
            plane.evict(2)               # migrate_out
            plane.register(2, 5.0, 1.0, 40.0)   # migrate_in
            block = plane.stamp(block)
        block[2, tslo.W_OPS] += 16
        block, closed = plane.roll(block, w0, w1,
                                   depth=torch.zeros(4, dtype=torch.int32))
        plane.export_jsonl(str(log), closed)
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    mine = [r for r in rows if r["client"] == 2]
    assert {r["contract_epoch"] for r in mine} == {1, 2}
    wins = _explain().client_windows(rows, 2)
    assert len(wins) == len(mine) == 3
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "explain.py"), "--slo",
         str(log), "--client", "2"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "explain.py"), "--slo",
         str(log), "--client", "12345"], capture_output=True, text=True)
    assert proc.returncode == 2


def test_mesh_rebalance_row_equals_bench():
    """``serve.mesh_rebalance_row`` at bench's shape (4 shards, 64 ids,
    24 epochs; the JAX row's 4 shards fit the 8 CPU devices) against
    ``bench.bench_mesh_rebalance``: every key but the wall clocks equal,
    the migration log and the per-shard decisions among them."""
    import bench
    from dmclock_tpu_torch import serve as tserve

    got = tserve.mesh_rebalance_row(device="cpu")
    want = bench.bench_mesh_rebalance()
    assert set(got) == set(want)
    for key, value in want.items():
        if key not in ("dps", "dps_on", "dps_off", "wall_s_on",
                       "wall_s_off", "recovered_dps"):
            assert got[key] == value, key
    assert got["migrations"] > 0
    assert got["shard_decisions_on"] != got["shard_decisions_off"]
