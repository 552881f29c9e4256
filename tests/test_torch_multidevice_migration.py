"""Live migration and the controller on a mesh laid out over device
groups (``EpochJob(engine_loop="mesh", devices=...)`` with p2c placement
and a controller whose live rule is ``migrate``) against the JAX
supervisor on its forced CPU devices (one shard a device), exactly.

Every group names the CPU (``("cpu",) * D``), which runs the grouped
code the way several cards do.  Held, field for field: the
``shard_skew`` job at ``n_shards`` 4 over 2 and 4 groups and at 8 over
2, 4 and 8 groups, each with a destination that grows its slot
capacity (every group grows to one rectangle); a hot shard down under a
fault plan; the wheel calendar, where the chunk's pressure peaks pick
the source.  A spy on ``groups.gather`` shows that the controller's
boundary and the migration never gather a stack.  A kill at each stage
of the move resumes on another layout to the bare run."""

from typing import NamedTuple

import pytest
import torch

from dmclock_tpu.lifecycle import churn as jchurn
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.lifecycle import churn as tchurn
from dmclock_tpu_torch.lifecycle import placement as TP
from dmclock_tpu_torch.parallel import groups
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

from test_torch_supervisor import assert_results_equal

CTL = dict(sync_max=1, backlog_hi=10 ** 9, occ_lo=0.0, hysteresis=1,
           cooldown=8, migrate_skew_hi=1.5, migrate_pick="cold",
           migrate_max=4)
BASE = dict(engine="prefix", k=16, select_impl="sort", n=96, depth=6,
            ring=10, epochs=8, m=2, seed=5, arrival_lam=1.0, waves=2,
            ckpt_every=2, engine_loop="mesh", placement="p2c")
WHEEL = dict(engine="calendar", k=4, calendar_impl="wheel",
             ladder_levels=2)
# the slot capacity a shard starts with: at these sizes a migration's
# destination outgrows it (4 shards: 16, the default; 8 shards: 8)
CAP0 = {4: 0, 8: 8}


def _kw(churn_mod, S, cap0=None, **over):
    spec = churn_mod.make_spec("shard_skew", total_ids=64, seed=3,
                               capacity0=CAP0[S] if cap0 is None else cap0,
                               n_shards=S,
                               cold_frac=0.5, cold_until=10 ** 9)
    return dict(BASE, n_shards=S, churn=spec, **dict({"controller": CTL},
                                                     **over))


def tjob(S, d=None, **over):
    kw = _kw(tchurn, S, **over)
    if d is not None:
        kw["devices"] = ("cpu",) * d
    return TS.EpochJob(**kw)


_REFS: dict = {}


def jax_ref(S, **over):
    key = (S, repr(sorted(over.items())))
    if key not in _REFS:
        _REFS[key] = JS.run_job(JS.EpochJob(**_kw(jchurn, S, **over)))
    return _REFS[key]


class St(NamedTuple):
    depth: torch.Tensor


@pytest.fixture
def boundary_spy(monkeypatch):
    """Counts, while the controller's boundary or a migration runs, the
    gathers of a stack and the one-rectangle growths."""
    seen = {"inside": 0, "gathers": 0, "grows": 0}

    def inside(fn):
        def wrapped(*a, **k):
            seen["inside"] += 1
            try:
                return fn(*a, **k)
            finally:
                seen["inside"] -= 1
        return wrapped

    gather, rebuild = groups.gather, groups.rebuild

    def spy_gather(*a, **k):
        if seen["inside"]:
            seen["gathers"] += 1
        return gather(*a, **k)

    def spy_rebuild(*a, **k):
        if seen["inside"]:
            seen["grows"] += 1
        return rebuild(*a, **k)

    monkeypatch.setattr(groups, "gather", spy_gather)
    monkeypatch.setattr(groups, "rebuild", spy_rebuild)
    monkeypatch.setattr(TS, "_mesh_migrate", inside(TS._mesh_migrate))
    monkeypatch.setattr(TS._Run, "control", inside(TS._Run.control))
    return seen


@pytest.mark.parametrize("S,d", [(4, 2), (4, 4), (8, 2), (8, 4), (8, 8)])
def test_grouped_migration_equals_jax(boundary_spy, S, d):
    got = TS.run_job(tjob(S, d), device="cpu")
    assert got.migrations > 0
    assert_results_equal(got, jax_ref(S))
    assert got.migration_log == jax_ref(S).migration_log
    assert boundary_spy["grows"] >= 1, "no destination grew"
    assert boundary_spy["gathers"] == 0


def test_grouped_migration_with_shards_down(boundary_spy):
    """Under this fault plan shards 1 and 2 are down at the first
    migrate boundary: every move goes to a live shard, and the grouped
    run equals the JAX run."""
    from dmclock_tpu_torch.robust import faults as F

    fault = {"seed": 0, "p_dropout": 0.3, "mean_outage_steps": 2.0}
    plan = F.plan_from_spec(F.parse_fault_spec(fault), 8, 4)
    got = TS.run_job(tjob(4, 2, fault_plan=fault), device="cpu")
    assert got.migrations > 0
    downs = 0
    for bnd, _cid, src, dst in got.migration_log:
        row = plan.up[min(bnd, plan.up.shape[0] - 1)]
        assert row[src] and row[dst], "moved through a DOWN shard"
        downs += int(not row.all())
    assert downs > 0, "no migration ran while a shard was down"
    assert_results_equal(got, jax_ref(4, fault_plan=fault))
    assert boundary_spy["gathers"] == 0


@pytest.mark.parametrize("d", [2, 4])
def test_grouped_wheel_pressure_fallback(boundary_spy, d):
    """On the wheel calendar the boundary depth is drained; the chunk's
    pressure peaks, read group by group, pick the source."""
    got = TS.run_job(tjob(4, d, **WHEEL), device="cpu")
    assert got.migrations > 0
    for _bnd, _cid, src, _dst in got.migration_log:
        assert src == 0
    assert_results_equal(got, jax_ref(4, **WHEEL))
    assert boundary_spy["gathers"] == 0


# bench's pick, firing every other boundary: the second firing's move
# resumes from the snapshot the first one's boundary saved.  No slot
# grows here (32 slots a shard from the start): a snapshot of grown
# stacks does not fit the job's template, so such a run replays from
# the start, in both packages
HOT = dict(controller=dict(CTL, migrate_pick="hot", cooldown=2), cap0=32)


@pytest.mark.parametrize("stage,first,then", [("evicted", 2, 4),
                                              ("handoff", 4, 1),
                                              ("registered", 1, 2)])
def test_kill_mid_migration_resumes_on_another_layout(tmp_path, stage,
                                                      first, then):
    want = TS.run_job(tjob(4, **HOT), device="cpu")
    assert len({b for b, *_ in want.migration_log}) >= 2
    seen = []

    def hook(s):
        if s == stage:
            seen.append(1)
            if len(seen) == 2:
                raise TH.HostKill(f"mid-migration:{stage}")

    old = TP._migrate_hook
    TP._migrate_hook = hook
    try:
        with pytest.raises(TS.SupervisorGaveUp):
            TS.run_supervised(tjob(4, first, **HOT), tmp_path,
                              device="cpu", max_restarts=0)
    finally:
        TP._migrate_hook = old
    res = TS.run_supervised(tjob(4, then, **HOT), tmp_path,
                            device="cpu")
    assert res.resumed_from is not None
    TS.assert_crash_equivalent(res, want)
    assert res.migration_log == want.migration_log


def test_boundary_read_by_group_equals_the_stack():
    """``_boundary_read`` over groups: one copy a group, joined in shard
    order, equal to the read of the one stack."""
    from dmclock_tpu_torch.control import _boundary_read
    from dmclock_tpu_torch.obs import provenance as obs_prov
    from dmclock_tpu_torch.obs.provenance import ProvBlock

    g = torch.Generator().manual_seed(3)
    depth = torch.randint(0, 9, (8, 12), generator=g, dtype=torch.int32)
    prov = ProvBlock(torch.zeros((8, 4), dtype=torch.int64),
                     torch.randint(0, 99, (8, obs_prov.PS_FIELDS),
                                   generator=g),
                     torch.zeros((8, 12), dtype=torch.int64))

    st = St(depth)
    want = _boundary_read(st, prov)
    for d in (2, 4, 8):
        got = _boundary_read(groups.place(st, ("cpu",) * d),
                             groups.place(prov, ("cpu",) * d))
        for a, b in zip(got, want):
            assert a.shape == b.shape and (a == b).all()
