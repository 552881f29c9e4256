"""The supervised mesh over a layout of device groups
(``EpochJob(engine_loop="mesh", devices=...)``) on the CPU, exactly.

Every group names the CPU (``("cpu",) * D``), which runs the grouped
code the way several cards do.  Held: a job over D = 2 and 4 groups
equals the one-group run and the JAX supervisor's run on its forced CPU
devices, bare with every telemetry plane and under the chaos plan; the
churn population with p2c placement under faults, and the controller
with migration over groups; a job killed on one layout and
resumed on another equals the uninterrupted run, both ways; the
snapshot files are the same bytes on every layout; and the refusals
(``S % D``, ``devices`` off the mesh loop)."""

import hashlib
import os

import pytest

from dmclock_tpu_torch.lifecycle import churn as tchurn
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

import test_torch_mesh_supervised as MS
from test_torch_supervisor import assert_results_equal

TELE = dict(with_hists=True, with_ledger=True, with_slo=True,
            with_prov=True, flight_records=16)
S = 4


def job(d=None, **over):
    kw = MS.kw_of("prefix-sort", n_shards=S, **TELE)
    kw.update(over)
    if d is not None:
        kw["devices"] = ("cpu",) * d
    return TS.EpochJob(**kw)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("chaos", [False, True], ids=["bare", "chaos"])
def test_grouped_job_equals_one_group_and_jax(chaos, d):
    over = dict(fault_plan=MS.CHAOS_SPEC) if chaos else {}
    got = TS.run_job(job(d, **over), device="cpu")
    assert got.decisions > 0
    assert_results_equal(got, MS.port("prefix-sort", n_shards=S,
                                      **TELE, **over))
    assert_results_equal(got, MS.jaxrun("prefix-sort", n_shards=S,
                                        **TELE, **over))
    if chaos:
        assert tobs.metrics_dict(got.metrics)["server_dropouts"] > 0


def _churn(**over):
    spec = tchurn.make_spec("churn_storm", total_ids=32, seed=3)
    return MS.kw_of("prefix-sort", n_shards=S, churn=spec, epochs=8,
                    placement="p2c", fault_plan=MS.CHAOS_SPEC, **over)


def test_churn_p2c_chaos_over_groups():
    want = TS.run_job(TS.EpochJob(**_churn()), device="cpu")
    got = TS.run_job(TS.EpochJob(**_churn(devices=("cpu",) * 2)),
                     device="cpu")
    assert_results_equal(got, want)
    assert got.placement == "p2c"


def test_controller_on_a_repeated_device_layout():
    """The controller and migration on a layout of two groups equal the
    one-device run (tests/test_torch_multidevice_migration.py holds
    more layouts against the JAX package)."""
    ctl = dict(sync_max=1, backlog_hi=10 ** 9, occ_lo=0.0, hysteresis=1,
               cooldown=8, migrate_skew_hi=1.5, migrate_pick="cold")
    spec = tchurn.make_spec("shard_skew", total_ids=64, seed=3,
                            cold_frac=0.5, cold_until=10 ** 9)
    kw = dict(engine="prefix", n=64, depth=4, ring=16, epochs=16, m=2,
              k=32, waves=2, ckpt_every=2, engine_loop="mesh", n_shards=4,
              placement="p2c", churn=spec, controller=ctl)
    want = TS.run_job(TS.EpochJob(**kw), device="cpu")
    got = TS.run_job(TS.EpochJob(**kw, devices=("cpu",) * 2),
                     device="cpu")
    assert want.migrations > 0
    assert_results_equal(got, want)
    assert got.controller_trajectory == want.controller_trajectory


def _ckpt_bytes(wd) -> dict:
    out = {}
    root = os.path.join(wd, "ckpt")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_snapshots_are_the_same_bytes_on_every_layout(tmp_path):
    ref = MS.port("prefix-sort", n_shards=S, **TELE)
    shots = []
    for d in (1, 2, 4):
        wd = tmp_path / f"d{d}"
        res = TS.run_supervised(job(d), wd, device="cpu")
        TS.assert_crash_equivalent(res, ref)
        shots.append(_ckpt_bytes(wd))
    assert shots[0] and shots[0] == shots[1] == shots[2]


@pytest.mark.parametrize("first, then", [(2, 1), (1, 2)])
def test_killed_on_one_layout_resumes_on_another(tmp_path, first, then):
    ref = MS.port("prefix-sort", n_shards=S, **TELE)
    wd = tmp_path / "wd"
    plan = TH.HostFaultPlan(kill_at_decisions=(ref.decisions // 2,))
    with pytest.raises(TS.SupervisorGaveUp):
        TS.run_supervised(job(first), wd, plan, device="cpu",
                          max_restarts=0)
    res = TS.run_supervised(job(then), wd, device="cpu")
    assert res.resumed_from is not None
    TS.assert_crash_equivalent(res, ref)


def test_layout_refusals():
    with pytest.raises(ValueError, match="S % D"):
        TS.run_job(job(3), device="cpu")
    with pytest.raises(ValueError, match="engine_loop='mesh'"):
        TS.run_job(TS.EpochJob(**MS.kw_of("prefix-sort", loop="stream",
                                          devices=("cpu", "cpu"))),
                   device="cpu")
    # the JSON of a default-layout job is the JAX package's, key for key
    assert "devices" not in job().to_json()
    assert tuple(TS.EpochJob.from_json(job(2).to_json()).devices) == \
        ("cpu", "cpu")
