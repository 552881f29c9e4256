"""The port's supervisor on open-population (churn) jobs against the JAX
package's: flash_crowd and churn_storm jobs with the SLO plane equal to
JAX's on both loops, lifecycle and SLO outputs included; churn crash
equivalence (mid-run kills, an admin op accepted before a kill, a kill
mid-compaction); and one spawn-mode run per loop whose child is really
SIGKILLed on the CPU and resumed from a rotation snapshot."""

import dataclasses
import json

import numpy as np
import pytest

from dmclock_tpu.lifecycle import make_spec as jax_make_spec
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.lifecycle import make_spec, wal_append
from dmclock_tpu_torch.lifecycle import plane as plane_mod
from dmclock_tpu_torch.obs import device as obsdev
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

from test_torch_supervisor import assert_results_equal

SPECS = {
    # growth, eviction, slot recycling and compaction at every boundary
    "churn_storm": dict(total_ids=16, base_lam=1.5, compact_every=1,
                        gens=4, stride=4, life=2, capacity0=4),
    "flash_crowd": dict(total_ids=32, base_lam=2.0, compact_every=2,
                        seed=11),
}
JOB = dict(epochs=12, m=2, k=8, ring=16, waves=4, ckpt_every=2, seed=11,
           with_slo=True, with_prov=True, with_ledger=True,
           with_hists=True)


def churn_kw(scenario: str, loop: str = "round", **extra) -> dict:
    return dict(JOB, engine="prefix", churn=make_spec(scenario,
                                                      **SPECS[scenario]),
                engine_loop=loop, **extra)


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(scenario, loop="round"):
        if (scenario, loop) not in cache:
            cache[(scenario, loop)] = TS.run_job(
                TS.EpochJob(**churn_kw(scenario, loop)), device="cpu")
        return cache[(scenario, loop)]
    return get


@pytest.mark.parametrize("scenario", sorted(SPECS))
@pytest.mark.parametrize("loop", ["round", "stream"])
def test_churn_job_equals_jax(refs, scenario, loop):
    got = refs(scenario, loop)
    kw = churn_kw(scenario, loop)
    assert kw["churn"] == jax_make_spec(scenario, **SPECS[scenario])
    want = JS.run_job(JS.EpochJob(**kw))
    assert_results_equal(got, want)
    assert got.decisions > 0 and got.slo["windows_closed"] > 0
    if scenario == "churn_storm":
        lc = got.lifecycle
        assert lc["grows"] >= 1 and lc["compactions"] >= 1
        assert lc["evictions"] >= 1 and lc["slot_recycles"] >= 1


@pytest.mark.parametrize("scenario", sorted(SPECS))
def test_churn_stream_equals_round(refs, scenario):
    TS.assert_crash_equivalent(refs(scenario, "stream"),
                               refs(scenario, "round"))


@pytest.mark.parametrize("loop", ["round", "stream"])
def test_kill_mid_churn_resumes_bit_identical(refs, tmp_path, loop):
    ref = refs("churn_storm", loop)
    plan = TH.HostFaultPlan(kill_at_decisions=(
        max(ref.decisions // 3, 1), max(2 * ref.decisions // 3, 2)))
    res = TS.run_supervised(TS.EpochJob(**churn_kw("churn_storm", loop)),
                            tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 2


def test_kill_between_admin_accept_and_apply(refs, tmp_path):
    """An op accepted through the control API (WAL-fsynced) before its
    boundary survives the kill and applies exactly once on resume."""
    job = TS.EpochJob(**churn_kw("churn_storm"))
    op = {"op": "update", "cid": 8, "r": 0.0, "w": 8.0, "l": 0.0,
          "apply_at": 8}
    wd_ref, wd_kill = tmp_path / "ref", tmp_path / "kill"
    wd_ref.mkdir(), wd_kill.mkdir()
    wal_append(wd_ref, op)
    wal_append(wd_kill, op)
    ref = TS.run_supervised(job, wd_ref, TH.zero_host_plan(),
                            device="cpu")
    assert ref.lifecycle["qos_updates"] == 1
    assert ref.digest != refs("churn_storm").digest
    res = TS.run_supervised(
        job, wd_kill,
        TH.HostFaultPlan(kill_at_decisions=(max(ref.decisions // 4, 1),)),
        device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.lifecycle["qos_updates"] == 1 and res.restarts == 1


def test_kill_mid_compaction(refs, tmp_path, monkeypatch):
    fired = []

    def hook():
        if not fired:
            fired.append(1)
            raise TH.HostKill("mid-compaction")

    monkeypatch.setattr(plane_mod, "_compact_hook", hook)
    res = TS.run_supervised(TS.EpochJob(**churn_kw("churn_storm")),
                            tmp_path, TH.zero_host_plan(), device="cpu")
    assert fired
    TS.assert_crash_equivalent(res, refs("churn_storm"))
    assert res.restarts == 1


def test_churn_zero_host_fault_gate(refs, tmp_path):
    ref = refs("flash_crowd")
    res = TS.run_supervised(TS.EpochJob(**churn_kw("flash_crowd")),
                            tmp_path, TH.zero_host_plan(), device="cpu")
    assert_results_equal(res, ref)
    assert np.array_equal(res.metrics, ref.metrics)


def test_lifecycle_mismatch_is_caught(refs):
    ref = refs("churn_storm")
    bad = dict(ref.lifecycle)
    bad["evictions"] += 1
    with pytest.raises(AssertionError, match="lifecycle"):
        TS.assert_crash_equivalent(ref._replace(lifecycle=bad), ref)


@pytest.mark.parametrize("loop", ["round", "stream"])
def test_spawn_child_sigkilled_and_resumed(refs, tmp_path, loop):
    """Each incarnation is ``python -m dmclock_tpu_torch.robust.supervisor``
    on the CPU; the plan's kill is a real SIGKILL of that child at half
    the decisions, and the next child resumes from a rotation snapshot."""
    ref = refs("churn_storm", loop)
    spans = tmp_path / "spans.jsonl"
    job = TS.EpochJob(**churn_kw("churn_storm", loop), span_log=str(spans))
    plan = TH.HostFaultPlan(kill_at_decisions=(ref.decisions // 2,))
    res = TS.run_supervised(job, tmp_path / "wd", plan, mode="spawn",
                            device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1 and res.resumed_from is not None
    assert res.metrics[obsdev.MET_SUPERVISOR_RESUMES] == 1
    # each child flushed its start (the parent's spawn to its initial
    # state) at its first checkpoint; the resumed child's precedes its
    # restore
    rows = [json.loads(ln) for ln in spans.read_text().splitlines()]
    starts = [r for r in rows if r["name"] == "supervisor.child_start"]
    assert len(starts) == 2 and all(
        0 < r["args"]["start_s"] < 600 for r in starts)
    assert rows.index(starts[1]) < [r["name"] for r in rows].index(
        "supervisor.resume")
    assert dataclasses.asdict(job) == dataclasses.asdict(
        TS.EpochJob.from_json(job.to_json()))
