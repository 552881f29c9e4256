"""The port's supervisor (``robust/supervisor.py``) against the JAX
package's, exactly: ``run_job`` on the matrix of the crash and streaming
smokes (prefix sort/radix, chain sort/radix, calendar minstop/bucketed,
each on the round and the stream loop, and one wheel job) with every
telemetry plane on; stream equal to round; the zero-host-fault gate;
crash equivalence under sampled plans; the ladder engaging and surviving
a resume; scrape loss; a resume from a snapshot the JAX supervisor wrote;
the refusals; and errors that must not be retried or restarted."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dmclock_tpu.robust import host_faults as JH
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.obs import device as obsdev
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS

BASE = dict(n=160, depth=6, ring=12, epochs=4, m=2, seed=9,
            arrival_lam=1.5, waves=3, ckpt_every=2)
TELE = dict(with_hists=True, with_ledger=True, flight_records=16,
            with_prov=True, with_slo=True)
MATRIX = {
    "prefix-sort": dict(engine="prefix", k=16, select_impl="sort"),
    "prefix-radix": dict(engine="prefix", k=16, select_impl="radix"),
    "chain-sort": dict(engine="chain", chain_depth=3, k=8,
                       select_impl="sort"),
    "chain-radix": dict(engine="chain", chain_depth=3, k=8,
                        select_impl="radix"),
    "calendar-minstop": dict(engine="calendar", k=4,
                             calendar_impl="minstop"),
    "calendar-bucketed": dict(engine="calendar", k=4,
                              calendar_impl="bucketed", ladder_levels=2),
}
CASES = [(name, loop) for name in MATRIX for loop in ("round", "stream")] \
    + [("calendar-wheel", "round")]
WHEEL = dict(engine="calendar", k=4, calendar_impl="wheel",
             ladder_levels=2)


def job_kw(name: str, loop: str = "round", **extra) -> dict:
    cfg = WHEEL if name == "calendar-wheel" else MATRIX[name]
    return dict(BASE, **TELE, **cfg, engine_loop=loop, **extra)


def tjob(**kw):
    return TS.EpochJob(**kw)


@pytest.fixture(scope="module")
def refs():
    """The bare runs, each computed once: ``refs(kind, name, loop,
    **extra)`` with kind "jax" or "port"."""
    cache = {}

    def get(kind, name, loop="round", **extra):
        key = (kind, name, loop, tuple(sorted(extra.items())))
        if key not in cache:
            kw = job_kw(name, loop, **extra)
            cache[key] = JS.run_job(JS.EpochJob(**kw)) if kind == "jax" \
                else TS.run_job(tjob(**kw), device="cpu")
        return cache[key]
    return get


def assert_results_equal(got, want, skip=("restarts", "resumed_from")):
    """Every field of two results, arrays by dtype and value."""
    assert got._fields == want._fields
    for f in got._fields:
        if f in skip:
            continue
        x, y = getattr(got, f), getattr(want, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert (x is None) == (y is None), f
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(x, y), f"{f} differs"
        else:
            assert x == y, f"{f}: {x} != {y}"


@pytest.mark.parametrize("name, loop", CASES)
def test_run_job_equals_jax(refs, name, loop):
    got, want = refs("port", name, loop), refs("jax", name, loop)
    assert got.decisions > 0
    assert_results_equal(got, want)


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_stream_equals_round(refs, name):
    r, s = refs("port", name, "round"), refs("port", name, "stream")
    TS.assert_crash_equivalent(s, r)
    assert np.array_equal(s.metrics, r.metrics)
    assert s.stream_fallbacks == 0


@pytest.mark.parametrize("loop", ["round", "stream"])
def test_zero_host_fault_gate(refs, tmp_path, loop):
    """Supervised with the empty plan is the bare run, bit for bit, the
    whole metric vector and every plane included; ladder rows zero."""
    ref = refs("port", "calendar-bucketed", loop)
    res = TS.run_supervised(tjob(**job_kw("calendar-bucketed", loop)),
                            tmp_path, TH.zero_host_plan(), device="cpu")
    assert_results_equal(res, ref)
    assert res.restarts == 0 and res.resumed_from is None
    assert res.metrics[obsdev.MET_LADDER_STEPS] == 0
    assert res.metrics[obsdev.MET_SUPERVISOR_RESUMES] == 0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("loop", ["round", "stream"])
def test_crash_equivalence_under_sampled_plans(refs, tmp_path, seed, loop):
    """Kills at sampled decision counts, a torn save, a rotted snapshot
    and a lost scrape port: the resumed run equals the uninterrupted
    one, and the JAX supervisor under the same plan restarts as often
    and resumes from the same snapshot."""
    name = "prefix-sort" if seed % 2 else "calendar-minstop"
    ref = refs("port", name, loop, epochs=6)
    plan_kw = dict(epochs=6, est_decisions=ref.decisions, kills=2,
                   save_kills=1, corrupt_saves=1, scrape_drops=1)
    plan = TH.sample_host_plan(seed, **plan_kw)
    # the scrape port (and so its loss) on one seed: closing an
    # endpoint waits out its poll interval
    kw = job_kw(name, loop, epochs=6,
                metrics_port=0 if seed == 0 else None)
    res = TS.run_supervised(tjob(**kw), tmp_path / "port", plan,
                            device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == TH.host_plan_events(plan)["restarts"] > 0
    want = JS.run_supervised(JS.EpochJob(**kw), tmp_path / "jax",
                             JH.sample_host_plan(seed, **plan_kw))
    assert res.restarts == want.restarts
    assert os.path.basename(res.resumed_from or "") == \
        os.path.basename(want.resumed_from or "")
    assert res.digest == want.digest
    assert np.array_equal(res.metrics, want.metrics)


@pytest.mark.parametrize("loop", ["round", "stream"])
def test_ladder_steps_to_tag64_and_keeps_it_across_a_resume(tmp_path, loop):
    """Client 0's proportion tag past the 2^31 ns window trips every
    tag32 epoch; the ladder (threshold 1) steps tag32 -> tag64 once, as
    in the JAX package, and a run killed after the step resumes at tag64
    and stays crash-equivalent."""
    kw = job_kw("prefix-sort", loop, tag_width=32,
                tag_spread_ns=2 ** 31 + 1, ladder=True,
                ladder_threshold=1, epochs=6)
    ref = TS.run_job(tjob(**kw), device="cpu")
    jref = JS.run_job(JS.EpochJob(**kw))
    assert_results_equal(ref, jref)
    assert ref.metrics[obsdev.MET_LADDER_STEPS] == 1
    assert ref.ladder_steps == [{"knob": "tag_width", "from": 32,
                                 "to": 64, "reason": "guard_trips"}]
    plan = TH.HostFaultPlan(
        kill_at_decisions=(max(3 * ref.decisions // 4, 1),))
    res = TS.run_supervised(tjob(**kw), tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1 and res.resumed_from is not None
    assert res.ladder_steps == [{"knob": "tag_width", "from": 32,
                                 "to": 64, "reason": "resumed"}]
    want = JS.run_supervised(JS.EpochJob(**kw), tmp_path / "jax",
                             JH.HostFaultPlan(**plan._asdict()))
    assert res.ladder_steps == want.ladder_steps


def test_scrape_loss_rebinds_and_leaves_the_run_alone(refs, tmp_path):
    ref = refs("port", "prefix-sort")
    job = tjob(**job_kw("prefix-sort", metrics_port=0))
    res = TS.run_supervised(job, tmp_path,
                            TH.HostFaultPlan(drop_scrape_at=(1,)),
                            device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 0 and res.scrape_rebinds >= 1


@pytest.mark.parametrize("loop", ["round", "stream"])
def test_port_resumes_a_jax_checkpoint(refs, tmp_path, loop):
    """The JAX supervisor is killed mid-run after writing snapshots; the
    port resumes from its rotation and ends with the JAX bare run's
    digest, state and planes."""
    kw = job_kw("prefix-radix", loop, epochs=6)
    jref = JS.run_job(JS.EpochJob(**kw))
    inj = JH.HostFaultInjector(
        JH.HostFaultPlan(kill_at_decisions=(jref.decisions // 2,)),
        str(tmp_path))
    with pytest.raises(JH.HostKill):
        JS._job_loop(JS.EpochJob(**kw), str(tmp_path), inj)
    res = TS.run_supervised(tjob(**kw), tmp_path, TH.zero_host_plan(),
                            device="cpu")
    assert res.resumed_from is not None
    assert res.metrics[obsdev.MET_SUPERVISOR_RESUMES] == 1
    TS.assert_crash_equivalent(res, jref)
    assert res.digest == jref.digest


# the mesh loop, its fault plans and p2c placement run now: what still
# refuses is the controller (ROADMAP.md item 12), on any loop, and a
# fault plan or p2c placement off the mesh (the JAX loop's composition
# checks).  The case ids are the ones these cases had when all four
# were refusals of unported modes, and are kept so a run's history stays
# comparable; what each checks now: "engine_loop-mesh-..." the
# controller on the mesh loop, "fault_plan-value1-..." a fault plan off
# the mesh, "placement-p2c-..." p2c placement off the mesh,
# "controller-True-..." the controller on the round loop.
@pytest.mark.parametrize("over, err, match", [
    pytest.param(dict(engine_loop="mesh", n_shards=2, controller=True),
                 NotImplementedError, "item 12",
                 id="engine_loop-mesh-NotImplementedError"),
    pytest.param(dict(fault_plan={"seed": 1, "p_dropout": 0.1}),
                 ValueError, "engine_loop='mesh'",
                 id="fault_plan-value1-ValueError"),
    pytest.param(dict(placement="p2c"), ValueError, "placement",
                 id="placement-p2c-ValueError"),
    pytest.param(dict(controller=True), NotImplementedError, "item 12",
                 id="controller-True-NotImplementedError"),
])
def test_unported_modes_refuse(tmp_path, over, err, match):
    job = dataclasses.replace(tjob(**job_kw("prefix-sort")), **over)
    with pytest.raises(err, match=match):
        TS.run_job(job, device="cpu")
    with pytest.raises(err, match=match):
        TS.run_supervised(job, tmp_path, device="cpu")


def test_runtime_error_is_neither_retried_nor_restarted(tmp_path,
                                                        monkeypatch):
    """A RuntimeError (what a CUDA error is) from an epoch propagates out
    of the trampoline at once: no retry, no ladder step, no restart."""
    calls = [0]

    def broken(engine):
        def scan(*a, **k):
            calls[0] += 1
            raise RuntimeError("CUDA error: an illegal memory access")
        return scan

    monkeypatch.setattr(tfp, "epoch_scan_fn", broken)
    job = tjob(**job_kw("prefix-radix", ladder=True, ladder_threshold=1))
    with pytest.raises(RuntimeError, match="CUDA error"):
        TS.run_supervised(job, tmp_path, TH.zero_host_plan(),
                          device="cpu", sleep=lambda s: None)
    assert calls[0] == 1


def test_launch_failures_step_the_ladder(refs, tmp_path, monkeypatch):
    """A transient error that outlives the guarded runner's retries is
    the ladder's launch-failure signal (the JAX rule): at the default
    threshold the second failed attempt steps radix -> sort, and the run
    ends equal to the sort job."""
    calls = []
    real = TS.run_epoch_guarded

    def flaky(state, now, **kw):
        calls.append(kw["select_impl"])
        if kw["select_impl"] == "radix":
            raise TimeoutError("transport never answered")
        return real(state, now, **kw)

    monkeypatch.setattr(TS, "run_epoch_guarded", flaky)
    res = TS.run_supervised(tjob(**job_kw("prefix-radix", ladder=True)),
                            tmp_path, TH.zero_host_plan(), device="cpu")
    assert [s["reason"] for s in res.ladder_steps] == ["launch_failures"]
    assert res.metrics[obsdev.MET_LADDER_STEPS] == 1
    assert res.restarts == 0 and calls[:3] == ["radix", "radix", "sort"]
    assert res.digest == refs("port", "prefix-sort").digest


def test_persistent_transient_error_restarts_then_gives_up(tmp_path,
                                                          monkeypatch):
    def dead(*_a, **_k):
        raise TimeoutError("transport never came back")

    monkeypatch.setattr(TS, "run_epoch_guarded", dead)
    with pytest.raises(TS.SupervisorGaveUp):
        TS.run_supervised(tjob(**job_kw("prefix-sort")), tmp_path,
                          TH.zero_host_plan(), max_restarts=2,
                          backoff_base_s=0.0, device="cpu")


def test_flight_dump_and_logs_on_a_crash(refs, tmp_path):
    """A killed incarnation dumps its flight ring; the span and SLO logs
    are flushed at checkpoint boundaries only, so the resumed run's
    stream holds each boundary's save span once."""
    ref = refs("port", "calendar-minstop")
    dump, spans, slo = (tmp_path / f for f in ("flight.jsonl",
                                               "spans.jsonl", "slo.jsonl"))
    job = tjob(**job_kw("calendar-minstop", flight_dump=str(dump),
                        span_log=str(spans), slo_log=str(slo)))
    plan = TH.HostFaultPlan(kill_at_decisions=(3 * ref.decisions // 4,))
    res = TS.run_supervised(job, tmp_path / "wd", plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    rows = [json.loads(ln) for ln in dump.read_text().splitlines()]
    assert rows and [r["seq"] for r in rows] == sorted(r["seq"]
                                                       for r in rows)
    saves = [json.loads(ln)["args"]["epoch"]
             for ln in spans.read_text().splitlines()
             if json.loads(ln)["name"] == "supervisor.checkpoint_save"]
    assert saves == [2, 4]
    assert slo.read_text().strip()


def test_epoch_job_json_equals_jax():
    assert TS.EpochJob().to_json() == JS.EpochJob().to_json()
    obj = JS.EpochJob(**job_kw("chain-radix", "stream")).to_json()
    assert TS.EpochJob.from_json(obj).to_json() == obj


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.run_job(tjob(**job_kw("prefix-sort")))
