"""The port's calibrated sustained rows (``serve.sustained_prepare`` and
the ``cfg3``/``cfg4`` rounds after it) against the JAX package's
``bench.bench_sustained`` on the CPU, exactly.

cfg3 runs at bench's own CPU shape (``bench.py`` ``--mode cfg3`` on a
CPU backend: 2,048 clients, k=512, m=8, ring 64 preloaded 48 deep, 16
waves, 24 timed rounds after 8 lower ones, two repetitions); cfg4 at a
cut shape (512 clients, the calendar engine at 64 steps, m=3, the 0.5
reservation-share target, four timed rounds, minstop).  Both sides get
the same seed.  The test records bench's arrival stream by wrapping
``numpy.random.default_rng`` (every ``poisson`` call of the seed-11
stream: its rate vector and its draw) and bench's calibrated
reservation inverses at the SLO plane's re-registration.  Held
exactly: the calibrated rates, every timed round's draws, the
calibrated ``resv_inv``, and the row's ``decisions``,
``resv_phase_frac`` and ``mean_depth``."""

import numpy as np
import pytest

import bench
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu_torch import serve as tserve

CASES = {
    "cfg3": dict(
        bench=dict(n=2048, k=512, m=8, rounds=24, zipf=False,
                   resv_rate=50.0, dt_round_ns=100_000_000, ring=64,
                   depth0=48, waves=16, rounds_lo=8, reps=2),
        cfg=dict(ring=64, depth0=48, resv_rate=50.0, waves=16, m=8,
                 k=512)),
    "cfg4": dict(
        bench=dict(n=512, k=0, m=3, rounds=4, zipf=True, resv_rate=1200.0,
                   dt_round_ns=50_000_000, waves=64, ring=128, depth0=64,
                   rounds_lo=0, calendar_steps=64, target_resv_share=0.5,
                   calendar_impl="minstop"),
        cfg=dict()),
}


class _Recorder:
    """A seed-11 generator that records every Poisson call."""

    def __init__(self, rng, calls):
        self._rng, self._calls = rng, calls

    def poisson(self, lam, *a, **kw):
        out = self._rng.poisson(lam, *a, **kw)
        self._calls.append((np.array(lam, dtype=np.float64, copy=True),
                            np.array(out, copy=True)))
        return out

    def __getattr__(self, name):
        return getattr(self._rng, name)


def _bench_run(monkeypatch, shape):
    calls, inv = [], []
    real = np.random.default_rng

    def default_rng(seed=None):
        rng = real(seed)
        return _Recorder(rng, calls) if seed == 11 else rng

    monkeypatch.setattr(np.random, "default_rng", default_rng)
    orig = jslo.SloPlane.register_from_inv

    def register_from_inv(self, resv_inv, weight_inv, limit_inv):
        inv.append(np.asarray(resv_inv).copy())
        return orig(self, resv_inv, weight_inv, limit_inv)

    monkeypatch.setattr(jslo.SloPlane, "register_from_inv",
                        register_from_inv)
    sh = dict(shape)
    pos = (sh.pop("n"), sh.pop("k"), sh.pop("m"), sh.pop("rounds"))
    out = bench.bench_sustained(*pos, **sh, slo=True, conformance_rounds=0,
                                capacity_check=False)
    monkeypatch.setattr(np.random, "default_rng", real)
    return out, calls, inv


@pytest.mark.parametrize("workload", sorted(CASES))
def test_calibrated_row_equals_bench(monkeypatch, workload):
    case = CASES[workload]
    shape = case["bench"]
    want, calls, inv = _bench_run(monkeypatch, shape)
    n = shape["n"]
    rlo, reps = shape["rounds_lo"], shape.get("reps", 3)
    n_timed = reps * (rlo + shape["rounds"]) if rlo else shape["rounds"]
    cal_iters = 5 if workload == "cfg4" else 1
    n_cal = 1 + 2 * cal_iters
    assert len(calls) == n_cal + n_timed

    # the row's shape at bench's CPU size
    row = "CFG3" if workload == "cfg3" else "CFG4"
    monkeypatch.setattr(tserve, row, dict(getattr(tserve, row),
                                          **case["cfg"]))
    prep = tserve.sustained_prepare(workload, n, n_timed, 11, device="cpu")
    assert prep.cal_rounds == n_cal
    assert prep.t0 == n_cal * shape["dt_round_ns"]
    # the calibrated rates and every timed draw, on the same stream
    np.testing.assert_array_equal(prep.lam, calls[n_cal][0])
    np.testing.assert_array_equal(
        prep.draws.numpy(),
        np.stack([np.minimum(out, shape["waves"]).astype(np.int32)
                  for _, out in calls[n_cal:]]))
    # the calibrated reservation inverses bench re-registers the SLO
    # contracts from
    assert len(inv) == 1
    np.testing.assert_array_equal(prep.state.resv_inv.numpy(), inv[0])

    if workload == "cfg3":
        res = tserve.cfg3_rounds(prep.state, prep.draws, t0=prep.t0)
        resv = int(((res.slot >= 0) & (res.phase == 0)).sum())
        assert bool(res.guards_ok.all())
    else:
        res = tserve.cfg4_rounds(prep.state, prep.draws, t0=prep.t0,
                                 calendar_impl="minstop")
        resv = int(res.resv_count.sum())
        assert bool(res.progress_ok.all())
    decisions = int(res.count.sum())
    assert decisions == want["decisions"]
    assert resv / max(decisions, 1) == want["resv_phase_frac"]
    assert float(res.state.depth.numpy().mean()) == want["mean_depth"]
