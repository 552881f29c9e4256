"""The port's whole sustained row (``serve.sustained_row``) and its
frontier pick against the JAX package's ``bench.bench_sustained`` and
``bench.bench_frontier`` on the CPU, exactly.

Both rows run bench's structure: calibration, timed chains with the SLO
block rolled once a chain into the burn-rate evaluator, the derived
scalars, two untimed conformance rounds (with the per-client JSONL
table), the windowed latency rounds (cfg4: 16 rounds, so the window is
4), the verdict and the telemetry and provenance tails.  cfg3 runs at
bench's CPU shape (2,048 clients, k=512, m=8, ring 64 preloaded 48 deep,
16 waves, 24-round chains after 8-round ones, two pairs) on both loops;
cfg4 at the cut shape of ``tests/test_torch_calibration.py`` (512
clients, one chain of four rounds).  Every key that does not read the
wall clock is held equal, the conformance table byte for byte.  The
SLO block rolls once a chain: ``rolls`` is ``2 * reps`` with short
chains, else 1 (``windows_closed`` counts the client windows those rolls
closed)."""

import pytest

import bench
from dmclock_tpu_torch import serve as tserve

CASES = {
    "cfg3": dict(
        bench=dict(n=2048, k=512, m=8, rounds=24, zipf=False,
                   resv_rate=50.0, dt_round_ns=100_000_000, ring=64,
                   depth0=48, waves=16, rounds_lo=8, reps=2),
        cfg=dict(ring=64, depth0=48, resv_rate=50.0, waves=16, m=8, k=512),
        row=dict(rounds=24, rounds_lo=8, reps=2, latency_rounds=0)),
    "cfg4": dict(
        bench=dict(n=512, k=0, m=3, rounds=4, zipf=True, resv_rate=1200.0,
                   dt_round_ns=50_000_000, waves=64, ring=128, depth0=64,
                   rounds_lo=0, calendar_steps=64, target_resv_share=0.5,
                   calendar_impl="minstop", latency_rounds=16),
        cfg=dict(),
        row=dict(rounds=4, rounds_lo=0, reps=1, latency_rounds=16)),
}

# every key of the row that does not read the wall clock
EXACT = ("decisions", "fill", "resv_phase_frac", "mean_depth",
         "bounded_by", "device_metrics", "engine_loop", "provenance_on",
         "slo", "slo_violations_total", "slo_worst_share_err",
         "slo_window_tardiness_p99_ns", "slo_windows_closed",
         "conformance", "tardiness_p50_ns", "tardiness_p90_ns",
         "tardiness_p99_ns", "tardiness_mean_ns", "tardiness_max_ns",
         "telemetry", "_hist_block", "provenance", "margin_p50_ns",
         "margin_p99_ns", "starvation_max_ns", "limit_gate_share")
CALENDAR = ("decisions_per_pass", "calendar_impl")
LATENCY = ("latency_samples", "latency_window")
WALL = ("dps", "round_ms_p50", "round_ms_p99", "round_ms_mean",
        "decisions_per_launch")


def _rows(monkeypatch, tmp_path, workload, loop):
    case = CASES[workload]
    sh = dict(case["bench"])
    pos = (sh.pop("n"), sh.pop("k"), sh.pop("m"), sh.pop("rounds"))
    want_out = tmp_path / "bench.jsonl"
    want = bench.bench_sustained(
        *pos, **sh, slo=True, conformance_rounds=2,
        conformance_out=str(want_out), engine_loop=loop,
        capacity_check=False)
    row = "CFG3" if workload == "cfg3" else "CFG4"
    monkeypatch.setattr(tserve, row, dict(getattr(tserve, row),
                                          **case["cfg"]))
    got_out = tmp_path / "port.jsonl"
    got = tserve.sustained_row(
        workload, pos[0], **case["row"], conformance_rounds=2,
        conformance_out=str(got_out), engine_loop=loop, device="cpu")
    return want, got, want_out.read_bytes(), got_out.read_bytes()


@pytest.mark.parametrize("workload,loop", [("cfg3", "round"),
                                           ("cfg3", "stream"),
                                           ("cfg4", "round")])
def test_row_equals_bench(monkeypatch, tmp_path, workload, loop):
    want, got, want_file, got_file = _rows(monkeypatch, tmp_path, workload,
                                           loop)
    keys = EXACT + (CALENDAR if workload == "cfg4" else ()) + \
        (LATENCY if CASES[workload]["row"]["latency_rounds"] else ())
    for key in keys:
        assert key in want, key
        assert got[key] == want[key], key
    # bench's starved_clients: the first 8 fired rows, or absent
    assert got.get("starved_clients") == want.get("starved_clients")
    for key in WALL:
        assert (key in got) == (key in want), key
    row = CASES[workload]["row"]
    assert got["slo"]["rolls"] == (2 * row["reps"] if row["rounds_lo"]
                                   else 1)
    assert got["conformance"]["clients"] == CASES[workload]["bench"]["n"]
    assert got_file == want_file
    lines = got_file.decode().splitlines()
    assert len(lines) == CASES[workload]["bench"]["n"]
    if workload == "cfg4":
        assert got["latency_window"] == 4
        assert got["latency_samples"] == row["latency_rounds"]
    if loop == "stream":
        assert got["stream_chunk"] == want["stream_chunk"] == 8


def _canned(monkeypatch, rows_by_m):
    """``bench.bench_sustained`` returning canned rows, keyed by ``m``."""
    def fake(n, k, m, rounds, **kw):
        return dict(rows_by_m[m])

    monkeypatch.setattr(bench, "bench_sustained", fake)


def _frontier_rows(spec):
    return {m: {"dps": dps, "round_ms_mean": ms, "round_ms_p50": ms,
                "round_ms_p99": ms * 1.5, "resv_phase_frac": share,
                "decisions": int(dps)}
            for m, (dps, ms, share) in spec.items()}


FRONTIER_CASES = {
    # two points fit 80 ms on the 0.5 mix: the faster one
    "fit": ({2: (1e6, 40.0, 0.5), 3: (2e6, 70.0, 0.45),
             6: (3e6, 120.0, 0.5), 12: (4e6, 200.0, 0.55)}, 80.0),
    # a faster point fits the budget but is off the mix
    "fit_off_mix": ({2: (1e6, 40.0, 0.5), 3: (9e6, 50.0, 0.8),
                     6: (3e6, 120.0, 0.5), 12: (4e6, 200.0, 0.3)}, 80.0),
    # nothing fits: the on-mix point with the shortest round
    "no_fit": ({2: (1e6, 40.0, 0.7), 3: (2e6, 70.0, 0.5),
                6: (3e6, 120.0, 0.52), 12: (4e6, 200.0, 0.5)}, 10.0),
    # every point off the mix: the first row
    "all_off_mix": ({2: (1e6, 40.0, 0.9), 3: (2e6, 70.0, 0.1),
                     6: (3e6, 120.0, 0.75), 12: (4e6, 200.0, 0.2)}, 500.0),
}


@pytest.mark.parametrize("case", sorted(FRONTIER_CASES))
def test_frontier_pick_equals_bench(monkeypatch, case):
    spec, target = FRONTIER_CASES[case]
    _canned(monkeypatch, _frontier_rows(spec))
    want, rows = bench.bench_frontier(target_latency_ms=target)
    assert len(rows) == 4
    got = tserve.frontier_pick(rows, target)
    assert got == want
    assert got["met_budget"] == (case.startswith("fit"))
    # without a budget bench picks nothing
    assert bench.bench_frontier(target_latency_ms=0.0)[0] is None


def test_frontier_rows_equal_bench(monkeypatch):
    """The frontier's rows are the row reduced to bench's keys: the
    port's ``frontier`` at two cut points against ``bench_frontier`` with
    ``bench_sustained`` cut to the same depth."""
    real = bench.bench_sustained

    def cut(n, k, m, rounds, **kw):
        kw.update(rounds_lo=0, latency_rounds=8, reps=1,
                  capacity_check=False)
        return real(n, k, m, 3, **kw)

    monkeypatch.setattr(bench, "bench_sustained", cut)
    points = ((2, 64), (3, 64))
    _, want = bench.bench_frontier(points, n=256, target_latency_ms=0.0)
    _, got = tserve.frontier(points, n=256, rounds=3, rounds_lo=0, reps=1,
                             latency_rounds=8, device="cpu")
    wall = ("dps", "round_ms_mean", "round_ms_p50", "round_ms_p99")
    assert [{k: v for k, v in r.items() if k not in wall} for r in got] \
        == [{k: v for k, v in r.items() if k not in wall} for r in want]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
