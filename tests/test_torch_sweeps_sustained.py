"""``scripts/torch_run_sweeps.py``'s sustained rows and cfg4 calibration
study against ``bench.bench_sustained``, the call the JAX repo's
``benchmark/run_sweeps.py`` rows make, on the CPU at the script's cut
shape (``CUT``: 2,048 clients; cfg3 at k=512, m=8, ring 64 preloaded 48
deep in 16 waves, cfg4 on the prefix engine at k=512, m=4 with Zipf
weights; the study one rate a design: mixed staggered, mixed aligned and
the 50/50 split; chains of 2 and 6 rounds in 2 pairs).

``bench_sustained`` is called with the row's arguments as they stand in
the case table, the JAX script's defaults for the rest (no SLO plane,
telemetry and provenance on, two conformance rounds).  Every key of the
row that does not read the wall clock is held equal."""

import pytest

import bench
from test_torch_sweeps import SW

EXACT = ("decisions", "fill", "resv_phase_frac", "mean_depth",
         "bounded_by", "device_metrics", "engine_loop", "provenance_on",
         "conformance", "tardiness_p50_ns", "tardiness_p99_ns",
         "telemetry", "_hist_block", "provenance", "margin_p99_ns",
         "starvation_max_ns", "limit_gate_share")


def _same_row(got: dict, want: dict, what: str) -> None:
    for key in EXACT:
        assert key in want, (what, key)
        assert got[key] == want[key], (what, key)
    assert got["decisions"] > 0


def test_sustained_rows_equal_bench():
    cases = SW.CUT["sustained"]["cases"]
    got = SW.tpu_sustained_sweep(cases, device="cpu")
    assert [name for name, _ in got] == [name for name, _ in cases]
    for (name, kw), (_, row) in zip(cases, got):
        _same_row(row, bench.bench_sustained(**kw), name)


@pytest.mark.parametrize("design", [0, 1, 2])
def test_calibration_rows_equal_bench(design):
    sh = dict(SW.CUT["calibration"])
    name, kw, rates = sh["cases"][design]
    sh["cases"] = ((name, kw, rates),)
    got = SW.cfg4_calibration_sweep(**sh, device="cpu")
    assert [(n, r) for n, r, _ in got] == [(name, r) for r in rates]
    for (_, r, row) in got:
        want = bench.bench_sustained(
            sh["n"], sh["k"], sh["m"], sh["rounds"], zipf=True,
            resv_rate=r, dt_round_ns=50_000_000, rounds_lo=sh["rounds_lo"],
            reps=sh["reps"], **kw)
        _same_row(row, want, f"{name} r={r}")


def test_split_and_aligned_populations_equal_bench():
    """``serve.sustained_qos``'s split population and
    ``_sustained_setup``'s aligned reservation tags, bench's."""
    import numpy as np

    from dmclock_tpu_torch import serve as tserve

    for shape in ({"split_resv": 0.5, "zipf": True, "resv_rate": 60.0},
                  {"split_resv": 0.25, "zipf": False, "resv_rate": 30.0}):
        r, w = tserve.sustained_qos("cfg3", 1000, shape)
        n_resv = int(1000 * shape["split_resv"])
        assert (r[:n_resv] == shape["resv_rate"]).all() and \
            (r[n_resv:] == 0).all() and (w[:n_resv] == 0).all()
        tail = bench._zipf_weights(1000 - n_resv) if shape["zipf"] else \
            np.asarray([1.0 + (i % 4) for i in range(1000 - n_resv)])
        assert np.array_equal(w[n_resv:], tail)
    rates, weights = np.full(64, 100.0), 1.0 + np.arange(64) % 4
    for aligned in (False, True):
        got = tserve._sustained_setup(64, 16, 8, rates, weights,
                                      resv_aligned=aligned, device="cpu")
        want = bench._sustained_setup(64, 16, 8, rates, weights,
                                      resv_aligned=aligned)
        for f in got._fields:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
