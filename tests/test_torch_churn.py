"""Bench's ``churn_<scenario>`` row on the port (``serve.churn_row``)
against ``bench.bench_churn`` itself, at reduced shapes on the CPU.

Every output key is compared except the wall-clock ones (``wall_s``,
``dps``) and the capacity record (``_capacity_row``), which the two
packages measure differently: decisions, the lifecycle snapshot counters, the
live PUT's boost record, the conformance table, the tardiness scalars,
the SLO block, ``slo_boost_windows`` and the histogram block.  The
row's own digest of a dynamic run equals its static variant's.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import bench
from dmclock_tpu.obs import spans as JS
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.obs import spans as TS

ROOT = Path(__file__).resolve().parent.parent

# bench's keys the two packages measure differently (the capacity
# record: XLA's compiles and the port's kernel build, projected bytes,
# the verdict on them) or that measure wall time
NOT_COMPARED = {"wall_s", "dps", "compile_ms_total", "retraces",
                "projected_hbm_bytes", "projected_hbm_error", "roofline",
                "bound_class"}

# flash_crowd with a backlog that never drains (bench's own regime at
# its accelerator shape); churn_storm, whose generations are evicted,
# recycled and compacted
SHAPES = {
    "flash_crowd": dict(total_ids=64, epochs=24, k=32),
    "churn_storm": dict(total_ids=48, epochs=32, k=64),
}


def _traced(S):
    clock = iter(range(0, 10 ** 12, 10))
    return S.SpanTracer(clock_ns=lambda: next(clock))


@pytest.mark.parametrize("scenario", sorted(SHAPES))
def test_churn_row_equals_bench(scenario):
    kw = SHAPES[scenario]
    jtr, ttr = _traced(JS), _traced(TS)
    want = bench.bench_churn(scenario, slo=True, tracer=jtr, **kw)
    got = tserve.churn_row(scenario, slo=True, tracer=ttr, device="cpu",
                           **kw)
    for key in sorted(set(want) | set(got)):
        if key in NOT_COMPARED or key == "digest":
            continue
        assert got.get(key) == want.get(key), key
    assert got["decisions"] > 0 and got["boost"]["http"] is True
    assert [(r["name"], r["cat"], r["depth"]) for r in ttr.rows()] == \
        [(r["name"], r["cat"], r["depth"]) for r in jtr.rows()]
    if scenario == "churn_storm":
        assert got["evictions"] > 0 and got["compactions"] > 0
    else:
        # the boosted client's delivered share grows after the PUT
        assert got["boost"]["share_gain"] > 1
    static = tserve.churn_row(scenario, slo=True, static=True,
                              device="cpu", **kw)
    assert static["digest"] == got["digest"]
    assert static["decisions"] == got["decisions"]
    assert static["registrations"] == kw["total_ids"]
    # the SLO windows and the evaluator only observe
    off = tserve.churn_row(scenario, slo=False, device="cpu", **kw)
    assert (off["digest"], off["decisions"]) == (got["digest"],
                                                 got["decisions"])
    assert "slo" not in off and "slo" in got


def test_churn_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "dmclock_tpu_torch.serve", "--workload",
         "churn", "--n", "32", "--epochs", "8", "--k", "16", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["workload"] == "churn_flash_crowd"
    assert row["device"] == "cpu" and row["decisions"] > 0
    assert row["boost"]["http"] is True
