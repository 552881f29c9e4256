"""The port's bench session (``python -m dmclock_tpu_torch.bench``) and
its ``serve`` row (``serve.serve_row``) against the JAX repo's
``bench.main()`` and ``bench.bench_serve_only`` on the CPU.

Both sessions run the same mode at bench's CPU shapes (the JAX one on
its CPU backend, the port with ``--device cpu``; the mesh over four CPU
groups in the port).  Held: the line's key set (the port's ``device``
in), every field that does not read the wall clock or is measured
differently, bench's programs in the compile planes (``bench.serve``,
``bench.round`` and ``bench.chunk``: equal compiles and retraces, no
dispatch fallback) and the module caches its rows run through
(``guarded.epoch``, ``mesh.chunk`` and the others of
``SESSION_CACHES``), the metric text with its rates masked,
``vs_baseline == round(value / 1e7, 4)``, and the "skipped" lines.
Then the session's own contract: a failing row prints bench's error
line and exits non-zero; a guard trip steps radix to sort and the row
is keyed ``serve``; a CUDA error re-raises without a step;
``--trace-out``, ``--metrics-port 0`` and ``--profile`` each leave their
output."""

import json
import re

import pytest

import bench
from dmclock_tpu.obs import compile_plane as jcp
from dmclock_tpu_torch import bench as tbench
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.obs import compile_plane as tcp

# keys that read the wall clock (rates, walls, latencies), and the
# capacity fields the two packages measure differently (PERF.md: the
# port measures the epoch blocks that the JAX ledger's closed form
# estimates with accumulators on).  The compile plane's and the cost
# counter's fields are measured differently too: XLA compiles each
# program and counts it statically, the port builds one kernel library
# and counts the ops one launch ran, so ``compile``, ``cost_analysis``,
# the rows' ``compile_ms_total``/``retraces`` and the ``roofline``
# verdict built on them (``bound_class``) are held by key, not value
CLOCK = {"metric", "value", "vs_baseline", "dps", "dps_off", "dps_on",
         "recovered_dps", "wall_s", "wall_s_off", "wall_s_on",
         "dps_per_shard", "dps_per_shard_max", "dps_per_shard_mean",
         "dps_per_shard_min", "capacity", "projected_hbm_bytes",
         "projected_hbm_bytes_per_shard", "compile", "cost_analysis",
         "bound_class", "compile_ms_total", "retraces", "roofline"}
# what only one package's line or rows carry: the port names its card,
# and its grouped mesh row names its layout; its churn row adds the
# canonical chain digest
JAX_ONLY = set()
PORT_ONLY = {"device", "devices", "n_groups", "digest"}
BOUND_CLASSES = {"compute_bound", "memory_bound", "dispatch_bound",
                 "unknown"}
# the programs bench captures for its rows (``aot_record``), and the
# module caches its rows run through: the guarded epochs of the churn
# row, the mesh chunks of the mesh rows
BENCH_CACHES = ("bench.serve", "bench.round", "bench.chunk")
SESSION_CACHES = BENCH_CACHES + ("guarded.epoch", "guarded.serial",
                                 "mesh.chunk", "supervisor.ingest",
                                 "fastpath.runner")
MODES = {
    "all": ["--mode", "all"],          # on the CPU: bench's serve row alone
    "serve": ["--mode", "serve"],
    "cfg3": ["--mode", "cfg3"],
    "churn": ["--mode", "churn"],
    "controller": ["--mode", "controller"],
    "rpc": ["--mode", "rpc"],
    "mesh": ["--mode", "mesh", "--n-shards", "4", "--rebalance", "on",
             "--clients", "2048"],
}


@pytest.fixture(autouse=True)
def _port_history(monkeypatch, tmp_path):
    """The port's session writes its history record into the test's
    directory, not into the checkout."""
    monkeypatch.setattr(tbench, "HISTORY", tmp_path / "port_history")


def jax_line(monkeypatch, capsys, argv) -> dict:
    monkeypatch.setattr(bench, "_record_history", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", ["bench.py"] + list(argv))
    capsys.readouterr()
    bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def port_line(capsys, argv, rc=0) -> dict:
    capsys.readouterr()
    assert tbench.main(list(argv) + ["--device", "cpu"]) == rc
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def masked(text: str) -> str:
    text = re.sub(r"[-+]?\d+\.\d+M", "<rate>", text)
    return re.sub(r"(p50|p99) \d+ms", r"\1 <ms>", text)


def assert_same(want, got, path="line"):
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(want) - JAX_ONLY == set(got) - PORT_ONLY, \
            (path, sorted(set(want) ^ set(got)))
        for k in set(want) & set(got):
            if k not in CLOCK:
                assert_same(want[k], got[k], f"{path}.{k}")
    else:
        assert got == want, path


def bench_programs(pl, caches=BENCH_CACHES) -> list:
    """``(cache, compiles, retraces)`` of bench's own programs (or of
    ``caches``) in a compile plane."""
    return sorted((e["cache"], e["compiles"], e["retraces"])
                  for e in pl.entries() if e["cache"] in caches)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_session_line_equals_bench(monkeypatch, capsys, mode):
    argv = MODES[mode]
    # fresh compile planes: the session's records alone
    monkeypatch.setattr(jcp, "_PLANE", jcp.CompilePlane())
    monkeypatch.setattr(tcp, "_PLANE", tcp.CompilePlane())
    want = jax_line(monkeypatch, capsys, argv)
    got = port_line(capsys, argv + (["--devices", "cpu,cpu,cpu,cpu"]
                                    if mode == "mesh" else []))
    # bench's programs: one capture a row where bench compiles one; the
    # guarded epochs and mesh chunks its rows run: the same entries,
    # compiles and retraces
    assert bench_programs(tcp.plane()) == bench_programs(jcp.plane())
    assert bench_programs(tcp.plane(), SESSION_CACHES) == \
        bench_programs(jcp.plane(), SESSION_CACHES)
    if mode in ("all", "serve", "cfg3"):
        assert bench_programs(tcp.plane()), mode
        assert got["compile"]["compiles"] >= 1
    assert got["compile"]["dispatch_fallbacks"] == 0
    assert want["backend"] == got["backend"] == "cpu"
    assert got["device"] == "cpu"
    assert_same(want, got)
    assert masked(got["metric"]) == masked(want["metric"])
    assert got["vs_baseline"] == round(got["value"] / 1e7, 4)
    assert got["unit"] == want["unit"] == "decisions/sec/chip"
    if mode == "mesh":
        assert got["mesh"]["n_groups"] == 4
        assert got["mesh_rebalance"]["migrations"] > 0
    if mode in ("all", "serve"):
        assert set(got["capacity"]["projected_hbm_bytes"]) == {"serve"}
    # the capacity block's verdicts: the same rows on both sides, each
    # one of the four classes
    for line in (want, got):
        verdicts = line.get("capacity", {}).get("bound_class", {})
        assert set(verdicts) == \
            set(want.get("capacity", {}).get("bound_class", {}))
        assert set(verdicts.values()) <= BOUND_CLASSES
    assert set(got.get("cost_analysis", {})) == \
        set(want.get("cost_analysis", {}))


@pytest.mark.parametrize("argv", [["--mode", "cfg4"],
                                  ["--mode", "frontier"],
                                  ["--target-latency", "500"]])
def test_skipped_lines_equal_bench(monkeypatch, capsys, argv):
    want = jax_line(monkeypatch, capsys, argv)
    got = port_line(capsys, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("select_impl", ["sort", "radix"])
def test_serve_row_equals_bench(select_impl):
    shape = dict(k=512, m=2, depth=24, n=1024, epochs_lo=1, epochs_hi=2,
                 reps=2, select_impl=select_impl)
    want = bench.bench_serve_only(**shape)
    got = tserve.serve_row(**shape, device="cpu")
    for key in ("fill", "select_impl", "tag_width", "device_metrics",
                "projected_hbm_bytes"):
        assert got[key] == want[key], key
    # ``decisions`` sums the valid pairs, and which pairs are valid
    # reads the clock: every pair serves the same decisions
    assert got["decisions"] * len(want["reps"]) == \
        want["decisions"] * len(got["reps"])
    assert set(want) - JAX_ONLY == set(got)
    assert 1 <= len(got["reps"]) <= 2
    with pytest.raises(AssertionError, match="cannot feed"):
        tserve.serve_row(k=4096, m=8, depth=16, n=512, device="cpu")


def _failing_radix(monkeypatch, exc):
    real = tserve.serve_row

    def row(**kw):
        if kw["select_impl"] == "radix":
            raise exc
        return real(**kw)

    monkeypatch.setattr(tserve, "serve_row", row)


def test_guard_trip_steps_radix_to_sort(monkeypatch, capsys):
    _failing_radix(monkeypatch, AssertionError("rebase guards tripped"))
    got = port_line(capsys, ["--mode", "serve", "--select-impl", "radix"])
    assert got["degradation_ladder"] == [{
        "knob": "select_impl", "from": "radix", "to": "sort",
        "reason": "guard_trips"}]
    assert got["metric"].endswith(")") and "serve-only " in got["metric"]
    assert "radix" not in got["metric"]


def test_cuda_error_is_not_laddered(monkeypatch, capsys):
    _failing_radix(monkeypatch, RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    got = port_line(capsys, ["--mode", "serve", "--select-impl", "radix"],
                    rc=1)
    assert "degradation_ladder" not in got
    assert got["error"].startswith("RuntimeError: CUDA error")
    assert got["value"] == 0.0 and got["vs_baseline"] == 0.0


def test_failing_row_exits_nonzero_after_its_line(monkeypatch, capsys):
    def row(*a, **kw):
        raise ValueError("a broken row")

    monkeypatch.setattr(tserve, "churn_row", row)
    got = port_line(capsys, ["--mode", "churn"], rc=1)
    assert got["metric"] == "bench failed mid-run (ValueError); no " \
                            "usable rate"
    assert got["error"] == "ValueError: a broken row"
    assert got["backend"] == "cpu"


def test_trace_metrics_and_profile_outputs(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    prof = tmp_path / "prof"
    capsys.readouterr()
    assert tbench.main(["--mode", "serve", "--device", "cpu",
                        "--trace-out", str(trace), "--metrics-port", "0",
                        "--profile", str(prof)]) == 0
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip())
    assert "spans" in line and "serve" in line["spans"]
    assert re.search(r"# metrics: serving http://127\.0\.0\.1:\d+",
                     cap.err)
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert any(e.get("name") == "bench.epoch" for e in events)
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]
