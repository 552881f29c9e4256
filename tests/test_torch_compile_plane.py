"""The port's compile plane (``obs/compile_plane.py``) against the JAX
package's on the CPU.

- The cost counter's convention, op for op, against XLA:CPU's
  ``cost_analysis`` of the same function (``dmclock_tpu.obs.
  compile_plane.cost_analysis_dict`` of the jitted JAX function, a key
  XLA leaves out read as 0): elementwise ops on seeded inputs of length
  1,000 in int64, int32 and bool, ``exp`` (transcendentals, no flops),
  ``sort`` (its flops; its bytes differ: ``torch.sort`` also writes the
  int64 indices, XLA's sort of one array does not), views (0).
- The kernel regions: a K1 and a K2 call on the CPU record exactly their
  formula (``fastpath.ring_window_cost``, ``kernels.wheel_scan_cost``)
  and none of their plain versions' ops.
- Exactness: a counted launch changes no input and no output; the
  ``serve`` epochs, the ``serve`` row and a ``cfg3`` and a ``cfg4``
  sustained row (at ``tests/test_torch_sustained_row.py``'s cut shapes,
  cut in depth) give the same decisions, ``state_digest`` and every
  non-clock key with the plane and the rows' cost count on and off.
- Build records: ``engine/_ext.py`` ``build()`` with the ``nvcc`` call
  stubbed: a ``compile`` span and its record instant in a tracer, the
  totals (one compile, then a library found), nothing recorded with the
  plane off, the rows' compile deltas, and ``publish_compile_metrics``'s
  families and sample lines equal to the JAX plane's for the same
  totals."""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.obs import compile_plane as jcp
from dmclock_tpu.obs.registry import MetricsRegistry as JRegistry
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import _ext
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.obs import capacity as tcap
from dmclock_tpu_torch.obs import compile_plane as tcp
from dmclock_tpu_torch.obs import spans as tspans
from dmclock_tpu_torch.obs.registry import MetricsRegistry as TRegistry

from test_torch_sustained_row import CASES

L = 1000
KEYS = ("flops", "bytes_accessed", "transcendentals")

ELEMENTWISE = {
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y,
    "bitwise_and": lambda x, y: x & y,
    "right_shift": lambda x, y: x >> y,
    "less": lambda x, y: x < y,
}


def _inputs(dtype):
    rng = np.random.default_rng(17)
    a = rng.integers(0, 1000, L).astype(dtype)
    b = rng.integers(0, 60, L).astype(dtype)
    return a, b


def xla_cost(fn, *args) -> dict:
    got = jcp.cost_analysis_dict(jax.jit(fn).lower(*args).compile())
    return {k: got.get(k, 0.0) for k in KEYS}


def port_cost(fn, *args) -> dict:
    ts = [torch.from_numpy(np.asarray(a)) for a in args]
    got = tcp.count_launch(lambda: fn(*ts))
    return {k: got.get(k, 0.0) for k in KEYS}


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("op", sorted(ELEMENTWISE) + ["minimum", "where"])
def test_elementwise_equals_xla(op, dtype):
    a, b = _inputs(dtype)
    if op == "minimum":
        args, jf, tf = (a, b), jnp.minimum, torch.minimum
    elif op == "where":
        args, jf, tf = (a < b, a, b), jnp.where, torch.where
    else:
        args, jf, tf = (a, b), ELEMENTWISE[op], ELEMENTWISE[op]
    want = xla_cost(jf, *args)
    assert port_cost(tf, *args) == want
    assert want["flops"] == L


def test_xla_reference_numbers():
    """The XLA:CPU numbers the convention is held to, as measured."""
    a, b = _inputs(np.int64)
    assert xla_cost(ELEMENTWISE["add"], a, b)["bytes_accessed"] == 24_000
    assert xla_cost(jnp.where, a < b, a, b)["bytes_accessed"] == 25_000
    assert xla_cost(ELEMENTWISE["less"], a, b)["bytes_accessed"] == 17_000
    a32, b32 = _inputs(np.int32)
    assert xla_cost(jnp.where, a32 < b32, a32, b32)["bytes_accessed"] \
        == 13_000


def test_bool_and_equals_xla():
    a, b = _inputs(np.int64)
    c, d = a < b, a > 500
    want = xla_cost(lambda x, y: x & y, c, d)
    assert want == {"flops": 1000.0, "bytes_accessed": 3000.0,
                    "transcendentals": 0.0}
    assert port_cost(lambda x, y: x & y, c, d) == want


def test_exp_is_transcendental():
    x = np.linspace(0.0, 1.0, L)
    want = xla_cost(jnp.exp, x)
    assert want == {"flops": 0.0, "bytes_accessed": 16_000.0,
                    "transcendentals": 1000.0}
    assert port_cost(torch.exp, x) == want


@pytest.mark.parametrize("n, ops", [(1000, 10_000), (1024, 10_240),
                                    (4096, 49_152)])
def test_sort_flops_equal_xla(n, ops):
    x = np.random.default_rng(n).integers(0, 1 << 40, n)
    want = xla_cost(jnp.sort, x)
    got = port_cost(lambda t: torch.sort(t), x)
    assert got["flops"] == want["flops"] == ops
    # torch.sort writes the values and their int64 indices; XLA's sort
    # of one array writes the values only
    assert got["bytes_accessed"] == want["bytes_accessed"] + 8 * n


def test_views_count_nothing():
    x = torch.arange(1000, dtype=torch.int64)
    got = tcp.count_launch(lambda: (x[3:10], x.view(10, 100),
                                    x.view(10, 100).T, x.reshape(20, 50),
                                    x.unsqueeze(0), x.expand(2, 1000)))
    assert got == {"flops": 0.0, "bytes_accessed": 0.0,
                   "transcendentals": 0.0}
    # .item() reads the element's bytes
    assert tcp.count_launch(lambda: int(x[5]))["bytes_accessed"] == 8


def test_kernel_regions_record_their_formula():
    n, q, w = 300, 16, 5
    rng = np.random.default_rng(3)
    ring = torch.from_numpy(rng.integers(0, 1 << 40, (n, q)))
    q0 = torch.from_numpy(rng.integers(0, q, n).astype(np.int32))
    cost = ring + 1
    with tcp.CostCounter() as c:
        tfp.ring_window_rows(ring, cost, q0, w)
    assert c.cost_analysis() == {"flops": 2 * n * w,
                                 "bytes accessed": 2 * (2 * n * w * 8)
                                 + 4 * n, "transcendentals": 0}
    assert c.ops() == {"kernel:ring_window": {
        "calls": 1, "flops": 2 * n * w,
        "bytes_accessed": 2 * (2 * n * w * 8) + 4 * n,
        "transcendentals": 0}}
    keys = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    nb = 256
    slot = torch.from_numpy(rng.integers(0, nb + 1, n).astype(np.int32))
    with tcp.CostCounter() as c:
        got = tk.wheel_scan(keys, slot, nb)
    assert list(c.ops()) == ["kernel:wheel_scan"]
    assert c.cost_analysis()["bytes accessed"] == 12 * n + 12 * nb + 9 == \
        tk.wheel_scan_cost(n, nb)["bytes_accessed"]
    # the region changes nothing of the result
    for g, want in zip(got, tk._wheel_scan_torch(keys, slot, nb)):
        assert torch.equal(g, want)
    assert not tcp._active()


def _state_tuple(st):
    return tuple(getattr(st, f).clone() for f in st._fields)


def test_counted_launch_changes_nothing():
    st = tserve._preloaded_state(512, 24, ring=24, device="cpu")
    before = _state_tuple(st)
    plain = tfp.scan_prefix_epoch(st, 0, 3, 128, anticipation_ns=0,
                                  with_metrics=True)
    with tcp.CostCounter() as c:
        counted = tfp.scan_prefix_epoch(st, 0, 3, 128, anticipation_ns=0,
                                        with_metrics=True)
    assert all(torch.equal(a, getattr(st, f))
               for a, f in zip(before, st._fields))
    for f in ("count", "guards_ok", "slot", "phase", "metrics"):
        assert torch.equal(getattr(plain, f), getattr(counted, f)), f
    assert int(tserve.state_digest(plain.state)) == \
        int(tserve.state_digest(counted.state))
    ops = c.ops()
    assert ops["kernel:ring_window"]["calls"] == 1
    assert c.cost_analysis()["flops"] > 0


@pytest.fixture
def plane_state(monkeypatch):
    """A fresh process plane for the test (a row's programs are captured
    once a row, so a second row at one shape in the same process records
    a retrace: the records must not depend on which tests ran before)."""
    pl = tcp.CompilePlane()
    monkeypatch.setattr(tcp, "_PLANE", pl)
    return pl


def _non_clock(row: dict) -> dict:
    clock = {"dps", "reps", "chain_ms", "sync_latency_ms", "round_ms_p50",
             "round_ms_p99", "round_ms_mean", "decisions_per_launch",
             "compile_ms_total", "roofline", "bound_class", "spans",
             "dispatch_ms_per_launch", "host_overhead_frac",
             "cost_analysis"}
    return {k: v for k, v in row.items() if k not in clock}


def _plane_off(monkeypatch, plane_state) -> None:
    """The plane off: no build records and no cost count in any row."""
    plane_state.enable(False)
    monkeypatch.setattr(tcp, "count_launch", lambda fn: {})


def test_serve_equal_with_plane_on_and_off(monkeypatch, plane_state):
    res = {}
    for on in (True, False):
        if on:
            plane_state.enable(True)
        else:
            _plane_off(monkeypatch, plane_state)
        r = tserve.serve_only(512, 24, 128, 3, 2, device="cpu")
        with tcp.CostCounter():
            rc = tserve.serve_only(512, 24, 128, 3, 2, device="cpu")
        row = tserve.serve_row(k=512, m=2, depth=24, n=1024, epochs_lo=1,
                               epochs_hi=2, reps=2, device="cpu")
        # a serve row's ``decisions`` sums its valid pairs, and which
        # pairs are valid reads the clock: every pair serves the same
        # decisions, so the row is held by its decisions a pair
        res[on] = (int(r.count.sum()), int(tserve.state_digest(r.state)),
                   int(rc.count.sum()), int(tserve.state_digest(rc.state)),
                   dict(_non_clock(row),
                        decisions=row["decisions"] // len(row["reps"])))
        assert res[on][:2] == res[on][2:4]
        if on:
            assert set(row["cost_analysis"]) == set(KEYS)
            assert row["bound_class"] in ("memory_bound", "compute_bound")
        else:
            assert row["cost_analysis"] == {}
    assert res[True] == res[False]


@pytest.mark.parametrize("workload, depth", [
    ("cfg3", dict(rounds=4, rounds_lo=2, reps=1, latency_rounds=0)),
    ("cfg4", dict(rounds=2, rounds_lo=0, reps=1, latency_rounds=0))])
def test_sustained_rows_equal_with_plane_on_and_off(monkeypatch,
                                                    plane_state, workload,
                                                    depth):
    row = "CFG3" if workload == "cfg3" else "CFG4"
    monkeypatch.setattr(tserve, row, dict(getattr(tserve, row),
                                          **CASES[workload]["cfg"]))
    n = CASES[workload]["bench"]["n"]
    # the row's final state, digested after the row (its count included)
    tail, seen = tserve.row_tail, []
    monkeypatch.setattr(tserve, "row_tail", lambda out, tele, state, *a,
                        **kw: (seen.append(state),
                               tail(out, tele, state, *a, **kw))[1])
    rows, digests = {}, {}
    for on in (True, False):
        if on:
            plane_state.enable(True)
        else:
            _plane_off(monkeypatch, plane_state)
        rows[on] = tserve.sustained_row(workload, n, **depth,
                                        conformance_rounds=1, device="cpu")
        digests[on] = int(tserve.state_digest(seen.pop()))
    assert digests[True] == digests[False]
    assert rows[True]["decisions"] > 0
    assert rows[False]["cost_analysis"] == {}
    assert _non_clock(rows[True]) == _non_clock(rows[False])
    ca = rows[True]["cost_analysis"]
    assert set(ca) == set(KEYS) and ca["bytes_accessed"] > 0
    assert rows[True]["retraces"] == 0


# ----------------------------------------------------------------------
# build records
# ----------------------------------------------------------------------

class _Clock:
    def __init__(self, step: int):
        self.t, self.step = 0, step

    def __call__(self) -> int:
        self.t += self.step
        return self.t


@pytest.fixture
def stub_build(monkeypatch, tmp_path, plane_state):
    """``_ext.build()`` into ``tmp_path`` with ``nvcc`` stubbed (the call
    writes the output file), on a fresh plane with a stepping clock."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF stub")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_ext, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_ext.subprocess, "run", fake_run)
    pl = tcp.CompilePlane(clock_ns=_Clock(1_000_000))
    monkeypatch.setattr(tcp, "_PLANE", pl)
    return pl, calls


def test_build_records_a_compile_span_and_totals(stub_build):
    pl, calls = stub_build
    tracer = tspans.SpanTracer(clock_ns=_Clock(10))
    pl.set_tracer(tracer)
    cp0 = pl.totals()
    lib = _ext.build()
    assert lib.exists() and len(calls) == 1
    assert _ext.build() == lib and len(calls) == 1     # found
    t = pl.totals()
    assert t == {"entries": 1, "compiles": 1, "retraces": 0,
                 "lower_ms_total": 2.0, "compile_ms_total": 1.0,
                 "dispatch_fallbacks": 0}
    assert set(t) == set(jcp.CompilePlane().totals())
    (entry,) = pl.entries()
    assert (entry["cache"], entry["entry"], entry["compiles"],
            entry["found"]) == ("kernels", lib.name, 1, 1)
    rows = tracer.rows()
    assert [(r["name"], r["cat"]) for r in rows] == [
        ("compile.kernels", "compile"),
        ("compile.kernels.record", "compile")]
    assert rows[1]["args"]["compiled"] is True
    assert rows[1]["args"]["compile_ms"] == 1.0
    # a row's compile fields are the plane's growth over the row
    out = tcap.capacity_row({}, dict(n=64, ring=8), cp0)
    assert (out["compile_ms_total"], out["retraces"]) == (1.0, 0)
    assert out["bound_class"] == "unknown"
    assert tcap.capacity_row({}, dict(n=64, ring=8), t)[
        "compile_ms_total"] == 0.0
    pl.set_tracer(None)


def test_build_with_the_plane_off(stub_build, monkeypatch):
    pl, calls = stub_build
    pl.enable(False)
    _ext.build()
    _ext.build()
    assert len(calls) == 1
    assert pl.totals()["entries"] == 0
    monkeypatch.setenv("DMCLOCK_COMPILE_PLANE", "0")
    assert not tcp.CompilePlane().enabled
    monkeypatch.setenv("DMCLOCK_COMPILE_PLANE", "1")
    assert tcp.CompilePlane().enabled


def test_failed_build_is_not_recorded(stub_build, monkeypatch):
    pl, _ = stub_build
    monkeypatch.setattr(_ext.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 2, "", "boom"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _ext.build()
    assert pl.totals()["entries"] == 0


def _samples(reg) -> list:
    return [ln for ln in reg.prometheus().splitlines()
            if not ln.startswith("#")]


def test_publish_compile_metrics_equals_jax(stub_build):
    pl, _ = stub_build
    lib = _ext.build()
    _ext.build()
    (entry,) = pl.entries()
    jpl = jcp.CompilePlane()
    jpl.record_compile("kernels", lib.name,
                       lower_ns=int(entry["lower_ms"] * 1e6),
                       compile_ns=int(entry["compile_ms"] * 1e6),
                       cost={}, hbm={})
    assert jpl.totals() == pl.totals()
    jr, tr = JRegistry(), TRegistry()
    jcp.publish_compile_metrics(jr, jpl)
    tcp.publish_compile_metrics(tr, pl)
    assert _samples(tr) == _samples(jr)
    assert 'dmclock_compile_ms_total{cache="kernels"} 1' in _samples(tr)


def test_normalize_cost_analysis_equals_jax():
    for ca in ({"flops": 3.0, "bytes accessed": 8.0},
               [{"flops": 1.0, "transcendentals": 2.0, "other": 5}], [],
               {}):
        assert tcp.normalize_cost_analysis(ca) == \
            jcp.normalize_cost_analysis(ca)


def test_count_degrades_and_device_failures_raise():
    def boom():
        raise ValueError("no such shape")

    assert tcp.count_launch(boom) == {"error": "ValueError: no such shape"}

    def dead():
        raise RuntimeError("ring_window kernel launch failed: CUDA error 1")

    with pytest.raises(RuntimeError, match="launch failed"):
        tcp.count_launch(dead)
    assert not tcp._active()
