"""The port's report tools (``scripts/torch_trace_report.py``,
``scripts/torch_slo_report.py``, ``scripts/torch_explain.py``) against
the JAX repo's ``scripts/trace_report.py``, ``slo_report.py`` and
``explain.py`` on the same input files, standard output byte for byte.

The inputs come from each package: a span trace (Chrome JSON and the
tracer's JSONL, on a deterministic clock), an SLO window log (a plane's
judged rolls of seeded window blocks), a flight ring dump and a decision
trace.  Every flag of each tool runs, ``--diff`` across the packages'
files and ``--trace`` included.  ``scripts/capacity_report.py`` and
``scripts/trace_diff.py``, which import neither package, read the port's
session line, its history record and its traces."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.obs import flight as jflight
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu.obs import spans as jspans
from dmclock_tpu.obs import trace as jtrace
from dmclock_tpu.obs import trace_export as jexport
from dmclock_tpu_torch.obs import flight as tflight
from dmclock_tpu_torch.obs import slo as tslo
from dmclock_tpu_torch.obs import spans as tspans
from dmclock_tpu_torch.obs import trace as ttrace
from dmclock_tpu_torch.obs import trace_export as texport

ROOT = Path(__file__).resolve().parent.parent


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"report_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOLS = {name: (_script(name), _script(f"torch_{name}"))
         for name in ("trace_report", "slo_report", "explain")}
N_CLIENTS = 6


def _clock():
    t = [0]

    def now():
        t[0] += 1_000 + (t[0] * 7919) % 5_000
        return t[0]
    return now


def _spans(mod, seed: int):
    """Nested spans over every category on a deterministic clock."""
    tr = mod.SpanTracer(clock_ns=_clock())
    rng = np.random.default_rng(seed)
    for i in range(12):
        with mod.span(tr, "bench.round", "dispatch", i=i):
            with mod.span(tr, "ingest.wave", "ingest"):
                pass
            for _ in range(int(rng.integers(1, 4))):
                with mod.span(tr, "epoch.batch", "device_compute"):
                    pass
        with mod.span(tr, "bench.digest_sync", "fetch"):
            pass
        if i % 4 == 3:
            with mod.span(tr, "supervisor.checkpoint_save", "checkpoint"):
                with mod.span(tr, "host.prep", "host_prep"):
                    pass
    return tr


def _slo_log(path: Path, plane_mod, seed: int, to_dev):
    """Three judged rolls of seeded window blocks, appended as JSONL."""
    rng = np.random.default_rng(seed)
    plane = plane_mod.SloPlane(N_CLIENTS, dt_epoch_ns=10**8, ring_depth=8)
    for c in range(N_CLIENTS):
        plane.register(c, 5.0 + c, 1.0 + c % 3, 40.0 if c % 2 else 0.0)
    for w in range(3):
        if w == 2:
            plane.register(4, 9.0, 2.0, 0.0)     # a contract-epoch bump
        blk = np.zeros((N_CLIENTS, plane_mod.W_FIELDS), dtype=np.int64)
        ops = rng.integers(0, 60, N_CLIENTS)
        ops[5] = 0
        blk[:, plane_mod.W_OPS] = ops
        blk[:, plane_mod.W_COST] = ops * rng.integers(1, 3, N_CLIENTS)
        blk[:, plane_mod.W_RESV_OPS] = ops // 3
        blk[:, plane_mod.W_TARDY_OPS] = rng.integers(0, 3, N_CLIENTS)
        blk[:, plane_mod.W_LB_OPS] = rng.integers(0, 2, N_CLIENTS)
        blk[:, plane_mod.W_TARD_SUM] = rng.integers(0, 10**7, N_CLIENTS)
        depth = rng.integers(0, 20, N_CLIENTS).astype(np.int32)
        depth[5] = 0
        block = plane.stamp(to_dev(blk))
        _, closed = plane.roll(block, 4 * w, 4 * w + 4, depth=to_dev(depth))
        plane.export_jsonl(str(path), closed)


def _flight(path: Path, mod, record, init, to_dev, seed: int):
    rng = np.random.default_rng(seed)
    fl = init()
    for _ in range(3):
        k = 8
        slot = rng.integers(-1, N_CLIENTS, k).astype(np.int32)
        fl = record(fl, to_dev(slot), to_dev((np.arange(k) % 3)
                                             .astype(np.int64)),
                    to_dev((np.arange(k) * 1000 + 7).astype(np.int64)),
                    to_dev((np.arange(k) % 5 + 1).astype(np.int32)),
                    margin=to_dev(rng.integers(-1, 10**6, k)
                                  .astype(np.int64)),
                    gate=to_dev(np.int64(rng.integers(0, 4))))
    mod.flight_dump(fl, str(path))


def _trace(path: Path, mod, seed: int):
    rng = np.random.default_rng(seed)
    with mod.DecisionTrace(str(path)) as tr:
        for i in range(40):
            c = int(rng.integers(0, N_CLIENTS))
            tr.record(1000 * i, 0, c, int(rng.integers(0, 2)),
                      int(rng.integers(1, 3)),
                      tag=[i, 2 * i, 0] if i % 3 else None,
                      margin=int(rng.integers(0, 100)) if i % 2 else None,
                      eligible_depth=int(rng.integers(0, 6)),
                      gate=int(rng.integers(0, 3)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("report_inputs")
    out = {}
    for tag, sp, ex in (("jax", jspans, jexport), ("port", tspans, texport)):
        tr = _spans(sp, 3 if tag == "jax" else 4)
        ex.export_chrome_trace(tr, str(d / f"{tag}.trace.json"))
        tr.export_jsonl(str(d / f"{tag}.spans.jsonl"))
        out[f"{tag}_chrome"] = str(d / f"{tag}.trace.json")
        out[f"{tag}_spans"] = str(d / f"{tag}.spans.jsonl")
    _slo_log(d / "jax.slo.jsonl", jslo, 5, jnp.asarray)
    _slo_log(d / "port.slo.jsonl", tslo, 6, torch.as_tensor)
    _flight(d / "jax.flight.jsonl", jflight, jflight.flight_record,
            lambda: jflight.flight_init(16), jnp.asarray, 7)
    _flight(d / "port.flight.jsonl", tflight, tflight.flight_record,
            lambda: tflight.flight_init(16, "cpu"), torch.as_tensor, 8)
    _trace(d / "jax.decisions.jsonl", jtrace, 9)
    _trace(d / "port.decisions.jsonl", ttrace, 10)
    for tag in ("jax", "port"):
        out[f"{tag}_slo"] = str(d / f"{tag}.slo.jsonl")
        out[f"{tag}_flight"] = str(d / f"{tag}.flight.jsonl")
        out[f"{tag}_decisions"] = str(d / f"{tag}.decisions.jsonl")
    return out


def _both(capsys, name: str, argv: list):
    """``(JAX stdout, port stdout, rc)``: the two tools on ``argv``."""
    outs, rcs = [], []
    for mod in TOOLS[name]:
        rcs.append(mod.main(argv))
        outs.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1], (name, argv, rcs)
    return outs[0], outs[1], rcs[0]


@pytest.mark.parametrize("argv", [
    ["{jax_chrome}"], ["{port_chrome}"], ["{port_spans}"],
    ["{jax_spans}", "--top", "3"], ["{port_chrome}", "--decisions", "1000"],
    ["{port_chrome}", "--diff", "{jax_chrome}"],
    ["{jax_spans}", "--diff", "{port_spans}", "--decisions", "500"]])
def test_trace_report_output_equals_the_jax_tool(inputs, capsys, argv):
    want, got, rc = _both(capsys, "trace_report",
                          [a.format(**inputs) for a in argv])
    assert rc == 0 and got == want and "dispatch-vs-compute ratio" in got


@pytest.mark.parametrize("argv", [
    ["{jax_slo}"], ["{port_slo}"], ["{port_slo}", "--client", "4"],
    ["{port_slo}", "--limit", "2"], ["{jax_slo}", "--limit", "0"],
    ["{port_slo}", "--diff", "{jax_slo}"],
    ["{jax_slo}", "--diff", "{port_slo}", "--client", "1"]])
def test_slo_report_output_equals_the_jax_tool(inputs, capsys, argv):
    want, got, rc = _both(capsys, "slo_report",
                          [a.format(**inputs) for a in argv])
    assert rc == 0 and got == want and "# totals:" in got


@pytest.mark.parametrize("argv", [
    ["--slo", "{port_slo}", "--client", "1"],
    ["--slo", "{jax_slo}", "--client", "3", "--window", "1"],
    ["--slo", "{port_slo}", "--client", "5"],
    ["--slo", "{port_slo}", "--client", "2", "--flight", "{port_flight}"],
    ["--slo", "{jax_slo}", "--client", "2", "--flight", "{jax_flight}",
     "--trace", "{jax_decisions}"],
    ["--slo", "{port_slo}", "--client", "0", "--trace",
     "{port_decisions}", "--flight", "{jax_flight}"],
    ["--slo", "{port_slo}", "--client", "4", "--diff", "{jax_slo}"],
    ["--slo", "{port_slo}", "--client", "3", "--trace",
     "{port_decisions}", "--diff", "{jax_slo}", "--json"]])
def test_explain_output_equals_the_jax_tool(inputs, capsys, argv):
    want, got, rc = _both(capsys, "explain",
                          [a.format(**inputs) for a in argv])
    assert rc == 0 and got == want and got


def test_bad_input_exit_codes_equal(inputs, tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert _both(capsys, "trace_report", [str(empty)])[2] == 2
    assert _both(capsys, "slo_report", [str(empty)])[2] == 1
    assert _both(capsys, "explain", ["--slo", inputs["port_slo"],
                                     "--client", "99"])[2] == 2


def test_capacity_report_and_trace_diff_read_the_port(monkeypatch, capsys,
                                                      tmp_path, inputs):
    """The JAX repo's two package-free tools on the port's outputs: the
    session line and history record of ``python -m
    dmclock_tpu_torch.bench --mode serve --spans --device cpu``, and the
    port's decision traces.  The line's serve row fills every column of
    the capacity report: the compile wall and retraces, the projected
    bytes, the cost counter's flops and bytes, the intensity, the
    dispatch share and the verdict."""
    from dmclock_tpu_torch import bench as tbench

    cap, diff = _script("capacity_report"), _script("trace_diff")
    monkeypatch.setattr(tbench, "HISTORY", tmp_path / "history")
    assert tbench.main(["--mode", "serve", "--spans", "--device",
                        "cpu"]) == 0
    line = tmp_path / "line.json"
    line.write_text(capsys.readouterr().out)
    assert "serve" in json.loads(line.read_text().splitlines()[-1])[
        "capacity"]["projected_hbm_bytes"]
    record, = (tmp_path / "history").glob("bench_*.json")
    for src in (line, record):
        assert cap.main([str(src)]) == 0
        out = capsys.readouterr().out
        assert "serve" in out, out
        if src == line:
            row, = [ln for ln in out.splitlines()
                    if ln.startswith("serve ")]
            cols = row.split()
            assert len(cols) == 9 and "-" not in cols, row
            assert cols[-1] in ("dispatch_bound", "memory_bound",
                                "compute_bound")
    assert cap.main([str(line), "--diff", str(record)]) == 0
    assert "serve" in capsys.readouterr().out

    same = inputs["port_decisions"]
    assert diff.main([same, same]) == 0
    assert capsys.readouterr().out.startswith("identical (40 decisions)")
    assert diff.main([same, inputs["jax_decisions"]]) == 1
    assert "divergence at decision" in capsys.readouterr().out
