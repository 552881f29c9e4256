"""The port's session history record (``dmclock_tpu_torch.bench
._record_history``) and its guard (``scripts/torch_bench_guard.py``)
against bench's (``bench._record_history``, ``scripts/bench_guard.py``).

The record: the same seeded rows through both writers, each pointed at
a temporary directory (the JAX one through its module's ``__file__``, so
nothing lands under ``benchmark/history/``), equal key for key but for
``platform`` and ``device`` -- and ``fallback``, which bench adds to any
CPU session and the port, which never falls back, never writes.

The guard: record sets written by the port's writer (a card's records,
``platform`` ``cuda``), then both guards over the same directory: exit
codes, standard output and standard error equal, for no history, drift
within tolerance, a 2x drop, a device change, and the chaos, restarted
supervised, actuating controller, degraded and CPU-session exclusions."""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench
from dmclock_tpu_torch import bench as tbench

ROOT = Path(__file__).resolve().parent.parent
CARD = torch.device("cuda")      # a device name only: nothing runs on it
CARD_NAME = "NVIDIA H100 80GB HBM3"


def _guard(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JG, TG = _guard("bench_guard"), _guard("torch_bench_guard")


def seeded_rows(seed: int, dps: float | None = None) -> dict:
    """A session's rows with bench's value kinds: floats, ints, strings,
    bools, numpy scalars and nested blocks (the record keeps the
    scalars and strings)."""
    rng = np.random.default_rng(seed)
    base = float(rng.uniform(30e6, 50e6)) if dps is None else dps
    return {
        "serve": {"dps": base, "fill": float(rng.uniform(0.9, 1.0)),
                  "select_impl": "sort", "decisions": int(rng.integers(
                      10**6, 10**7)), "provenance_on": True,
                  "chain_ms": [1.0, 2.0], "np_float": np.float64(1.5),
                  "np_int": np.int64(3)},
        "cfg4": {"dps": base / 4, "fill": 0.3, "mean_depth": 0.0,
                 "bounded_by": "load_generator_capped",
                 "tardiness_p99_ns": int(rng.integers(10**5, 10**6)),
                 "device_metrics": {"decisions": 5}},
    }


@pytest.mark.parametrize("kw", [
    {}, {"fault_plan": "seed=7,p_dropout=0.05"},
    {"supervised": True, "restarts": 2}, {"controller": "on"},
    {"ladder_steps": [{"knob": "select_impl", "from": "radix",
                       "to": "sort", "reason": "guard trip"}]},
    {"supervised": True, "restarts": 0, "controller": "both",
     "ladder_steps": []}])
def test_record_equals_bench(monkeypatch, tmp_path, kw):
    rows = seeded_rows(11)
    monkeypatch.setattr(bench, "__file__", str(tmp_path / "jax" / "bench.py"))
    bench._record_history(rows, **kw)
    want_file, = (tmp_path / "jax" / "benchmark" / "history").glob(
        "bench_*.json")
    monkeypatch.setattr(tbench, "HISTORY", tmp_path / "port" / "history")
    tbench._record_history(rows, torch.device("cpu"), "cpu", **kw)
    got_file, = (tmp_path / "port" / "history").glob("bench_*.json")
    want, got = json.loads(want_file.read_text()), json.loads(
        got_file.read_text())
    assert got_file.name.startswith("bench_") and got["platform"] == "cpu"
    assert got["device"] == "cpu" and "fallback" not in got
    assert want.pop("fallback") is True
    for rec in (want, got):
        del rec["platform"], rec["device"]
    assert got == want
    assert got["workloads"]["serve"]["np_float"] == 1.5
    assert "np_int" not in got["workloads"]["serve"]


def test_no_rows_no_record(monkeypatch, tmp_path):
    monkeypatch.setattr(tbench, "HISTORY", tmp_path / "history")
    tbench._record_history({}, CARD, CARD_NAME)
    assert not (tmp_path / "history").exists()


def test_session_records_to_the_port_history(monkeypatch, tmp_path,
                                             capsys):
    """``python -m dmclock_tpu_torch.bench`` records its rows, each row's
    scalars as the session measured them, on the device it ran on."""
    monkeypatch.setattr(tbench, "HISTORY", tmp_path / "history")
    assert tbench.main(["--mode", "serve", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    rec_file, = (tmp_path / "history").glob("bench_*.json")
    rec = json.loads(rec_file.read_text())
    assert f"# recorded {rec_file.relative_to(tmp_path.parent)}" in \
        captured.err
    assert rec["platform"] == "cpu" and rec["device"] == line["device"]
    assert rec["fault_plan"] == "none" and set(rec["workloads"]) == {"serve"}
    assert rec["workloads"]["serve"]["dps"] == line["value"] or \
        round(rec["workloads"]["serve"]["dps"], 1) == line["value"]


def _write(hist: Path, sessions, monkeypatch) -> Path:
    """``sessions``: ``(dps, device, kw)`` each, recorded into ``hist`` by
    the port's writer at increasing timestamps."""
    monkeypatch.setattr(tbench, "HISTORY", hist)
    for i, (dps, device, kw) in enumerate(sessions):
        kw = dict(kw)
        rows = seeded_rows(i, dps)
        for row in rows.values():
            row.update(kw.pop("row_extra", {}))
        monkeypatch.setattr(tbench, "time",
                            SimpleNamespace(time=lambda i=i: 1000 + i))
        tbench._record_history(rows, kw.pop("dev", CARD), device, **kw)
    return hist


CLEAN = [(40e6, CARD_NAME, {}), (35e6, CARD_NAME, {}), (45e6, CARD_NAME, {})]
SETS = {
    "within_drift": CLEAN + [(25e6, CARD_NAME, {})],
    "drop_2x": CLEAN + [(10e6, CARD_NAME, {})],
    "device_change": CLEAN + [(10e6, "NVIDIA H100 PCIe", {})],
    "chaos_newest": CLEAN + [(5e6, CARD_NAME,
                              {"fault_plan": "seed=7,p_dropout=0.05"})],
    "chaos_prior": [(1e6, CARD_NAME, {"fault_plan": "seed=7"})] + CLEAN
    + [(10e6, CARD_NAME, {})],
    "restarted": CLEAN + [(5e6, CARD_NAME, {"supervised": True,
                                            "restarts": 2})],
    "supervised_clean": CLEAN + [(41e6, CARD_NAME, {"supervised": True,
                                                    "restarts": 0})],
    "controller": CLEAN + [(5e6, CARD_NAME, {
        "controller": "on", "row_extra": {"controller_decisions": 3}})],
    "controller_idle": CLEAN + [(5e6, CARD_NAME, {
        "controller": "on", "row_extra": {"controller_decisions": 0}})],
    "degraded": CLEAN + [(5e6, CARD_NAME, {"ladder_steps": [
        {"knob": "select_impl", "from": "radix", "to": "sort",
         "reason": "guard trip"}]})],
    "cpu_session": CLEAN + [(0.2e6, "cpu", {"dev": torch.device("cpu")})],
    "one_record": [(40e6, CARD_NAME, {})],
}


def _run(mod, hist: Path, monkeypatch, capsys, argv=()):
    monkeypatch.setattr(mod, "HISTORY", hist)
    monkeypatch.setattr(sys, "argv", ["bench_guard.py", *argv])
    capsys.readouterr()          # the writer's "# recorded" lines
    rc = mod.main()
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_no_history(monkeypatch, capsys, tmp_path):
    assert TG.HISTORY == ROOT / "dmclock_tpu_torch" / "_history" == \
        tbench.HISTORY
    rc_j, out_j, _ = _run(JG, tmp_path / "none", monkeypatch, capsys)
    rc_t, out_t, _ = _run(TG, tmp_path / "none", monkeypatch, capsys)
    assert rc_j == rc_t == 0
    assert "no history yet -- pass" in out_j and \
        "no history yet -- pass" in out_t
    assert "dmclock_tpu_torch/_history/" in out_t
    assert "benchmark/history" not in out_t


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("argv", [(), ("--tolerance", "3.0"),
                                  ("--min-records", "4")])
def test_guard_verdicts_equal_bench_guard(monkeypatch, capsys, tmp_path,
                                          name, argv):
    hist = _write(tmp_path / "history", SETS[name], monkeypatch)
    want = _run(JG, hist, monkeypatch, capsys, argv)
    got = _run(TG, hist, monkeypatch, capsys, argv)
    assert got == want
    assert want[1]


def test_guard_verdicts_judge_as_expected(monkeypatch, capsys, tmp_path):
    """The verdicts above are the ones each set exists for."""
    expect = {"within_drift": (0, "OK"), "drop_2x": (1, "REGRESSION"),
              "device_change": (0, "not judged"),
              "chaos_newest": (0, "chaos"), "chaos_prior": (1, "REGRESSION"),
              "restarted": (0, "not judged"),
              "supervised_clean": (0, "OK"),
              "controller": (0, "controller-actuated"),
              "controller_idle": (1, "REGRESSION"),
              "degraded": (0, "ladder-degraded"),
              "cpu_session": (0, "not judged")}
    for name, (rc, word) in expect.items():
        hist = _write(tmp_path / name, SETS[name], monkeypatch)
        got_rc, out, _ = _run(TG, hist, monkeypatch, capsys)
        assert got_rc == rc and word in out, (name, out)
