"""The port's simulators against the JAX package's: config parsing, the
harness's traces and per-client phase splits (``dmclock-torch`` against
JAX's ``dmclock-tpu``, and ``ssched``) in pull and push mode on the
scaled shapes of ``tests/test_sim_tpu_parity.py``, the reports, the
``--trace`` JSONL and the Chrome trace export, and the ``dmc_sim`` /
``ssched_sim`` CLIs' output.  Every compared value is exact; only the
wall-clock lines of a report are left out."""

import dataclasses
import functools
import json
from pathlib import Path

import pytest
import torch

from dmclock_tpu.obs import trace as jtrace
from dmclock_tpu.obs import trace_export as jexport
from dmclock_tpu.sim import config as jcfg
from dmclock_tpu.sim import dmc_sim as jdmc
from dmclock_tpu.sim import ssched_sim as jssched
from dmclock_tpu.sim.harness import SimReport as JaxReport
from dmclock_tpu_torch import models
from dmclock_tpu_torch.obs import trace as ttrace
from dmclock_tpu_torch.obs import trace_export as texport
from dmclock_tpu_torch.sim import config as tcfg
from dmclock_tpu_torch.sim import dmc_sim as tdmc
from dmclock_tpu_torch.sim import ssched_sim as tssched
from dmclock_tpu_torch.sim.harness import SimReport

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.conf"))

# tests/test_sim_tpu_parity.py's scaled shapes, as keyword dicts
SHAPES = {
    "example": dict(
        clients=[dict(client_count=1, client_total_ops=60, client_wait_s=0,
                      client_iops_goal=200, client_outstanding_ops=32,
                      client_reservation=0.0, client_limit=0.0,
                      client_weight=1.0, client_server_select_range=1),
                 dict(client_count=1, client_total_ops=60, client_wait_s=1,
                      client_iops_goal=200, client_outstanding_ops=32,
                      client_reservation=0.0, client_limit=40.0,
                      client_weight=1.0, client_server_select_range=1),
                 dict(client_count=1, client_total_ops=60, client_wait_s=2,
                      client_iops_goal=200, client_outstanding_ops=32,
                      client_reservation=0.0, client_limit=50.0,
                      client_weight=2.0, client_server_select_range=1),
                 dict(client_count=1, client_total_ops=40, client_wait_s=0,
                      client_iops_goal=100, client_outstanding_ops=16,
                      client_reservation=0.0, client_limit=0.0,
                      client_weight=1.0, client_req_cost=3,
                      client_server_select_range=1)],
        servers=[dict(server_count=1, server_iops=160, server_threads=1)],
        server_soft_limit=False),
    "100th": dict(
        clients=[dict(client_count=2, client_total_ops=50,
                      client_iops_goal=100, client_outstanding_ops=16,
                      client_reservation=20.0, client_limit=60.0,
                      client_weight=1.0, client_server_select_range=1),
                 dict(client_count=1, client_total_ops=40,
                      client_iops_goal=100, client_outstanding_ops=16,
                      client_reservation=10.0, client_limit=0.0,
                      client_weight=2.0, client_req_cost=3,
                      client_server_select_range=1)],
        servers=[dict(server_count=1, server_iops=120, server_threads=2)],
        server_soft_limit=True),
    "multi_server": dict(
        clients=[dict(client_count=3, client_total_ops=60,
                      client_iops_goal=120, client_outstanding_ops=8,
                      client_reservation=15.0, client_limit=0.0,
                      client_weight=1.0, client_server_select_range=2)],
        servers=[dict(server_count=2, server_iops=80, server_threads=1)],
        server_soft_limit=False),
}


def make_cfg(mod, shape: str, **kw):
    d = SHAPES[shape]
    return mod.SimConfig(
        client_groups=len(d["clients"]), server_groups=len(d["servers"]),
        cli_group=[mod.ClientGroup(**g) for g in d["clients"]],
        srv_group=[mod.ServerGroup(**g) for g in d["servers"]],
        server_soft_limit=d["server_soft_limit"], **kw)


@functools.lru_cache(maxsize=None)
def jax_run(shape: str, mode: str, model: str):
    return jdmc.run_sim(make_cfg(jcfg, shape), model=model, seed=7,
                        record_trace=True, server_mode=mode)


@functools.lru_cache(maxsize=None)
def port_run(shape: str, mode: str, model: str):
    return tdmc.run_sim(make_cfg(tcfg, shape), model=model, seed=7,
                        record_trace=True, server_mode=mode, device="cpu")


def assert_same_run(got, want):
    assert len(got.trace) == len(want.trace) > 0
    for i, (a, b) in enumerate(zip(got.trace, want.trace)):
        assert a == b, f"trace diverges at op {i}: port={a} jax={b}"
    assert got.loop.now_ns == want.loop.now_ns
    for cid in want.clients:
        ca, cb = got.clients[cid].stats, want.clients[cid].stats
        assert (ca.ops_completed, ca.reservation_ops, ca.priority_ops,
                ca.completion_times_ns, ca.finish_time_ns) == \
            (cb.ops_completed, cb.reservation_ops, cb.priority_ops,
             cb.completion_times_ns, cb.finish_time_ns)
    for sid in want.servers:
        sa, sb = got.servers[sid].stats, want.servers[sid].stats
        assert sa.per_client_phase == sb.per_client_phase


def stable(text: str) -> list:
    """A report's lines without the wall-clock parts: the ``wall:``
    tail of the duration line and the host-call latency averages."""
    out = []
    for line in text.splitlines():
        if line.startswith("average ") or line.startswith("# trace-out"):
            continue
        out.append(line.split("; wall:")[0])
    return out


# ----------------------------------------------------------------------
# config
# ----------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_parse_config_file_equals_jax(path):
    got = tcfg.parse_config_file(str(path))
    want = jcfg.parse_config_file(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.total_clients, got.total_servers) == \
        (want.total_clients, want.total_servers)


def test_config_defaults_equal_jax():
    assert dataclasses.asdict(tcfg.SimConfig()) == \
        dataclasses.asdict(jcfg.SimConfig())
    cfg = tcfg.SimConfig(client_groups=3, server_groups=2)
    assert len(cfg.cli_group) == 3 and len(cfg.srv_group) == 2


# ----------------------------------------------------------------------
# the harness
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["pull", "push"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dmclock_torch_trace_equals_jax_engine(shape, mode):
    assert_same_run(port_run(shape, mode, "dmclock-torch"),
                    jax_run(shape, mode, "dmclock-tpu"))


@pytest.mark.parametrize("mode", ["pull", "push"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ssched_trace_equals_jax(shape, mode):
    assert_same_run(port_run(shape, mode, "ssched"),
                    jax_run(shape, mode, "ssched"))


@pytest.mark.parametrize("model", ["dmclock-torch", "ssched"])
@pytest.mark.parametrize("mode", ["pull", "push"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_reports_equal_jax(shape, mode, model):
    jmodel = "dmclock-tpu" if model == "dmclock-torch" else model
    got = SimReport(port_run(shape, mode, model))
    want = JaxReport(jax_run(shape, mode, jmodel))
    assert stable(got.format(show_intervals=True)) == \
        stable(want.format(show_intervals=True))
    assert got.format_conformance() == want.format_conformance()
    assert got.conformance() == want.conformance()
    assert got.tardiness_percentiles() == want.tardiness_percentiles()
    assert got.phase_totals() == want.phase_totals()
    assert got.ledger_check() == want.ledger_check()
    assert got.slo_window_check() == want.slo_window_check()
    assert got.client_interval_ops(0.25) == want.client_interval_ops(0.25)
    if model == "dmclock-torch" and mode == "pull":
        chk = got.ledger_check()
        assert chk["mismatches"] == [] and chk["ops"] > 0
        assert got.slo_window_check()["mismatches"] == []


def test_refused_models_are_named():
    """Every model of the JAX package's registry is ported (its
    ``dmclock-tpu`` is the port's ``dmclock-torch``): only an unknown name
    is refused."""
    assert models.NOT_PORTED == {}
    assert models.names() == ["dmclock", "dmclock-delayed",
                              "dmclock-native", "dmclock-torch", "ssched"]
    assert models.push_names() == ["dmclock", "dmclock-delayed",
                                   "dmclock-torch", "ssched"]
    with pytest.raises(KeyError, match="unknown"):
        models.get("nope")
    with pytest.raises(KeyError, match="no push-mode queue"):
        models.get_push("dmclock-native")


def _write_conf(tmp_path, shape: str) -> str:
    d = SHAPES[shape]
    lines = ["[global]", f"server_groups = {len(d['servers'])}",
             f"client_groups = {len(d['clients'])}",
             "server_random_selection = true",
             f"server_soft_limit = {str(d['server_soft_limit']).lower()}"]
    for i, g in enumerate(d["clients"]):
        lines.append(f"[client.{i}]")
        for k, v in g.items():
            key = "client_wait" if k == "client_wait_s" else k
            lines.append(f"{key} = {v}")
    for i, g in enumerate(d["servers"]):
        lines.append(f"[server.{i}]")
        lines += [f"{k} = {v}" for k, v in g.items()]
    path = tmp_path / f"{shape}.conf"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _main_out(capsys, main, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("mode", ["pull", "push"])
def test_dmc_sim_main_equals_jax(tmp_path, capsys, mode):
    """The CLI with every reporting flag: stdout equal but for the wall
    clock, the --trace JSONL byte for byte, the Chrome trace of the same
    spans, and the metrics dump's families."""
    conf = _write_conf(tmp_path, "multi_server")
    common = ["-c", conf, "--seed", "3", "--server-mode", mode,
              "--intervals", "--conformance", "--ledger-check",
              "--slo-check"]
    runs = {}
    for who, main, extra in (
            ("port", tdmc.main, ["--device", "cpu"]),
            ("jax", jdmc.main, ["--model", "dmclock-tpu"])):
        paths = {k: str(tmp_path / f"{who}.{k}")
                 for k in ("jsonl", "json", "metrics.json")}
        rc, out = _main_out(capsys, main, common + extra + [
            "--trace", paths["jsonl"], "--trace-out", paths["json"],
            "--metrics-out", paths["metrics.json"]])
        assert rc == 0
        runs[who] = (out, paths)
    (pout, pp), (jout, jp) = runs["port"], runs["jax"]
    assert stable(pout) == stable(jout)
    assert "# trace-check: ok" in pout
    assert Path(pp["jsonl"]).read_bytes() == Path(jp["jsonl"]).read_bytes()
    assert ttrace.validate_trace_file(pp["jsonl"]) == \
        jtrace.validate_trace_file(jp["jsonl"])
    a = texport.validate_chrome_trace(pp["json"])
    b = jexport.validate_chrome_trace(jp["json"])
    assert (a["events"], a["tids"], a["cat_count"]) == \
        (b["events"], b["tids"], b["cat_count"])
    names = [sorted((r["name"], r["cat"]) for r in m.load_rows(p["json"]))
             for m, p in ((texport, pp), (jexport, jp))]
    assert names[0] == names[1]
    pm = json.loads(Path(pp["metrics.json"]).read_text())
    jm = json.loads(Path(jp["metrics.json"]).read_text())
    assert sorted(pm) == sorted(jm)


def test_ssched_sim_main_equals_jax(tmp_path, capsys):
    conf = _write_conf(tmp_path, "100th")
    rc, pout = _main_out(capsys, tssched.main,
                         ["-c", conf, "--device", "cpu", "--conformance",
                          "--ledger-check", "--slo-check"])
    assert rc == 0
    rc, jout = _main_out(capsys, jssched.main,
                         ["-c", conf, "--conformance", "--ledger-check",
                          "--slo-check"])
    assert rc == 0
    assert stable(pout) == stable(jout)
    assert "no backend exposes a conformance ledger" in pout


def test_dmc_sim_main_refuses_by_name(tmp_path, capsys):
    conf = _write_conf(tmp_path, "multi_server")
    for argv, what in ((["--use-prop-heap"], "dmclock-native"),
                       (["--model", "dmclock", "--use-prop-heap"],
                        "dmclock-native"),
                       (["--model", "nope"], "unknown scheduler model")):
        with pytest.raises(SystemExit) as e:
            tdmc.main(["-c", conf, "--device", "cpu"] + argv)
        assert e.value.code == 2
        assert what in capsys.readouterr().err


def test_dmc_sim_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    conf = _write_conf(tmp_path, "multi_server")
    with pytest.raises(RuntimeError, match="cuda"):
        tdmc.main(["-c", conf])
    with pytest.raises(RuntimeError, match="cuda"):
        tdmc.run_sim(make_cfg(tcfg, "multi_server"), model="ssched")


# ----------------------------------------------------------------------
# obs.trace and obs.trace_export
# ----------------------------------------------------------------------

_ROWS = [(5, 0, 1, 0, 1, None, None, None, None),
         (7, 1, "c2", 1, 3, (10, 20, 30), 4, 2, 0),
         (9, 0, 1, 1, 2, None, -3, None, 7)]


def _write_trace(mod, path, limit):
    with mod.DecisionTrace(str(path), limit=limit) as tr:
        for t, s, c, ph, cost, tag, m, d, g in _ROWS:
            tr.record(t, s, c, ph, cost, tag=tag, margin=m,
                      eligible_depth=d, gate=g)
    return tr


@pytest.mark.parametrize("limit", [10, 2])
def test_decision_trace_equals_jax(tmp_path, limit):
    a = _write_trace(ttrace, tmp_path / "a.jsonl", limit)
    b = _write_trace(jtrace, tmp_path / "b.jsonl", limit)
    assert (a.rows_written, a.rows_dropped) == \
        (b.rows_written, b.rows_dropped)
    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    assert Path(pa).read_bytes() == Path(pb).read_bytes()
    assert ttrace.load_trace(pa) == jtrace.load_trace(pb)
    assert ttrace.validate_trace_file(pa) == jtrace.validate_trace_file(pb)
    per = ttrace.validate_trace_file(pa)["per_phase"]
    pair = (per["reservation"], per["priority"])
    assert ttrace.summarize(pa, pair) == jtrace.summarize(pb, pair)
    assert ttrace.summarize(pa, {"decisions_reservation": pair[0],
                                 "decisions_priority": pair[1]}) == \
        jtrace.summarize(pb, {"decisions_reservation": pair[0],
                              "decisions_priority": pair[1]})
    with pytest.raises(ValueError, match="diverge"):
        ttrace.summarize(pa, (pair[0] + 1, pair[1]))


def test_trace_schema_errors_equal_jax(tmp_path):
    bad = tmp_path / "bad.jsonl"
    for text in ('{"t": 1}\n', 'not json\n',
                 '{"t":1,"server":0,"client":0,"phase":"x","cost":1,'
                 '"tag":null}\n'):
        bad.write_text(text)
        with pytest.raises(ValueError) as ea:
            ttrace.load_trace(str(bad))
        with pytest.raises(ValueError) as eb:
            jtrace.load_trace(str(bad))
        assert str(ea.value) == str(eb.value)


_SPANS = [
    {"name": "sim.pull", "cat": "dispatch", "ts": 1000, "dur": 5000,
     "tid": 1, "args": {"server": 0}},
    {"name": "sim.add", "cat": "ingest", "ts": 1500, "dur": 1000,
     "tid": 1},
    {"name": "sim.add", "cat": "ingest", "ts": 7000, "dur": 250,
     "tid": 2},
]


def test_chrome_export_equals_jax(tmp_path):
    assert texport.chrome_events(_SPANS) == jexport.chrome_events(_SPANS)
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    meta = {"run": "x"}
    assert texport.export_chrome_trace(_SPANS, str(pa), metadata=meta) == \
        jexport.export_chrome_trace(_SPANS, str(pb), metadata=meta)
    assert pa.read_bytes() == pb.read_bytes()
    assert texport.validate_chrome_trace(str(pa)) == \
        jexport.validate_chrome_trace(str(pb))
    assert texport.load_rows(str(pa)) == jexport.load_rows(str(pb))
    assert texport.rows_self_times(_SPANS) == jexport.rows_self_times(_SPANS)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "a", "cat": "ingest", "ph": "X", "ts": 0, "dur": 10},
        {"name": "b", "cat": "ingest", "ph": "X", "ts": 5, "dur": 10}]}))
    with pytest.raises(ValueError) as ea:
        texport.validate_chrome_trace(str(bad))
    with pytest.raises(ValueError) as eb:
        jexport.validate_chrome_trace(str(bad))
    assert str(ea.value) == str(eb.value)
