"""The port's entry scripts, ``scripts/torch_run_fullscale.py`` and
``scripts/torch_silicon_parity.py``, on the CPU against the JAX repo's
``scripts/run_fullscale.py`` and ``scripts/silicon_parity.py``.

Held: a MULTICHIP record written at a tiny shape (4 shards over two CPU
groups, the cut dry run, the rebalance row) that the JAX
``load_multichip`` reads with ``ok`` true, with the JAX record's keys
and the same normalized view from both readers; the acceptance-config
parity on a scaled copy of ``configs/dmc_sim_example.conf``, its trace
equal to the JAX oracle's; the cluster parity against the port's host
loop at a small shape for both tracker kinds; the silicon gate's scaled
shapes equal to the JAX script's field for field, one shape's trace
equal to the JAX oracle's, and a forced divergence leaving ``match:
false`` in the report and the gate failing."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name.replace("/", "_"), ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TFS = _script("torch_run_fullscale")
JFS = _script("run_fullscale")
TSP = _script("torch_silicon_parity")
JSP = _script("silicon_parity")
CPU = torch.device("cpu")


def test_record_reads_in_the_jax_loader(tmp_path, capsys):
    rec = tmp_path / "multichip.json"
    rc = TFS.main(["--record", str(rec), "--configs", "",
                   "--cluster", "off", "--n-devices", "4",
                   "--clients", "2048", "--dryrun-clients", "60",
                   "--dryrun-k", "64", "--rebalance", "on",
                   "--device", "cpu", "--devices", "cpu,cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["record"] == str(rec)
    raw = json.loads(rec.read_text())
    want = JFS.load_multichip(str(rec))
    got = TFS.load_multichip(str(rec))
    assert set(raw) == set(want) == set(got)
    assert want == got
    assert want["schema"] == 3 and want["ok"] and want["rc"] == 0
    assert want["n_devices"] == 4 and want["mesh"]["n_shards"] == 4
    assert want["mesh"]["n_groups"] == 2
    assert want["rebalance"]["migrations"] > 0
    dry = json.loads(raw["tail"])
    assert dry["workload"] == "multichip" and dry["servers"] == 4
    assert [p["tracker"] for p in dry["policies"]] == ["orig", "borrowing"]
    # the old records still read
    for old in sorted(ROOT.glob("MULTICHIP_r0*.json")):
        assert TFS.load_multichip(str(old)) == JFS.load_multichip(str(old))


def _scaled_example(tmp_path) -> Path:
    text = (ROOT / "configs" / "dmc_sim_example.conf").read_text()
    text = text.replace("client_total_ops = 2000",
                        "client_total_ops = 40")
    path = tmp_path / "example_scaled.conf"
    path.write_text(text)
    return path


def test_sim_parity_equals_the_jax_oracle(tmp_path):
    from dmclock_tpu.sim.config import parse_config_file as jparse
    from dmclock_tpu.sim.dmc_sim import run_sim as jrun

    conf = _scaled_example(tmp_path)
    n = TFS.sim_parity(str(conf), CPU)
    want = jrun(jparse(str(conf)), model="dmclock-delayed", seed=12345,
                record_trace=True)
    assert n == len(want.trace) > 0

    from dmclock_tpu_torch.sim.config import parse_config_file
    from dmclock_tpu_torch.sim.dmc_sim import run_sim

    got = run_sim(parse_config_file(str(conf)), model="dmclock-torch",
                  seed=12345, record_trace=True, device="cpu")
    assert [tuple(map(int, t)) for t in got.trace] == \
        [tuple(map(int, t)) for t in want.trace]


@pytest.mark.parametrize("kind", ["orig", "borrowing"])
def test_cluster_parity_small(kind):
    n = TFS.cluster_parity(kind, CPU, n_servers=8, n_clients=24,
                           rounds=3, k=40, max_arr=2, seed=53)
    assert n > 0


def test_silicon_shapes_equal_jax():
    got, want = TSP.make_shapes(), JSP.make_shapes()
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_n, a), (_m, b) in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_silicon_trace_equals_the_jax_oracle():
    from dmclock_tpu.sim.dmc_sim import run_sim as jrun
    from dmclock_tpu_torch.sim.dmc_sim import run_sim

    (_n, tcfg), (_m, jcfg) = TSP.make_shapes()[1], JSP.make_shapes()[1]
    assert TSP.trace_parity("100th", tcfg, CPU) > 0
    got = run_sim(tcfg, model="dmclock-torch", seed=7, record_trace=True,
                  device="cpu")
    want = jrun(jcfg, model="dmclock-delayed", seed=7, record_trace=True)
    assert [tuple(map(int, t)) for t in got.trace] == \
        [tuple(map(int, t)) for t in want.trace]


def test_silicon_gate_report_and_divergence(tmp_path, monkeypatch):
    artifact = (ROOT / "SILICON_PARITY.json").read_bytes()
    out = tmp_path / "parity.json"
    shape = TSP.make_shapes()[1:2]
    rep = TSP.run(out, "cpu", shapes=shape)
    assert rep["match"] and json.loads(out.read_text()) == rep
    assert [s["name"] for s in rep["shapes"]] == ["100th",
                                                  "calendar-vs-serial"]
    assert rep["platform"] == "cpu" and rep["total_decisions"] > 500

    from dmclock_tpu_torch.sim import dmc_sim

    real = dmc_sim.run_sim

    def diverging(cfg, model="dmclock-torch", **kw):
        sim = real(cfg, model=model, **kw)
        if model == "dmclock-torch":
            t = sim.trace[5]
            sim.trace[5] = (t[0] + 1,) + tuple(t[1:])
        return sim

    monkeypatch.setattr(dmc_sim, "run_sim", diverging)
    with pytest.raises(AssertionError, match="diverges at op 5"):
        TSP.main(["--out", str(out), "--device", "cpu"])
    bad = json.loads(out.read_text())
    assert bad["match"] is False and "diverges at op 5" in bad["error"]
    assert (ROOT / "SILICON_PARITY.json").read_bytes() == artifact
