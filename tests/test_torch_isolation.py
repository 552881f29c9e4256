"""The port stands alone: no JAX, nothing of the JAX package, and no
silent fallback from CUDA to the CPU."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import state as tstate

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dmclock_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_serve_profile.py",
     ROOT / "scripts" / "torch_run_fullscale.py",
     ROOT / "scripts" / "torch_silicon_parity.py"] + \
    [ROOT / "scripts" / f"torch_{name}.py"
     for name in ("run_sweeps", "trace_report", "slo_report", "explain",
                  "bench_guard", "profile_fastpath", "serial_walls",
                  "group_walls", "k3_scaling")]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "dmclock_tpu", "bench",
                   "__graft_entry__", "profile_util")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_serve_leaves_jax_unloaded():
    code = ("import sys\n"
            "from dmclock_tpu_torch.serve import serve_only\n"
            "r = serve_only(64, 8, 32, 2, 1, device='cpu')\n"
            "assert int(r.count.sum()) > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_bench_session_leaves_jax_unloaded():
    """``python -m dmclock_tpu_torch.bench`` on the CPU ends with no JAX,
    no JAX package and no JAX repo ``bench`` module loaded."""
    code = ("import sys, runpy\n"
            "sys.argv = ['bench', '--mode', 'serve', '--device', 'cpu']\n"
            "try:\n"
            "    runpy.run_module('dmclock_tpu_torch.bench',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu', 'bench'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    # the session's history record: checked, then taken out of the tree
    recorded = re.findall(r"^# recorded (\S+)$", out.stderr, re.M)
    for rel in recorded:
        (ROOT / rel).unlink()
    assert out.returncode == 0, out.stderr
    assert '"vs_baseline"' in out.stdout
    assert len(recorded) == 1 and \
        recorded[0].startswith("dmclock_tpu_torch/_history/bench_")


def _script_inputs(tmp: Path) -> dict:
    """Small inputs for the report tools and the guard, made by the port:
    a span trace, an SLO log, a decision trace and a history record."""
    import json

    from dmclock_tpu_torch.obs import slo as tslo
    from dmclock_tpu_torch.obs import spans as tspans
    from dmclock_tpu_torch.obs import trace as ttrace
    from dmclock_tpu_torch.obs import trace_export as texport

    tr = tspans.SpanTracer()
    for _ in range(3):
        with tspans.span(tr, "bench.round", "dispatch"):
            with tspans.span(tr, "epoch.batch", "device_compute"):
                pass
    texport.export_chrome_trace(tr, str(tmp / "trace.json"))
    plane = tslo.SloPlane(2, dt_epoch_ns=10**8, ring_depth=4)
    plane.register(0, 5.0, 1.0, 0.0)
    block = plane.stamp(tslo.window_zero(2, "cpu"))
    block[0, tslo.W_OPS] += 3
    _, closed = plane.roll(block, 0, 4,
                           depth=torch.zeros(2, dtype=torch.int32))
    plane.export_jsonl(str(tmp / "slo.jsonl"), closed)
    with ttrace.DecisionTrace(str(tmp / "decisions.jsonl")) as dt:
        dt.record(10, 0, 0, 0, 1)
    (tmp / "history").mkdir()
    (tmp / "history" / "bench_1000.json").write_text(json.dumps(
        {"platform": "cuda", "device": "card", "fault_plan": "none",
         "workloads": {"serve": {"dps": 1e7}}}))
    return {"trace": tmp / "trace.json", "slo": tmp / "slo.jsonl",
            "decisions": tmp / "decisions.jsonl",
            "history": tmp / "history"}


SCRIPT_RUNS = {
    "run_sweeps": ["--cut", "--skip-km", "--calendar", "--device", "cpu"],
    "trace_report": ["{trace}", "--diff", "{trace}"],
    "slo_report": ["{slo}", "--diff", "{slo}"],
    "explain": ["--slo", "{slo}", "--client", "0", "--trace",
                "{decisions}"],
    "bench_guard": [],
    "profile_fastpath": ["--n", "128", "--k", "32", "--reps", "1",
                         "--rows", "component", "--device", "cpu"],
    "serial_walls": ["--device", "cpu", "--rows", "queue,dmc_sim,dryrun",
                     "--queue-n", "200", "--sim-ops", "5",
                     "--dryrun-clients", "30"],
}


@pytest.mark.parametrize("name", sorted(SCRIPT_RUNS))
def test_new_scripts_leave_jax_unloaded(tmp_path, name):
    """Each of the port's scripts run as ``python scripts/torch_<name>.py``
    on the CPU exits 0 with no JAX, no JAX package and no ``bench`` or
    ``profile_util`` module loaded (the guard over a history directory
    of one record)."""
    paths = _script_inputs(tmp_path)
    argv = [a.format(**paths) for a in SCRIPT_RUNS[name]]
    script = ROOT / "scripts" / f"torch_{name}.py"
    # the guard parses sys.argv itself and reads its module's HISTORY
    call = ("main.__globals__['HISTORY'] = pathlib.Path("
            f"{str(paths['history'])!r})\nrc = main()\n"
            if name == "bench_guard" else "rc = main(sys.argv[1:])\n")
    code = ("import pathlib, runpy, sys\n"
            f"sys.argv = [{str(script)!r}] + {argv!r}\n"
            "main = runpy.run_path(sys.argv[0])['main']\n"
            + call +
            "assert rc == 0, rc\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu', 'bench', 'profile_util'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip()


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tstate.init_state(4, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.serve_only(8, 4, 4, 1, 1)


def test_cfg4_leaves_jax_unloaded():
    code = ("import sys\n"
            "from dmclock_tpu_torch.serve import serve_cfg4\n"
            "r = serve_cfg4(32, 1, device='cpu')\n"
            "assert int(r.count.sum()) > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.serve_cfg4(8, 1)


def test_chain_and_knobs_leave_jax_unloaded():
    """The chain entry point and the radix / int32-carry knobs load no
    JAX either, and default to the card."""
    code = ("import sys\n"
            "from dmclock_tpu_torch import serve\n"
            "r = serve.serve_chain(64, 8, 32, 2, 1, device='cpu')\n"
            "assert int(r.count.sum()) > 0\n"
            "r = serve.serve_only(64, 8, 32, 2, 1, select_impl='radix',\n"
            "                     tag_width=32, device='cpu')\n"
            "assert int(r.count.sum()) > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.serve_chain(8, 4, 4, 1, 1)
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.high_rate_state(8, 4)


def test_queue_api_leaves_jax_unloaded():
    """The pull and push queues and the queue workload load no JAX, and
    default to the card."""
    code = ("import sys\n"
            "from dmclock_tpu_torch.core.qos import ClientInfo\n"
            "from dmclock_tpu_torch.core.recs import ReqParams\n"
            "from dmclock_tpu_torch.engine.queue import "
            "TpuPullPriorityQueue\n"
            "from dmclock_tpu_torch.engine.push_queue import "
            "TpuPushPriorityQueue\n"
            "q = TpuPullPriorityQueue(lambda c: ClientInfo(1, 1, 0),\n"
            "                         speculative_batch=4, device='cpu')\n"
            "for i in range(8):\n"
            "    q.add_request(i, i % 3, ReqParams(), time_ns=10**9)\n"
            "assert q.pull_request(2 * 10**9).is_retn()\n"
            "assert len(q.pull_batch(2 * 10**9, 4)) == 4\n"
            "got = []\n"
            "p = TpuPushPriorityQueue(lambda c: ClientInfo(0, 1, 0),\n"
            "                         lambda: True,\n"
            "                         lambda *a: got.append(a),\n"
            "                         now_ns_f=lambda: 10**9,\n"
            "                         sched_at_f=lambda t: None,\n"
            "                         device='cpu')\n"
            "p.add_request('r', 1, ReqParams())\n"
            "assert len(got) == 1\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if not torch.cuda.is_available():
        from dmclock_tpu_torch.core.qos import ClientInfo
        from dmclock_tpu_torch.engine.push_queue import TpuPushPriorityQueue

        with pytest.raises(RuntimeError, match="cuda"):
            TpuPushPriorityQueue(lambda c: ClientInfo(0, 1, 0),
                                 lambda: True, lambda *a: None)
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.serve_queue(8)
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.virtual_server("push", 8)


def test_churn_row_leaves_jax_unloaded():
    """Bench's churn row on the port (the lifecycle plane, the guarded
    epoch, the registry and its HTTP endpoint, the SLO evaluator) loads
    no JAX, and defaults to the card."""
    code = ("import sys\n"
            "from dmclock_tpu_torch.serve import churn_row\n"
            "r = churn_row(total_ids=32, epochs=8, k=16, device='cpu')\n"
            "assert r['decisions'] > 0 and r['boost']['http']\n"
            "import dmclock_tpu_torch.lifecycle, dmclock_tpu_torch.utils\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if not torch.cuda.is_available():
        from dmclock_tpu_torch.lifecycle import run_serial_churn

        with pytest.raises(RuntimeError, match="cuda"):
            tserve.churn_row(total_ids=8, epochs=1)
        with pytest.raises(RuntimeError, match="cuda"):
            run_serial_churn({"capacity0": 2}, epochs=1)


def test_supervisor_and_spawn_child_leave_jax_unloaded(tmp_path):
    """A supervised job in spawn mode loads no JAX in the parent, and the
    child's entry point (``_child_main``, what ``python -m
    dmclock_tpu_torch.robust.supervisor <workdir>`` runs) loads none
    either; the supervisor defaults to the card."""
    job = ("EpochJob(n=32, depth=4, ring=8, epochs=2, m=2, k=8, "
           "ckpt_every=1, with_hists=True, with_slo=True)")
    check = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'dmclock_tpu'))\n"
             "assert not bad, bad\n")
    parent = ("import sys\n"
              "from dmclock_tpu_torch.robust.supervisor import (\n"
              "    EpochJob, run_supervised)\n"
              "from dmclock_tpu_torch.robust.host_faults import "
              "HostFaultPlan\n"
              f"r = run_supervised({job}, {str(tmp_path / 'a')!r},\n"
              "    HostFaultPlan(kill_at_decisions=(1,)), mode='spawn',\n"
              "    device='cpu')\n"
              "assert r.restarts == 1 and r.decisions > 0\n" + check)
    out = subprocess.run([sys.executable, "-c", parent], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    wd = tmp_path / "b"
    child = ("import json, os, sys\n"
             "from dmclock_tpu_torch.robust import supervisor as S\n"
             f"os.makedirs({str(wd)!r})\n"
             f"json.dump(dict(job=S.{job}.to_json(), plan={{}}, "
             "device='cpu'),\n"
             f"          open(os.path.join({str(wd)!r}, S.JOB_FILE), 'w'))\n"
             f"assert S._child_main({str(wd)!r}) == 0\n" + check)
    out = subprocess.run([sys.executable, "-c", child], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (wd / "result.json").exists()
    if not torch.cuda.is_available():
        from dmclock_tpu_torch.robust import supervisor as S

        with pytest.raises(RuntimeError, match="cuda"):
            S.run_job(S.EpochJob(n=8, depth=2, ring=4, epochs=1))
        with pytest.raises(RuntimeError, match="cuda"):
            S.run_supervised(S.EpochJob(n=8, depth=2, ring=4, epochs=1),
                             tmp_path / "c")


_SMALL_CONF = ("[global]\nclient_groups = 1\nserver_groups = 1\n"
               "server_random_selection = true\n"
               "[client.0]\nclient_count = 4\nclient_total_ops = 20\n"
               "client_iops_goal = 100\nclient_outstanding_ops = 8\n"
               "client_reservation = 10.0\nclient_limit = 0.0\n"
               "client_server_select_range = 2\n"
               "[server.0]\nserver_count = 2\nserver_iops = 160\n")


def _imported(stderr: str) -> set:
    """Module names from ``python -X importtime``'s report."""
    out = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            out.add(line.rsplit("|", 1)[1].strip())
    return out


@pytest.mark.parametrize("module, extra", [
    ("dmclock_tpu_torch.sim.dmc_sim", ["--ledger-check", "--slo-check"]),
    ("dmclock_tpu_torch.sim.dmc_sim", ["--server-mode", "push"]),
    ("dmclock_tpu_torch.sim.ssched_sim", []),
    ("dmclock_tpu_torch.sim.device_sim", ["--slices-per-launch", "16"]),
    ("dmclock_tpu_torch.sim.dmc_sim", ["--model", "dmclock"]),
    ("dmclock_tpu_torch.sim.dmc_sim", ["--model", "dmclock-delayed",
                                       "--server-mode", "push"]),
], ids=["dmc_sim", "dmc_sim_push", "ssched_sim", "device_sim",
        "dmc_sim_oracle", "dmc_sim_oracle_push"])
def test_sim_clis_leave_jax_unloaded(tmp_path, module, extra):
    """``python -m`` of each simulator CLI on the CPU runs to its report
    and imports no JAX and nothing of the JAX package (the interpreter's
    own import report, ``-X importtime``, lists every module loaded)."""
    conf = tmp_path / "small.conf"
    conf.write_text(_SMALL_CONF)
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", module, "-c", str(conf),
         "--device", "cpu"] + extra,
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "total ops: 80" in out.stdout
    mods = _imported(out.stderr)
    assert module in mods or "dmclock_tpu_torch.sim" in mods
    bad = sorted(m for m in mods if _forbidden(m))
    assert not bad, bad


def test_sim_entry_points_default_to_the_card(tmp_path):
    """Without a card, every simulator entry point's default device
    raises; none moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from dmclock_tpu_torch.sim import device_sim, dmc_sim, ssched_sim
    from dmclock_tpu_torch.sim.config import parse_config_file

    conf = tmp_path / "small.conf"
    conf.write_text(_SMALL_CONF)
    for main in (dmc_sim.main, ssched_sim.main, device_sim.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["-c", str(conf)])
    cfg = parse_config_file(str(conf))
    with pytest.raises(RuntimeError, match="cuda"):
        dmc_sim.run_sim(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        device_sim.run_device_sim(cfg)


def test_mesh_row_and_cluster_leave_jax_unloaded():
    code = ("import sys\n"
            "from dmclock_tpu_torch import serve\n"
            "r = serve.mesh_row(128, n_shards=2, epochs=2, warmup_epochs=2,"
            " chunk=2, fault_spec={'seed': 3, 'p_dropout': 0.3},"
            " device='cpu')\n"
            "assert r['decisions'] > 0\n"
            "o = serve.cluster_outage(2, 12, steps=2, decisions_per_step=4,"
            " device='cpu')\n"
            "assert o['served'] > 0\n"
            "from dmclock_tpu_torch.obs import capacity\n"
            "assert capacity.projected_hbm(256, ring=16, engine='prefix',"
            " m=2, k=8) > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_mesh_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from dmclock_tpu_torch.parallel import cluster as TCL
    from dmclock_tpu_torch.parallel import mesh as TM

    for call in (lambda: TCL.make_mesh(2),
                 lambda: TCL.init_cluster(2, 4),
                 lambda: TCL.init_mesh_views(2, 4),
                 lambda: TM.counter_init(2, 4),
                 lambda: tserve.mesh_row(64, n_shards=2),
                 lambda: tserve.multichip_policy(2, 6),
                 lambda: tserve.cluster_outage(2, 6)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_supervised_mesh_leaves_jax_unloaded():
    code = ("import sys\n"
            "from dmclock_tpu_torch.robust import supervisor as TS\n"
            "from dmclock_tpu_torch.lifecycle import make_spec\n"
            "job = TS.EpochJob(engine_loop='mesh', n_shards=2, n=64,"
            " epochs=4, ckpt_every=2, fault_plan='seed=7,p_dropout=0.2')\n"
            "r = TS.run_job(job, device='cpu')\n"
            "assert r.decisions > 0 and r.mesh_counters.shape[1] == 2\n"
            "spec = make_spec('flash_crowd', total_ids=32)\n"
            "r = TS.run_job(TS.EpochJob(engine_loop='mesh', n_shards=2,"
            " n=64, epochs=4, ckpt_every=2, churn=spec, placement='p2c'),"
            " device='cpu')\n"
            "assert r.placement == 'p2c'\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_supervised_mesh_and_calibration_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from dmclock_tpu_torch.robust import supervisor as TS

    job = TS.EpochJob(engine_loop="mesh", n_shards=2, n=64, epochs=2)
    for call in (lambda: TS.run_job(job),
                 lambda: TS.run_supervised(job, tmp_path / "wd"),
                 lambda: tserve.sustained_prepare("cfg3", 64, 1),
                 lambda: tserve.cfg4_setup(64, 1),
                 lambda: tserve.sustained_start("cfg3", 64)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_sustained_row_watchdog_and_oracle_leave_jax_unloaded(tmp_path):
    """The sustained row CLI with its watchdog, the frontier, the
    publishers, the oracle queues and the native binding load no JAX."""
    out = tmp_path / "conf.jsonl"
    code = ("import sys, json, io, contextlib\n"
            "from dmclock_tpu_torch import serve\n"
            "buf = io.StringIO()\n"
            "with contextlib.redirect_stdout(buf):\n"
            "    rc = serve.main(['--workload', 'cfg4', '--n', '64',"
            " '--rounds', '2', '--rounds-lo', '0', '--latency-rounds', '4',"
            f" '--conformance-out', {str(out)!r}, '--spans',"
            " '--device', 'cpu'])\n"
            "row = json.loads(buf.getvalue().splitlines()[-1])\n"
            "assert rc == 0 and row['decisions'] > 0, row\n"
            "assert row['latency_samples'] == 4\n"
            "pick, rows = serve.frontier(((2, 8),), n=64, rounds=2,"
            " rounds_lo=0, reps=1, latency_rounds=4,"
            " target_latency_ms=1e9, device='cpu')\n"
            "assert pick['met_budget'] in (True, False)\n"
            "from dmclock_tpu_torch.obs import watchdog, histograms\n"
            "from dmclock_tpu_torch.core import PullPriorityQueue,"
            " ClientInfo, ReqParams\n"
            "q = PullPriorityQueue(lambda c: ClientInfo(1, 1, 0),"
            " run_gc_thread=False)\n"
            "q.add_request(0, 0, ReqParams(), time_ns=0)\n"
            "assert q.pull_request(10**9).tag is not None\n"
            "from dmclock_tpu_torch import native, models\n"
            "native.load_library()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(out.read_text().splitlines()) == 64


def test_sustained_row_and_frontier_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    for call in (lambda: tserve.sustained_row("cfg3", 64, rounds=1,
                                              rounds_lo=0),
                 lambda: tserve.frontier(((2, 8),), n=64, rounds=1,
                                         rounds_lo=0, reps=1,
                                         latency_rounds=0),
                 lambda: tserve.scalar_latency()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_control_and_net_are_in_the_source_scan():
    """The controller and the RPC front end are among the scanned files
    (the scan walks the whole package)."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for name in ("control/__init__.py", "control/policy.py",
                 "control/journal.py", "control/signals.py",
                 "net/framing.py", "net/faults.py", "net/journal.py",
                 "net/client.py", "net/server.py", "net/serve.py",
                 "net/loadgen.py", "obs/rpc.py"):
        assert f"dmclock_tpu_torch/{name}" in scanned, name


def test_run_serve_and_controller_leave_jax_unloaded():
    """The RPC serving loop (live over loopback, then its replay) and a
    controller-on mesh job with migration on the CPU load no JAX."""
    code = ("import sys, threading, dataclasses\n"
            "from dmclock_tpu_torch.net.serve import RpcServeConfig, "
            "make_server, run_serve\n"
            "from dmclock_tpu_torch.net import loadgen\n"
            "cfg = RpcServeConfig(n=8, depth=2, ring=8, epochs=4, m=2, "
            "k=8, waves=2, ckpt_every=2, wait_ops=1, device='cpu')\n"
            "srv = make_server(cfg).start()\n"
            "sc = loadgen.full_schedule(3, workers=1, requests=6, "
            "n_clients=8, max_nops=2)[0]\n"
            "t = threading.Thread(target=loadgen.run_worker, "
            "args=('127.0.0.1', srv.port, sc))\n"
            "t.start(); t.join()\n"
            "live = run_serve(cfg, server=srv); srv.stop()\n"
            "assert live['decisions'] > 0\n"
            "from dmclock_tpu_torch.lifecycle import make_spec\n"
            "from dmclock_tpu_torch.robust import supervisor as S\n"
            "spec = make_spec('shard_skew', total_ids=64, seed=3, "
            "cold_frac=0.5, cold_until=10**9)\n"
            "r = S.run_job(S.EpochJob(engine_loop='mesh', n_shards=4, "
            "n=96, depth=6, ring=10, epochs=8, m=2, k=16, seed=5, "
            "arrival_lam=1.0, waves=2, churn=spec, placement='p2c', "
            "controller=dict(sync_max=1, backlog_hi=10**9, occ_lo=0.0, "
            "hysteresis=1, cooldown=8, migrate_skew_hi=1.5, "
            "migrate_pick='cold')), device='cpu')\n"
            "assert r.migrations > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_run_serve_and_rows_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from dmclock_tpu_torch.net.serve import RpcServeConfig, run_serve

    assert RpcServeConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_serve(RpcServeConfig(n=8, epochs=2), trace=[[[0] * 8] * 2])
    for call in (lambda: tserve.controller_row(("diurnal",), total_ids=32,
                                               epochs=4, sides="on"),
                 lambda: tserve.mesh_rebalance_row(total_ids=16,
                                                   epochs=4)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_the_mesh_across_devices_leaves_jax_unloaded(tmp_path):
    """The grouped entry points (a layout of device groups on the CPU)
    and both module CLIs' ``--devices`` import no JAX."""
    code = ("import sys\n"
            "from dmclock_tpu_torch import serve\n"
            "from dmclock_tpu_torch.parallel import cluster, groups, mesh\n"
            "from dmclock_tpu_torch.robust import supervisor as TS\n"
            "from dmclock_tpu_torch.sim import device_sim as DS\n"
            "m = cluster.make_mesh(4, devices=('cpu',) * 2)\n"
            "assert m.grouped\n"
            "r = serve.mesh_row(256, n_shards=4, epochs=2, warmup_epochs=2,"
            " chunk=2, devices=('cpu',) * 4)\n"
            "assert r['decisions'] > 0 and r['n_groups'] == 4\n"
            "p = serve.multichip_policy(2, 12, decisions_per_step=4, "
            "rounds=1, drain_rounds=1, check_qos=False, "
            "devices=('cpu', 'cpu'))\n"
            "assert p['served'] > 0\n"
            "j = TS.run_job(TS.EpochJob(engine_loop='mesh', n_shards=2, n=32,"
            " epochs=2, devices=('cpu', 'cpu')), device='cpu')\n"
            "assert j.decisions > 0\n"
            "_, sim, spec = DS.headline_setup(16, device='cpu')\n"
            "sim = DS.device_sim_step(sim, spec, 1, mesh=cluster.make_mesh("
            "spec.n_servers, devices=('cpu',) * 2))\n"
            "assert groups.is_grouped(sim.engine)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmclock_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for args in (["-m", "dmclock_tpu_torch.serve", "--workload", "mesh",
                  "--n-shards", "2", "--clients", "128", "--devices",
                  "cpu,cpu"],
                 ["-m", "dmclock_tpu_torch.sim.device_sim", "-c",
                  "configs/dmc_sim_example.conf", "--max-launches", "1",
                  "--slices-per-launch", "2", "--devices", "cpu"]):
        out = subprocess.run([sys.executable, *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr


def test_the_mesh_across_devices_defaults_to_the_cards():
    """``devices=None`` means every visible card and raises without
    one; a named card past the visible count raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from dmclock_tpu_torch.device import resolve_devices
    from dmclock_tpu_torch.parallel import cluster as TCL
    from dmclock_tpu_torch.robust import supervisor as TS
    from dmclock_tpu_torch.sim import device_sim as TDS

    for call in (lambda: TCL.make_mesh(4),
                 lambda: resolve_devices(None),
                 lambda: resolve_devices(4),
                 lambda: resolve_devices(("cuda:3",)),
                 lambda: tserve.mesh_row(64, n_shards=2,
                                         devices=("cuda:0", "cuda:1")),
                 lambda: tserve.multichip_policy(2, 6, devices=2),
                 lambda: tserve.plan_mesh_shards(64, devices=None,
                                                 device="cuda"),
                 lambda: TDS.run_device_sim(TDS.headline_config(16),
                                            devices=2),
                 lambda: TS.run_job(TS.EpochJob(
                     engine_loop="mesh", n_shards=2, n=16, epochs=2,
                     devices=("cuda:0", "cuda:1")), device="cpu")):
        with pytest.raises(RuntimeError, match="cuda|CUDA"):
            call()
