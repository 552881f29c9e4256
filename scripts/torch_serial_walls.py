"""Wall times of the port's serial-engine paths, for one tree of it.

The serial engine (``engine/kernels.py`` ``engine_run``) is what the
pull queue, the simulators and the cluster run.  This script times those
paths end to end and prints one JSON line.  It imports
``dmclock_tpu_torch`` from ``--root`` (default: the checkout it lies in),
so the same file times another tree unpacked beside it (``git archive``
of a parent commit), and both can be compared in one call.

Rows (``--rows``, comma-separated):

- ``queue``: ``serve.serve_queue(--queue-n)``, the ``queue`` cell: the
  bulk load's adds/s, two ``pull_batch(2048)``'s decisions/s, the
  stream, 512 ``pull_request``s' pulls/s.
- ``dmc_sim``: ``sim/dmc_sim.py`` ``--model dmclock-torch`` on
  ``configs/dmc_sim_example.conf`` (pull mode) and
  ``configs/dmc_sim_8_6.conf`` (push mode), every ``client_total_ops``
  cut to ``--sim-ops`` (0: the configs whole); wall and decisions/s.
- ``dryrun``: ``serve.multichip_row`` at 8 servers x 10,000 clients, 32
  decisions a step, 1 + 1 closed-loop rounds and 1 drain round, both
  trackers, then ``serve.cluster_outage`` (3 steps): ``chip_smoke.py``'s
  cut of the cluster dry run.
- ``dryrun_full``: the dry run at its depth (1,024 decisions a step, 2 +
  6 rounds, 4 drain rounds), both trackers.
- ``fullscale``: ``scripts/torch_run_fullscale.py``'s ``cluster_parity``
  under OrigTracker: 8 servers x 1,000 clients x 10 rounds of k=1,100,
  each decision held against a host loop of oracle queues.

Usage::

    python scripts/torch_serial_walls.py [--root DIR] [--rows queue,dmc_sim]
        [--device cuda|cpu] [--sim-ops 50] [--queue-n 10000]
        [--dryrun-clients 10000]

Without ``--device`` the rows run on the card; ``--device cpu`` times the
same rows on the host (a CPU twin).  The line carries the card's name
and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_RUNS = (("pull", "configs/dmc_sim_example.conf"),
            ("push", "configs/dmc_sim_8_6.conf"))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _sync(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _timed(torch, device, fn):
    _sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    return out, time.perf_counter() - t0


def _cut_conf(root: str, conf: str, ops: int, tmp: str) -> str:
    """``conf`` with every ``client_total_ops`` set to ``ops``."""
    with open(os.path.join(root, conf)) as f:
        lines = f.read().splitlines()
    out = [f"client_total_ops = {ops}"
           if ln.split("=")[0].strip() == "client_total_ops" else ln
           for ln in lines]
    path = os.path.join(tmp, f"cut_{ops}_" + os.path.basename(conf))
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


def row_queue(torch, serve, a) -> dict:
    run, wall = _timed(torch, a.device,
                       lambda: serve.serve_queue(a.queue_n, device=a.device))
    sec, st = run.seconds, run.stats
    batch_s = sec["pull_batch_0"] + sec["pull_batch_1"]
    return dict(wall_s=wall, stages_s=sec, adds=st["adds"],
                adds_per_s=st["adds"] / sec["bulk_load"],
                batch_decisions=st["batch_decisions"],
                batch_decisions_per_s=st["batch_decisions"] / batch_s,
                pulls_per_s=serve.QUEUE["pulls"] / sec["pull_request"],
                decisions=st["decisions"], hit_share=st["hit_share"])


def row_dmc_sim(torch, a) -> dict:
    from dmclock_tpu_torch.sim import dmc_sim

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, conf in SIM_RUNS:
            path = os.path.join(a.root, conf) if not a.sim_ops else \
                _cut_conf(a.root, conf, a.sim_ops, tmp)
            trace = os.path.join(tmp, f"{mode}.jsonl")
            buf = io.StringIO()

            def run():
                with contextlib.redirect_stdout(buf):
                    return dmc_sim.main(
                        ["-c", path, "--model", "dmclock-torch",
                         "--server-mode", mode, "--device", a.device,
                         "--trace", trace])

            rc, wall = _timed(torch, a.device, run)
            with open(trace) as f:
                rows = sum(1 for _ in f)
            out[mode] = dict(config=conf, client_total_ops=a.sim_ops or
                             "whole", rc=rc, wall_s=wall, decisions=rows,
                             decisions_per_s=rows / wall)
    return out


def row_dryrun(torch, serve, a, full: bool) -> dict:
    kw = {} if full else dict(decisions_per_step=32, warmup=1, rounds=1,
                              drain_rounds=1, check_qos=False)
    mc, wall = _timed(torch, a.device, lambda: serve.multichip_row(
        8, a.dryrun_clients, device=a.device, **kw))
    out = dict(wall_s=wall, served=[p["served"] for p in mc["policies"]],
               digests=[p.get("digest") for p in mc["policies"]])
    if not full:
        o, owall = _timed(torch, a.device, lambda: serve.cluster_outage(
            8, a.dryrun_clients, steps=3, decisions_per_step=32,
            device=a.device))
        out.update(outage_wall_s=owall, outage_digest=o["digest"],
                   outage_served=o["served"])
    return out


def row_fullscale(torch, a) -> dict:
    sys.path.insert(0, os.path.join(a.root, "scripts"))
    import torch_run_fullscale as fs

    n, wall = _timed(torch, a.device, lambda: fs.cluster_parity(
        "orig", torch.device(a.device), **fs.CLUSTER))
    return dict(wall_s=wall, decisions=n, shape=fs.CLUSTER)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose dmclock_tpu_torch is timed")
    ap.add_argument("--rows", default="queue,dmc_sim,dryrun")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sim-ops", type=int, default=50)
    ap.add_argument("--queue-n", type=int, default=10_000)
    ap.add_argument("--dryrun-clients", type=int, default=10_000)
    a = ap.parse_args(argv)
    a.root = os.path.abspath(a.root)
    sys.path.insert(0, a.root)
    import torch

    from dmclock_tpu_torch import serve

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_serial_walls: no CUDA device", file=sys.stderr)
        return 2
    rows = {}
    for name in (r for r in a.rows.split(",") if r):
        t0 = time.perf_counter()
        if name == "queue":
            rows[name] = row_queue(torch, serve, a)
        elif name == "dmc_sim":
            rows[name] = row_dmc_sim(torch, a)
        elif name in ("dryrun", "dryrun_full"):
            rows[name] = row_dryrun(torch, serve, a, name == "dryrun_full")
        elif name == "fullscale":
            rows[name] = row_fullscale(torch, a)
        else:
            raise SystemExit(f"unknown row {name!r}")
        print(f"# {name}: {time.perf_counter() - t0:.3f} s", file=sys.stderr,
              flush=True)
    print(json.dumps({"root": a.root, "device": a.device,
                      "card": _card() if a.device.startswith("cuda")
                      else "cpu", "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
