#!/usr/bin/env python
"""The full-scale parity gates of the port, and the MULTICHIP record
(schema v3).

The counterpart of ``scripts/run_fullscale.py`` on the PyTorch port.
The checks run directly, not through pytest:

- the acceptance configs (``configs/dmc_sim_example.conf`` and
  ``configs/dmc_sim_100th.conf``) through ``dmc_sim`` with the card's
  engine (``dmclock-torch``) against the host oracle
  (``dmclock-delayed``), trace for trace, with each client's phase split;
- the 8-server x 1,000-client x 10-round cluster parity for both tracker
  kinds: the card's ``cluster_step`` against a host loop of the port's
  oracle queues and service trackers, decision for decision.

``--record FILE`` also writes the MULTICHIP record in schema v3, with
the JAX record's keys: ``n_devices``/``rc``/``ok``/``tail`` (the tail is
the cluster dry run, ``serve.multichip_row``, as JSON), the ``mesh``
block and, under ``--rebalance on``, the ``rebalance`` block, both read
off the line of one ``python -m dmclock_tpu_torch.bench --mode mesh``
run.  :func:`load_multichip` (its own copy) reads schemas 1-3.

``--n-devices N`` is the shard (server) count; ``--devices`` lays the
mesh and the dry run out (default every visible card, one when there is
one); ``--device`` runs the parity checks (default the card; ``cpu``
only when named).
The last line printed is a JSON summary with ``ok``.

Usage: python scripts/torch_run_fullscale.py [--record FILE]
       [--configs example,100th] [--cluster on|off] [--n-devices N]
       [--clients N] [--counter-sync-every K] [--fault-plan SPEC]
       [--rebalance on|off] [--dryrun-clients C] [--dryrun-k K]
       [--device D] [--devices LIST]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

MULTICHIP_SCHEMA = 3
CONFIGS = {"example": "dmc_sim_example.conf",
           "100th": "dmc_sim_100th.conf"}
# tests/test_cluster_realism.py test_cluster_parity_fullscale's shape
CLUSTER = dict(n_servers=8, n_clients=1000, rounds=10, k=1100, max_arr=1,
               seed=53)


def load_multichip(path: str) -> dict:
    """A MULTICHIP record of any schema: v1 (no ``schema`` key)
    normalizes to ``schema=1, mesh=None, rebalance=None``; v2 carries
    the mesh block (``rebalance`` None); v3 adds the rebalance block.
    Every v1/v2 key keeps its meaning in v3."""
    with open(path) as fh:
        obj = json.load(fh)
    out = {
        "schema": int(obj.get("schema", 1)),
        "n_devices": int(obj.get("n_devices", 0)),
        "rc": int(obj.get("rc", 0)),
        "ok": bool(obj.get("ok", False)),
        "skipped": bool(obj.get("skipped", False)),
        "tail": obj.get("tail", ""),
        "mesh": obj.get("mesh"),
        "rebalance": obj.get("rebalance"),
    }
    if out["schema"] >= 2 and out["mesh"] is not None:
        m = out["mesh"]
        m.setdefault("dps", 0.0)
        m.setdefault("n_shards", out["n_devices"])
        m.setdefault("counter_sync_every", 1)
        m.setdefault("counter_bytes_per_epoch", 0)
        m.setdefault("fault_plan", "none")
        m.setdefault("fault_dropouts_per_shard", [])
        m.setdefault("fault_resyncs_per_shard", [])
        m.setdefault("faults_injected_total", 0)
    if out["schema"] >= 3 and out["rebalance"] is not None:
        r = out["rebalance"]
        r.setdefault("placement", "p2c")
        r.setdefault("migrations", 0)
        r.setdefault("migration_log", [])
        r.setdefault("shard_skew_before", 0.0)
        r.setdefault("shard_skew_after", 0.0)
        r.setdefault("recovered_dps", 0.0)
        r.setdefault("recovered_decisions", 0)
    return out


def sim_parity(conf: str, device, seed: int = 12345) -> int:
    """One acceptance config: the oracle's trace and the card's, op for
    op, and each client's phase split.  Returns the decisions."""
    from dmclock_tpu_torch.sim.config import parse_config_file
    from dmclock_tpu_torch.sim.dmc_sim import run_sim

    cfg = parse_config_file(str(REPO / "configs" / conf))
    host = run_sim(cfg, model="dmclock-delayed", seed=seed,
                   record_trace=True, device=device)
    card = run_sim(cfg, model="dmclock-torch", seed=seed,
                   record_trace=True, device=device)
    assert len(host.trace) == len(card.trace) > 0, \
        f"{conf}: trace lengths {len(host.trace)} != {len(card.trace)}"
    for i, (a, b) in enumerate(zip(host.trace, card.trace)):
        assert a == b, f"{conf}: trace diverges at op {i}: host={a} " \
                       f"card={b}"
    for cid in host.clients:
        ca, cb = host.clients[cid].stats, card.clients[cid].stats
        assert (ca.reservation_ops, ca.priority_ops) == \
            (cb.reservation_ops, cb.priority_ops), \
            f"{conf}: phase split differs for client {cid}"
    return len(host.trace)


def cluster_parity(tracker_kind: str, device, *, n_servers: int,
                   n_clients: int, rounds: int, k: int, max_arr: int,
                   seed: int) -> int:
    """``cluster_step`` on ``device`` (an unrecorded program,
    ``parallel.cluster.bare_step_jit``) against a host loop of oracle
    queues (one a server, delayed tags) and service trackers (one a
    client), decision for decision: type, slot, phase, cost, the FUTURE
    wake-ups and each server's clock.  Costs are ``1 + c % 3``.
    Returns the decisions served."""
    import numpy as np

    from dmclock_tpu_torch.core import (BorrowingTracker, ClientInfo,
                                        NextReqType, OrigTracker, Phase,
                                        PullPriorityQueue, ReqParams,
                                        ServiceTracker)
    from dmclock_tpu_torch.parallel import cluster as CL

    infos = [ClientInfo(10.0, 1.0 + (c % 3), 0.0) for c in range(n_clients)]
    costs = [1 + (c % 3) for c in range(n_clients)]
    cost_t = torch.tensor(costs, dtype=torch.int64, device=device)

    def inv(attr):
        return torch.tensor([getattr(i, attr) for i in infos],
                            dtype=torch.int64, device=device)

    mesh = CL.make_mesh(n_servers, device)
    # the step as a program outside the plane's records, as the JAX
    # check's bare jax.jit
    step = CL.bare_step_jit(mesh, (k, max_arr, 0, False, 0))
    cl = CL.init_cluster(n_servers, n_clients, tracker_kind=tracker_kind,
                         device=device)
    cl = CL.install_clients(cl, inv("reservation_inv_ns"),
                            inv("weight_inv_ns"), inv("limit_inv_ns"))
    queues = [PullPriorityQueue(lambda c: infos[c], delayed_tag_calc=True,
                                run_gc_thread=False)
              for _ in range(n_servers)]
    host_cls = {"orig": OrigTracker, "borrowing": BorrowingTracker}[
        tracker_kind]
    trackers = [ServiceTracker(tracker_cls=host_cls, run_gc_thread=False)
                for _ in range(n_clients)]
    host_now = [0] * n_servers
    rng = random.Random(seed)
    served = 0
    for rnd in range(rounds + 1):
        if rnd == 0:
            # first contacts in slot order fix the host tie-break rank
            arrivals = np.ones((n_servers, n_clients), dtype=np.int32)
        else:
            arrivals = np.asarray(
                [[rng.randint(0, max_arr) for _c in range(n_clients)]
                 for _s in range(n_servers)], dtype=np.int32)
        cl, decs = step(cl, torch.from_numpy(arrivals).to(device), cost_t)
        d = {f: getattr(decs, f).cpu().numpy()
             for f in ("type", "slot", "phase", "cost", "when")}
        d_now = cl.now.cpu().numpy()
        for s in range(n_servers):
            for wave in range(max_arr):
                for c in range(n_clients):
                    if arrivals[s][c] > wave:
                        rp = trackers[c].get_req_params(s)
                        queues[s].add_request(
                            (rnd, wave, c), c, ReqParams(rp.delta, rp.rho),
                            time_ns=host_now[s], cost=costs[c])
        for s in range(n_servers):
            responses = []
            for i in range(k):
                pr = queues[s].pull_request(host_now[s])
                where = f"{tracker_kind} round {rnd} server {s} step {i}"
                if pr.type is NextReqType.RETURNING:
                    assert (d["type"][s][i], d["slot"][s][i],
                            d["phase"][s][i], d["cost"][s][i]) == \
                        (0, pr.client, int(pr.phase is Phase.PRIORITY),
                         pr.cost), where
                    responses.append((pr.client, pr.phase, pr.cost))
                elif pr.type is NextReqType.FUTURE:
                    assert (d["type"][s][i], d["when"][s][i]) == \
                        (1, pr.when_ready), f"{where} FUTURE"
                    host_now[s] = pr.when_ready
                else:
                    assert d["type"][s][i] == 2, f"{where} NONE"
            assert host_now[s] == d_now[s], f"round {rnd} server {s} clock"
            for client, phase, cost in responses:
                trackers[client].track_resp(s, phase, cost)
            served += len(responses)
    return served


def _mesh_session(a) -> tuple:
    """The v2 mesh block and the v3 rebalance block: the line of one
    ``python -m dmclock_tpu_torch.bench --mode mesh`` run."""
    cmd = [sys.executable, "-m", "dmclock_tpu_torch.bench",
           "--mode", "mesh", "--clients", str(a.clients),
           "--n-shards", str(a.n_devices),
           "--counter-sync-every", str(a.counter_sync_every),
           "--fault-plan", a.fault_plan, "--rebalance", a.rebalance,
           "--device", a.device]
    if a.devices is not None:
        cmd += ["--devices", a.devices]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    for line in reversed((proc.stdout or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                break
            return proc.returncode, obj.get("mesh"), \
                obj.get("mesh_rebalance")
    sys.stderr.write((proc.stderr or "")[-4000:])
    return proc.returncode or 1, None, None


def _dryrun(a) -> tuple:
    """The v1 block: the cluster dry run (``serve.multichip_row``) with
    its QoS assertions, as JSON text."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.device import parse_devices

    try:
        row = serve.multichip_row(
            a.n_devices, a.dryrun_clients,
            decisions_per_step=a.dryrun_k, device=a.device,
            devices=None if a.devices is None
            else parse_devices(a.devices))
        return 0, json.dumps(row)[-4000:]
    except (AssertionError, RuntimeError, ValueError) as e:
        return 1, f"{type(e).__name__}: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", metavar="FILE", default=None,
                    help="write the MULTICHIP schema-v3 record here")
    ap.add_argument("--configs", default="example,100th",
                    help="acceptance configs to hold: names of "
                    f"{','.join(CONFIGS)} or config paths ('' for none)")
    ap.add_argument("--cluster", choices=["on", "off"], default="on",
                    help="the 8 x 1,000 x 10 cluster parity, both "
                    "tracker kinds")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="shards of the mesh and servers of the dry run")
    ap.add_argument("--clients", type=int, default=100_000,
                    help="mesh: clients over all shards")
    ap.add_argument("--counter-sync-every", type=int, default=1)
    ap.add_argument("--fault-plan", default="none")
    ap.add_argument("--rebalance", choices=["off", "on"], default="off")
    ap.add_argument("--dryrun-clients", type=int, default=10_000,
                    help="dry run: clients a server")
    ap.add_argument("--dryrun-k", type=int, default=1024,
                    help="dry run: decisions a server a round")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None,
                    help="the mesh's layout (default every visible card)")
    a = ap.parse_args(argv)

    from dmclock_tpu_torch.device import resolve_device

    dev = resolve_device(a.device)
    if a.devices is None and dev.type == "cuda" and \
            torch.cuda.device_count() > 1:
        a.devices = str(torch.cuda.device_count())   # every visible card
    checks = []

    def check(name, fn):
        t0 = time.perf_counter()
        try:
            c = {"check": name, "decisions": fn(), "ok": True,
                 "seconds": time.perf_counter() - t0}
            print(f"# fullscale {name}: ok, {c['decisions']} decisions in "
                  f"{c['seconds']:.3f} s", file=sys.stderr, flush=True)
        except AssertionError as e:
            c = {"check": name, "ok": False, "error": str(e)}
            print(f"# fullscale {name}: FAILED: {e}", file=sys.stderr,
                  flush=True)
        checks.append(c)

    for name in (c for c in a.configs.split(",") if c):
        check(name, lambda name=name: sim_parity(CONFIGS.get(name, name),
                                                 dev))
    if a.cluster == "on":
        for kind in ("orig", "borrowing"):
            check(f"cluster_{kind}",
                  lambda kind=kind: cluster_parity(kind, dev, **CLUSTER))
    rc = 0 if all(c["ok"] for c in checks) else 1
    summary = {"ok": rc == 0, "rc": rc, "checks": checks}
    if a.record:
        d_rc, tail = _dryrun(a)
        m_rc, mesh, rebal = _mesh_session(a)
        record = {
            "schema": MULTICHIP_SCHEMA,
            "n_devices": a.n_devices,
            "rc": rc or d_rc or m_rc,
            "ok": rc == 0 and d_rc == 0 and m_rc == 0
            and mesh is not None
            and (a.rebalance == "off" or rebal is not None),
            "skipped": False,
            "tail": tail,
            "mesh": mesh,
            "rebalance": rebal,
        }
        with open(a.record, "w") as fh:
            json.dump(record, fh, indent=1)
        summary.update(ok=record["ok"], rc=record["rc"],
                       record=os.fspath(a.record))
        print(f"# multichip v3 record -> {a.record} (dryrun rc={d_rc}, "
              f"mesh rc={m_rc}, aggregate "
              f"{0 if not mesh else mesh.get('dps', 0) / 1e6:.1f}M dec/s)",
              file=sys.stderr)
    print(json.dumps(summary))
    return summary["rc"]


if __name__ == "__main__":
    sys.exit(main())
