"""Wall times of the port's programs over several groups of one card,
for one tree of it.

A layout of several groups (``make_mesh(S, devices=("cuda:0",) * D)``)
runs the port's multi-group programs group by group.  This script times
those paths on one card beside the stacked layout (one group) and prints
one JSON line.  It imports ``dmclock_tpu_torch`` from ``--root``
(default: the checkout it lies in), so the same file times another tree
unpacked beside it (``git archive`` of a parent commit), and both can be
compared in one call.

Rows (``--rows``, comma-separated):

- ``mesh_row``: bench's mesh row (``serve.mesh_row``, 100,000 clients
  over 8 shards) at ``counter_sync_every`` 1 and 4 and under the chaos
  spec, stacked and over ``--groups`` groups of the card: decisions/s of
  each, and every key but the walls and the layout's held equal.
- ``session_mesh``: bench's session mesh cell, ``python -m
  dmclock_tpu_torch.bench --mode mesh --n-shards 4 --rebalance on
  --devices cuda:0,cuda:0,cuda:0,cuda:0``, as a process of its own: its
  value (decisions/s) and the process's wall.
- ``cluster_step``: ``cluster.cluster_step`` at the cut dry run's shape
  (8 servers x 10,000 clients, 32 decisions a step) over 8 groups and
  stacked: the first call and 3 chained calls each, every call equal.
- ``device_sim``: the device sim's headline (100,000 clients x 8
  servers) for 2 slices through ``jit_device_sim_step`` over 8 groups
  and over one: the first call and 2 calls on fresh copies of the sim,
  each equal to the one-group program's.

Usage::

    python scripts/torch_group_walls.py [--root DIR] [--rows mesh_row]
        [--groups 4] [--clients 100000] [--dryrun-clients 10000]
        [--sim-clients 100000]

Walls are host clocks around work that ends in a synchronisation of the
card.  The line carries the card's name and power limit as
``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS = "seed=7,p_dropout=0.05,mean_outage_steps=2,p_dup=0.1"
# row keys that follow the clock or the layout, not the decisions
ROW_SKIP = {"dps", "dps_per_shard", "dps_per_shard_mean",
            "dps_per_shard_min", "dps_per_shard_max", "wall_s", "devices",
            "n_groups", "hbm_budget_bytes", "max_clients_per_shard",
            "shards_planned"}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(torch, got, want, what: str) -> None:
    from torch.utils import _pytree as pytree

    from dmclock_tpu_torch.parallel import groups

    a = pytree.tree_leaves(groups.gather(got, "cpu"))
    b = pytree.tree_leaves(groups.gather(want, "cpu"))
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} leaves against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if torch.is_tensor(x):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{what}: leaf {i} differs")
        elif x != y:
            raise AssertionError(f"{what}: leaf {i} {x!r} != {y!r}")


def row_mesh(torch, serve, a) -> dict:
    from dmclock_tpu_torch.obs.registry import MetricsRegistry
    from dmclock_tpu_torch.robust import faults as TF

    out = {}
    for tag, kw in (("k1", dict(counter_sync_every=1)),
                    ("k4", dict(counter_sync_every=4)),
                    ("chaos", dict(fault_spec=TF.parse_fault_spec(CHAOS)))):
        rows = {}
        for name, devs in (("stacked", ("cuda:0",)),
                           ("groups", ("cuda:0",) * a.groups)):
            rows[name], _ = _timed(torch, lambda: serve.mesh_row(
                a.clients, n_shards=8, devices=devs,
                registry=MetricsRegistry(), **kw))
        for key, val in rows["stacked"].items():
            if key not in ROW_SKIP and rows["groups"].get(key) != val:
                raise AssertionError(f"mesh_row {tag}: {key} "
                                     f"{rows['groups'].get(key)} != {val}")
        out[tag] = dict(dps_stacked=rows["stacked"]["dps"],
                        dps_groups=rows["groups"]["dps"],
                        ratio=rows["groups"]["dps"] / rows["stacked"]["dps"],
                        decisions=rows["groups"]["decisions"])
    return out


def row_session_mesh(a) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "dmclock_tpu_torch.bench", "--mode", "mesh",
         "--n-shards", "4", "--rebalance", "on", "--devices",
         ",".join(["cuda:0"] * 4)], cwd=a.root, capture_output=True,
        text=True, timeout=1200)
    wall = time.perf_counter() - t0
    if p.returncode:
        raise AssertionError(f"session_mesh rc {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    return dict(value=line["value"], n_groups=line["mesh"]["n_groups"],
                mesh_dps=line["mesh"]["dps"], process_wall_s=wall)


def row_cluster(torch, serve, a) -> dict:
    from dmclock_tpu_torch.parallel import cluster as CL

    out = {}
    runs = {}
    for name, devs in (("stacked", None), ("groups", ("cuda:0",) * 8)):
        mesh, cl, costs = serve.multichip_cluster(8, a.dryrun_clients,
                                                  "orig", "cuda",
                                                  devices=devs)
        costs = torch.from_numpy(costs).to("cuda")
        arr = torch.full((8, a.dryrun_clients), 3, dtype=torch.int32,
                         device="cuda")
        prog = CL.mesh_step_jit({}, CL.cluster_step, mesh,
                                (32, 3, 0, False, 50_000_000))
        walls, outs = [], []
        for _ in range(4):
            got, wall = _timed(torch, lambda: prog(cl, arr, costs))
            walls.append(wall)
            outs.append(got)
            cl = got[0]
        runs[name] = outs
        out[name] = dict(first_call_s=walls[0], call_s=walls[1:])
    for i, (got, want) in enumerate(zip(runs["groups"], runs["stacked"])):
        _same(torch, got, want, f"cluster_step call {i}")
    return out


def row_device_sim(torch, a) -> dict:
    from torch.utils import _pytree as pytree

    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.sim import device_sim as DS

    def clone(tree):
        return pytree.tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x, tree)

    _, sim0, spec = DS.headline_setup(a.sim_clients, device="cuda")
    out, want = {}, None
    for name, devs in (("one", ("cuda:0",)), ("groups", ("cuda:0",) * 8)):
        mesh = CL.make_mesh(spec.n_servers, devices=devs)
        sim = DS.shard_device_sim(sim0, mesh) if len(devs) > 1 else sim0
        step = DS.jit_device_sim_step(spec, 2, devices=mesh.devices)
        walls = []
        for _ in range(3):
            counts = DS.StepCounts()
            res, wall = _timed(torch, lambda: step(clone(sim),
                                                   counts=counts))
            got = DS.device_sim_to_numpy(res)
            del res
            if want is None:
                want = got
            for key in want:
                x, y = got[key], want[key]
                for k in (x if isinstance(x, dict) else [None]):
                    u, v = (x, y) if k is None else (x[k], y[k])
                    if u.dtype != v.dtype or not (u == v).all():
                        raise AssertionError(f"device_sim {name}: {key} "
                                             f"{k} differs")
            walls.append(wall)
        out[name] = dict(first_call_s=walls[0], call_s=walls[1:],
                         read_backs=counts.read_backs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose dmclock_tpu_torch is timed")
    ap.add_argument("--rows", default="mesh_row,session_mesh,cluster_step,"
                    "device_sim")
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--clients", type=int, default=100_000)
    ap.add_argument("--dryrun-clients", type=int, default=10_000)
    ap.add_argument("--sim-clients", type=int, default=100_000)
    a = ap.parse_args(argv)
    a.root = os.path.abspath(a.root)
    sys.path.insert(0, a.root)
    import torch

    from dmclock_tpu_torch import serve

    if not torch.cuda.is_available():
        print("torch_group_walls: no CUDA device", file=sys.stderr)
        return 2
    runs = dict(mesh_row=lambda: row_mesh(torch, serve, a),
                session_mesh=lambda: row_session_mesh(a),
                cluster_step=lambda: row_cluster(torch, serve, a),
                device_sim=lambda: row_device_sim(torch, a))
    names = [r for r in a.rows.split(",") if r]
    for name in names:
        if name not in runs:
            raise SystemExit(f"unknown row {name!r}")
    rows, failed = {}, []
    for name in names:
        # a row that fails is reported and the others still run
        t0 = time.perf_counter()
        try:
            rows[name] = runs[name]()
        except Exception as e:  # noqa: BLE001
            rows[name] = dict(error=f"{type(e).__name__}: {e}"[:2000])
            failed.append(name)
        print(f"# {name}: {time.perf_counter() - t0:.3f} s", file=sys.stderr,
              flush=True)
    print(json.dumps({"root": a.root, "card": _card(),
                      "torch": torch.__version__, "rows": rows}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
