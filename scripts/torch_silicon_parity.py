#!/usr/bin/env python
"""On-card parity gate of the port: the host oracle against the card's
engine, op for op.

The counterpart of ``scripts/silicon_parity.py`` on the PyTorch port.
It runs scaled ``dmc_sim`` acceptance shapes (its own copy of
``make_shapes``) through the host oracle (``dmclock-delayed``) and the
engine on the card (``dmclock-torch``) and requires the full service
traces -- (virtual time, server, client, phase, cost) per op -- and every
client's phase split to be equal; then a calendar-against-serial check
on the card (calendar batches on a mixed-QoS deep state commit exactly
the serial engine's next ``count`` decisions: per-client counts, phase
counts and the whole final state).

The report goes to ``--out FILE`` only: it is marked in progress
(``match: false``) before the first shape runs and rewritten with
``match: false`` and the error on any failure, so a stale file never
claims success.  The report is also the last line printed.  The default
device is the card, and with no card the gate raises: the port has no
CPU fallback.  ``--device cpu`` runs it on the CPU, as the tests do.

Usage: python scripts/torch_silicon_parity.py --out FILE
       [--device cuda|cuda:N|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def make_shapes():
    from dmclock_tpu_torch.sim.config import (ClientGroup, ServerGroup,
                                              SimConfig)

    def cfg(clients, servers, **kw):
        return SimConfig(client_groups=len(clients),
                         server_groups=len(servers),
                         cli_group=clients, srv_group=servers, **kw)

    # scaled dmc_sim_example.conf: 4 QoS groups incl. limited and
    # weighted clients
    example = cfg([
        ClientGroup(client_count=1, client_total_ops=60, client_wait_s=0,
                    client_iops_goal=200, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=0.0,
                    client_weight=1.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=60, client_wait_s=1,
                    client_iops_goal=200, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=40.0,
                    client_weight=1.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=60, client_wait_s=2,
                    client_iops_goal=200, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=50.0,
                    client_weight=2.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=40, client_wait_s=0,
                    client_iops_goal=100, client_outstanding_ops=16,
                    client_reservation=0.0, client_limit=0.0,
                    client_weight=1.0, client_req_cost=3,
                    client_server_select_range=1),
    ], [ServerGroup(server_count=1, server_iops=160, server_threads=1)],
        server_soft_limit=False)

    # scaled dmc_sim_100th.conf: reservation-heavy with a cost-3
    # client, soft limit (AtLimit.ALLOW)
    hundredth = cfg([
        ClientGroup(client_count=2, client_total_ops=50,
                    client_iops_goal=100, client_outstanding_ops=16,
                    client_reservation=20.0, client_limit=60.0,
                    client_weight=1.0, client_server_select_range=1),
        ClientGroup(client_count=1, client_total_ops=40,
                    client_iops_goal=100, client_outstanding_ops=16,
                    client_reservation=10.0, client_limit=0.0,
                    client_weight=2.0, client_req_cost=3,
                    client_server_select_range=1),
    ], [ServerGroup(server_count=1, server_iops=120, server_threads=1)],
        server_soft_limit=True)

    # a wider weighted mix, past 1,000 decisions in all
    wide = cfg([
        ClientGroup(client_count=4, client_total_ops=100,
                    client_iops_goal=300, client_outstanding_ops=32,
                    client_reservation=0.0, client_limit=0.0,
                    client_weight=1.0, client_server_select_range=2),
        ClientGroup(client_count=4, client_total_ops=100,
                    client_iops_goal=300, client_outstanding_ops=32,
                    client_reservation=5.0, client_limit=0.0,
                    client_weight=3.0, client_server_select_range=2),
    ], [ServerGroup(server_count=2, server_iops=400, server_threads=1)],
        server_soft_limit=False)

    return [("example", example), ("100th", hundredth), ("wide", wide)]


def trace_parity(name: str, cfg, device, seed: int = 7) -> int:
    """The oracle's and the card's traces, op for op, and each client's
    phase split; returns the decisions."""
    from dmclock_tpu_torch.sim.dmc_sim import run_sim

    oracle = run_sim(cfg, model="dmclock-delayed", seed=seed,
                     record_trace=True, device=device)
    card = run_sim(cfg, model="dmclock-torch", seed=seed,
                   record_trace=True, device=device)
    n = len(oracle.trace)
    assert n == len(card.trace) > 0, \
        f"{name}: trace lengths differ ({n} vs {len(card.trace)})"
    for i, (a, b) in enumerate(zip(oracle.trace, card.trace)):
        assert a == b, f"{name}: trace diverges at op {i}: " \
                       f"oracle={a} card={b}"
    for cid in oracle.clients:
        ca, cb = oracle.clients[cid].stats, card.clients[cid].stats
        assert (ca.reservation_ops, ca.priority_ops) == \
            (cb.reservation_ops, cb.priority_ops), \
            f"{name}: phase split differs for client {cid}"
    return n


def calendar_check(device) -> int:
    """Calendar batches on a mixed-QoS deep state, each held against the
    serial engine's next ``count`` decisions on the same device: the
    per-client and per-phase counts and every field of the final
    state."""
    import random

    import numpy as np
    import torch

    from dmclock_tpu_torch.core import ClientInfo, ReqParams
    from dmclock_tpu_torch.core.timebase import NS_PER_SEC as S
    from dmclock_tpu_torch.engine import TpuPullPriorityQueue, kernels
    from dmclock_tpu_torch.engine.fastpath import calendar_batch

    rng = random.Random(17)
    infos = {}
    for c in range(48):
        kind = c % 4
        if kind == 0:
            infos[c] = ClientInfo(1.5, 0, 0)
        elif kind == 1:
            infos[c] = ClientInfo(0, 1.0 + c % 3, 0)
        elif kind == 2:
            infos[c] = ClientInfo(1.0, 2.0, 6.0)
        else:
            infos[c] = ClientInfo(0.5, 1.0, 0)
    q = TpuPullPriorityQueue(lambda c: infos[c], capacity=64,
                             ring_capacity=64, device=device)
    t = 1 * S
    for i in range(900):
        c = rng.randrange(48)
        t += rng.randint(0, S // 8)
        delta = rng.randint(1, 4)
        q.add_request(("r", i), c, ReqParams(delta, rng.randint(1, delta)),
                      time_ns=t, cost=rng.randint(1, 3))
    with q.data_mtx:
        q._flush()
    state = q.state
    total = 0
    now = t + 2 * S
    for _ in range(30):
        b = calendar_batch(state, now, steps=8, anticipation_ns=0)
        assert bool(b.progress_ok), "calendar stalled on the card"
        cnt = int(b.count)
        if cnt == 0:
            now += 2 * S
            continue
        ser_state, _, decs = kernels.engine_run(
            state, now, cnt, allow_limit_break=False, anticipation_ns=0,
            advance_now=False)
        d_slot = decs.slot.cpu().numpy()
        d_phase = decs.phase.cpu().numpy()
        assert (decs.type.cpu().numpy() == kernels.RETURNING).all()
        served = np.zeros(64, np.int32)
        np.add.at(served, d_slot, 1)
        assert np.array_equal(served, b.served.cpu().numpy()), \
            "calendar per-client counts diverge from serial on the card"
        resv = np.zeros(64, np.int32)
        np.add.at(resv, d_slot[d_phase == 0], 1)
        assert np.array_equal(resv, b.served_resv.cpu().numpy()), \
            "calendar phase counts diverge from serial on the card"
        for name, x, y in zip(state._fields, b.state, ser_state):
            assert torch.equal(x, y), \
                f"calendar state field {name} diverges on the card"
        state = b.state
        total += cnt
    assert total > 500, f"calendar check too shallow: {total}"
    return total


def run(out: Path, device="cuda", shapes=None) -> dict:
    """The gate; writes ``out`` (in progress first, then the report)
    and returns the report.  Raises on any failure after recording it."""
    import torch

    from dmclock_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    report = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "device": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "shapes": [], "total_decisions": 0, "match": True}
    t0 = time.perf_counter()
    out.write_text(json.dumps({**report, "match": False, "running": True},
                              indent=1))
    try:
        for name, cfg in (make_shapes() if shapes is None else shapes):
            n = trace_parity(name, cfg, dev)
            report["shapes"].append({"name": name, "decisions": n})
            report["total_decisions"] += n
            print(f"silicon parity: {name}: {n} decisions bit-exact",
                  file=sys.stderr)
        n = calendar_check(dev)
        report["shapes"].append({"name": "calendar-vs-serial",
                                 "decisions": n})
        report["total_decisions"] += n
    except BaseException as e:
        report["match"] = False
        report["error"] = f"{type(e).__name__}: {e}"
        report["wall_s"] = round(time.perf_counter() - t0, 1)
        out.write_text(json.dumps(report, indent=1))
        raise
    report["wall_s"] = round(time.perf_counter() - t0, 1)
    out.write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", metavar="FILE", required=True,
                    help="where the report goes")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    report = run(Path(a.out), a.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
