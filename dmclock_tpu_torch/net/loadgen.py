"""Multi-process load generator for the RPC ingest plane
(docs/RPC.md "Quickstart"; the port's copy of ``scripts/loadgen.py``,
whose schedules it reproduces byte for byte).

N worker PROCESSES (real sockets, real concurrency -- not asyncio
simulation) each drive a :class:`.client.RpcClient` through a SEEDED,
byte-identical request schedule:

- worker ``w`` owns the client ids with ``cid % workers == w``
  (disjoint (cid, seq) spaces -- exactly-once accounting needs no
  cross-process coordination);
- the schedule is a pure function of ``(seed, worker, requests,
  n_clients, max_nops, workers)`` via a dedicated PCG64 stream, so
  the same flags always produce the same frames in the same order
  (``--schedule-only`` prints it; the determinism test and the
  chaos oracle both consume it);
- ``--fault-spec`` draws the slow-sender stalls
  client-side (``stall_ms``/``p_stall``); drops/dups/reorders are
  server-side ingress faults and need nothing here beyond honest
  timeout retry.

Prints one JSON summary line (merged worker stats) and exits 0 when
every request admitted, 1 when any was abandoned after retries::

    python -m dmclock_tpu_torch.net.loadgen --port P --workers 4 \
        --requests 16 --n-clients 16 --seed 7
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import sys
import time
from typing import List, Tuple

import numpy as np

from . import faults as faults_mod
from .client import RpcClient, RpcError


def worker_schedule(seed: int, worker: int, *, workers: int,
                    requests: int, n_clients: int,
                    max_nops: int) -> List[Tuple[int, int, int]]:
    """The deterministic per-worker schedule: ``requests`` tuples of
    ``(cid, seq, nops)`` over the worker's own cid partition.  Pure
    function of its arguments -- the determinism gate asserts two
    evaluations are byte-identical."""
    own = [c for c in range(int(n_clients))
           if c % int(workers) == int(worker)]
    if not own:
        return []
    rng = np.random.Generator(np.random.PCG64(
        [int(seed), int(worker), int(requests), int(n_clients)]))
    picks = rng.integers(0, len(own), size=int(requests))
    nops = rng.integers(1, int(max_nops) + 1, size=int(requests))
    seqs = {c: 0 for c in own}
    out = []
    for i in range(int(requests)):
        cid = own[int(picks[i])]
        out.append((cid, seqs[cid], int(nops[i])))
        seqs[cid] += 1
    return out


def full_schedule(seed: int, *, workers: int, requests: int,
                  n_clients: int, max_nops: int
                  ) -> List[List[Tuple[int, int, int]]]:
    return [worker_schedule(seed, w, workers=workers,
                            requests=requests, n_clients=n_clients,
                            max_nops=max_nops)
            for w in range(int(workers))]


def schedule_blob(schedules) -> bytes:
    """Canonical bytes of a schedule (what 'byte-identical' means)."""
    return json.dumps(schedules, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def run_worker(host: str, port: int, schedule, *,
               timeout_s: float = 0.5, max_attempts: int = 8,
               fault_spec=None) -> dict:
    """Drive one worker's schedule to completion; returns its client
    stats (importable -- the in-process bench mode and the tests run
    workers as threads through this same function)."""
    spec = faults_mod.parse_net_fault_spec(fault_spec)
    with RpcClient(host, port, timeout_s=timeout_s,
                   max_attempts=max_attempts) as cli:
        for cid, seq, nops in schedule:
            stall = faults_mod.stall_ms(spec, cid, seq, 0)
            if stall:
                time.sleep(stall / 1000.0)
            try:
                cli.request(cid, seq, nops)
            except RpcError:
                pass            # counted in stats["failed"]
        return dict(cli.stats)


def _worker_main(args, w: int, q) -> None:
    sched = worker_schedule(args.seed, w, workers=args.workers,
                            requests=args.requests,
                            n_clients=args.n_clients,
                            max_nops=args.max_nops)
    try:
        stats = run_worker(args.host, args.port, sched,
                           timeout_s=args.timeout_s,
                           max_attempts=args.max_attempts,
                           fault_spec=args.fault_spec)
    except Exception as e:      # a worker crash is a failed leg,
        stats = {"error": f"{type(e).__name__}: {e}",
                 "failed": len(sched)}     # not a hung one
    q.put((w, stats))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dmclock_tpu_torch.net.loadgen")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per worker")
    ap.add_argument("--n-clients", type=int, default=16)
    ap.add_argument("--max-nops", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout-s", type=float, default=0.5)
    ap.add_argument("--max-attempts", type=int, default=8)
    ap.add_argument("--fault-spec", default=None,
                    help="client-side stalls (net.faults grammar)")
    ap.add_argument("--schedule-only", action="store_true",
                    help="print the schedule JSON and exit (the "
                    "determinism gate / chaos oracle feed)")
    args = ap.parse_args(argv)

    scheds = full_schedule(args.seed, workers=args.workers,
                           requests=args.requests,
                           n_clients=args.n_clients,
                           max_nops=args.max_nops)
    if args.schedule_only:
        sys.stdout.write(schedule_blob(scheds).decode("utf-8") + "\n")
        return 0
    if not args.port:
        ap.error("--port is required (unless --schedule-only)")

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker_main, args=(args, w, q),
                         daemon=True)
             for w in range(args.workers)]
    for p in procs:
        p.start()
    merged: dict = {}
    for _ in procs:
        w, stats = q.get()
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                merged[k] = merged.get(k, 0) + v
            else:
                merged.setdefault("errors", []).append(v)
    for p in procs:
        p.join(timeout=30)
    merged["workers"] = args.workers
    merged["requests_per_worker"] = args.requests
    merged["schedule_sha"] = hashlib.sha256(
        schedule_blob(scheds)).hexdigest()
    sys.stdout.write(json.dumps(merged, sort_keys=True) + "\n")
    return 1 if merged.get("failed", 0) or "errors" in merged else 0


if __name__ == "__main__":
    raise SystemExit(main())
