"""The serving entry point: the ``serve`` workload's shape.

``serve_only`` builds a preloaded steady-state backlog (every client
queued ``depth`` deep, weights 1..4, a reservation of 100 ops/s, no
limit) and runs prefix-commit epochs over it at ``now = 0`` -- the
shape of the JAX package's ``bench.py`` ``serve`` workload
(``bench_serve_only``): 100,000 clients, a 320-slot ring, m=32 batches
of up to k=65536 decisions per epoch, sorted selection, int64 tags,
metrics on.

Run it (on the card; ``device="cpu"`` for a small CPU run)::

    python -m dmclock_tpu_torch.serve --n 100000 --epochs 3
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import numpy as np
import torch

from .core.timebase import rate_to_inv_ns
from .device import DEFAULT_DEVICE, resolve_device
from .engine.bridge import state_from_numpy
from .engine.fastpath import scan_prefix_epoch
from .engine.state import EngineState, _FRESH_FILLS
from .obs import device as obsdev


def _preloaded_state(n_clients: int, depth: int, ring: int = 64, *,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> EngineState:
    """Every client queued ``depth`` deep (the port's copy of the JAX
    package's ``__graft_entry__._preloaded_state``).

    Head proportion tags are staggered over each client's own serve
    period (2 * weight_inv) by a Weyl-sequence phase, so same-weight
    clients do not form lock-stepped tag cohorts.  Built in numpy and
    copied to ``device`` once."""
    n = n_clients
    c = np.arange(n)
    rinv = np.full(n, rate_to_inv_ns(100.0), dtype=np.int64)
    winv = np.asarray([rate_to_inv_ns(1.0 + w) for w in range(4)],
                      dtype=np.int64)[c % 4]
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    jitter = (phase * 2.0 * winv).astype(np.int64)
    q_arr = np.zeros((n, ring), dtype=np.int64)
    q_arr[:, :depth - 1] = np.arange(1, depth, dtype=np.int64)
    arrays = {f: np.full((n,), fill, dtype=np.int64)
              for f, fill in _FRESH_FILLS.items()}
    arrays.update(
        active=np.ones(n, dtype=bool), idle=np.zeros(n, dtype=bool),
        head_ready=np.zeros(n, dtype=bool),
        order=c.astype(np.int64),
        resv_inv=rinv, weight_inv=winv,
        head_resv=rinv.copy(),           # first tag = inv * 1 unit
        head_prop=winv + jitter,
        head_limit=np.full(n, -(1 << 62), dtype=np.int64),
        depth=np.full(n, depth, dtype=np.int32),
        q_head=np.zeros(n, dtype=np.int32),
        q_arrival=q_arr,
        q_cost=np.ones((n, ring), dtype=np.int64),
    )
    return state_from_numpy(arrays, device)


class ServeResult(NamedTuple):
    """``epochs`` prefix-commit epochs' output (stacked on the device)."""

    state: EngineState      # after the last epoch
    count: torch.Tensor     # int32[E, m] decisions committed per batch
    guards_ok: torch.Tensor  # bool[E, m]
    slot: torch.Tensor      # int32[E, m, k] serial-order winners
    phase: torch.Tensor     # int8[E, m, k]
    cost: torch.Tensor      # int32[E, m, k]
    metrics: torch.Tensor   # int64[NUM_METRICS], merged over epochs


def serve_epochs(state: EngineState, epochs: int, *, k: int = 65536,
                 m: int = 32) -> ServeResult:
    """Run ``epochs`` prefix epochs at ``now = 0`` from ``state``; no
    host synchronisation between epochs."""
    met = obsdev.metrics_zero(state.device)
    counts, guards, slots, phases, costs = [], [], [], [], []
    for _ in range(epochs):
        ep = scan_prefix_epoch(state, 0, m, k, anticipation_ns=0,
                               with_metrics=True)
        state = ep.state
        counts.append(ep.count)
        guards.append(ep.guards_ok)
        slots.append(ep.slot)
        phases.append(ep.phase)
        costs.append(ep.cost)
        met = obsdev.metrics_combine(met, ep.metrics)
    return ServeResult(state=state, count=torch.stack(counts),
                       guards_ok=torch.stack(guards),
                       slot=torch.stack(slots), phase=torch.stack(phases),
                       cost=torch.stack(costs), metrics=met)


def serve_only(n: int = 100_000, depth: int = 320, k: int = 65536,
               m: int = 32, epochs: int = 3, *,
               device: str | torch.device = DEFAULT_DEVICE
               ) -> ServeResult:
    """The ``serve`` workload: ``n`` clients preloaded ``depth`` deep in
    a ``depth``-slot ring, then ``epochs`` epochs of ``m`` batches of up
    to ``k`` decisions.  Callers check every ``guards_ok``."""
    state = _preloaded_state(n, depth, ring=depth,
                             device=resolve_device(device))
    return serve_epochs(state, epochs, k=k, m=m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--depth", type=int, default=320)
    ap.add_argument("--k", type=int, default=65536)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    res = serve_only(a.n, a.depth, a.k, a.m, a.epochs, device=a.device)
    print(json.dumps({
        "device": str(res.state.device),
        "decisions": int(res.count.sum()),
        "guards_ok": bool(res.guards_ok.all()),
        "metrics": obsdev.metrics_dict(res.metrics)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
