"""The serving entry points: the ``serve``, ``chain``, ``cfg3``,
``cfg4`` and ``queue`` workloads.

``serve_only`` builds a preloaded steady-state backlog (every client
queued ``depth`` deep, weights 1..4, a reservation of 100 ops/s, no
limit) and runs prefix-commit epochs over it at ``now = 0`` -- the
shape of the JAX package's ``bench.py`` ``serve`` workload
(``bench_serve_only``): 100,000 clients, a 320-slot ring, m=32 batches
of up to k=65536 decisions per epoch, metrics on, with its knobs:
``select_impl`` ("sort" or "radix"), ``tag_width`` (64 or 32) and
``window_m``.  ``high_rate_state`` is the same backlog at 1000x the
rates, the shape on which the int32 tag carry never trips.

``serve_chain`` runs the chain engine (``scan_chain_epoch``) on the same
backlog at ``now = 20 ms``, where every reservation tag is eligible; its
units are one decision long there, since every request costs the same.
``variable_cost_state`` is the backlog with per-request costs, on which
``chain_epochs`` commits longer units.

``serve_cfg3`` and ``serve_cfg4`` run bench's sustained closed loops
(``bench.py`` ``bench_sustained``), named by bench's row keys.  ``cfg3``:
10,000 clients, weights 1..4, a reservation of 100 ops/s each, a
256-slot ring preloaded 128 deep, 100 ms rounds of 32 waves, each round
(``prefix_round``) m=32 flat prefix batches of up to k=4096 decisions.
``cfg4``: 100,000 clients with Zipf weights and a reservation of 1200
ops/s each, a 128-slot ring preloaded 64 deep, 50 ms rounds of 64 waves,
each round (``calendar_round``) m=3 calendar batches of 64 serve steps
per client on the ``calendar_impl`` scheme: "minstop" is bench's
``cfg4`` row, "wheel" (8 ladder levels on the timer wheel) its
``cfg4_wheel``.  Every round clamps the Poisson arrivals to ring
headroom and ingests them in one ring pass.  Before the timed rounds,
``sustained_prepare`` (``cfg3_setup``, ``cfg4_setup``) runs bench's
calibration on the same ``default_rng(11)`` stream: a warm round, then
one calibration iteration of two rounds for cfg3 and five for cfg4,
which set each client's arrival rate to its measured service (with a
load probe and an overload back-off) and, for cfg4, retune the
reservations toward a 0.5 reservation share; the timed rounds then draw
from the calibrated rates, all before the first of them.  The telemetry
accumulators (histograms, ledger, SLO window block, provenance) ride
the timed rounds, on by default as in bench; ``row_scalars`` reads
bench's derived scalars from them.  ``engine_loop="stream"`` runs the
rounds as stream chunks of 8 (``engine.stream``; bench's
``cfg3_stream`` and ``cfg4_stream``).  ``sustained_row`` is bench's row
whole, key for key: timed chain pairs with the differenced ``dps``, the
SLO block rolled once a chain into the burn-rate verdict, the derived
scalars, the conformance rounds and table, the windowed latency rounds
and the telemetry and provenance tails; ``frontier`` sweeps cfg4 over
its batch count with bench's ``--target-latency`` pick
(``frontier_pick``).  Bench's rows run as bench compiles them: each
captures its program once (``obs/compile_plane.py`` ``aot_record``, a
CUDA graph on the card) and replays it, ``serve_row`` its epoch
(``bench.serve``), ``sustained_row`` its round (``bench.round``,
:func:`round_program`, calibration included) and stream chunks
(``bench.chunk``); ``cfg3_stream``/``cfg4_stream`` replay
``engine.stream.jit_stream_chunk`` with the state donated.

``serve_queue`` drives the pull queue API (``engine.queue``) at cfg3's
population, 10,000 clients, through the exact serial engine (no K1 or
K2 launch); ``virtual_server`` runs the push queue in the virtual-time
embedding, or the pull queue, behind a simulated server.

``churn_row`` is bench's ``churn_<scenario>`` row: an open population
(4,096 ids on ``flash_crowd``) driven by the lifecycle plane over
guarded prefix epochs (m=4, k=256, ring 32) with the admin API on a
live HTTP endpoint and a real ``PUT /clients/{id}/qos`` halfway.

``controller_row``, ``rpc_row`` and ``mesh_rebalance_row`` are bench's
control-plane rows: exact supervised twins with the closed-loop
controller off and on over three churn scenarios; the RPC ingest front
end on real loopback sockets with its live-versus-replay digest gate
(and a chaos leg under a network fault spec); and the shard-rebalancing
A/B, the static mesh against p2c placement with live migration.

``mesh_row`` is bench's ``mesh`` row: 100,000 clients over S shards
stacked on one card (``parallel.mesh``), each a full prefix engine on
its own partition, coordinated by the delta/rho counter sum at epoch
boundaries; ``fault_spec`` makes it a chaos run.  ``multichip_row`` is
the cluster dry run (``__graft_entry__.dryrun_multichip``) on
``parallel.cluster.cluster_step`` under both trackers, with its QoS
assertions; ``cluster_outage`` runs ``robust_cluster_step`` under a
single outage.

Run it (on the card; ``--device cpu`` for a small CPU run)::

    python -m dmclock_tpu_torch.serve --n 100000 --epochs 3
    python -m dmclock_tpu_torch.serve --select-impl radix --tag-width 32
    python -m dmclock_tpu_torch.serve --workload chain --epochs 1
    python -m dmclock_tpu_torch.serve --workload cfg3 --spans
    python -m dmclock_tpu_torch.serve --workload cfg3 --engine-loop stream
    python -m dmclock_tpu_torch.serve --workload cfg4 --conformance-out f
    python -m dmclock_tpu_torch.serve --workload cfg4 --calendar-impl wheel \
        --rounds 6 --rounds-lo 2 --reps 2 --latency-rounds 16
    python -m dmclock_tpu_torch.serve --workload frontier --target-latency 1000
    python -m dmclock_tpu_torch.serve --workload cfg4 --n 256 --rounds 3 \
        --rounds-lo 0 --latency-rounds 8 --device cpu
    python -m dmclock_tpu_torch.serve --workload queue [--n 10000]
    python -m dmclock_tpu_torch.serve --workload churn
    python -m dmclock_tpu_torch.serve --workload churn --n 512 \
        --epochs 32 --k 64 --device cpu
    python -m dmclock_tpu_torch.serve --workload mesh --n-shards 8
    python -m dmclock_tpu_torch.serve --workload mesh --n-shards 4 \
        --clients 2048 --device cpu
    python -m dmclock_tpu_torch.serve --workload multichip
    python -m dmclock_tpu_torch.serve --workload controller
    python -m dmclock_tpu_torch.serve --workload controller --n 96 \
        --epochs 32 --device cpu
    python -m dmclock_tpu_torch.serve --workload rpc --rpc-fault-spec \
        seed=7,p_drop=0.1,p_dup=0.05,p_reorder=0.05
    python -m dmclock_tpu_torch.serve --workload mesh --rebalance on
    python -m dmclock_tpu_torch.serve --workload mesh_rebalance --device cpu
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import heapq
import json
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .core.qos import ClientInfo
from .core.recs import ReqParams
from .core.timebase import MAX_TAG, rate_to_inv_ns
from .device import (DEFAULT_DEVICE, parse_devices, resolve_device,
                     resolve_devices)
from .engine.bridge import state_from_numpy
from .engine.fastpath import (CalendarEpoch, PrefixEpoch,
                              scan_calendar_epoch, scan_chain_epoch,
                              scan_prefix_epoch)
from .engine.kernels import as_scalar, ingest_superwave
from .engine.push_queue import TpuPushPriorityQueue
from .engine.queue import TpuPullPriorityQueue
from .engine.state import FIELD_DTYPES, EngineState, _FRESH_FILLS, init_state
from .engine.stream import (STREAM_GUARD_FIELD, STREAM_OUT_FIELDS,
                            build_stream_chunk, jit_ingest_step,
                            jit_stream_chunk)
from .lifecycle import (LifecyclePlane, SlotMap, lam_vector, make_spec,
                        mount_admin_api, static_variant)
from .lifecycle.plane import canon_results
from .obs import capacity as obscap
from .obs import compile_plane
from .obs import device as obsdev
from .obs import histograms as obshist
from .obs import provenance as obsprov
from .obs import slo as obsslo
from .obs import spans as obsspans
from .obs.alerts import SloEvaluator
from .obs.registry import MetricsHTTPServer, MetricsRegistry
from .obs.slo import SloPlane
from .parallel.groups import tree_map
from .robust.digest import DIGEST_FIELDS, digest_update
from .robust.guarded import run_epoch_guarded

_NP_DTYPES = {torch.int64: np.int64, torch.int32: np.int32,
              torch.bool: np.bool_}


def _fresh_arrays(n: int, ring: int) -> dict:
    """Every state field as a numpy array holding ``init_state``'s fill,
    with the field's dtype (the rings [n, ring], the rest [n])."""
    return {f: np.full((n, ring) if f in ("q_arrival", "q_cost") else (n,),
                       fill, dtype=_NP_DTYPES[FIELD_DTYPES[f]])
            for f, fill in _FRESH_FILLS.items()}


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
    arrays = _fresh_arrays(n, ring)
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


def high_rate_state(n: int, ring: int = 128, *,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> EngineState:
    """The preloaded backlog, ``ring`` deep in a ``ring``-slot ring, with
    every client's rates x1000 (weights 1000..4000 ops/s, reservation
    100,000 ops/s): each serve advances a tag by about 1e6 ns, so a
    whole serve epoch's drift fits the int32 carry's window and
    ``tag_width=32`` never trips.  The port's copy of the JAX package's
    ``profile_fastpath._high_rate_state``, which preloads 128 deep (the
    same state at its ring of 128).  At the default rates a tag moves
    0.25-1 s a serve and the carry trips inside the first epoch."""
    st = _preloaded_state(n, ring, ring=ring, device=device)
    return st._replace(resv_inv=st.resv_inv // 1000,
                       weight_inv=st.weight_inv // 1000,
                       head_resv=st.head_resv // 1000,
                       head_prop=st.head_prop // 1000)


def variable_cost_state(n: int, depth: int, seed: int = 5, *,
                        device: str | torch.device = DEFAULT_DEVICE
                        ) -> EngineState:
    """The preloaded backlog (``depth`` deep in a ``depth``-slot ring)
    with every request's cost drawn from 1..4
    (``numpy.random.default_rng(seed)``), the head tags as in the
    uniform backlog.  A weight serve pays its reservation debt with the
    served request's cost and tags the next request with that one's, so
    where the next cost is lower the reservation tag falls to ``now`` or
    below and the chain engine serves the client again in the same unit:
    at ``now = 0`` units of length 2 occur from the first batch."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 5, n, dtype=np.int64)
    ring = rng.integers(1, 5, (n, depth), dtype=np.int64)
    st = _preloaded_state(n, depth, ring=depth, device=device)
    return st._replace(head_cost=torch.from_numpy(head).to(st.device),
                       q_cost=torch.from_numpy(ring).to(st.device))


def serve_epochs(state: EngineState, epochs: int, *, k: int = 65536,
                 m: int = 32, select_impl: str = "sort",
                 tag_width: int = 64, window_m: int | None = None,
                 now_ns: int = 0) -> ServeResult:
    """Run ``epochs`` prefix epochs at ``now_ns`` from ``state``; no host
    synchronisation between epochs.  ``select_impl``, ``tag_width`` and
    ``window_m`` as in ``scan_prefix_epoch``."""
    met = obsdev.metrics_zero(state.device)
    counts, guards, slots, phases, costs = [], [], [], [], []
    for _ in range(epochs):
        ep = scan_prefix_epoch(state, now_ns, m, k, anticipation_ns=0,
                               with_metrics=True, select_impl=select_impl,
                               tag_width=tag_width, window_m=window_m)
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
               m: int = 32, epochs: int = 3, *, select_impl: str = "sort",
               tag_width: int = 64, window_m: int | None = None,
               device: str | torch.device = DEFAULT_DEVICE
               ) -> ServeResult:
    """The ``serve`` workload: ``n`` clients preloaded ``depth`` deep in
    a ``depth``-slot ring, then ``epochs`` epochs of ``m`` batches of up
    to ``k`` decisions (the knobs of ``bench_serve_only``).  Callers
    check every ``guards_ok``: under ``tag_width=32`` a carry trip
    clears it for the rest of that epoch."""
    state = _preloaded_state(n, depth, ring=depth,
                             device=resolve_device(device))
    return serve_epochs(state, epochs, k=k, m=m, select_impl=select_impl,
                        tag_width=tag_width, window_m=window_m)


def _timed_serve_chain(state: EngineState, epochs: int, run,
                       tracer=None):
    """Bench's ``_timed_chain``: ``epochs`` replays of the captured epoch
    ``run`` (``(state, now) -> PrefixEpoch``, the state donated) launched
    back to back and one synchronisation at the end; returns ``(state,
    decisions, wall_s, guards_ok, metrics)``.  Every epoch's guards are
    read (a trip mid-chain zeroes that epoch's counts), and the counts
    and metrics are read back after the clock stops."""
    t0 = time.perf_counter()
    counts, guards, mets = [], [], []
    for _ in range(epochs):
        with obsspans.span(tracer, "bench.epoch", "dispatch"):
            ep = run(state, 0)
            state = ep.state
            counts.append(ep.count)
            guards.append(ep.guards_ok)
            mets.append(ep.metrics)
    with obsspans.span(tracer, "bench.digest_sync", "device_compute"):
        _sync(state.device)
    wall = time.perf_counter() - t0
    g_ok = all(bool(g.all()) for g in guards)
    total = int(sum(int(c.sum()) for c in counts))
    met = obsdev.metrics_combine_np(
        np.zeros(obsdev.NUM_METRICS, dtype=np.int64),
        *[m.cpu().numpy() for m in mets])
    return state, total, wall, g_ok, met


def serve_row(k: int = 65536, m: int = 32, *, epochs_lo: int = 3,
              epochs_hi: int = 6, depth: int = 320, reps: int = 5,
              n: int = 100_000, with_metrics: bool = True,
              select_impl: str = "sort", tag_width: int = 64,
              window_m: int | None = None, tracer=None,
              device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Bench's ``serve`` row (``bench_serve_only``, line for line): the
    preloaded weight steady state, serving only.

    Each of ``reps`` fresh preloaded states runs a warm chain of one
    epoch, then a chain of ``epochs_lo`` and one of ``epochs_hi``
    epochs, each timed from its first launch to one synchronisation.
    The difference of the pair cancels the fixed cost of a chain; a
    pair is dropped when ``t_hi <= t_lo`` or the short chain sits under
    ``1.2 *`` :func:`scalar_latency`, and ``dps`` is the median of the
    valid pairs (none valid raises).  A guard trip in a timed chain
    raises, as bench's assert does.  Keys are bench's: ``dps``,
    ``decisions``, ``reps`` (each pair's rate in millions), ``fill``,
    ``select_impl``, ``tag_width``, ``spans`` with a tracer,
    ``device_metrics``, ``cost_analysis`` (the cost counter's count of
    one epoch on the preloaded state, after the timed chains) and the
    capacity record (``projected_hbm_bytes``, the compile plane's
    ``compile_ms_total`` and ``retraces`` over the row, ``roofline`` and
    ``bound_class``).  Every epoch is a replay of bench's ``bench.serve``
    program, ``scan_prefix_epoch`` with the state donated, captured once
    for the row (``compile_plane.aot_record``) before the first chain."""
    dev = resolve_device(device)
    cp0 = compile_plane.plane().totals()
    state = _preloaded_state(n, depth, ring=depth, device=dev)
    need = (epochs_lo + epochs_hi + 1) * m * k
    # bench's margin: weights are 1..4, so the heaviest class is served
    # ~1.6x the mean; a backlog sized to the mean drains mid-chain
    assert need * 1.5 <= n * depth, \
        f"backlog {n * depth} cannot feed {need} decisions " \
        "with heavy-class margin"
    knobs = dict(m=m, k=k, with_metrics=with_metrics,
                 select_impl=select_impl, tag_width=tag_width,
                 window_m=window_m)
    run = compile_plane.aot_record(
        "bench.serve", (n, k, m, depth, select_impl, tag_width, window_m,
                        with_metrics),
        functools.partial(scan_prefix_epoch, anticipation_ns=0, **knobs),
        state, 0, donate_argnums=(0,))
    lat = scalar_latency(dev)
    rates, total_d, total_pot = [], 0, 0
    met = np.zeros(obsdev.NUM_METRICS, dtype=np.int64)
    win = None if tracer is None else tracer.category_totals()
    wall_total = 0.0
    launches = 0
    for rep in range(max(reps, 1)):
        if rep:
            state = _preloaded_state(n, depth, ring=depth, device=dev)
        state, _, w0, _, _ = _timed_serve_chain(state, 1, run, tracer)
        state, d_lo, t_lo, g1, m1 = _timed_serve_chain(
            state, epochs_lo, run, tracer)
        state, d_hi, t_hi, g2, m2 = _timed_serve_chain(
            state, epochs_hi, run, tracer)
        assert g1 and g2, "rebase guards tripped -- untrustworthy"
        met = obsdev.metrics_combine_np(met, m1, m2)
        wall_total += w0 + t_lo + t_hi
        launches += 1 + epochs_lo + epochs_hi
        if t_hi <= t_lo or t_lo < 1.2 * lat:
            continue    # inverted by jitter, or the short chain at the
            #             synchronisation floor
        rates.append((d_hi - d_lo) / (t_hi - t_lo))
        total_d += d_hi + d_lo
        total_pot += (epochs_hi + epochs_lo) * m * k
    assert rates, \
        "no valid pair: chains too short for the synchronisation floor"
    out = {"dps": float(np.median(rates)), "decisions": total_d,
           "reps": [round(r / 1e6, 1) for r in rates],
           "fill": total_d / total_pot,
           "select_impl": select_impl, "tag_width": tag_width}
    sp = _span_summary(tracer, win, wall_total, launches)
    if sp is not None:
        out["spans"] = sp
        out["dispatch_ms_per_launch"] = sp["dispatch_ms_per_launch"]
        out["host_overhead_frac"] = sp["host_overhead_frac"]
    if with_metrics:
        out["device_metrics"] = obsdev.metrics_dict(met)
    # one launch counted on the preloaded state, outside every timed
    # chain and span
    del state, run
    fresh = _preloaded_state(n, depth, ring=depth, device=dev)
    out["cost_analysis"] = compile_plane.count_launch(
        lambda: scan_prefix_epoch(fresh, 0, anticipation_ns=0, **knobs))
    del fresh
    return obscap.capacity_row(out, dict(
        n=n, ring=depth, engine="prefix", m=m, k=k,
        select_impl=select_impl, tag_width=tag_width, window_m=window_m),
        cp0)


class ChainResult(NamedTuple):
    """``epochs`` chained epochs' output (stacked on the device)."""

    state: EngineState        # after the last epoch
    count: torch.Tensor       # int32[E, m] decisions per batch
    unit_count: torch.Tensor  # int32[E, m] committed units per batch
    guards_ok: torch.Tensor   # bool[E, m]
    slot: torch.Tensor        # int32[E, m, k] unit clients
    cls: torch.Tensor         # int8[E, m, k] unit entry classes
    length: torch.Tensor      # int8[E, m, k] unit decisions
    metrics: torch.Tensor     # int64[NUM_METRICS], merged over epochs


def chain_epochs(state: EngineState, epochs: int, *, k: int = 65536,
                 m: int = 8, chain_depth: int = 4,
                 now_ns: int = 20_000_000, select_impl: str = "sort",
                 tag_width: int = 64) -> ChainResult:
    """Run ``epochs`` chained epochs at ``now_ns`` from ``state``; no
    host synchronisation between epochs."""
    met = obsdev.metrics_zero(state.device)
    eps = []
    for _ in range(epochs):
        ep = scan_chain_epoch(state, now_ns, m, k, chain_depth=chain_depth,
                              anticipation_ns=0, with_metrics=True,
                              select_impl=select_impl, tag_width=tag_width)
        state = ep.state
        met = obsdev.metrics_combine(met, ep.metrics)
        eps.append(ep)
    return ChainResult(
        state=state, metrics=met,
        **{f: torch.stack([getattr(ep, f) for ep in eps])
           for f in ("count", "unit_count", "guards_ok", "slot", "cls",
                     "length")})


def serve_chain(n: int = 100_000, depth: int = 320, k: int = 65536,
                m: int = 8, epochs: int = 1, *, chain_depth: int = 4,
                now_ns: int = 20_000_000, select_impl: str = "sort",
                tag_width: int = 64,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> ChainResult:
    """The chain engine on the ``serve`` backlog: ``n`` clients
    preloaded ``depth`` deep, ``epochs`` epochs of ``m`` chained batches
    of up to ``k`` units of up to ``chain_depth`` decisions, at
    ``now_ns``.  At the default 20 ms every client's 10 ms reservation
    tag is eligible, so both phases occur: constraint serves first, then
    weight serves.  Every request costs 1, so a weight serve's
    reservation debt cancels its tag advance exactly and no unit grows
    past one decision (``variable_cost_state`` makes them grow)."""
    state = _preloaded_state(n, depth, ring=depth,
                             device=resolve_device(device))
    return chain_epochs(state, epochs, k=k, m=m, chain_depth=chain_depth,
                        now_ns=now_ns, select_impl=select_impl,
                        tag_width=tag_width)


# ----------------------------------------------------------------------
# the sustained closed loops: cfg3 (prefix engine) and cfg4 (calendar)
# ----------------------------------------------------------------------

# bench.py's cfg3 row (bench_sustained with the cfg3 shape): 10,000
# clients (the ``n`` argument), weights 1 + i % 4, 100 ops/s
# reservations, 100 ms rounds, the flat prefix engine at k=4096, m=32;
# no reservation-share target, so one calibration iteration
CFG3 = dict(ring=256, depth0=128, resv_rate=100.0, waves=32,
            dt_round_ns=100_000_000, m=32, k=4096, select_impl="sort",
            zipf=False, target_resv_share=0.0)

# the cfg4 workload's shape (bench.py cfg4 mode) at its starting values,
# calibrated toward a 0.5 reservation share over five iterations; the
# calendar scheme is an argument: bench's ``cfg4`` row is "minstop",
# ``cfg4_wheel`` is "wheel"
CFG4 = dict(ring=128, depth0=64, resv_rate=1200.0, waves=64,
            dt_round_ns=50_000_000, m=3, steps=64, ladder_levels=8,
            zipf=True, target_resv_share=0.5)

STREAM_CHUNK = 8     # bench's --stream-chunk default
SLO_RING_DEPTH = 32  # bench's SLO plane ring (bench_sustained)


def _zipf_weights(n: int, s: float = 1.1, lo: float = 0.5,
                  hi: float = 64.0) -> np.ndarray:
    """Zipf-by-rank weights, clipped to a sane QoS range and shuffled
    (seed 7) so slot order does not correlate with weight (the port's
    copy of ``bench._zipf_weights``)."""
    w = 1.0 / np.arange(1, n + 1) ** s
    w = np.clip(w / w[n // 2], lo, hi)
    rng = np.random.default_rng(7)
    rng.shuffle(w)
    return w


def _sustained_setup(n: int, ring: int, depth0: int,
                     resv_rates: np.ndarray, weights: np.ndarray, *,
                     resv_aligned: bool = False,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> EngineState:
    """Preload ``depth0``-deep queues for a mixed-QoS population (the
    port's copy of ``bench._sustained_setup``, with its per-client
    reservation-phase stagger, which ``resv_aligned`` drops so that
    reservation tags advance in lock-stepped cohorts).  A zero rate or
    weight disables that axis for the client (ClientInfo 0 -> 0) and
    pins its head tag to MAX_TAG.  Built in numpy, copied to ``device``
    once."""
    c = np.arange(n)
    rinv = np.asarray([rate_to_inv_ns(r) for r in resv_rates],
                      dtype=np.int64)
    winv = np.asarray([rate_to_inv_ns(w) for w in weights],
                      dtype=np.int64)
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    jitter = (phase * 2.0 * winv).astype(np.int64)
    rjit = np.zeros(n, dtype=np.int64) if resv_aligned else \
        (phase * 2.0 * rinv).astype(np.int64)
    q_arr = np.zeros((n, ring), dtype=np.int64)
    q_arr[:, :depth0 - 1] = np.arange(1, depth0, dtype=np.int64)
    arrays = _fresh_arrays(n, ring)
    arrays.update(
        active=np.ones(n, dtype=bool), idle=np.zeros(n, dtype=bool),
        order=c.astype(np.int64), resv_inv=rinv, weight_inv=winv,
        head_resv=np.where(rinv == 0, np.int64(MAX_TAG), rinv + rjit),
        head_prop=np.where(winv == 0, np.int64(MAX_TAG), winv + jitter),
        head_limit=np.full(n, -(1 << 62), dtype=np.int64),
        depth=np.full(n, depth0, dtype=np.int32),
        q_arrival=q_arr, q_cost=np.ones((n, ring), dtype=np.int64))
    return state_from_numpy(arrays, device)


def _row_cfg(workload: str, m: int | None = None,
             steps: int | None = None, shape: dict | None = None) -> dict:
    """The row's shape; ``shape`` replaces fields of :data:`CFG3` or
    :data:`CFG4` (bench's CPU shape of cfg3, a selection or ladder knob),
    and ``m`` and ``steps`` its batches a round and calendar steps (the
    frontier's points)."""
    if workload not in ("cfg3", "cfg4"):
        raise ValueError(f"unknown sustained workload {workload!r}")
    c = CFG3 if workload == "cfg3" else CFG4
    over = dict(shape or {}, **{k: v for k, v in (("m", m), ("steps", steps))
                                if v is not None})
    return dict(c, **over) if over else c


def sustained_qos(workload: str, n: int, shape: dict | None = None):
    """``(reservation rates, weights)`` of ``workload`` ("cfg3" or
    "cfg4") at ``n`` clients, as bench configures them.  A ``split_resv``
    share > 0 in the shape makes that share of the clients reservation
    only (weight 0) and the rest weight only (reservation 0), bench's
    split population."""
    c = _row_cfg(workload, shape=shape)

    def weights_of(count):
        return _zipf_weights(count) if c["zipf"] \
            else np.asarray([1.0 + (i % 4) for i in range(count)])

    split = c.get("split_resv", 0.0)
    if split > 0:
        n_resv = int(n * split)
        return (np.concatenate([np.full(n_resv, c["resv_rate"]),
                                np.zeros(n - n_resv)]),
                np.concatenate([np.zeros(n_resv), weights_of(n - n_resv)]))
    return np.full(n, c["resv_rate"]), weights_of(n)


def sustained_start(workload: str, n: int, *,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> EngineState:
    """The row's state before calibration (bench's
    ``_sustained_setup``), on ``device``."""
    c = _row_cfg(workload)
    resv_rates, weights = sustained_qos(workload, n)
    return _sustained_setup(n, c["ring"], c["depth0"], resv_rates,
                            weights, device=device)


def sustained_lam0(workload: str, n: int, *, m: int | None = None,
                   steps: int | None = None,
                   shape: dict | None = None) -> np.ndarray:
    """Bench's starting guess of the per-client arrival rate a round:
    the reservation floor plus the weight share of the surplus (the
    calendar's serve budget is ``m * n * steps``, the prefix engine's
    ``m * k``), clipped to ``waves - 1``.  The warm round draws from
    it."""
    c = _row_cfg(workload, m, steps, shape)
    resv_rates, weights = sustained_qos(workload, n, shape)
    serve_per_round = c["m"] * (n * c["steps"] if workload == "cfg4"
                                else c["k"])
    round_s = c["dt_round_ns"] / 1e9
    surplus = max(serve_per_round - float(resv_rates.sum()) * round_s, 0.0)
    return np.minimum(resv_rates * round_s
                      + surplus * (weights / weights.sum()),
                      c["waves"] - 1.0)


class Sustained(NamedTuple):
    """A sustained row ready for its timed rounds (``sustained_prepare``):
    the calibrated state, the timed rounds' arrival counts and where they
    start, and what calibration measured."""

    state: EngineState      # after the warm and calibration rounds
    draws: torch.Tensor     # int32[rounds, n] timed arrival counts
    t0: int                 # t_base of the first timed round
    lam: np.ndarray         # float64[n] calibrated arrival rates
    resv_share: float       # reservation share of the last calibration
    #                         iteration's decisions
    cal_rounds: int         # warm + calibration rounds run
    resv_rates: np.ndarray  # float64[n] calibrated reservation rates
    rng: np.random.Generator  # the arrival stream after the timed draws
    program: object = None  # the row's captured round (round_program)


def sustained_prepare(workload: str, n: int, rounds: int, seed: int = 11,
                      *, calendar_impl: str = "minstop",
                      m: int | None = None, steps: int | None = None,
                      shape: dict | None = None, telemetry: bool = True,
                      slo: bool = True, provenance: bool = True,
                      tracer=None,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> Sustained:
    """Bench's calibration (``bench_sustained``, in its order), then every
    timed round's draws, all on ``device`` before the first timed round.

    One ``numpy.random.default_rng(seed)`` stream feeds everything: the
    warm round at ``t = 0`` draws from the starting guess (the
    reservation floor plus the weight share of the surplus); then
    ``cal_iters`` iterations (1, or 5 with a calendar or a reservation-
    share target) of two rounds each, ``t_base`` advancing a round at a
    time.  Every round is a replay of the row's captured round
    (:func:`round_program`, captured before the warm round), with zeroed
    accumulators of the row's ``telemetry``, ``slo`` and ``provenance``
    riding it as bench's do, their counts then dropped.  Each iteration
    gathers per-client service (the calendar's ``served`` vector; the
    prefix rounds' committed slots) and sets
    ``lam = min(served / 2, waves - 1)``, raised by the load probe when
    the queues drained below 0.75 ``depth0`` and cut by the overload
    back-off above 1.5 ``depth0`` (neither in the last iteration); a
    reservation-share target rescales the reservation rates by
    ``clip((target / share) ** 0.6, 0.33, 3)`` and writes their inverses
    into the state.  The timed rounds' draws come next on the same
    stream, from the calibrated ``lam``.  The calibration rounds read
    their decisions back (untimed).  ``calendar_impl`` picks cfg4's
    scheme; ``shape``,
    ``m`` and ``steps`` override the row's shape (:func:`_row_cfg`).
    With a span ``tracer`` every round is a ``serve.round`` dispatch
    span.  Later draws (the conformance and latency rounds) continue on
    ``rng``."""
    from .core.timebase import MAX_INV_NS, NS_PER_SEC

    dev = resolve_device(device)
    c = _row_cfg(workload, m, steps, shape)
    resv_rates, weights = sustained_qos(workload, n, shape)
    state = _sustained_setup(n, c["ring"], c["depth0"], resv_rates,
                             weights, resv_aligned=c.get("resv_aligned",
                                                         False),
                             device=dev)
    calendar = workload == "cfg4"
    dt, waves = c["dt_round_ns"], c["waves"]
    lam = sustained_lam0(workload, n, m=m, steps=steps, shape=shape)
    rng = np.random.default_rng(seed)

    def draw():
        return np.minimum(rng.poisson(lam), waves).astype(np.int32)

    cal_tele = Tele(
        hists=obshist.hist_zero(dev) if telemetry else None,
        ledger=obshist.ledger_zero(n, dev) if telemetry else None,
        slo=obsslo.window_zero(n, dev) if slo else None,
        prov=obsprov.prov_init(n, 0, dev) if provenance else None)
    program = round_program(workload, n, c, calendar_impl, state, cal_tele,
                            telemetry=telemetry, slo=slo)

    def one_round(st, t_base):
        nonlocal cal_tele
        counts = torch.from_numpy(draw()).to(dev)
        with obsspans.span(tracer, "serve.round", "dispatch"):
            ep = program(st, counts, t_base, cal_tele)
        cal_tele = _tele_of(ep)
        return ep

    state = one_round(state, 0).state
    t_base = dt
    target = float(c["target_resv_share"])
    cal_iters = 5 if (calendar or target) else 1
    share = 0.0
    for it in range(cal_iters):
        served = np.zeros(n, dtype=np.int64)
        resv_total = 0
        for _ in range(2):
            ep = one_round(state, t_base)
            state = ep.state
            t_base += dt
            if calendar:
                resv_total += int(ep.resv_count.sum())
                served += ep.served.cpu().numpy().astype(np.int64)
            else:
                slots = ep.slot.cpu().numpy().ravel()
                phase = ep.phase.cpu().numpy().ravel()
                ok = slots >= 0
                resv_total += int((ok & (phase == 0)).sum())
                np.add.at(served, slots[ok], 1)
        total = int(served.sum())
        share = resv_total / max(total, 1)
        lam = np.minimum(served / 2, waves - 1.0)
        depth_mean = float(state.depth.cpu().numpy().mean())
        if depth_mean < 0.75 * c["depth0"] and it < cal_iters - 1:
            lam = np.minimum(np.maximum(lam * 1.4, lam + 0.5), waves - 1.0)
        elif depth_mean > 1.5 * c["depth0"] and it < cal_iters - 1:
            lam = lam * 0.85
        if target and total:
            adj = float(np.clip((target / max(share, 1e-3)) ** 0.6,
                                0.33, 3.0))
            resv_rates = resv_rates * adj
            # the vectorized rate_to_inv_ns: same rounding and sentinels
            with np.errstate(divide="ignore"):
                rinv = np.where(
                    resv_rates <= 0, 0,
                    np.minimum(np.rint(NS_PER_SEC
                                       / np.maximum(resv_rates, 1e-12)),
                               MAX_INV_NS)).astype(np.int64)
            state = state._replace(resv_inv=torch.from_numpy(rinv).to(dev))
    draws = torch.from_numpy(np.stack([draw() for _ in range(rounds)])) \
        .to(dev)
    return Sustained(state=state, draws=draws, t0=int(t_base), lam=lam,
                     resv_share=share, cal_rounds=1 + 2 * cal_iters,
                     resv_rates=resv_rates, rng=rng, program=program)


def _round_body(workload: str, c: dict, calendar_impl: str):
    """``(round function, its keywords)`` of the row's shape ``c``:
    :func:`calendar_round` on ``calendar_impl`` for cfg4,
    :func:`prefix_round` for cfg3."""
    base = dict(m=c["m"], waves=c["waves"], dt_round_ns=c["dt_round_ns"])
    if workload == "cfg4":
        return calendar_round, dict(base, steps=c["steps"],
                                    ladder_levels=c["ladder_levels"],
                                    calendar_impl=calendar_impl)
    return prefix_round, dict(base, k=c["k"], select_impl=c["select_impl"])


def round_entry(workload: str, n: int, c: dict, calendar_impl: str, *,
                telemetry: bool, slo: bool):
    """``(entry, body)`` of bench's ``bench.round`` program for the row's
    shape ``c``: bench's entry tuple (its ``wheel_kernel`` slot reads
    ``"cuda"``: K2 has one route here) and the round body of
    :func:`_round_body` as ``(state, counts, t_base, tele) -> epoch``."""
    round_fn, eng_kw = _round_body(workload, c, calendar_impl)
    calendar = workload == "cfg4"
    entry = (n, c.get("k", 0), c["m"], c["ring"],
             "calendar" if calendar else "prefix",
             c.get("select_impl", "sort"), calendar_impl,
             c["steps"] if calendar else 0, c.get("ladder_levels", 8),
             "cuda", 1, telemetry, slo, True)

    def round_body(state, counts, t_base, tele):
        return round_fn(state, counts, t_base, tele=tele, **eng_kw)

    return entry, round_body


def round_program(workload: str, n: int, c: dict, calendar_impl: str,
                  state: EngineState, tele, *, telemetry: bool, slo: bool):
    """Bench's ``bench.round`` program (:func:`round_entry`), captured
    now (``compile_plane.aot_record``) on ``state``, zero arrivals and
    ``tele``, with the state and the accumulators donated."""
    entry, body = round_entry(workload, n, c, calendar_impl,
                              telemetry=telemetry, slo=slo)
    zeros = torch.zeros((n,), dtype=torch.int32, device=state.device)
    return compile_plane.aot_record("bench.round", entry, body, state,
                                    zeros, 0, tele, donate_argnums=(0, 3))


def cfg3_setup(n: int = 10_000, rounds: int = 3, seed: int = 11, *,
               device: str | torch.device = DEFAULT_DEVICE) -> Sustained:
    """The cfg3 row calibrated as bench calibrates it (one iteration of
    two rounds after the warm round), with ``rounds`` timed rounds'
    draws: :func:`sustained_prepare`."""
    return sustained_prepare("cfg3", n, rounds, seed, device=device)


def cfg4_setup(n: int = 100_000, rounds: int = 3, seed: int = 11, *,
               calendar_impl: str = "minstop",
               device: str | torch.device = DEFAULT_DEVICE) -> Sustained:
    """The cfg4 row calibrated on ``calendar_impl`` as bench calibrates
    it (five iterations toward a 0.5 reservation share), with
    ``rounds`` timed rounds' draws: :func:`sustained_prepare`."""
    return sustained_prepare("cfg4", n, rounds, seed,
                             calendar_impl=calendar_impl, device=device)


class Tele(NamedTuple):
    """The telemetry accumulators a sustained row carries from round to
    round (bench's ``tele``): histograms and ledger (``--telemetry``),
    the provenance block (``--provenance``) and the SLO window block
    (``--slo``); None where off."""

    hists: object = None
    ledger: object = None
    slo: object = None
    prov: object = None


def slo_plane(workload: str, n: int, state: EngineState | None = None,
              shape: dict | None = None) -> SloPlane:
    """The row's SLO plane (host data): every client registered from the
    configured rates (no limit), ring depth 32, as ``bench_sustained``
    builds it; given the calibrated ``state``, every contract is then
    re-registered from its inverse-rate arrays, as bench does before the
    timed rounds."""
    cfg = _row_cfg(workload, shape=shape)
    resv_rates, weights = sustained_qos(workload, n, shape)
    plane = SloPlane(n, dt_epoch_ns=cfg["dt_round_ns"],
                     ring_depth=SLO_RING_DEPTH)
    for c in range(n):
        plane.register(c, float(resv_rates[c]), float(weights[c]), 0.0)
    if state is not None:
        plane.register_from_inv(state.resv_inv, state.weight_inv,
                                state.limit_inv)
    return plane


def tele_zero(n: int, *, telemetry: bool = True, provenance: bool = True,
              plane: SloPlane | None = None, t0: int = 0,
              device: str | torch.device = DEFAULT_DEVICE) -> Tele:
    """Fresh accumulators (bench's ``tele_zero``): ``t0`` is the
    provenance watermark's baseline; the SLO block is stamped from
    ``plane`` (None: SLO off)."""
    dev = resolve_device(device)
    return Tele(
        hists=obshist.hist_zero(dev) if telemetry else None,
        ledger=obshist.ledger_zero(n, dev) if telemetry else None,
        slo=None if plane is None else plane.stamp(obsslo.window_zero(n,
                                                                      dev)),
        prov=obsprov.prov_init(n, t0, dev) if provenance else None)


def _tele_of(ep) -> Tele:
    return Tele(hists=ep.hists, ledger=ep.ledger, slo=ep.slo, prov=ep.prov)


def _round_ingest(state: EngineState, counts: torch.Tensor, t_base, *,
                  waves: int, dt_round_ns: int):
    """A round's ingest (``bench_sustained``'s round body): clamp
    ``counts[N]`` to ring headroom, ingest them as ``waves`` waves spread
    over the round (cost = rho = delta = 1).  Returns ``(state, t_base
    0-d, dropped 0-d)``."""
    dev = state.device
    t_base = as_scalar(t_base, dev)
    headroom = torch.clamp(state.ring_capacity - state.depth,
                           min=0).to(torch.int32)
    counts, dropped = obsdev.admission_clamp(counts, headroom)
    wave_times = t_base + torch.arange(waves, dtype=torch.int64,
                                       device=dev) * (dt_round_ns // waves)
    ones = torch.ones((state.capacity,), dtype=torch.int64, device=dev)
    st = ingest_superwave(state, counts, wave_times, ones, ones, ones,
                          anticipation_ns=0)
    return st, t_base, dropped


def _with_drops(ep, dropped):
    return ep._replace(metrics=obsdev.metrics_combine(
        ep.metrics, obsdev.metrics_delta(device=ep.metrics.device,
                                         ingest_drops=dropped)))


def prefix_round(state: EngineState, counts: torch.Tensor, t_base, *,
                 m: int, k: int, waves: int, dt_round_ns: int,
                 select_impl: str = "sort", tele: Tele | None = None
                 ) -> PrefixEpoch:
    """One closed-loop round of the prefix engine (bench's round body
    for the cfg3 row): ingest, then ``m`` prefix batches of up to ``k``
    decisions at ``now = t_base + dt_round_ns``, the accumulators of
    ``tele`` riding them.  The epoch's metrics include the round's
    ``ingest_drops``."""
    st, t_base, dropped = _round_ingest(state, counts, t_base, waves=waves,
                                        dt_round_ns=dt_round_ns)
    ep = scan_prefix_epoch(st, t_base + dt_round_ns, m, k, anticipation_ns=0,
                           with_metrics=True, select_impl=select_impl,
                           **(tele or Tele())._asdict())
    return _with_drops(ep, dropped)


def calendar_round(state: EngineState, counts: torch.Tensor, t_base, *,
                   m: int, steps: int, ladder_levels: int, waves: int,
                   dt_round_ns: int, calendar_impl: str,
                   tele: Tele | None = None) -> CalendarEpoch:
    """One closed-loop round of the calendar engine (the cfg4 row's
    round body): ingest, then ``m`` calendar batches at ``now = t_base +
    dt_round_ns``, the accumulators of ``tele`` riding them.  The
    epoch's metrics include the round's ``ingest_drops``."""
    st, t_base, dropped = _round_ingest(state, counts, t_base, waves=waves,
                                        dt_round_ns=dt_round_ns)
    ep = scan_calendar_epoch(st, t_base + dt_round_ns, m, steps=steps,
                             with_metrics=True, calendar_impl=calendar_impl,
                             ladder_levels=ladder_levels,
                             **(tele or Tele())._asdict())
    return _with_drops(ep, dropped)


class Cfg3Result(NamedTuple):
    """``rounds`` cfg3 rounds' output (stacked on the device)."""

    state: EngineState        # after the last round
    count: torch.Tensor       # int32[R, m] decisions per batch
    guards_ok: torch.Tensor   # bool[R, m]
    slot: torch.Tensor        # int32[R, m, k] serial-order winners
    phase: torch.Tensor       # int8[R, m, k]
    cost: torch.Tensor        # int32[R, m, k]
    lb: torch.Tensor          # bool[R, m, k]
    metrics: torch.Tensor     # int64[NUM_METRICS], merged over rounds
    tele: Tele                # the accumulators after the last round


class Cfg4Result(NamedTuple):
    """``rounds`` cfg4 rounds' output (stacked on the device)."""

    state: EngineState         # after the last round
    count: torch.Tensor        # int32[R, m] decisions per batch
    resv_count: torch.Tensor   # int32[R, m]
    progress_ok: torch.Tensor  # bool[R, m]
    served: torch.Tensor       # int32[R, N] per-client decisions
    level_count: torch.Tensor  # int32[R, m, L]
    metrics: torch.Tensor      # int64[NUM_METRICS], merged over rounds
    tele: Tele = Tele()        # the accumulators after the last round


_CFG3_FIELDS = STREAM_OUT_FIELDS["prefix"]
_CFG4_FIELDS = STREAM_OUT_FIELDS["calendar"]


def cfg3_rounds(state: EngineState, draws: torch.Tensor, *, t0: int = 0,
                tele: Tele | None = None) -> Cfg3Result:
    """Round ``r`` ingests ``draws[r]`` at ``t_base = t0 + r * 100 ms``
    and serves at the end of the round; no host synchronisation between
    rounds."""
    c = CFG3
    tele = tele or Tele()
    met = obsdev.metrics_zero(state.device)
    eps = []
    for r in range(draws.shape[0]):
        ep = prefix_round(state, draws[r], t0 + r * c["dt_round_ns"],
                          m=c["m"], k=c["k"], waves=c["waves"],
                          dt_round_ns=c["dt_round_ns"],
                          select_impl=c["select_impl"], tele=tele)
        state, tele = ep.state, _tele_of(ep)
        met = obsdev.metrics_combine(met, ep.metrics)
        eps.append(ep)
    return Cfg3Result(
        state=state, metrics=met, tele=tele,
        **{f: torch.stack([getattr(ep, f) for ep in eps])
           for f in _CFG3_FIELDS})


def cfg4_rounds(state: EngineState, draws: torch.Tensor, *,
                calendar_impl: str, t0: int = 0,
                tele: Tele | None = None) -> Cfg4Result:
    """Round ``r`` ingests ``draws[r]`` at ``t_base = t0 + r * 50 ms``
    and runs the ``calendar_impl`` scheme ("minstop" is bench's ``cfg4``
    row, "wheel" its ``cfg4_wheel``); no host synchronisation between
    rounds."""
    c = CFG4
    tele = tele or Tele()
    met = obsdev.metrics_zero(state.device)
    eps = []
    for r in range(draws.shape[0]):
        ep = calendar_round(state, draws[r], t0 + r * c["dt_round_ns"],
                            m=c["m"], steps=c["steps"],
                            ladder_levels=c["ladder_levels"],
                            waves=c["waves"], dt_round_ns=c["dt_round_ns"],
                            calendar_impl=calendar_impl, tele=tele)
        state, tele = ep.state, _tele_of(ep)
        met = obsdev.metrics_combine(met, ep.metrics)
        eps.append(ep)
    return Cfg4Result(
        state=state, metrics=met, tele=tele,
        **{f: torch.stack([getattr(ep, f) for ep in eps])
           for f in _CFG4_FIELDS})


def _stream_rounds(state, draws, *, cfg: dict, engine: str, t0: int,
                   tele: Tele | None, chunk: int, **kw):
    """The rounds as stream chunks of ``chunk`` rounds (the last one
    shorter): ``build_stream_chunk`` per chunk length, epochs numbered
    from ``t0 / dt``.  Returns ``(state, tele, metrics merged over the
    rounds, per-round outs)``."""
    dt = cfg["dt_round_ns"]
    if t0 % dt:
        raise ValueError(f"stream rounds start on the round grid: t0 {t0} "
                         f"is not a multiple of {dt}")
    tele = tele or Tele()
    chunks, outs = {}, []
    r, rounds = 0, draws.shape[0]
    while r < rounds:
        c = min(chunk, rounds - r)
        if c not in chunks:
            chunks[c] = jit_stream_chunk(
                engine=engine, epochs=c, m=cfg["m"], dt_epoch_ns=dt,
                waves=cfg["waves"], with_metrics=True, donate=True, **kw)
        ch = chunks[c](state, t0 // dt + r, draws[r:r + c], tele.hists,
                       tele.ledger, None, tele.slo, tele.prov)
        state = ch.state
        tele = Tele(hists=ch.hists, ledger=ch.ledger, slo=ch.slo,
                    prov=ch.prov)
        outs.append(ch.outs)
        r += c
    outs = {f: torch.cat([o[f] for o in outs]) for f in outs[0]}
    met = obsdev.metrics_zero(state.device)
    for row in outs.pop("metrics"):
        met = obsdev.metrics_combine(met, row)
    return state, tele, met, outs


def cfg3_stream(state: EngineState, draws: torch.Tensor, *, t0: int = 0,
                tele: Tele | None = None, chunk: int = STREAM_CHUNK
                ) -> Cfg3Result:
    """The cfg3 rounds as stream chunks (bench's ``cfg3_stream`` row):
    equal to :func:`cfg3_rounds` in every output except the metrics'
    ``ingest_drops`` row, which the chunk does not count."""
    c = CFG3
    state, tele, met, outs = _stream_rounds(
        state, draws, cfg=c, engine="prefix", t0=t0, tele=tele,
        chunk=chunk, k=c["k"], select_impl=c["select_impl"])
    return Cfg3Result(state=state, metrics=met, tele=tele, **outs)


def cfg4_stream(state: EngineState, draws: torch.Tensor, *,
                calendar_impl: str, t0: int = 0, tele: Tele | None = None,
                chunk: int = STREAM_CHUNK) -> Cfg4Result:
    """The cfg4 rounds as stream chunks (bench's ``cfg4_stream`` row for
    ``calendar_impl``); as :func:`cfg3_stream`, no ``ingest_drops``."""
    c = CFG4
    state, tele, met, outs = _stream_rounds(
        state, draws, cfg=c, engine="calendar", t0=t0, tele=tele,
        chunk=chunk, k=c["steps"], calendar_impl=calendar_impl,
        ladder_levels=c["ladder_levels"])
    return Cfg4Result(state=state, metrics=met, tele=tele, **outs)


def _sustained_run(workload: str, n: int, rounds: int, seed: int, *,
                   telemetry: bool, slo: bool, provenance: bool,
                   engine_loop: str, stream_chunk: int, device, **kw):
    """The row: calibration, fresh accumulators at the calibrated time
    and the SLO contracts re-registered from the calibrated state, then
    the timed rounds.  Returns ``(prep, result)``."""
    if engine_loop not in ("round", "stream"):
        raise ValueError(f"engine_loop {engine_loop!r} is not round or "
                         f"stream")
    dev = resolve_device(device)
    prep = sustained_prepare(workload, n, rounds, seed,
                             calendar_impl=kw.get("calendar_impl", "minstop"),
                             telemetry=telemetry, slo=slo,
                             provenance=provenance, device=dev)
    plane = slo_plane(workload, n, state=prep.state) if slo else None
    tele = tele_zero(n, telemetry=telemetry, provenance=provenance,
                     plane=plane, t0=prep.t0, device=dev)
    if engine_loop == "stream":
        run = cfg3_stream if workload == "cfg3" else cfg4_stream
        kw["chunk"] = stream_chunk
    else:
        run = cfg3_rounds if workload == "cfg3" else cfg4_rounds
    return prep, run(prep.state, prep.draws, t0=prep.t0, tele=tele, **kw)


def serve_cfg3(n: int = 10_000, rounds: int = 3, seed: int = 11, *,
               telemetry: bool = True, slo: bool = True,
               provenance: bool = True, engine_loop: str = "round",
               stream_chunk: int = STREAM_CHUNK,
               device: str | torch.device = DEFAULT_DEVICE) -> Cfg3Result:
    """The ``cfg3`` workload (bench's ``cfg3`` row, ``cfg3_stream`` with
    ``engine_loop="stream"``): ``n`` clients calibrated as bench does,
    then ``rounds`` timed closed-loop rounds, telemetry, SLO window and
    provenance on by default as in bench.  Callers check every
    ``guards_ok``."""
    return _sustained_run("cfg3", n, rounds, seed,
                          telemetry=telemetry, slo=slo,
                          provenance=provenance, engine_loop=engine_loop,
                          stream_chunk=stream_chunk, device=device)[1]


def serve_cfg4(n: int = 100_000, rounds: int = 3, seed: int = 11, *,
               calendar_impl: str = "minstop", telemetry: bool = True,
               slo: bool = True, provenance: bool = True,
               engine_loop: str = "round",
               stream_chunk: int = STREAM_CHUNK,
               device: str | torch.device = DEFAULT_DEVICE) -> Cfg4Result:
    """The ``cfg4`` workload: ``n`` clients calibrated as bench does,
    then ``rounds`` timed closed-loop rounds on the ``calendar_impl``
    scheme (bench's ``cfg4`` is "minstop", ``cfg4_wheel`` "wheel"),
    telemetry, SLO window and provenance on by default as in bench.
    Callers check every ``progress_ok`` (False: the serial engine must
    take that batch)."""
    return _sustained_run("cfg4", n, rounds, seed,
                          calendar_impl=calendar_impl, telemetry=telemetry,
                          slo=slo, provenance=provenance,
                          engine_loop=engine_loop,
                          stream_chunk=stream_chunk, device=device)[1]


def _stderr_log(line: str) -> None:
    print(line, file=sys.stderr)


def row_tail(out: dict, tele: Tele, state: EngineState, t_end: int,
             dt_round_ns: int, *, watchdog=None, log=_stderr_log) -> dict:
    """Bench's telemetry and provenance scalars of a sustained row
    (``bench_sustained``'s tail), read back once from the accumulators
    into ``out``: reservation tardiness p50/p90/p99 (log2 bucket upper
    bounds), mean (histogram) and max (ledger), the ``telemetry`` block
    and the raw histogram block (``_hist_block``, the registry feed);
    the ``provenance`` block, winner margin p50/p99, the starvation
    watermark and the limit-gate share; and, from a starvation monitor
    at 8 rounds of virtual time observing at ``t_end`` (routed through
    ``watchdog`` when one is given, else ``log``), the first 8 clients
    it flags as ``starved_clients``."""
    if tele.hists is not None:
        h_np = obshist._np64(tele.hists)
        lt = obshist.ledger_totals(tele.ledger)
        for q, key in ((0.50, "tardiness_p50_ns"),
                       (0.90, "tardiness_p90_ns"),
                       (0.99, "tardiness_p99_ns")):
            out[key] = obshist.hist_percentile(
                h_np, obshist.HIST_RESV_TARDINESS, q)
        out["tardiness_mean_ns"] = obshist.hist_mean(
            h_np, obshist.HIST_RESV_TARDINESS)
        out["tardiness_max_ns"] = float(lt["tardiness_max_ns"])
        out["telemetry"] = {"histograms": obshist.hist_dict(h_np),
                            "ledger_totals": lt}
        out["_hist_block"] = h_np.tolist()
    if tele.prov is not None:
        pd = obsprov.prov_dict(tele.prov)
        out["provenance"] = pd
        out["margin_p50_ns"] = pd["margin_p50_ns"]
        out["margin_p99_ns"] = pd["margin_p99_ns"]
        out["starvation_max_ns"] = pd["starvation_max_ns"]
        out["limit_gate_share"] = round(pd["limit_gate_share"], 4)
        mon = obsprov.StarvationMonitor(8 * dt_round_ns, watchdog=watchdog,
                                        log=log)
        mon.observe(tele.prov, int(t_end), backlog=state.depth)
        if mon.fired:
            out["starved_clients"] = mon.fired[:8]
    return out


def row_scalars(tele: Tele, state: EngineState, t_end: int,
                dt_round_ns: int) -> dict:
    """:func:`row_tail` of the accumulators at ``t_end`` (its monitor
    silent), with the ledger's column totals and the SLO window block's
    column totals beside it."""
    out = row_tail({}, tele, state, t_end, dt_round_ns,
                   log=lambda _line: None)
    out.pop("_hist_block", None)
    if tele.ledger is not None:
        out["ledger_totals"] = obshist.ledger_totals(tele.ledger)
    if tele.slo is not None:
        out["slo_window_totals"] = obsslo.window_totals(tele.slo)
    return out


# bench's accelerator depth of each sustained row (bench.py main: cfg3
# 60 rounds after 20 in 3 pairs, cfg4 40 after 12 in 4 pairs and 100
# latency rounds) and its population
ROW_DEPTH = {"cfg3": dict(rounds=60, rounds_lo=20, reps=3, latency_rounds=0),
             "cfg4": dict(rounds=40, rounds_lo=12, reps=4,
                          latency_rounds=100)}
ROW_N = {"cfg3": 10_000, "cfg4": 100_000}
# bench_frontier: cfg4 over (m, steps) points, each row at this depth
FRONTIER = dict(points=((2, 64), (3, 64), (6, 64), (12, 64)), rounds=24,
                rounds_lo=8, reps=2, latency_rounds=60)


def scalar_latency(device: str | torch.device = DEFAULT_DEVICE,
                   reps: int = 5) -> float:
    """Seconds of one tiny device op and its read back, averaged over
    ``reps`` (the port's ``profile_util.scalar_latency``): the floor a
    timed chain's single synchronisation adds."""
    dev = resolve_device(device)
    x = torch.tensor(3, dtype=torch.int64, device=dev)
    int(x * 2 + 1)
    t0 = time.perf_counter()
    v = x
    for _ in range(reps):
        v = v * 2 + 1
        int(v)
    return (time.perf_counter() - t0) / reps


def state_digest(state: EngineState) -> torch.Tensor:
    """A 0-d int64 tensor that depends on every batch an epoch chain
    commits (each commit changes ``depth``, ``head_prop`` or
    ``prev_resv``): the port's ``profile_util.state_digest``.  Reading it
    back waits for the whole chain."""
    return state.depth.sum(dtype=torch.int64) + state.head_prop.sum() + \
        state.prev_resv.sum()


def _per_pass_cap(n: int, k: int, calendar_steps: int, calendar_impl: str,
                  ladder_levels: int) -> int:
    """Most decisions one batch can commit, the ``fill`` denominator
    (bench's ``_per_pass_cap``): ``k`` for the prefix engine,
    ``n * steps`` a calendar batch, times ``ladder_levels`` for the
    bucketed and wheel schemes, which refresh the step budget at every
    level."""
    if not calendar_steps:
        return k
    levels = ladder_levels \
        if calendar_impl in ("bucketed", "wheel") else 1
    return n * calendar_steps * levels


def _span_summary(tracer, window, wall_s: float, launches: int):
    """The span window over the timed chains (bench's ``_span_summary``):
    per-category self-time deltas, the per-launch dispatch/device split
    and the host-overhead share of the chains' wall."""
    if tracer is None or window is None:
        return None
    now = tracer.category_totals()
    d = {c: now.get(c, 0) - window.get(c, 0) for c in obsspans.CATEGORIES}
    wall_ns = max(wall_s * 1e9, 1.0)
    host_ns = d["ingest"] + d["host_prep"] + d["dispatch"] + \
        d["fetch"] + d["drain"]
    covered = host_ns + d["device_compute"] + d["checkpoint"]
    launches = max(launches, 1)
    return {
        "launches": launches,
        "dispatch_ms_per_launch": d["dispatch"] / launches / 1e6,
        "device_ms_per_launch": d["device_compute"] / launches / 1e6,
        "host_overhead_frac": host_ns / wall_ns,
        "covered_frac": covered / wall_ns,
        "wall_ms": wall_ns / 1e6,
        "categories_ms": {c: v / 1e6 for c, v in d.items() if v},
    }


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def sustained_row(workload: str, n: int | None = None, *,
                  rounds: int | None = None, rounds_lo: int | None = None,
                  reps: int | None = None,
                  latency_rounds: int | None = None,
                  conformance_rounds: int = 2, conformance_out=None,
                  calendar_impl: str = "minstop", m: int | None = None,
                  steps: int | None = None, telemetry: bool = True,
                  slo: bool = True, provenance: bool = True,
                  engine_loop: str = "round",
                  stream_chunk: int = STREAM_CHUNK, seed: int = 11,
                  shape: dict | None = None, tracer=None, watchdog=None,
                  device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Bench's sustained row whole (``bench_sustained``, in its order):
    the row's keys as one dict.

    After :func:`sustained_prepare` has calibrated the row and drawn
    every timed round: ``reps`` pairs of timed chains of ``rounds_lo``
    then ``rounds`` rounds (one chain of ``rounds`` when ``rounds_lo`` is
    0).  A chain's wall runs from its first launch to one synchronisation
    at its end; ``dps`` is the median over the valid differenced pairs
    (a pair is skipped when ``t_hi <= t_lo`` or ``t_lo < 1.2 *``
    :func:`scalar_latency`; none valid raises), with one chain ``d / (t
    - lat)``.  The SLO window block rolls once a chain (idle windows
    skipped) into a burn-rate evaluator.  Then ``fill``,
    ``resv_phase_frac``, ``mean_depth``, ``decisions_per_launch``,
    ``decisions_per_pass`` (cfg4), ``device_metrics`` and ``bounded_by``;
    ``conformance_rounds`` untimed rounds judge each client's delivered
    rate against its floor and weight share (``conformance``, their
    decisions ``conformance_decisions``; one JSON line a client into
    ``conformance_out``); ``latency_rounds`` rounds
    with a window of ``w`` in flight sample each round's completion
    interval (``round_ms_p50``/``p99``; a CUDA event a round, the oldest
    synchronised, so a sample waits for that round only); then the
    verdict (``slo``, ``slo_*``) and :func:`row_tail`.  Every round
    after calibration carries the accumulators.  On the card the chains'
    rounds are also timed by CUDA events (``event_round_ms_*``).  Last,
    ``cost_analysis``: the cost counter's count of one round on a copy
    of the calibrated state and fresh accumulators, with zero arrivals
    (bench counts its round on a zero-arrivals sample), and the capacity
    record with the compile plane's fields and the roofline verdict.

    ``engine_loop="stream"`` runs the chains as stream chunks of
    ``stream_chunk`` rounds.  Depth defaults to bench's accelerator
    depth (:data:`ROW_DEPTH`); ``m``/``steps`` override the shape (the
    frontier), ``shape`` its other fields (:func:`_row_cfg`)."""
    if engine_loop not in ("round", "stream"):
        raise ValueError(f"engine_loop {engine_loop!r} is not round or "
                         f"stream")
    cp0 = compile_plane.plane().totals()
    c = _row_cfg(workload, m, steps, shape)
    depth = ROW_DEPTH[workload]
    rounds = depth["rounds"] if rounds is None else rounds
    rounds_lo = depth["rounds_lo"] if rounds_lo is None else rounds_lo
    reps = depth["reps"] if reps is None else reps
    latency_rounds = depth["latency_rounds"] if latency_rounds is None \
        else latency_rounds
    n = ROW_N[workload] if n is None else n
    dev = resolve_device(device)
    calendar = workload == "cfg4"
    engine = "calendar" if calendar else "prefix"
    dt, waves, mb = c["dt_round_ns"], c["waves"], c["m"]
    stream_on = engine_loop == "stream"
    stream_chunk = max(int(stream_chunk), 1)
    rlo = max(rounds_lo, 0)
    n_pre = reps * (rlo + rounds) if rlo else rounds

    prep = sustained_prepare(workload, n, n_pre, seed,
                             calendar_impl=calendar_impl, m=m, steps=steps,
                             shape=shape, telemetry=telemetry, slo=slo,
                             provenance=provenance, tracer=tracer,
                             device=dev)
    state, draws, t_base = prep.state, prep.draws, prep.t0
    resv_rates = prep.resv_rates
    weights = sustained_qos(workload, n, shape)[1]
    round_fn, eng_kw = _round_body(workload, c, calendar_impl)
    program = prep.program

    def draw():
        return np.minimum(prep.rng.poisson(prep.lam), waves) \
            .astype(np.int32)

    plane = slo_plane(workload, n, state=state, shape=shape) if slo \
        else None
    slo_eval = SloEvaluator(plane, log=lambda _line: None) if slo else None
    tele = tele_zero(n, telemetry=telemetry, provenance=provenance,
                     plane=plane, t0=t_base, device=dev)
    # what the cost count runs on, after the timed section: the
    # calibrated state and fresh accumulators, copied to the host before
    # any round, so the timed section holds no second copy on the device
    count_from = (tree_map(_host_copy, state), tree_map(_host_copy, tele),
                  t_base)

    # bench's ``bench.chunk`` programs, one a chunk length the chains
    # use, each captured here on the calibrated state, zero arrivals and
    # the accumulators (donated), so no capture lands in a timed chain
    chunks = {}
    if stream_on:
        for span_len in ((rlo, rounds) if rlo else (rounds,)):
            for length in {min(stream_chunk, span_len - p)
                           for p in range(0, span_len, stream_chunk)}:
                if length in chunks:
                    continue
                chunks[length] = compile_plane.aot_record(
                    "bench.chunk",
                    (n, c.get("k", 0), mb, c["ring"], engine,
                     c.get("select_impl", "sort"), calendar_impl,
                     c["steps"] if calendar else 0, "cuda", telemetry,
                     slo, True, length),
                    build_stream_chunk(
                        engine=engine, epochs=length, m=mb, dt_epoch_ns=dt,
                        waves=waves, with_metrics=True, count_drops=True,
                        **({"k": c["steps"], "calendar_impl": calendar_impl,
                            "ladder_levels": c["ladder_levels"]}
                           if calendar else
                           {"k": c["k"], "select_impl": c["select_impl"]})),
                    state, t_base // dt,
                    torch.zeros((length, n), dtype=torch.int32,
                                device=dev), tele.hists, tele.ledger, None,
                    tele.slo, tele.prov, donate_argnums=(0, 3, 4, 5, 6, 7))

    def resv_of(slot, phase):
        return torch.sum((slot >= 0) & (phase == 0), dim=-1)

    met_acc = np.zeros(obsdev.NUM_METRICS, dtype=np.int64)
    span_win = None if tracer is None else tracer.category_totals()
    chain_walls, chain_launches, event_ms = [], [0], []
    slo_round0 = [0]
    on_card = dev.type == "cuda"

    def chain(lo, hi):
        nonlocal state, t_base, tele, met_acc
        cnts, rss, guards, mets, evs = [], [], [], [], []
        launches = 0
        if on_card:
            evs.append(torch.cuda.Event(enable_timing=True))
            evs[-1].record()
        t0 = time.perf_counter()
        pos = lo
        while pos < hi:
            if stream_on:
                cl = min(stream_chunk, hi - pos)
                with obsspans.span(tracer, "serve.chunk", "dispatch",
                                   rounds=cl):
                    ch = chunks[cl](state, t_base // dt,
                                    draws[pos:pos + cl], tele.hists,
                                    tele.ledger, None, tele.slo,
                                    tele.prov)
                    state = ch.state
                    tele = Tele(hists=ch.hists, ledger=ch.ledger,
                                slo=ch.slo, prov=ch.prov)
                    o = ch.outs
                    cnts.append(o["count"])
                    rss.append(o["resv_count"] if calendar
                               else resv_of(o["slot"], o["phase"]))
                    guards.append(o[STREAM_GUARD_FIELD[engine]])
                    mets.append(o["metrics"])
            else:
                cl = 1
                with obsspans.span(tracer, "serve.round", "dispatch"):
                    ep = program(state, draws[pos], t_base, tele)
                    state, tele = ep.state, _tele_of(ep)
                    cnts.append(ep.count)
                    rss.append(ep.resv_count if calendar
                               else resv_of(ep.slot, ep.phase))
                    guards.append(ep.progress_ok if calendar
                                  else ep.guards_ok)
                    mets.append(ep.metrics)
            if on_card:
                evs.append(torch.cuda.Event(enable_timing=True))
                evs[-1].record()
            t_base += cl * dt
            launches += 1
            pos += cl
        with obsspans.span(tracer, "serve.sync", "device_compute"):
            _sync(dev)
        wall = time.perf_counter() - t0
        chain_walls.append(wall)
        chain_launches[0] += launches
        per = (hi - lo) / launches
        event_ms.extend(a.elapsed_time(b) / per
                        for a, b in zip(evs, evs[1:]))
        if not all(bool(g.all()) for g in guards):
            raise AssertionError(f"{workload}: a guard tripped in a timed "
                                 f"chain -- its counts are not "
                                 f"trustworthy")
        cn = np.concatenate([_np(x).ravel() for x in cnts])
        rs = np.concatenate([_np(x).ravel() for x in rss])
        met_acc = obsdev.metrics_combine_np(
            met_acc, *[row for mv in mets
                       for row in np.atleast_2d(_np(mv))])
        if slo:
            fresh, closed = plane.roll(tele.slo, slo_round0[0],
                                       slo_round0[0] + hi - lo,
                                       skip_idle=True)
            slo_round0[0] += hi - lo
            slo_eval.observe_roll(closed)
            tele = tele._replace(slo=fresh)
        return int(cn.sum()), wall, cn, rs

    cap = _per_pass_cap(n, c.get("k", 0), c.get("steps", 0), calendar_impl,
                        c.get("ladder_levels", 0))
    lat = scalar_latency(dev)
    if rlo:
        rates, all_cnts, all_rs, total = [], [], [], 0
        pos = 0
        for _ in range(max(reps, 1)):
            d_lo, t_lo, cnts_lo, rs_lo = chain(pos, pos + rlo)
            d_hi, t_hi, cnts_hi, rs_hi = chain(pos + rlo,
                                               pos + rlo + rounds)
            pos += rlo + rounds
            total += d_lo + d_hi
            all_cnts += [cnts_lo, cnts_hi]
            all_rs += [rs_lo, rs_hi]
            if t_hi <= t_lo or t_lo < 1.2 * lat:
                continue
            rates.append((d_hi - d_lo) / (t_hi - t_lo))
        if not rates:
            raise AssertionError("no valid pair of timed chains: the "
                                 "chains are too short for the "
                                 "synchronisation floor")
        dps = float(np.median(rates))
        cnts = np.concatenate(all_cnts)
        rs = np.concatenate(all_rs)
    else:
        total, t_hi, cnts, rs = chain(0, rounds)
        dps = total / (t_hi - lat)
    denom = n_pre * mb * cap

    mean_depth = float(_np(state.depth).mean())
    out = {"dps": dps, "decisions": total,
           "fill": total / denom,
           "resv_phase_frac": float(rs.sum()) / max(cnts.sum(), 1),
           "mean_depth": mean_depth,
           "select_impl": c.get("select_impl", "sort"),
           "engine_loop": engine_loop,
           "provenance_on": bool(provenance),
           "chain_ms": [w * 1e3 for w in chain_walls],
           "sync_latency_ms": lat * 1e3}
    if event_ms:
        out["event_round_ms_median"] = float(np.median(event_ms))
        out["event_round_ms_mean"] = float(np.mean(event_ms))
    out["decisions_per_launch"] = total / max(chain_launches[0], 1)
    if stream_on:
        out["stream_chunk"] = stream_chunk
    sp = _span_summary(tracer, span_win, sum(chain_walls),
                       chain_launches[0])
    if sp is not None:
        out["spans"] = sp
        out["dispatch_ms_per_launch"] = sp["dispatch_ms_per_launch"]
        out["host_overhead_frac"] = sp["host_overhead_frac"]
        sp["decisions_per_launch"] = out["decisions_per_launch"]
        out["dispatch_ns_per_decision"] = sp["dispatch_ns_per_decision"] = \
            sp["dispatch_ms_per_launch"] * 1e6 \
            / max(out["decisions_per_launch"], 1e-9)
    if calendar:
        out["calendar_impl"] = calendar_impl
        out["decisions_per_pass"] = total / max(n_pre * mb, 1)
        if calendar_impl in ("bucketed", "wheel"):
            out["ladder_levels"] = c["ladder_levels"]
    md = obsdev.metrics_dict(met_acc)
    out["device_metrics"] = md
    if md.get("limit_stalls", 0):
        out["bounded_by"] = "scheduler_stalled"
    elif mean_depth < 0.75 * c["depth0"] and not md.get("ingest_drops", 0):
        out["bounded_by"] = "load_generator_capped"
    else:
        out["bounded_by"] = "engine_throughput"

    def untimed_round(counts):
        nonlocal state, t_base, tele
        with obsspans.span(tracer, "serve.round", "dispatch"):
            ep = program(state, counts, t_base, tele)
            state, tele = ep.state, _tele_of(ep)
        t_base += dt
        return ep

    if conformance_rounds:
        served_c = np.zeros(n, dtype=np.int64)
        conf_decisions = 0
        for _ in range(conformance_rounds):
            ep = untimed_round(torch.from_numpy(draw()).to(dev))
            conf_decisions += int(ep.count.sum())
            if calendar:
                served_c += _np(ep.served).astype(np.int64)
            else:
                slots = _np(ep.slot).ravel()
                np.add.at(served_c, slots[slots >= 0], 1)
        out["conformance"] = conformance_block(
            served_c, conformance_rounds * dt / 1e9, resv_rates, weights,
            conformance_out)
        out["conformance_decisions"] = conf_decisions

    if latency_rounds:
        lat_rt = scalar_latency(dev)
        round_est = (total / max(n_pre, 1)) / max(dps, 1.0)
        w = max(4, int(np.ceil(2.0 * lat_rt / max(round_est, 1e-4))))
        w = min(w, max(latency_rounds // 4, 4))
        n_rounds = latency_rounds + w
        pre2 = torch.from_numpy(np.stack([draw() for _ in range(n_rounds)])) \
            .to(dev)
        _sync(dev)
        pending, marks = [], []
        for i in range(n_rounds):
            untimed_round(pre2[i])
            ev = None
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
            pending.append(ev)
            if len(pending) >= w:
                ev = pending.pop(0)
                if ev is not None:
                    ev.synchronize()
                marks.append(time.perf_counter())
        _sync(dev)
        samples_ms = np.diff(np.asarray(marks)) * 1e3
        out["latency_samples"] = int(samples_ms.size)
        out["latency_window"] = w
        out["round_ms_p50"] = float(np.percentile(samples_ms, 50))
        out["round_ms_p99"] = float(np.percentile(samples_ms, 99))
        out["round_ms_mean"] = round_est * 1e3

    if slo:
        _slo_result_block(out, slo_eval)
    row_tail(out, tele, state, t_base, dt, watchdog=watchdog)
    out["cost_analysis"] = count_round(
        round_fn, eng_kw, tree_map(lambda t: t.to(dev), count_from[0]),
        tree_map(lambda t: t.to(dev), count_from[1]), count_from[2])
    del count_from
    # bench's capacity record: the knob setting's resident bytes
    return obscap.capacity_row(out, sustained_capacity_cfg(
        workload, n, calendar_impl=calendar_impl, telemetry=telemetry,
        slo=slo, engine_loop=engine_loop, stream_chunk=stream_chunk, m=m,
        steps=steps, shape=shape), cp0)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.to("cpu", copy=True)


def count_round(round_fn, eng_kw: dict, state: EngineState, tele: Tele,
                t_base: int) -> dict:
    """The cost counter's ``cost_analysis`` of one sustained round
    (``round_fn``, as :func:`_round_body` gives it) from ``state`` and
    ``tele`` at ``t_base`` with zero arrivals; the inputs are not
    changed."""
    zeros = torch.zeros((state.capacity,), dtype=torch.int32,
                        device=state.device)
    return compile_plane.count_launch(
        lambda: round_fn(state, zeros, t_base, tele=tele, **eng_kw))


def sustained_capacity_cfg(workload: str, n: int, *,
                           calendar_impl: str = "minstop",
                           telemetry: bool = True, slo: bool = True,
                           engine_loop: str = "round",
                           stream_chunk: int = STREAM_CHUNK,
                           m: int | None = None,
                           steps: int | None = None,
                           shape: dict | None = None) -> dict:
    """The sustained row's knob setting as ``obs.capacity`` reads it
    (bench's ``cap_cfg``): the projected resident bytes of the row and
    the pre-launch check of the session's ``--capacity``."""
    c = _row_cfg(workload, m, steps, shape)
    calendar = workload == "cfg4"
    return dict(n=n, ring=c["ring"],
                engine="calendar" if calendar else "prefix", m=c["m"],
                k=c["steps"] if calendar else c["k"], chain_depth=1,
                select_impl=c.get("select_impl", "sort"),
                calendar_impl=calendar_impl,
                ladder_levels=c.get("ladder_levels", 8),
                telemetry=telemetry, slo=slo,
                stream_chunk=stream_chunk if engine_loop == "stream"
                else 0)


def conformance_block(served: np.ndarray, window_s: float,
                      resv_rates: np.ndarray, weights: np.ndarray,
                      path=None) -> dict:
    """Bench's end-of-run conformance table: each client's delivered rate
    over ``window_s`` against its reservation floor (met at 0.95 of it)
    and its expected rate (floor plus its weight share of the surplus);
    with ``path``, one JSON line a client in bench's key order (a write
    error is reported on stderr, not raised)."""
    rate_c = served / window_s
    total_rate = rate_c.sum()
    has_resv = resv_rates > 0
    resv_met = rate_c >= 0.95 * resv_rates
    surplus = max(total_rate - float(resv_rates.sum()), 0.0)
    w_share = np.where(weights.sum() > 0,
                       weights / max(weights.sum(), 1e-12), 0.0)
    expect = resv_rates + surplus * w_share
    has_w = weights > 0
    share_err = np.abs(rate_c - expect) / np.maximum(expect, 1e-9)
    block = {
        "window_s": window_s,
        "clients": int(served.size),
        "resv_clients": int(has_resv.sum()),
        "resv_met_frac": float(resv_met[has_resv].mean())
        if has_resv.any() else 1.0,
        "share_err_mean": float(share_err[has_w].mean())
        if has_w.any() else 0.0,
        "delivered_rate_total": float(total_rate),
    }
    if path:
        try:
            with open(path, "w") as fh:
                for i in range(served.size):
                    fh.write(json.dumps({
                        "client": i,
                        "reservation": float(resv_rates[i]),
                        "weight": float(weights[i]),
                        "ops": int(served[i]),
                        "rate": float(rate_c[i]),
                        "expected_rate": float(expect[i]),
                        "resv_met": bool(resv_met[i])
                        if has_resv[i] else True,
                    }) + "\n")
        except OSError as e:
            _stderr_log(f"# conformance-out write failed: {e}")
    return block


def frontier_pick(rows: list, target_latency_ms: float) -> dict:
    """Bench's ``--target-latency`` pick over frontier rows: among the
    points that hold the 0.5 reservation share (within 0.1), the one
    with the most ``dps`` whose ``round_ms_mean`` fits the budget; with
    none fitting, the on-mix point with the shortest mean round (the
    first row when no point is on the mix).  ``met_budget`` says which."""
    fits = [x for x in rows
            if x["round_ms_mean"] <= target_latency_ms
            and abs(x["resv_phase_frac"] - 0.5) <= 0.1]
    pick = max(fits, key=lambda x: x["dps"]) if fits else \
        min((x for x in rows if abs(x["resv_phase_frac"] - 0.5) <= 0.1),
            key=lambda x: x["round_ms_mean"], default=rows[0])
    pick = dict(pick)
    pick["met_budget"] = bool(fits)
    return pick


def frontier(points=FRONTIER["points"], *, n: int = ROW_N["cfg4"],
             target_latency_ms: float = 0.0,
             rounds: int = FRONTIER["rounds"],
             rounds_lo: int = FRONTIER["rounds_lo"],
             reps: int = FRONTIER["reps"],
             latency_rounds: int = FRONTIER["latency_rounds"],
             tracer=None, watchdog=None,
             device: str | torch.device = DEFAULT_DEVICE):
    """The cfg4 throughput/latency frontier (bench's ``bench_frontier``):
    the cfg4 row at each ``(m, steps)`` point, SLO off, each reduced to
    ``m``, ``steps``, ``dps``, the round times, ``resv_phase_frac`` and
    ``decisions``.  Returns ``(pick, rows)``: :func:`frontier_pick` with
    a ``target_latency_ms``, else None."""
    rows = []
    for m, steps in points:
        r = sustained_row("cfg4", n, rounds=rounds, rounds_lo=rounds_lo,
                          reps=reps, latency_rounds=latency_rounds, m=m,
                          steps=steps, slo=False, tracer=tracer,
                          watchdog=watchdog, device=device)
        rows.append({"m": m, "steps": steps, "dps": r["dps"],
                     "round_ms_mean": r.get("round_ms_mean", 0.0),
                     "round_ms_p50": r.get("round_ms_p50", 0.0),
                     "round_ms_p99": r.get("round_ms_p99", 0.0),
                     "resv_phase_frac": r["resv_phase_frac"],
                     "decisions": r["decisions"]})
        _stderr_log(f"# frontier m={m} steps={steps}: "
                    f"{r['dps'] / 1e6:.1f}M dec/s, round mean "
                    f"{r.get('round_ms_mean', 0):.1f}ms, interval p99 "
                    f"{r.get('round_ms_p99', 0):.1f}ms")
    pick = frontier_pick(rows, target_latency_ms) if target_latency_ms \
        else None
    return pick, rows


# ----------------------------------------------------------------------
# the pull and push queue API at full width
# ----------------------------------------------------------------------

# the queue workload's shape: cfg3's sustained population (bench.py
# cfg3 mode, 10,000 clients) behind the pull queue, one 100 ms round of
# arrivals (cfg3's dt_round_ns) loaded through add_request
QUEUE = dict(adds_per_client=24, dt_round_ns=100_000_000, spec=64,
             batch=2048, stream_chunks=4, stream_dt_ns=1_000_000,
             stream_batch=256, pulls=512, pull_dt_ns=2_000,
             interleaved_adds=1000, updates=100, removes=10,
             final_batch=128, weight_now_ns=1_000_000, weight_batch=256)


def queue_classes(n: int, seed: int = 3) -> list:
    """``n`` ``ClientInfo``s, a seeded third of each class: cfg3's
    (reservation 100 ops/s, weight 1, no limit), the acceptance
    config's (``configs/dmc_sim_100th.conf``: reservation 20, weight 1,
    limit 60 ops/s), and best effort (weight 2-4, no reservation, no
    limit)."""
    rng = np.random.default_rng(seed)
    cls = rng.permutation(np.arange(n) % 3)
    weight = rng.integers(2, 5, n)
    return [ClientInfo(100.0, 1.0, 0.0) if c == 0
            else ClientInfo(20.0, 1.0, 60.0) if c == 1
            else ClientInfo(0.0, float(w), 0.0)
            for c, w in zip(cls.tolist(), weight.tolist())]


def queue_bulk_load(q, n: int, seed: int = 3) -> int:
    """Add the bulk load to the pull queue ``q`` without a flush: 24
    requests per client at seeded times over one 100 ms round, in time
    order; client ``c``'s ``j``-th is request ``(c, j)``.  Returns the
    number of adds."""
    k = QUEUE["adds_per_client"]
    rng = np.random.default_rng(seed + 1)
    t_add = rng.integers(0, QUEUE["dt_round_ns"], (n, k))
    order = np.argsort(t_add, axis=None, kind="stable")
    seq = np.zeros(n, dtype=np.int64)
    for c, t in zip((order // k).tolist(), t_add.reshape(-1)[order].tolist()):
        q.add_request((c, int(seq[c])), c, ReqParams(), time_ns=t)
        seq[c] += 1
    return n * k


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pullreq_row(pr) -> tuple:
    """A ``PullReq`` as a comparable tuple (phase by value)."""
    return (pr.type.value, pr.client, pr.request,
            None if pr.phase is None else int(pr.phase), pr.cost,
            pr.when_ready)


class QueueRun(NamedTuple):
    """Everything ``serve_queue`` observed, for exact comparison between
    devices, plus the host wall time of each stage."""

    pulls: list        # every PullReq handed out, as pullreq_row tuples
    removed: list      # requests remove_by_client handed back
    counters: dict     # scheduling, speculative-buffer and GC counters
    ledger: dict       # client -> ledger row (list)
    slo: dict          # client -> open SLO window row (list)
    rolled: list       # roll_slo_windows() rows
    departed: list     # departed_report() rows
    state: EngineState
    seconds: dict      # stage -> host wall seconds
    stats: dict        # adds, decisions, segments, ...


def serve_queue(n: int = 10_000, seed: int = 3, *,
                device: str | torch.device = DEFAULT_DEVICE) -> QueueRun:
    """The ``queue`` workload: ``n`` clients behind one
    ``TpuPullPriorityQueue(speculative_batch=64)`` on ``device``.

    Bulk load: 24 ``add_request``s per client at seeded times over one
    100 ms round, in time order (capacity grows 128 -> n's power of two,
    the ring 16 -> 32), then a flush.  Serving, in order: two
    ``pull_batch(100 ms, 2048)``; ``pull_batch_stream`` of 4 windows of
    256 at 1 ms spacing; 512 ``pull_request``s at an advancing now with
    1,000 adds interleaved (a tenth to new clients); ``update_client_info``
    for 100 clients; ``remove_by_client`` for 10; one
    ``remove_by_req_filter``; ``do_clean`` under an injected monotonic
    clock past the idle and the erase age (idle marks, erases, recycled
    slots, a reactivation); a last ``pull_batch``; then a ``pull_batch``
    of 256 at 1 ms, before every queued reservation tag, so its
    decisions are weight-phase.  Every stage's wall time is host-paced:
    each launch reads its decisions back."""
    dev = resolve_device(device)
    c = QUEUE
    infos = queue_classes(n + c["interleaved_adds"] + 100, seed)
    clock = [0.0]
    q = TpuPullPriorityQueue(lambda cid: infos[cid],
                             speculative_batch=c["spec"],
                             monotonic_clock=lambda: clock[0], device=dev)
    rng = np.random.default_rng(seed + 2)
    pulls, seconds = [], {}
    nxt = {cid: c["adds_per_client"] for cid in range(n)}

    def add(cid, t):
        seq = nxt.get(cid, 0)
        nxt[cid] = seq + 1
        return q.add_request((cid, seq), cid, ReqParams(), time_ns=t)

    def stage(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[name] = time.perf_counter() - t0
        return out

    def bulk():
        adds = queue_bulk_load(q, n, seed)
        q.flush()
        return adds

    adds = stage("bulk_load", bulk)
    t = c["dt_round_ns"]
    growth = dict(capacity=q.state.capacity, ring=q.state.ring_capacity,
                  segments=q.ingest_segments)
    for i in range(2):
        pulls += stage(f"pull_batch_{i}", lambda: [
            pullreq_row(p) for p in q.pull_batch(t, c["batch"])])
    t += c["stream_dt_ns"]
    pulls += stage("stream", lambda: [
        pullreq_row(p) for w in q.pull_batch_stream(
            t, c["stream_dt_ns"], c["stream_chunks"], c["stream_batch"])
        for p in w])
    t += c["stream_chunks"] * c["stream_dt_ns"]
    add_at = np.sort(rng.integers(0, c["pulls"], c["interleaved_adds"]))
    targets = rng.integers(0, n, c["interleaved_adds"])
    fresh = n

    def interleaved():
        nonlocal t, fresh
        out, j = [], 0
        for i in range(c["pulls"]):
            t += c["pull_dt_ns"]
            while j < add_at.size and add_at[j] == i:
                if j % 10 == 0:
                    cid, fresh = fresh, fresh + 1
                else:
                    cid = int(targets[j])
                add(cid, t)
                j += 1
            out.append(pullreq_row(q.pull_request(t)))
        return out

    hits0 = q.spec_hits
    pulls += stage("pull_request", interleaved)
    hit_share = (q.spec_hits - hits0) / c["pulls"]

    removed = []

    def admin():
        for cid in rng.choice(n, c["updates"], replace=False).tolist():
            infos[cid].update(50.0, 2.0, 0.0)
            q.update_client_info(cid)
        for cid in rng.choice(n, c["removes"], replace=False).tolist():
            q.remove_by_client(cid, accum=removed.append)
        q.remove_by_req_filter(
            lambda r: r[0] % 50 == 7 and r[1] % 3 == 0)

    stage("admin", admin)

    def clean():
        nonlocal t, fresh
        q.do_clean()                       # mark point 0
        t += c["pull_dt_ns"]
        out = [pullreq_row(p) for p in q.pull_batch(t, 64)]
        for cid in range(0, n, 20):
            add(cid, t)
        clock[0] = q.idle_age_s + 100.0
        q.do_clean()                       # idle marks
        clock[0] = q.erase_age_s + 100.0
        q.do_clean()                       # erases, up to erase_max
        for _ in range(100):               # new tenants on freed slots
            add(fresh, t)
            fresh += 1
        idle = sorted(q._host_idle)
        if idle:                           # an idle client reactivates
            add(q._client_of[idle[0]], t)
        t += c["pull_dt_ns"]
        return out + [pullreq_row(p) for p in
                      q.pull_batch(t, c["final_batch"])]

    pulls += stage("clean", clean)
    # the weight phase at full width: a window at 1 ms, before every
    # queued reservation tag (the first of each client lies at or past
    # its arrival plus its reservation interval), so every decision is
    # a weight-phase one among the ready clients
    weight = stage("weight", lambda: [
        pullreq_row(p) for p in q.pull_batch(c["weight_now_ns"],
                                             c["weight_batch"])])
    pulls += weight
    departed = [(cid, row.tolist()) for cid, row in q.departed_report()]
    rolled = q.roll_slo_windows()
    q.settle()
    counters = dict(
        reservation=q.reserv_sched_count, priority=q.prop_sched_count,
        limit_break=q.limit_break_sched_count, spec_hits=q.spec_hits,
        spec_refills=q.spec_refills, spec_settles=q.spec_settles,
        spec_replays=q.spec_replays, slot_recycles=q.slot_recycles,
        ingest_segments=q.ingest_segments, clients=q.client_count(),
        requests=q.request_count())
    decisions = sum(1 for p in pulls if p[0] == 0)
    stats = dict(
        n=n, adds=adds, growth=growth, decisions=decisions,
        batch_decisions=sum(1 for p in pulls[:2 * c["batch"]]
                            if p[0] == 0),
        hit_share=hit_share,
        weight_window=len(weight),
        weight_phase=sum(1 for p in weight if p[0] == 0 and p[3] == 1),
        device_mb=sum(x.numel() * x.element_size()
                      for x in q.state) / 1e6)
    return QueueRun(
        pulls=pulls, removed=removed, counters=counters,
        ledger={cid: r.tolist() for cid, r in q.ledger_rows().items()},
        slo={cid: r.tolist() for cid, r in q.slo_window_rows().items()},
        rolled=rolled, departed=departed, state=q.state, seconds=seconds,
        stats=stats)


# the push check's server: 32 service slots at 640 us an op (50,000
# ops/s), arrivals within 5 ms, so a backlog forms and limited clients
# wait
PUSH = dict(threads=32, op_ns=640_000, window_ns=5_000_000)


def virtual_server(mode: str, n: int = 1000, seed: int = 5, *,
                   device: str | torch.device = DEFAULT_DEVICE):
    """A server of ``PUSH["threads"]`` service slots in virtual time,
    fed by ``n`` clients (``queue_classes``) sending one request each at
    seeded times within ``PUSH["window_ns"]``.  ``mode="push"``: a
    ``TpuPushPriorityQueue`` in the virtual-time embedding dispatches
    through ``handle_f``, sized by ``capacity_f`` (the free slots), and
    arms its wakeups through ``sched_at_f``.  ``mode="pull"``: the
    server pulls ``pull_batch(now, free)`` from a
    ``TpuPullPriorityQueue`` on each arrival, completion and wakeup.
    The two make the same decisions.  Returns ``(dispatch order,
    wakeups fired)``, the order a list of ``(virtual ns, client,
    request, phase)``."""
    if mode not in ("push", "pull"):
        raise ValueError(f"mode {mode!r} is not push or pull")
    dev = resolve_device(device)
    infos = queue_classes(n, seed)
    rng = np.random.default_rng(seed)
    threads = PUSH["threads"]
    events, order = [], []
    st = dict(now=0, busy=0, seq=0, armed=None, woke=0)

    def at(when, fn):
        heapq.heappush(events, (when, st["seq"], fn))
        st["seq"] += 1

    def start(client, request, phase, cost):
        st["busy"] += 1
        order.append((st["now"], client, request, int(phase)))
        at(st["now"] + PUSH["op_ns"] * cost, complete)

    def complete():
        st["busy"] -= 1
        if mode == "push":
            q.request_completed()
        else:
            dispatch()

    def fire():
        st["armed"] = None
        st["woke"] += 1
        if mode == "push":
            q.sched_ahead_fire()
        else:
            dispatch()

    def sched_at(when):
        if st["armed"] is None or when < st["armed"]:
            st["armed"] = when
            at(max(when, st["now"]), fire)

    def dispatch():
        while st["busy"] < threads:
            done = False
            for pr in q.pull_batch(st["now"], threads - st["busy"]):
                if pr.is_retn():
                    start(pr.client, pr.request, pr.phase, pr.cost)
                else:
                    if pr.is_future():
                        sched_at(pr.when_ready)
                    done = True
            if done:
                break

    def arrive(cid, j):
        q.add_request((cid, j), cid, ReqParams(), time_ns=st["now"])
        if mode == "pull":
            dispatch()

    if mode == "push":
        q = TpuPushPriorityQueue(
            lambda cid: infos[cid], lambda: st["busy"] < threads, start,
            capacity_f=lambda: threads - st["busy"],
            now_ns_f=lambda: st["now"], sched_at_f=sched_at, device=dev)
    else:
        q = TpuPullPriorityQueue(lambda cid: infos[cid], device=dev)
    for when, cid in sorted((int(rng.integers(0, PUSH["window_ns"])), cid)
                            for cid in range(n)):
        at(when, functools.partial(arrive, cid, 0))
    while events:
        st["now"], _, fn = heapq.heappop(events)
        fn()
    q.shutdown()
    return order, st["woke"]


# ----------------------------------------------------------------------
# the churn row: bench's open-population workload
# ----------------------------------------------------------------------

# bench's accelerator shape of the row (bench.py ``--mode all``)
CHURN = dict(total_ids=4096, epochs=64, every=4, engine="prefix", m=4,
             k=256, ring=32, waves=8, base_lam=2.0,
             dt_epoch_ns=50_000_000, seed=11, boost_factor=8.0)


def _slo_result_block(out: dict, slo_eval) -> None:
    """Fold the burn-rate evaluator's verdict into a row (bench's
    ``_slo_result_block``): the ``slo`` block and its flat scalars."""
    s = slo_eval.summary()
    out["slo"] = s
    out["slo_violations_total"] = s["violations_total"]
    out["slo_worst_share_err"] = s["worst_window_share_err"]
    out["slo_window_tardiness_p99_ns"] = s["window_tardiness_p99_ns"]
    out["slo_windows_closed"] = s["windows_closed"]


def _digest_fields(results) -> tuple:
    """The digest-relevant tensors of an epoch's results, kept (without
    the state) until the run's digest is taken after the timed loop."""
    return tuple(SimpleNamespace(**{
        name: getattr(r, name) for name in DIGEST_FIELDS
        if getattr(r, name, None) is not None}) for r in results)


def churn_row(scenario: str = "flash_crowd", *,
              total_ids: int = CHURN["total_ids"],
              epochs: int = CHURN["epochs"], every: int = CHURN["every"],
              engine: str = CHURN["engine"], m: int = CHURN["m"],
              k: int = CHURN["k"], ring: int = CHURN["ring"],
              waves: int = CHURN["waves"],
              base_lam: float = CHURN["base_lam"],
              dt_epoch_ns: int = CHURN["dt_epoch_ns"],
              seed: int = CHURN["seed"], boost_client: int = None,
              boost_factor: float = CHURN["boost_factor"],
              slo: bool = True, tracer=None, static: bool = False,
              device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Bench's ``churn_<scenario>`` row (``bench.py`` ``bench_churn``) on
    the port: the lifecycle plane drives a ``lifecycle.churn`` scenario
    (flash crowds arriving and departing, idle eviction recycling slots,
    grow-on-demand capacity, compaction every 2nd boundary) over an
    ingest + guarded-epoch loop, with the admin API mounted on a live
    scrape endpoint.  At the halfway boundary the row sends a real
    ``PUT /clients/{id}/qos`` over HTTP that boosts ``boost_client``'s
    weight by ``boost_factor`` (``boost.http`` says whether it went over
    HTTP or, when the bind failed, in process); the conformance table
    reports delivered shares in the windows before and after it.

    The loop is bench's, line for line, and so are the output keys;
    the capacity record (``obs.capacity.capacity_row``) has bench's
    ``projected_hbm_bytes``, compile-plane fields and roofline verdict
    (``unknown``: the churn row, as bench's, counts no
    ``cost_analysis`` and has no ``spans`` block).  ``slo`` (bench's
    default ``--slo on``) rolls the SLO
    windows on the boundary grid and judges them with the burn-rate
    evaluator.  Added: ``digest``, the canonical client-id-space chain
    digest of the decisions (taken after the timed loop, from the
    per-epoch results and slot maps), which equals the ``static=True``
    run's (the spec's ``static_variant``)."""
    import urllib.request

    dev = resolve_device(device)
    cp0 = compile_plane.plane().totals()
    spec = make_spec(scenario, total_ids=total_ids, seed=seed,
                     base_lam=base_lam, compact_every=2)
    if static:
        spec = static_variant(spec)
    plane = LifecyclePlane(spec, tracer=tracer)
    state = init_state(spec["capacity0"], ring, device=dev)
    hists = obshist.hist_zero(dev)
    ledger = obshist.ledger_zero(spec["capacity0"], dev)
    slo_block = slo_plane = slo_eval = None
    slo_w0 = 0
    if slo:
        slo_plane = SloPlane(spec["capacity0"], dt_epoch_ns=dt_epoch_ns,
                             ring_depth=max(epochs // every, 8))
        slo_eval = SloEvaluator(slo_plane, log=lambda _line: None)
        slo_block = obsslo.window_zero(spec["capacity0"], dev)
        plane.attach_slo(slo_plane)
    ingest = jit_ingest_step(dt_epoch_ns=dt_epoch_ns, waves=waves)
    rng = np.random.Generator(np.random.PCG64(seed))
    boost_at = max((epochs // 2 // every) * every, every)

    def ops_by_cid(led) -> np.ndarray:
        """Cumulative delivered ops per client id (evicted clients are
        out of scope for the shares)."""
        col = led[:, obshist.LED_OPS].cpu().numpy()
        return plane.slots.scatter_by_cid(col, total_ids)

    # the control endpoint for the live PUT (fail-soft: a refused bind
    # falls back to the in-process handler)
    server = None
    try:
        server = MetricsHTTPServer(MetricsRegistry(), port=0)
    except OSError:
        pass
    if server is not None:
        mount_admin_api(server, plane, slo=slo_plane)

    def live_put(cid: int, r: float, w: float, l: float,
                 apply_at: int) -> bool:
        body = json.dumps({"reservation": r, "weight": w, "limit": l,
                           "apply_at": apply_at}).encode()
        if server is not None:
            req = urllib.request.Request(
                f"http://{server.host}:{server.port}/clients/{cid}/qos",
                data=body, method="PUT")
            with urllib.request.urlopen(req, timeout=10) as resp:
                if resp.status != 202:
                    raise RuntimeError(f"PUT /clients/{cid}/qos answered "
                                       f"{resp.status}")
            return True
        plane.accept({"op": "update", "cid": cid, "r": r, "w": w,
                      "l": l, "apply_at": apply_at})
        return False

    decisions = 0
    ops_mid = None
    boosted = None
    kept = []          # per epoch: (digest fields, cid_of_slot)
    t0 = time.perf_counter()
    try:
        for e in range(epochs):
            if e % every == 0:
                if slo_plane is not None and e > 0:
                    slo_block, closed = slo_plane.roll(
                        slo_block, slo_w0, e,
                        cid_of_slot=plane.slots.cid_of_slot,
                        depth=state.depth)
                    slo_w0 = e
                    slo_eval.observe_roll(closed)
                if e == boost_at:
                    if boost_client is None or \
                            boost_client not in plane.qos:
                        # the lowest live client id: a fixed pick may
                        # have been evicted by now
                        boost_client = min(plane.slots.slot_of)
                    r0, w0, l0 = plane.qos[boost_client]
                    boosted = {"client": boost_client,
                               "weight_before": w0,
                               "weight_after": w0 * boost_factor,
                               "boundary": e,
                               "http": live_put(
                                   boost_client, r0,
                                   w0 * boost_factor, l0, e)}
                    ops_mid = ops_by_cid(ledger)
                with obsspans.span(tracer, "lifecycle.boundary",
                                   "host_prep", epoch=e):
                    if slo_block is not None:
                        state, ledger, slo_block = plane.boundary(
                            state, e, every, ledger=ledger,
                            slo_block=slo_block)
                    else:
                        state, ledger = plane.boundary(
                            state, e, every, ledger=ledger)
            t_base = e * dt_epoch_ns
            raw = rng.poisson(lam_vector(spec, e)).astype(np.int32)
            with obsspans.span(tracer, "bench.round", "dispatch"):
                counts = torch.from_numpy(plane.map_counts(raw)).to(dev)
                state = ingest(state, counts, t_base)
                ep = run_epoch_guarded(
                    state, t_base + dt_epoch_ns, engine=engine, m=m,
                    k=k, with_metrics=True, hists=hists,
                    ledger=ledger, slo=slo_block, tracer=tracer)
            state, hists, ledger = ep.state, ep.hists, ep.ledger
            if slo_block is not None:
                slo_block = ep.slo
            decisions += ep.count
            kept.append((_digest_fields(ep.results),
                         plane.slots.cid_of_slot.copy()))
        _sync(dev)
        wall_s = time.perf_counter() - t0
        if slo_plane is not None:
            slo_block, closed = slo_plane.roll(
                slo_block, slo_w0, epochs,
                cid_of_slot=plane.slots.cid_of_slot, depth=state.depth)
            slo_eval.observe_roll(closed)
        ops_end = ops_by_cid(ledger)
    finally:
        if server is not None:
            server.close()

    # conformance: delivered throughput shares in the windows before
    # and after the live update, among the clients holding work in both
    conf = None
    if boosted is not None:
        before = ops_mid
        # a client evicted after the boost has its cumulative row folded
        # into the departed report and zeroed: its after-share is zero
        after = np.maximum(ops_end - ops_mid, 0)
        sb, sa = max(before.sum(), 1), max(after.sum(), 1)
        bc = boost_client
        rows = sorted(set(range(min(6, total_ids))) | {bc})
        conf = [{"client": c,
                 "weight": plane.qos.get(c, (0.0, 0.0, 0.0))[1],
                 "ops_before": int(before[c]),
                 "ops_after": int(after[c]),
                 "share_before": float(before[c] / sb),
                 "share_after": float(after[c] / sa)} for c in rows]
        boosted["share_before"] = float(before[bc] / sb)
        boosted["share_after"] = float(after[bc] / sa)
        boosted["share_gain"] = boosted["share_after"] \
            / max(boosted["share_before"], 1e-12)

    snap = plane.snapshot()
    h_np = hists.cpu().numpy().astype(np.int64)
    out = {"dps": decisions / max(wall_s, 1e-9),
           "decisions": decisions, "wall_s": wall_s,
           "scenario": scenario, "engine": engine,
           "total_ids": total_ids, "epochs": epochs,
           "boundary_every": every,
           "peak_clients": snap["peak_clients"],
           "live_clients": snap["live_clients"],
           "capacity": snap["capacity"],
           "registrations": snap["registrations"],
           "evictions": snap["evictions"],
           "compactions": snap["compactions"],
           "qos_updates": snap["qos_updates"],
           "slot_recycles": snap["slot_recycles"],
           "grows": snap["grows"],
           "boost": boosted, "conformance": conf}
    for q, key in ((0.50, "tardiness_p50_ns"),
                   (0.90, "tardiness_p90_ns"),
                   (0.99, "tardiness_p99_ns")):
        out[key] = obshist.hist_percentile(
            h_np, obshist.HIST_RESV_TARDINESS, q)
    out["tardiness_mean_ns"] = obshist.hist_mean(
        h_np, obshist.HIST_RESV_TARDINESS)
    out["tardiness_max_ns"] = float(obshist.ledger_totals(
        ledger)["tardiness_max_ns"])
    if slo_plane is not None:
        _slo_result_block(out, slo_eval)
        if boosted is not None:
            # the boosted client's closed windows report against their
            # own contract versions: the PUT lands in a fresh one
            out["slo_boost_windows"] = [
                {"window": [w.e0, w.e1],
                 "contract_epoch": w.cepoch, "ops": w.ops}
                for w in slo_plane.ring_rows(boost_client)]
    out["_hist_block"] = h_np.tolist()
    digest = b"\x00" * 32
    for fields, cids in kept:
        view = SlotMap.load({"lc_cids": cids,
                             "lc_ever": np.zeros(cids.shape, dtype=bool),
                             "lc_next_order": 0})
        digest = digest_update(digest,
                               canon_results(fields, view, total_ids))
    out["digest"] = hashlib.sha256(digest).hexdigest()
    # the capacity record: the open population sized for the full id
    # space landing at once, lifecycle slot map included
    obscap.capacity_row(out, dict(n=total_ids, ring=ring, engine=engine,
                                  m=m, k=k, telemetry=True, slo=slo,
                                  lifecycle=True), cp0)
    return out



# ----------------------------------------------------------------------
# the mesh row (bench.py --mode mesh) and the cluster dry run
# ----------------------------------------------------------------------

# bench's mesh row shape (bench_mesh): 100,000 clients, the prefix
# engine at m=4, k=256, ring 16 preloaded 12 deep, Poisson(2) in 4
# waves, 100 ms epochs, chunks of 8; 8 warm epochs, 24 timed
MESH = dict(clients=100_000, engine="prefix", epochs=24, warmup_epochs=8,
            chunk=8, m=4, k=256, ring=16, depth=12, arrival_lam=2.0,
            waves=4, dt_epoch_ns=10 ** 8)
MESH_SEED = 29       # bench_mesh's arrival RNG (PCG64)


def mesh_job(n: int, devices=None, **over):
    """The mesh row's per-shard job (bench_mesh's ``EpochJob``): the
    ``MESH`` shape at ``n`` clients a shard, ``over`` replacing fields.
    Its ``_job_state`` is every shard's starting state.  ``devices``
    lays a supervised run of it (``engine_loop="mesh"``) out in groups
    (``EpochJob.devices``)."""
    from .robust.supervisor import EpochJob

    kw = dict(engine=MESH["engine"], n=n, depth=MESH["depth"],
              ring=MESH["ring"], m=MESH["m"], k=MESH["k"],
              arrival_lam=MESH["arrival_lam"], waves=MESH["waves"],
              dt_epoch_ns=MESH["dt_epoch_ns"])
    if devices is not None:
        kw["devices"] = tuple(str(d) for d in devices)
    kw.update(over)
    return EpochJob(**kw)


def mesh_start(job, n_shards: int, device, mesh=None):
    """``(state, cd, cr, view_d, view_r, slo)``: ``job``'s preloaded
    state stacked ``n_shards`` times, the counter plane at the protocol
    origin and a zero SLO window block, on ``device`` (laid out on
    ``mesh`` by group when one is given)."""
    from .parallel import mesh as mesh_mod
    from .robust.supervisor import _job_state

    state = mesh_mod.stack_shards(_job_state(job, device), n_shards, mesh)
    return (state,) + mesh_mod.counter_init(n_shards, job.n,
                                            device=device, mesh=mesh) \
        + (mesh_mod.stack_shards(obsslo.window_zero(job.n, device),
                                 n_shards, mesh),)


def mesh_draws(rng: np.random.Generator, n_shards: int, n: int,
               epochs: int, lam: float, device) -> torch.Tensor:
    """``epochs`` epochs of the mesh row's Poisson arrivals, drawn
    ``[S, n]`` an epoch as bench draws them, as int32 ``[S, E, n]`` on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.stack(
        [rng.poisson(lam, (n_shards, n)).astype(np.int32)
         for _ in range(epochs)]), 0, 1))).to(device)


def plan_mesh_shards(clients: int, n_shards=None, *, ring: int = 16,
                     engine: str = "prefix", m: int = 4, k: int = 256,
                     telemetry: bool = True, slo: bool = True,
                     stream_chunk: int = 8,
                     device: str | torch.device = DEFAULT_DEVICE,
                     devices=None) -> dict:
    """Shard planning for the mesh row (bench.py ``plan_mesh_shards``):
    without ``n_shards`` the count comes from the client target by
    inverting the capacity ledger against the card's budget
    (``obs.capacity.plan_capacity`` over ``device_hbm_budget``).  The
    shards share one card, so an explicit ``n_shards`` is not capped at
    a device count; ``over_budget`` is set as bench sets it, when a
    shard's partition exceeds the planned per-shard maximum.  Without a
    budget (the CPU) and without ``n_shards``, one shard.

    ``devices`` plans a layout of ``D = len(devices)`` groups: each
    group's budget is its device's (``device_hbm_budget``) split evenly
    among the groups that share the device, the smallest share plans
    the per-group maximum (a group holds ``clients / D``; at one shard
    a device that is bench's per-shard maximum), the shard count is
    rounded up to a multiple of D, and the record adds ``devices`` and
    ``n_groups``."""
    cap_cfg = dict(ring=ring, engine=engine, m=m, k=k,
                   telemetry=telemetry, slo=slo,
                   stream_chunk=stream_chunk)
    if devices is not None:
        return _plan_mesh_groups(clients, n_shards, resolve_devices(
            devices), cap_cfg)
    budget = obscap.device_hbm_budget(resolve_device(device))
    shards_planned = max_per_shard = None
    if budget is not None:
        cap = obscap.plan_capacity(budget, **cap_cfg)
        max_per_shard = max(int(cap["max_clients"]), 1)
        shards_planned = max(1, -(-int(clients) // max_per_shard))
    eff = int(n_shards) if n_shards else (shards_planned or 1)
    per_shard = -(-int(clients) // eff)
    plan = {
        "clients_total": int(clients),
        "n_shards": eff,
        "clients_per_shard": per_shard,
        "shards_planned": shards_planned,
        "max_clients_per_shard": max_per_shard,
        "hbm_budget_bytes": budget,
        "projected_hbm_bytes_per_shard":
            int(obscap.projected_hbm(per_shard, **cap_cfg)),
    }
    if max_per_shard is not None and per_shard > max_per_shard:
        plan["over_budget"] = True
    return plan


def _plan_mesh_groups(clients: int, n_shards, devs: tuple,
                      cap_cfg: dict) -> dict:
    """:func:`plan_mesh_shards` over a layout of groups."""
    n_groups = len(devs)
    shares = []
    for d in devs:
        b = obscap.device_hbm_budget(d)
        shares.append(None if b is None else b // devs.count(d))
    budget = None if None in shares else min(shares)
    shards_planned = max_per_group = None
    if budget is not None:
        cap = obscap.plan_capacity(budget, **cap_cfg)
        max_per_group = max(int(cap["max_clients"]), 1)
        shards_planned = max(1, -(-int(clients) // max_per_group))
    eff = int(n_shards) if n_shards else \
        n_groups * -(-(shards_planned or n_groups) // n_groups)
    if eff % n_groups:
        raise ValueError(f"{eff} shards do not split over {n_groups} "
                         "devices (S % D must be 0)")
    per_shard = -(-int(clients) // eff)
    plan = {
        "clients_total": int(clients),
        "n_shards": eff,
        "clients_per_shard": per_shard,
        "shards_planned": shards_planned,
        "max_clients_per_shard": max_per_group,
        "hbm_budget_bytes": budget,
        "projected_hbm_bytes_per_shard":
            int(obscap.projected_hbm(per_shard, **cap_cfg)),
        "devices": [str(d) for d in devs],
        "n_groups": n_groups,
    }
    if max_per_group is not None and \
            per_shard * (eff // n_groups) > max_per_group:
        plan["over_budget"] = True
    return plan


def mesh_row(clients: int = MESH["clients"], *, n_shards=None,
             counter_sync_every: int = 1, engine: str = MESH["engine"],
             epochs: int = MESH["epochs"],
             warmup_epochs: int = MESH["warmup_epochs"],
             chunk: int = MESH["chunk"], m: int = MESH["m"],
             k: int = MESH["k"], ring: int = MESH["ring"],
             depth: int = MESH["depth"],
             arrival_lam: float = MESH["arrival_lam"],
             waves: int = MESH["waves"],
             dt_epoch_ns: int = MESH["dt_epoch_ns"],
             with_metrics: bool = True, slo: bool = True, tracer=None,
             fault_spec=None, registry=None,
             device: str | torch.device = DEFAULT_DEVICE,
             devices=None) -> dict:
    """Bench's mesh row (bench.py ``bench_mesh``): S full per-shard
    engines, each one server owning a distinct ``clients / S``
    partition with its own queue state and Poisson arrival stream,
    advance whole chunks of fused ingest + serve epochs
    (``parallel.mesh``) with the ``[clients / S]``-sized delta/rho
    counter sum at epoch boundaries (views refresh on the
    ``counter_sync_every`` grid).  The chunks are bench's: warm chunks
    untimed, then every timed chunk's draws (and fault slices) made and
    put on the card before the clock starts, the chunks chained, one
    synchronize at the end.

    ``fault_spec`` (a parsed ``robust.faults.parse_fault_spec`` dict)
    makes it a chaos run: one plan over every epoch (warm ones too)
    runs inside the chunks, and the row records the plan tag and the
    per-shard dropout and resync counts read off the device metric rows
    (their totals equal ``plan_events``).  The row's keys are bench's;
    ``registry`` (default: the process registry) gets the per-shard
    window and fault gauges.

    ``devices`` lays the shards out over a layout of devices
    (``make_mesh(S, devices=...)``; a name may repeat), every input
    placed by group before the clock starts; the row adds ``devices``
    and ``n_groups``.  Without it every shard stacks on ``device``."""
    from .obs.registry import default_registry
    from .parallel import groups
    from .parallel import mesh as mesh_mod
    from .parallel import tracker as trk
    from .robust import faults as faults_mod

    dev = resolve_device(device) if devices is None \
        else resolve_devices(devices)[0]
    plan = plan_mesh_shards(clients, n_shards, ring=ring, engine=engine,
                            m=m, k=k, slo=slo, stream_chunk=chunk,
                            device=dev, devices=devices)
    S = plan["n_shards"]
    n = plan["clients_per_shard"]
    every = int(max(counter_sync_every, 1))
    if plan.pop("over_budget", False):
        return {"workload": "mesh", "engine": engine,
                "engine_loop": "mesh", "dps": 0.0, "decisions": 0,
                "capacity_skipped": True,
                "projected_hbm_bytes":
                    plan["projected_hbm_bytes_per_shard"],
                "counter_sync_every": every,
                **{key: val for key, val in plan.items()
                   if val is not None}}
    job = mesh_job(n, engine=engine, depth=depth, ring=ring, m=m, k=k,
                   arrival_lam=arrival_lam, waves=waves,
                   dt_epoch_ns=dt_epoch_ns)
    mesh = mesh_mod.make_mesh(S, dev) if devices is None \
        else mesh_mod.make_mesh(S, devices=devices)
    state, cd, cr, vd, vr, wblock = mesh_start(job, S, dev, mesh)
    warm_chunks = max(1, warmup_epochs // chunk)
    n_chunks = max(1, epochs // chunk)
    fplan = None
    if fault_spec is not None:
        fplan = faults_mod.plan_from_spec(
            fault_spec, (warm_chunks + n_chunks) * chunk, S)
    # chunks start at multiples of chunk, so chunk % K == 0 keeps every
    # group head on the sync grid
    skipping = fplan is None and every > 1 and chunk % every == 0
    fn = mesh_mod.jit_mesh_chunk(
        mesh, engine=engine, epochs=chunk, m=m, k=k,
        dt_epoch_ns=dt_epoch_ns, waves=waves, with_metrics=with_metrics,
        counter_sync_every=counter_sync_every, ingest=True,
        with_faults=fplan is not None, collective_skipping=skipping)
    rng = np.random.Generator(np.random.PCG64(MESH_SEED))

    def draw(e):
        return mesh_mod.place_shards(
            mesh_draws(rng, S, n, e, arrival_lam, dev), mesh)

    def fault_chunk(e0):
        if fplan is None:
            return None
        return mesh_mod.fault_inputs(
            faults_mod.plan_chunk(fplan, e0, e0 + chunk), mesh)

    fault_mets = []

    def launch(out, e0, counts, fc):
        with obsspans.span(tracer, "mesh.bench_chunk", "dispatch",
                           epoch0=e0, shards=S, chaos=fplan is not None):
            out = fn(out.state, out.cd, out.cr, out.view_d, out.view_r,
                     e0, counts, None, None, out.slo, None, None, fc)
        if fplan is not None:
            fault_mets.append(out.outs["metrics"])
        return out

    out = mesh_mod.MeshChunk(state=state, outs={}, cd=cd, cr=cr,
                             view_d=vd, view_r=vr, slo=wblock)
    e0 = 0
    for _ in range(warm_chunks):
        out = launch(out, e0, draw(chunk), fault_chunk(e0))
        e0 += chunk
    pregen = [(draw(chunk), fault_chunk(e0 + i * chunk))
              for i in range(n_chunks)]
    for d in set(mesh.devices):
        _sync(d)
    timed = []
    t0 = time.perf_counter()
    for counts_c, fc in pregen:
        out = launch(out, e0, counts_c, fc)
        timed.append(out.outs["count"])
        e0 += chunk
    for d in set(mesh.devices):
        _sync(d)
    wall = time.perf_counter() - t0

    per_shard = np.zeros(S, dtype=np.int64)
    for counts_arr in timed:
        per_shard += groups.gather(counts_arr, "cpu").numpy() \
            .reshape(S, -1).sum(axis=1)
    total = int(per_shard.sum())
    shard_dps = per_shard / wall
    sched = trk.exchange_schedule(n_chunks * chunk, counter_sync_every,
                                  start=warm_chunks * chunk)
    bytes_per_sync = trk.counter_view_bytes(n)
    row = {
        "workload": "mesh", "engine": engine, "engine_loop": "mesh",
        "dps": total / wall,
        "dps_per_shard_mean": float(shard_dps.mean()),
        "dps_per_shard_min": float(shard_dps.min()),
        "dps_per_shard_max": float(shard_dps.max()),
        "dps_per_shard": [float(x) for x in shard_dps],
        "decisions": total, "wall_s": wall,
        "epochs": n_chunks * chunk, "stream_chunk": chunk,
        "counter_sync_every": every,
        "counter_syncs": sched["syncs"],
        "counter_bytes_per_sync": bytes_per_sync,
        "collective_skipping": bool(skipping),
        # with collective skipping the sum runs once per K-epoch group
        "counter_bytes_per_epoch":
            float(bytes_per_sync / every if skipping else bytes_per_sync),
        "counter_view_bytes_per_epoch":
            bytes_per_sync * sched["syncs"] / max(sched["epochs"], 1),
        **{key: val for key, val in plan.items() if val is not None},
    }
    reg = registry if registry is not None else default_registry()
    row["fault_plan"] = faults_mod.describe(fplan)
    if fplan is not None:
        mets = np.zeros((S, obsdev.NUM_METRICS), dtype=np.int64)
        for mchunk in fault_mets:
            a = groups.gather(mchunk, "cpu").numpy()
            for s in range(S):
                mets[s] = obsdev.metrics_combine_np(mets[s], *a[s])
        row["fault_dropouts_per_shard"] = [
            int(x) for x in mets[:, obsdev.MET_SERVER_DROPOUTS]]
        row["fault_resyncs_per_shard"] = [
            int(x) for x in mets[:, obsdev.MET_TRACKER_RESYNCS]]
        row["faults_injected_total"] = int(
            mets[:, obsdev.MET_FAULTS_INJECTED].sum())
        obsdev.publish_shard_faults(reg, mets,
                                    labels={"workload": "mesh"})
    obsslo.publish_shard_windows(reg, groups.gather(out.slo, "cpu")
                                 .numpy(),
                                 merged=out.slo_merged.cpu().numpy(),
                                 workload="mesh")
    return row


def _multichip_qos(n_clients: int, n_servers: int):
    """The dry run's contracts: reservation 1 op/s, weights 1:2:3 by
    slot, no limit, costs 1 + slot % 2, and the staggered tag phases."""
    rinv = np.full(n_clients, rate_to_inv_ns(1.0), dtype=np.int64)
    winv = np.asarray([rate_to_inv_ns(1.0 + (i % 3))
                       for i in range(n_clients)], dtype=np.int64)
    costs = np.asarray([1 + (i % 2) for i in range(n_clients)],
                       dtype=np.int64)
    phase = ((np.arange(n_clients) * 2654435761) & 0xFFFFF) \
        / float(1 << 20)
    return rinv, winv, costs, phase


def multichip_cluster(n_servers: int, n_clients: int, tracker_kind: str,
                      device: str | torch.device = DEFAULT_DEVICE,
                      devices=None):
    """The dry run's cluster (``__graft_entry__._dryrun_policy``): every
    server installs the same population, the clock starts at 1 s, and
    every client's previous tags are staggered across its own serve
    period.  ``devices`` lays the servers out in groups
    (``make_mesh(S, devices=...)``), as the dry run's mesh of devices
    does.  Returns ``(mesh, cluster, costs)``."""
    from .parallel import cluster as CL

    dev = resolve_device(device) if devices is None \
        else resolve_devices(devices)[0]
    mesh = CL.make_mesh(n_servers, dev) if devices is None \
        else CL.make_mesh(n_servers, devices=devices)
    cl = CL.init_cluster(n_servers, n_clients, tracker_kind=tracker_kind,
                         device=dev)
    rinv, winv, costs, phase = _multichip_qos(n_clients, n_servers)
    cl = CL.install_clients(cl, rinv, winv,
                            np.zeros(n_clients, dtype=np.int64))
    t0 = 10 ** 9
    u_est = n_servers + 1.5
    stag_w = (phase * 2.0 * winv * u_est).astype(np.int64)
    per_r = (rinv * u_est).astype(np.int64)
    stag_r = (phase * per_r).astype(np.int64)

    def bcast(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(a, (n_servers,) + np.shape(a)))).to(dev)

    cl = cl._replace(
        engine=cl.engine._replace(prev_prop=bcast(t0 + stag_w),
                                  prev_resv=bcast(t0 - per_r + stag_r)),
        now=torch.full((n_servers,), t0, dtype=torch.int64, device=dev))
    return mesh, CL.shard_cluster(cl, mesh), costs


def multichip_policy(n_servers: int = 8, n_clients: int = 10_000,
                     tracker_kind: str = "orig", *, warmup: int = 2,
                     rounds: int = 6, decisions_per_step: int = 1024,
                     max_arrivals: int = 3, drain_rounds: int = 4,
                     check_qos: bool = True,
                     device: str | torch.device = DEFAULT_DEVICE,
                     devices=None) -> dict:
    """One accounting policy of the cluster dry run
    (``__graft_entry__._dryrun_policy``) on ``cluster_step``, run as an
    unrecorded program (``parallel.cluster.bare_step_jit``): a closed
    loop of ``warmup + rounds`` rounds (every completion triggers the
    client's next request to that server, windows of 4), then a deep
    preloaded backlog drained with no arrivals.  ``check_qos`` runs the
    dry run's assertions: a mostly busy cluster, every class's service
    over its reservation floor, a pure weight-phase drain and
    cost-weighted drain shares within 10% of 1:2:3 (they need the dry
    run's depth).  Returns the served totals, the class service, the
    shares and ``digest``, the ``robust.cluster.decision_digest`` of
    every round's decisions.  ``devices`` runs it over a layout of
    device groups (:func:`multichip_cluster`)."""
    from .parallel import cluster as CL
    from .parallel import groups
    from .robust.cluster import decision_digest

    mesh, cl, costs = multichip_cluster(n_servers, n_clients,
                                        tracker_kind, device, devices)
    dev = mesh.device
    k = decisions_per_step
    dt_round = 50_000_000
    _, winv, _, phase = _multichip_qos(n_clients, n_servers)

    # the step as a program outside the plane's records (the dry run's
    # bare jax.jit in JAX): each server's serial leg captured
    prog = CL.bare_step_jit(mesh, (k, max_arrivals, 0, False, dt_round))
    costs_in = CL.program_input(costs)

    def step(cl, arr):
        cl, decs = prog(cl, torch.from_numpy(arr), costs_in)
        return cl, CL.decisions_to_numpy(decs)

    total = 0
    class_of = np.arange(n_clients) % 3
    resv_by_class = np.zeros(3, dtype=np.int64)
    prio_by_class = np.zeros(3, dtype=np.int64)
    outstanding = 4
    arrivals_np = np.full((n_servers, n_clients), outstanding,
                          dtype=np.int64)
    owed = np.zeros((n_servers, n_clients), dtype=np.int64)
    seq = []
    for r in range(warmup + rounds):
        send = np.minimum(arrivals_np + owed, max_arrivals)
        owed = arrivals_np + owed - send
        cl, decs = step(cl, send.astype(np.int32))
        seq.append(decs)
        served = int((decs.type == 0).sum())
        if check_qos and served <= 0.6 * n_servers * k:
            raise AssertionError(
                f"round {r}: {served} served of {n_servers * k} slots: "
                "the load should keep the cluster mostly busy")
        total += served
        arrivals_np = np.zeros((n_servers, n_clients), dtype=np.int64)
        for s in range(n_servers):
            np.add.at(arrivals_np[s], decs.slot[s][decs.type[s] == 0], 1)
        if r < warmup:
            continue
        mask = decs.type == 0
        cls = class_of[decs.slot[mask]]
        ph = decs.phase[mask]
        np.add.at(resv_by_class, cls[ph == 0], 1)
        np.add.at(prio_by_class, cls[ph == 1], 1)
    backlog = int(groups.gather(cl.engine.depth).sum())
    t_virtual = rounds * dt_round / 1e9
    floor_per_class = (n_clients / 3) * 1.0 * t_virtual
    total_by_class = resv_by_class + prio_by_class
    if check_qos:
        if backlog <= 0:
            raise AssertionError("expected residual backlog")
        if not (resv_by_class.sum() > 0 and prio_by_class.sum() > 0):
            raise AssertionError(f"both phases must be exercised: "
                                 f"resv={resv_by_class} "
                                 f"prio={prio_by_class}")
        if not np.all(total_by_class >= 0.8 * floor_per_class):
            raise AssertionError(
                f"reservation floors violated: {total_by_class.tolist()}"
                f" < {floor_per_class:.0f} per class")

    # the contended backlog: uniform deltas, staggered tag phases, no
    # arrivals; cost-weighted service per class must split 1:2:3
    depth0 = 16
    ring = groups.first_leaf(cl.engine.q_arrival).shape[-1]
    q_arr = np.zeros((n_clients, ring), dtype=np.int64)
    q_arr[:, :depth0 - 1] = np.tile(np.arange(1, depth0), (n_clients, 1))
    adv = winv * (1 + costs)
    stag = (phase * 2.0 * adv).astype(np.int64)
    t1 = int(groups.gather(cl.now).max()) + 10 ** 9

    def bcast(a):
        return CL.place_shards(torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(a, (n_servers,) + np.shape(a)))).to(dev), mesh)

    i64 = np.int64
    eng = cl.engine._replace(
        idle=bcast(np.zeros(n_clients, dtype=bool)),
        head_resv=bcast(np.full(n_clients, 1 << 60, dtype=i64)),
        prev_resv=bcast(np.full(n_clients, 1 << 60, dtype=i64)),
        head_prop=bcast(t1 + stag), prev_prop=bcast(t1 + stag),
        head_limit=bcast(np.full(n_clients, -(1 << 62), dtype=i64)),
        head_arrival=bcast(np.full(n_clients, t1, dtype=i64)),
        head_cost=bcast(costs), head_rho=bcast(np.ones(n_clients, i64)),
        head_ready=bcast(np.zeros(n_clients, dtype=bool)),
        cur_rho=bcast(np.ones(n_clients, i64)),
        cur_delta=bcast(np.ones(n_clients, i64)),
        depth=bcast(np.full(n_clients, depth0, dtype=np.int32)),
        q_head=bcast(np.zeros(n_clients, dtype=np.int32)),
        q_arrival=bcast(q_arr),
        q_cost=bcast(np.tile(costs[:, None], (1, ring))))
    cl = cl._replace(engine=eng, now=CL.place_shards(torch.full(
        (n_servers,), t1, dtype=torch.int64, device=dev), mesh))
    cost_units = np.zeros(3, dtype=np.int64)
    zero_arr = np.zeros((n_servers, n_clients), dtype=np.int32)
    for _ in range(drain_rounds):
        cl, decs = step(cl, zero_arr)
        seq.append(decs)
        m = decs.type == 0
        if check_qos and not (decs.phase[m] == 1).all():
            raise AssertionError("drain phase must be pure weight-phase "
                                 "service")
        np.add.at(cost_units, class_of[decs.slot[m]], decs.cost[m])
    w = np.array([1.0, 2.0, 3.0])
    u_share = cost_units / max(cost_units.sum(), 1)
    expect = w / w.sum()
    if check_qos and not np.all(np.abs(u_share - expect) < 0.10 * expect):
        raise AssertionError(f"weight shares violated: "
                             f"{u_share.tolist()} vs 1:2:3")
    return {"tracker": tracker_kind, "servers": n_servers,
            "clients": n_clients, "decisions_per_step": k,
            "rounds": warmup + rounds, "drain_rounds": drain_rounds,
            "served": total, "backlog": backlog,
            "class_service": total_by_class.tolist(),
            "floor_per_class": floor_per_class,
            "cost_units": cost_units.tolist(),
            "weight_shares": u_share.tolist(),
            "qos_checked": bool(check_qos),
            "digest": decision_digest(seq)}


def multichip_row(n_servers: int = 8, n_clients: int = 10_000, *,
                  tracker_kinds=("orig", "borrowing"), **kw) -> dict:
    """The cluster dry run (``__graft_entry__.dryrun_multichip``) under
    both accounting policies, OrigTracker and BorrowingTracker: one
    :func:`multichip_policy` record per policy (``devices=`` passes
    through: the dry run over a layout of device groups)."""
    return {"workload": "multichip", "servers": n_servers,
            "clients": n_clients,
            "policies": [multichip_policy(n_servers, n_clients, kind,
                                          **kw)
                         for kind in tracker_kinds]}


def cluster_outage(n_servers: int = 8, n_clients: int = 10_000, *,
                   steps: int = 3, decisions_per_step: int = 64,
                   server: int = 1, down_from: int = 1,
                   down_until: int = 2,
                   device: str | torch.device = DEFAULT_DEVICE,
                   devices=None) -> dict:
    """``robust_cluster_step`` on the dry run's cluster under a
    ``single_outage_plan`` (``server`` down for ``[down_from,
    down_until)``), each server sent a window of 4 a step: the decision
    digest, the merged metrics, and the final held views and clocks as
    host numpy."""
    from .parallel import groups
    from .robust import cluster as RC
    from .robust import faults as faults_mod

    mesh, cl, costs = multichip_cluster(n_servers, n_clients, "orig",
                                        device, devices)
    plan = faults_mod.single_outage_plan(
        steps, n_servers, server=server, down_from=down_from,
        down_until=down_until)
    arrivals = np.full((steps, n_servers, n_clients), 4, dtype=np.int32)
    rc, seq = RC.run_with_plan(
        RC.init_robust(cl), arrivals, costs, mesh, plan,
        decisions_per_step=decisions_per_step, max_arrivals=3,
        advance_ns=50_000_000)
    return {"digest": RC.decision_digest(seq),
            "metrics": RC.metrics_totals(rc),
            "events": faults_mod.plan_events(plan),
            "view_delta": groups.gather(rc.view_delta, "cpu").numpy(),
            "view_rho": groups.gather(rc.view_rho, "cpu").numpy(),
            "now": groups.gather(rc.cluster.now, "cpu").numpy(),
            "served": int(sum((d.type == 0).sum() for d in seq))}


CONTROLLER = dict(scenarios=("shard_skew", "limit_thrash", "diurnal"),
                  total_ids=192, epochs=48)   # bench's accelerator shape
RPC = dict(n=32, epochs=16, requests=64, workers=4)
REBALANCE = dict(n_shards=4, total_ids=64, epochs=24)


def _timed_job(job, device):
    """One supervised bare run and its wall (bench's ``one``)."""
    from .robust.supervisor import run_job

    t0 = time.perf_counter()
    res = run_job(job, device=device)
    return res, time.perf_counter() - t0


def controller_row(scenarios=CONTROLLER["scenarios"], *,
                   sides: str = "both",
                   total_ids: int = CONTROLLER["total_ids"],
                   epochs: int = CONTROLLER["epochs"],
                   ckpt_every: int = 4, engine: str = "prefix",
                   engine_loop: str = "stream", m: int = 2, k: int = 32,
                   ring: int = 16, waves: int = 6, seed: int = 17,
                   tracer=None,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Bench's ``controller_<scenario>`` rows (``bench.py``
    ``bench_controller``) on the port: each churn scenario runs as a
    pair of exact-twin supervised jobs, identical but for
    ``EpochJob(controller=...)``, so the recovered dec/s and burn-epoch
    delta belong to the controller's actuations alone.  ``sides`` picks
    the twins ("off", "on" or "both").  With both, an untimed warmup of
    the off twin runs first, as in bench; the port compiles nothing per
    shape, so it only keeps the twins' timing comparable.  Keys are
    bench's; the defaults are bench's accelerator shape."""
    import dataclasses

    from .robust.supervisor import EpochJob, run_job

    out = {}
    for scenario in scenarios:
        spec = make_spec(scenario, total_ids=total_ids,
                         capacity0=max(16, total_ids // 4), seed=seed)
        job = EpochJob(engine=engine, engine_loop=engine_loop,
                       churn=spec, epochs=epochs, m=m, k=k, ring=ring,
                       waves=waves, ckpt_every=ckpt_every, seed=seed,
                       with_slo=True)
        row = {"workload": "controller", "scenario": scenario,
               "engine": engine, "engine_loop": engine_loop,
               "epochs": epochs, "ckpt_every": ckpt_every,
               "total_ids": total_ids, "controller": sides}
        with obsspans.span(tracer, "controller.bench_ab", "dispatch",
                           scenario=scenario, sides=sides):
            if sides == "both":
                run_job(job, device=device)      # the untimed warmup
            if sides in ("off", "both"):
                off, wall = _timed_job(job, device)
                row.update(
                    dps_off=off.decisions / wall,
                    decisions_off=int(off.decisions), wall_s_off=wall,
                    violations_off=int(off.slo["violations_total"]),
                    burn_windows_off=int(off.slo.get("burn_windows", 0)),
                    burn_epochs_off=int(off.slo.get("burn_epochs", 0)))
                if sides == "off":
                    row["slo"] = off.slo
            if sides in ("on", "both"):
                on, wall = _timed_job(
                    dataclasses.replace(job, controller=True), device)
                row.update(
                    dps_on=on.decisions / wall,
                    decisions_on=int(on.decisions), wall_s_on=wall,
                    violations_on=int(on.slo["violations_total"]),
                    burn_windows_on=int(on.slo.get("burn_windows", 0)),
                    burn_epochs_on=int(on.slo.get("burn_epochs", 0)),
                    controller_decisions=int(on.controller_decisions),
                    controller_knobs=on.controller_knobs,
                    controller_trajectory=on.controller_trajectory or [],
                    slo=on.slo)
        if sides == "both":
            row["dps"] = row["dps_on"]
            row["recovered_dps"] = row["dps_on"] - row["dps_off"]
            row["burn_epochs_recovered"] = (row["burn_epochs_off"]
                                            - row["burn_epochs_on"])
            row["violations_recovered"] = (row["violations_off"]
                                           - row["violations_on"])
        else:
            row["dps"] = row.get("dps_on", row.get("dps_off", 0.0))
        out[f"controller_{scenario}"] = row
    return out


def rpc_row(*, workers: int = RPC["workers"],
            requests: int = RPC["requests"], n: int = RPC["n"],
            epochs: int = RPC["epochs"], ckpt_every: int = 2, m: int = 2,
            k: int = 32, ring: int = 16, waves: int = 6, seed: int = 17,
            engine: str = "prefix", fault_spec=None, tracer=None,
            device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Bench's ``rpc`` row (``bench.py`` ``bench_rpc``) on the port: a
    real loopback ``net.server.IngestServer``, ``workers`` concurrent
    clients (threads through ``net.loadgen.run_worker``) on seeded
    schedules, the serving loop admitting the coalesced superwaves on
    the card, then the gate in process: a replay fed the journaled
    trace lands on the same chain digest and trace hash
    (``digest_match``).  ``fault_spec`` makes it a chaos leg whose
    drop/dup/reorder counters must equal the host oracle's
    (``chaos_exact``).  Keys are bench's; ``tracer`` is accepted for
    bench's signature and records nothing here, as in bench."""
    import dataclasses
    import tempfile
    import threading

    from .net import faults as net_faults
    from .net.journal import ArrivalJournal
    from .net.loadgen import full_schedule, run_worker
    from .net.serve import RpcServeConfig, make_server, run_serve

    del tracer
    scheds = full_schedule(seed, workers=workers, requests=requests,
                           n_clients=n, max_nops=3)
    spec = net_faults.parse_net_fault_spec(fault_spec)
    oracle = net_faults.plan_schedule_events(
        spec, [[(c, q) for c, q, _ in sc] for sc in scheds])
    with tempfile.TemporaryDirectory() as d:
        cfg = RpcServeConfig(
            engine=engine, n=n, epochs=epochs, ckpt_every=ckpt_every,
            m=m, k=k, ring=ring, waves=waves, seed=seed, workdir=d,
            fault_spec=fault_spec, high_watermark=10 ** 6, wait_ops=1,
            wait_timeout_s=60, device=str(resolve_device(device)))
        server = make_server(cfg).start()
        threads = [threading.Thread(
            target=run_worker, args=("127.0.0.1", server.port, scheds[w]),
            kwargs=dict(timeout_s=0.5, max_attempts=10))
            for w in range(workers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out = run_serve(cfg, server=server)
        wall = time.perf_counter() - t0
        server.stop()
        trace = ArrivalJournal(d).counts_trace()
        replay = run_serve(dataclasses.replace(cfg, workdir=None,
                                               wait_ops=0), trace=trace)
    ev = out["events"]
    chaos_exact = (ev.get("drops_injected", 0) == oracle["drops"]
                   and ev.get("dup_frames", 0) == oracle["dups"]
                   and ev.get("reordered", 0) == oracle["reorders"])
    return {"rpc": {
        "workload": "rpc", "scenario": net_faults.describe(spec),
        "workers": int(workers), "requests_per_worker": int(requests),
        "engine": engine, "epochs": epochs,
        "dps": out["decisions"] / max(wall, 1e-9),
        "decisions": out["decisions"], "wall_s": wall,
        "admitted_ops": out["admitted_ops_traced"],
        "carry_ops": out["carry_ops"],
        "ingest_drops": out["ingest_drops"], "digest": out["digest"],
        "digest_match": bool(replay["digest"] == out["digest"]
                             and replay["trace_sha"] == out["trace_sha"]),
        "chaos_exact": bool(chaos_exact),
        "oracle_drops": oracle["drops"], "oracle_dups": oracle["dups"],
        "oracle_reorders": oracle["reorders"],
        "chaos_drops": int(ev.get("drops_injected", 0)),
        "chaos_dups": int(ev.get("dup_frames", 0)),
        "chaos_reorders": int(ev.get("reordered", 0)),
        "busy": int(ev.get("busy", 0)),
        "deduped": int(ev.get("deduped", 0)),
        "lat_p50_ms": out["latency"]["p50_ms"],
        "lat_p99_ms": out["latency"]["p99_ms"],
    }}


# bench's rebalance controller: migrate is the only live rule (sync
# pinned, clamp and compact parked), moving the largest-demand drained
# clients off the hot shard
REBALANCE_CTL = dict(sync_max=1, backlog_hi=10 ** 9, occ_lo=0.0,
                     hysteresis=1, cooldown=2, migrate_skew_hi=1.5,
                     migrate_pick="hot", migrate_max=4)


def mesh_rebalance_row(*, n_shards: int = REBALANCE["n_shards"],
                       total_ids: int = REBALANCE["total_ids"],
                       epochs: int = REBALANCE["epochs"],
                       ckpt_every: int = 4, engine: str = "prefix",
                       m: int = 2, k: int = 32, ring: int = 16,
                       waves: int = 6, seed: int = 17, tracer=None,
                       device: str | torch.device = DEFAULT_DEVICE,
                       devices=None) -> dict:
    """Bench's ``mesh_rebalance`` row (``bench.py``
    ``bench_mesh_rebalance``) on the port: two exact-twin supervised
    mesh jobs on the ``shard_skew`` scenario, the static ``cid % S``
    mesh against ``placement="p2c"`` with a controller whose only live
    rule is ``migrate`` (:data:`REBALANCE_CTL`), so
    the recovered decisions and shard-skew delta belong to the
    migrations.  Skew is max/mean of the per-shard completion totals
    (``mesh_counters[0]``).  An untimed warmup of the off twin runs
    first, as in bench.  The JAX row caps ``n_shards`` at its device
    count; every shard here is a slice of one card, so ``n_shards`` is
    taken as given.  ``devices`` lays both twins out over device groups
    (``EpochJob.devices``; ``S % D == 0``), bench's one shard a device
    where ``D == S``: the controller reads and migration writes group by
    group.  Keys are bench's."""
    import dataclasses

    from .robust.supervisor import EpochJob, run_job

    S = int(n_shards)
    spec = make_spec("shard_skew", total_ids=total_ids, n_shards=S,
                      seed=seed)
    job = EpochJob(engine=engine, engine_loop="mesh", n_shards=S,
                   churn=spec, epochs=epochs, m=m, k=k, ring=ring,
                   waves=waves, ckpt_every=ckpt_every, seed=seed,
                   devices=None if devices is None else tuple(
                       str(d) for d in resolve_devices(devices)))

    def skew(res):
        tot = np.asarray(res.mesh_counters[0],
                         dtype=np.float64).sum(axis=1)
        return float(tot.max() / max(tot.mean(), 1e-12)), \
            [int(t) for t in tot]

    row = {"workload": "mesh_rebalance", "scenario": "shard_skew",
           "engine": engine, "engine_loop": "mesh", "n_shards": S,
           "epochs": epochs, "ckpt_every": ckpt_every,
           "total_ids": total_ids, "rebalance": "on",
           "placement": "p2c"}
    with obsspans.span(tracer, "mesh.bench_rebalance", "dispatch",
                       n_shards=S, epochs=epochs):
        run_job(job, device=device)          # the untimed warmup
        off, wall_off = _timed_job(job, device)
        on, wall_on = _timed_job(dataclasses.replace(
            job, placement="p2c", controller=dict(REBALANCE_CTL)), device)
    skew_off, shards_off = skew(off)
    skew_on, shards_on = skew(on)
    row.update(
        dps_off=off.decisions / wall_off, dps_on=on.decisions / wall_on,
        decisions_off=int(off.decisions), decisions_on=int(on.decisions),
        wall_s_off=wall_off, wall_s_on=wall_on,
        shard_skew_before=skew_off, shard_skew_after=skew_on,
        shard_skew_final=skew_on,
        shard_decisions_off=shards_off, shard_decisions_on=shards_on,
        migrations=int(on.migrations), migration_log=on.migration_log,
        placement_counters=on.placement_counters,
        controller_knobs=on.controller_knobs)
    row["dps"] = row["dps_on"]
    row["recovered_dps"] = row["dps_on"] - row["dps_off"]
    row["recovered_decisions"] = (row["decisions_on"]
                                  - row["decisions_off"])
    row["shard_skew_recovered"] = skew_off - skew_on
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("serve", "serve_row", "chain",
                                           "cfg3",
                                           "cfg4", "frontier", "queue",
                                           "churn", "mesh", "multichip",
                                           "controller", "rpc",
                                           "mesh_rebalance"),
                    default="serve")
    ap.add_argument("--controller", choices=("off", "on", "both"),
                    default="both",
                    help="controller: which twins run (recovered deltas "
                    "need both)")
    ap.add_argument("--rpc-workers", type=int, default=RPC["workers"],
                    help="rpc: concurrent loadgen clients")
    ap.add_argument("--rpc-fault-spec", default=None,
                    help="rpc: a network chaos spec, e.g. 'seed=7,"
                    "p_drop=0.1,p_dup=0.05,p_reorder=0.05'")
    ap.add_argument("--rebalance", choices=("on", "off"), default="off",
                    help="mesh: also run the shard-rebalancing A/B "
                    "(the mesh_rebalance row)")
    ap.add_argument("--clients", type=int, default=None,
                    help="mesh: clients over all shards (100000); "
                    "multichip: clients per server (10000)")
    ap.add_argument("--n-shards", type=int, default=None,
                    help="mesh: shards on the card (planned from the "
                    "memory budget when absent); multichip: servers (8)")
    ap.add_argument("--counter-sync-every", type=int, default=1,
                    help="mesh: epochs between counter-view refreshes")
    ap.add_argument("--fault-plan", default=None,
                    help="mesh: a fault spec, e.g. 'seed=7,p_dropout="
                    "0.05,mean_outage_steps=2,p_dup=0.1' (a plain label "
                    "or 'none' runs no faults)")
    ap.add_argument("--n", type=int, default=None,
                    help="clients (100000; cfg3 and queue 10000; churn: "
                    "the id space, 4096; controller 192, mesh_rebalance "
                    "64; rpc: clients and coalesce slots, 32)")
    ap.add_argument("--depth", type=int, default=320,
                    help="serve, serve_row, chain: queue depth and ring "
                    "size")
    ap.add_argument("--k", type=int, default=None,
                    help="serve, chain, churn: decisions (units) per "
                    "batch (65536; churn 256)")
    ap.add_argument("--m", type=int, default=None,
                    help="serve, chain, churn: batches per epoch (32; "
                    "chain 8; churn 4)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="serve, chain, churn (3; churn 64), controller "
                    "(48), rpc (16), mesh_rebalance (24)")
    ap.add_argument("--epochs-lo", type=int, default=3,
                    help="serve_row: epochs of a short timed chain")
    ap.add_argument("--epochs-hi", type=int, default=6,
                    help="serve_row: epochs of a long timed chain")
    ap.add_argument("--requests", type=int, default=RPC["requests"],
                    help="rpc: requests per loadgen worker")
    ap.add_argument("--churn-scenario", default="flash_crowd",
                    choices=("flash_crowd", "diurnal", "churn_storm",
                             "limit_thrash", "shard_skew"),
                    help="churn: the lifecycle scenario")
    ap.add_argument("--rounds", type=int, default=None,
                    help="cfg3, cfg4, frontier: rounds of a long timed "
                    "chain (bench's 60; cfg4 40; frontier 24)")
    ap.add_argument("--rounds-lo", type=int, default=None,
                    help="cfg3, cfg4, frontier: rounds of a short chain, "
                    "0 for one chain (20; cfg4 12; frontier 8)")
    ap.add_argument("--reps", type=int, default=None,
                    help="cfg3, cfg4, frontier: pairs of timed chains "
                    "(3; cfg4 4; frontier 2); serve_row: fresh states, "
                    "a pair each (5)")
    ap.add_argument("--latency-rounds", type=int, default=None,
                    help="cfg3, cfg4, frontier: windowed latency rounds "
                    "(0; cfg4 100; frontier 60)")
    ap.add_argument("--conformance-rounds", type=int, default=2,
                    help="cfg3, cfg4: untimed conformance rounds")
    ap.add_argument("--conformance-out", metavar="FILE", default=None,
                    help="cfg3, cfg4: the per-client conformance table "
                    "as JSONL")
    ap.add_argument("--target-latency", type=float, default=0.0,
                    metavar="MS",
                    help="pick the frontier point with the most "
                    "decisions/s whose mean round fits this budget; "
                    "implies --workload frontier")
    ap.add_argument("--spans", action="store_true",
                    help="cfg3, cfg4, frontier: host spans and the "
                    "watchdog; its warnings (the last 8) join the line")
    ap.add_argument("--engine-loop", choices=("round", "stream"),
                    default="round",
                    help="cfg3, cfg4: one call per round, or stream "
                    "chunks of --stream-chunk rounds")
    ap.add_argument("--stream-chunk", type=int, default=STREAM_CHUNK,
                    help="cfg3, cfg4: rounds per stream chunk")
    ap.add_argument("--calendar-impl",
                    choices=("minstop", "bucketed", "wheel"),
                    default="minstop",
                    help="cfg4: the calendar scheme (bench's cfg4 row is "
                    "minstop, cfg4_wheel is wheel)")
    for name in ("telemetry", "slo", "provenance"):
        ap.add_argument(f"--{name}", choices=("on", "off"), default="on",
                        help=f"cfg3, cfg4 (churn: slo): the {name} "
                        "accumulators")
    ap.add_argument("--select-impl", choices=("sort", "radix"),
                    default="sort", help="serve, chain: selection backend")
    ap.add_argument("--tag-width", type=int, choices=(64, 32), default=64,
                    help="serve, chain: epoch tag carry width")
    ap.add_argument("--window-m", type=int, default=None,
                    help="serve: batches per ring-window prefetch")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--devices", default=None,
                    help="mesh, mesh_rebalance, multichip: lay the "
                         "shards out over devices"
                         ", a list (cuda:0,cuda:1; a name may repeat) or "
                         "a count of cards (4 = the first four)")
    a = ap.parse_args(argv)
    devices = None if a.devices is None else parse_devices(a.devices)
    if a.target_latency:
        a.workload = "frontier"
    if a.workload == "queue":
        r = serve_queue(10_000 if a.n is None else a.n, device=a.device)
        sec = r.seconds
        print(json.dumps({
            "workload": "queue", "device": str(r.state.device),
            **r.stats, "counters": r.counters,
            "bulk_adds_per_s": r.stats["adds"] / sec["bulk_load"],
            "pull_batch_decisions_per_s": r.stats["batch_decisions"]
            / (sec["pull_batch_0"] + sec["pull_batch_1"]),
            "pull_request_per_s": QUEUE["pulls"] / sec["pull_request"],
            "seconds": sec}))
        return 0
    if a.workload in ("cfg3", "cfg4", "frontier"):
        return _main_sustained(a)
    if a.workload == "serve_row":
        row = serve_row(a.k or 65536, a.m or 32, epochs_lo=a.epochs_lo,
                        epochs_hi=a.epochs_hi, depth=a.depth,
                        reps=5 if a.reps is None else a.reps,
                        n=a.n or 100_000, select_impl=a.select_impl,
                        tag_width=a.tag_width, window_m=a.window_m,
                        device=a.device)
        _print_rows({"serve" if a.select_impl == "sort"
                     else "serve_radix": row}, a.device)
        return 0
    if a.workload == "mesh":
        from .robust.faults import parse_fault_spec

        row = mesh_row(a.clients or MESH["clients"], n_shards=a.n_shards,
                       counter_sync_every=a.counter_sync_every,
                       fault_spec=parse_fault_spec(a.fault_plan),
                       device=a.device, devices=devices)
        print(json.dumps({"device": str(resolve_device(a.device)
                                        if devices is None else
                                        resolve_devices(devices)[0]),
                          **row}))
        if a.rebalance == "on":
            _print_rows({"mesh_rebalance": mesh_rebalance_row(
                n_shards=a.n_shards or REBALANCE["n_shards"],
                device=a.device, devices=devices)}, a.device)
        return 0
    if a.workload == "controller":
        _print_rows(controller_row(
            sides=a.controller, total_ids=a.n or CONTROLLER["total_ids"],
            epochs=a.epochs or CONTROLLER["epochs"], device=a.device),
            a.device)
        return 0
    if a.workload == "rpc":
        _print_rows(rpc_row(
            workers=a.rpc_workers, requests=a.requests,
            n=a.n or RPC["n"], epochs=a.epochs or RPC["epochs"],
            fault_spec=a.rpc_fault_spec, device=a.device), a.device)
        return 0
    if a.workload == "mesh_rebalance":
        _print_rows({"mesh_rebalance": mesh_rebalance_row(
            n_shards=a.n_shards or REBALANCE["n_shards"],
            total_ids=a.n or REBALANCE["total_ids"],
            epochs=a.epochs or REBALANCE["epochs"], device=a.device,
            devices=devices)}, a.device)
        return 0
    if a.workload == "multichip":
        row = multichip_row(a.n_shards or 8, a.clients or 10_000,
                            decisions_per_step=a.k or 1024,
                            device=a.device, devices=devices)
        if devices is not None:
            row["devices"] = [str(d) for d in resolve_devices(devices)]
        print(json.dumps({"device": str(resolve_device(a.device)
                                        if devices is None else
                                        resolve_devices(devices)[0]),
                          **row}))
        return 0
    if a.workload == "churn":
        res = churn_row(
            a.churn_scenario, total_ids=a.n or CHURN["total_ids"],
            epochs=a.epochs or CHURN["epochs"], m=a.m or CHURN["m"],
            k=a.k or CHURN["k"], slo=a.slo == "on", device=a.device)
        res.pop("_hist_block")
        print(json.dumps({"workload": f"churn_{a.churn_scenario}",
                          "device": str(resolve_device(a.device)),
                          **res}))
        return 0
    a.n = 100_000 if a.n is None else a.n
    a.k = 65536 if a.k is None else a.k
    a.epochs = 3 if a.epochs is None else a.epochs
    knobs = dict(select_impl=a.select_impl, tag_width=a.tag_width)
    if a.workload == "serve":
        res = serve_only(a.n, a.depth, a.k, 32 if a.m is None else a.m,
                         a.epochs, window_m=a.window_m, device=a.device,
                         **knobs)
        ok = {"guards_ok": bool(res.guards_ok.all()), **knobs}
    elif a.workload == "chain":
        res = serve_chain(a.n, a.depth, a.k, 8 if a.m is None else a.m,
                          a.epochs, device=a.device, **knobs)
        committed = res.length[res.slot >= 0].to(torch.int64)
        ok = {"guards_ok": bool(res.guards_ok.all()), **knobs,
              "units": int(res.unit_count.sum()),
              "unit_lengths": torch.bincount(committed).tolist()}
    met = obsdev.metrics_dict(res.metrics)
    print(json.dumps({
        "workload": a.workload, "device": str(res.state.device),
        "decisions": int(res.count.sum()), **ok,
        "reservation_share": met["decisions_reservation"]
        / max(met["decisions_total"], 1),
        "metrics": met}))
    return 0


def _print_rows(rows: dict, device) -> None:
    """One JSON line a row, keyed by bench's row name."""
    for key, row in rows.items():
        print(json.dumps({"row": key,
                          "device": str(resolve_device(device)), **row}))


def _main_sustained(a) -> int:
    """The cfg3 and cfg4 rows and the frontier as one JSON line: bench's
    keys beside the port's.  With ``--spans`` a span tracer and a
    watchdog (bench's: 2 s polls, a 60 s stall, the default registry)
    watch the run, and the line carries the watchdog's last 8 warnings
    on every exit path."""
    from .obs.registry import default_registry, publish_span_gauges
    from .obs.watchdog import Watchdog

    flags = {name: getattr(a, name) == "on"
             for name in ("telemetry", "slo", "provenance")}
    tracer = watchdog = None
    if a.spans:
        tracer = obsspans.SpanTracer()
        watchdog = Watchdog(tracer, interval_s=2.0, stall_after_s=60.0,
                            registry=default_registry()).start()
    depth = {k: getattr(a, k) for k in ("rounds", "rounds_lo", "reps",
                                        "latency_rounds")}
    key = a.workload
    if a.workload == "cfg4" and a.calendar_impl != "minstop":
        key = f"cfg4_{a.calendar_impl}"
    if a.engine_loop == "stream" and a.workload != "frontier":
        key += "_stream"
    out = {"workload": key, "device": str(resolve_device(a.device))}
    try:
        if a.workload == "frontier":
            pick, rows = frontier(
                n=a.n or ROW_N["cfg4"],
                target_latency_ms=a.target_latency, tracer=tracer,
                watchdog=watchdog, device=a.device,
                **{k: FRONTIER[k] if v is None else v
                   for k, v in depth.items()})
            out["rows"] = rows
            if pick is not None:
                out["picked"] = pick
        else:
            n = ROW_N[a.workload] if a.n is None else a.n
            row = sustained_row(
                a.workload, n, **depth,
                conformance_rounds=a.conformance_rounds,
                conformance_out=a.conformance_out,
                calendar_impl=a.calendar_impl, engine_loop=a.engine_loop,
                stream_chunk=a.stream_chunk, tracer=tracer,
                watchdog=watchdog, device=a.device, **flags)
            hb = row.pop("_hist_block", None)
            if hb is not None:
                obshist.publish_hists(default_registry(),
                                      np.asarray(hb, dtype=np.int64),
                                      labels={"workload": key})
            if "spans" in row:
                publish_span_gauges(default_registry(), row["spans"],
                                    labels={"workload": key})
            out.update(n=n, telemetry_on=flags["telemetry"],
                       slo_on=flags["slo"], **row)
    except BaseException as e:
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        if watchdog is not None:
            watchdog.close()
            if watchdog.warnings:
                out["watchdog_warnings"] = watchdog.warnings[-8:]
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
