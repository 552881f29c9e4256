"""The serving entry points: the ``serve``, ``chain``, ``cfg4`` and
``queue`` workloads.

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

``serve_cfg4`` runs the ``cfg4`` closed loop (``bench.py`` cfg4 mode,
``bench_sustained``): 100,000 clients with Zipf weights and a
reservation of 1200 ops/s each, a 128-slot ring preloaded 64 deep, and
50 ms rounds.  Each round (``calendar_round``) clamps the Poisson
arrivals to ring headroom, ingests 64 waves in one ring pass, and runs
m=3 calendar batches of 64 serve steps per client per level, 8 ladder
levels, on the timer wheel.  The bench's calibration loop, which
retunes the arrival and reservation rates toward a 0.5 reservation
share, is load-generator logic and is not ported: the rounds run at the
bench's starting values.

``serve_queue`` drives the pull queue API (``engine.queue``) at cfg3's
population, 10,000 clients, through the exact serial engine (no K1 or
K2 launch); ``virtual_server`` runs the push queue in the virtual-time
embedding, or the pull queue, behind a simulated server.

Run it (on the card; ``--device cpu`` for a small CPU run)::

    python -m dmclock_tpu_torch.serve --n 100000 --epochs 3
    python -m dmclock_tpu_torch.serve --select-impl radix --tag-width 32
    python -m dmclock_tpu_torch.serve --workload chain --epochs 1
    python -m dmclock_tpu_torch.serve --workload cfg4 --rounds 3
    python -m dmclock_tpu_torch.serve --workload cfg4 --n 256 --device cpu
    python -m dmclock_tpu_torch.serve --workload queue [--n 10000]
"""

from __future__ import annotations

import argparse
import functools
import heapq
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from .core.qos import ClientInfo
from .core.recs import ReqParams
from .core.timebase import MAX_TAG, rate_to_inv_ns
from .device import DEFAULT_DEVICE, resolve_device
from .engine.bridge import state_from_numpy
from .engine.fastpath import (CalendarEpoch, scan_calendar_epoch,
                              scan_chain_epoch, scan_prefix_epoch)
from .engine.kernels import as_scalar, ingest_superwave
from .engine.push_queue import TpuPushPriorityQueue
from .engine.queue import TpuPullPriorityQueue
from .engine.state import FIELD_DTYPES, EngineState, _FRESH_FILLS
from .obs import device as obsdev

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
# the cfg4 closed loop
# ----------------------------------------------------------------------

# the cfg4 workload's shape (bench.py cfg4 mode) at its starting values
CFG4 = dict(ring=128, depth0=64, resv_rate=1200.0, waves=64,
            dt_round_ns=50_000_000, m=3, steps=64, ladder_levels=8,
            calendar_impl="wheel")


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
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> EngineState:
    """Preload ``depth0``-deep queues for a mixed-QoS population (the
    port's copy of ``bench._sustained_setup``, with its per-client
    reservation-phase stagger).  A zero rate or weight disables that
    axis for the client (ClientInfo 0 -> 0) and pins its head tag to
    MAX_TAG.  Built in numpy, copied to ``device`` once."""
    c = np.arange(n)
    rinv = np.asarray([rate_to_inv_ns(r) for r in resv_rates],
                      dtype=np.int64)
    winv = np.asarray([rate_to_inv_ns(w) for w in weights],
                      dtype=np.int64)
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    jitter = (phase * 2.0 * winv).astype(np.int64)
    rjit = (phase * 2.0 * rinv).astype(np.int64)
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


def calendar_round(state: EngineState, counts: torch.Tensor, t_base, *,
                   m: int, steps: int, ladder_levels: int, waves: int,
                   dt_round_ns: int, calendar_impl: str) -> CalendarEpoch:
    """One closed-loop round (``bench_sustained``'s round body): clamp
    the int32 ``counts[N]`` to ring headroom, ingest them as ``waves``
    waves spread over the round (cost = rho = delta = 1), then run
    ``m`` calendar batches at ``now = t_base + dt_round_ns``.  The
    epoch's metrics include the round's ``ingest_drops``."""
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
    ep = scan_calendar_epoch(st, t_base + dt_round_ns, m, steps=steps,
                             with_metrics=True, calendar_impl=calendar_impl,
                             ladder_levels=ladder_levels)
    return ep._replace(metrics=obsdev.metrics_combine(
        ep.metrics, obsdev.metrics_delta(device=dev, ingest_drops=dropped)))


def cfg4_setup(n: int = 100_000, rounds: int = 3, seed: int = 11, *,
               device: str | torch.device = DEFAULT_DEVICE):
    """The cfg4 state and every round's arrival counts, both on
    ``device``: ``(state, draws int32[rounds, n])``.  Arrivals are
    ``numpy.random.default_rng(seed).poisson(lam)`` clipped to
    ``waves``, with ``lam`` the bench's starting guess (the reservation
    floor plus the weight share of the surplus, clipped to ``waves -
    1``); all draws are made and uploaded here, before any round."""
    dev = resolve_device(device)
    c = CFG4
    weights = _zipf_weights(n)
    resv_rates = np.full(n, c["resv_rate"])
    state = _sustained_setup(n, c["ring"], c["depth0"], resv_rates,
                             weights, device=dev)
    round_s = c["dt_round_ns"] / 1e9
    serve_per_round = c["m"] * n * c["steps"]
    surplus = max(serve_per_round - float(resv_rates.sum()) * round_s, 0.0)
    lam = np.minimum(resv_rates * round_s
                     + surplus * (weights / weights.sum()),
                     c["waves"] - 1.0)
    rng = np.random.default_rng(seed)
    draws = np.stack([np.minimum(rng.poisson(lam), c["waves"])
                      .astype(np.int32) for _ in range(rounds)])
    return state, torch.from_numpy(draws).to(dev)


class Cfg4Result(NamedTuple):
    """``rounds`` cfg4 rounds' output (stacked on the device)."""

    state: EngineState         # after the last round
    count: torch.Tensor        # int32[R, m] decisions per batch
    resv_count: torch.Tensor   # int32[R, m]
    progress_ok: torch.Tensor  # bool[R, m]
    served: torch.Tensor       # int32[R, N] per-client decisions
    level_count: torch.Tensor  # int32[R, m, L]
    metrics: torch.Tensor      # int64[NUM_METRICS], merged over rounds


def cfg4_rounds(state: EngineState, draws: torch.Tensor, *,
                t0: int = 0, calendar_impl: str = CFG4["calendar_impl"]
                ) -> Cfg4Result:
    """Round ``r`` ingests ``draws[r]`` at ``t_base = t0 + r * 50 ms``;
    no host synchronisation between rounds."""
    c = CFG4
    met = obsdev.metrics_zero(state.device)
    eps = []
    for r in range(draws.shape[0]):
        ep = calendar_round(state, draws[r], t0 + r * c["dt_round_ns"],
                            m=c["m"], steps=c["steps"],
                            ladder_levels=c["ladder_levels"],
                            waves=c["waves"], dt_round_ns=c["dt_round_ns"],
                            calendar_impl=calendar_impl)
        state = ep.state
        met = obsdev.metrics_combine(met, ep.metrics)
        eps.append(ep)
    return Cfg4Result(
        state=state, metrics=met,
        **{f: torch.stack([getattr(ep, f) for ep in eps])
           for f in ("count", "resv_count", "progress_ok", "served",
                     "level_count")})


def serve_cfg4(n: int = 100_000, rounds: int = 3, seed: int = 11, *,
               device: str | torch.device = DEFAULT_DEVICE) -> Cfg4Result:
    """The ``cfg4`` workload: ``n`` clients, ``rounds`` closed-loop
    rounds from virtual time 0.  Callers check every ``progress_ok``
    (False: the serial engine must take that batch)."""
    state, draws = cfg4_setup(n, rounds, seed, device=device)
    return cfg4_rounds(state, draws)


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
             final_batch=128)


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
    slots, a reactivation); a last ``pull_batch``.  Every stage's wall
    time is host-paced: each launch reads its decisions back."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("serve", "chain", "cfg4",
                                           "queue"), default="serve")
    ap.add_argument("--n", type=int, default=None,
                    help="clients (100000; queue 10000)")
    ap.add_argument("--depth", type=int, default=320,
                    help="serve, chain: queue depth and ring size")
    ap.add_argument("--k", type=int, default=65536,
                    help="serve, chain: decisions (units) per batch")
    ap.add_argument("--m", type=int, default=None,
                    help="serve, chain: batches per epoch (32; chain 8)")
    ap.add_argument("--epochs", type=int, default=3, help="serve, chain")
    ap.add_argument("--rounds", type=int, default=3, help="cfg4")
    ap.add_argument("--select-impl", choices=("sort", "radix"),
                    default="sort", help="serve, chain: selection backend")
    ap.add_argument("--tag-width", type=int, choices=(64, 32), default=64,
                    help="serve, chain: epoch tag carry width")
    ap.add_argument("--window-m", type=int, default=None,
                    help="serve: batches per ring-window prefetch")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
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
    a.n = 100_000 if a.n is None else a.n
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
    else:
        res = serve_cfg4(a.n, a.rounds, device=a.device)
        ok = {"progress_ok": bool(res.progress_ok.all())}
    met = obsdev.metrics_dict(res.metrics)
    print(json.dumps({
        "workload": a.workload, "device": str(res.state.device),
        "decisions": int(res.count.sum()), **ok,
        "reservation_share": met["decisions_reservation"]
        / max(met["decisions_total"], 1),
        "metrics": met}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
