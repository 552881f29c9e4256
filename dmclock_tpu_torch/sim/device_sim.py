"""Device-resident batch-synchronous QoS simulator.

Counterpart of ``dmclock_tpu/sim/device_sim.py``: the whole closed loop
-- client load generation, the delta/rho piggyback protocol, dmClock
scheduling and service completion -- lives on the card, with the
servers as a leading axis S of every ``[S, C]`` and ``[S, C, Q]``
tensor.  The host drives the slices and reads back one count per serve
batch per server.

This is deliberately a DIFFERENT model from the discrete-event host
harness (``sim.harness``), trading event-exact timing for throughput:

- Time advances in fixed slices of ``q * op_time`` ns; a server with
  backlog serves exactly ``q`` requests per slice (its iops rate), and
  every serve in a slice is stamped at the slice boundary.
- A client's sends for a slice are computed from its rate gap and
  window at the slice start; completions feed back with one-slice
  latency (outstanding decreases at the end of the slice that served
  them).
- Server selection: the harness's deterministic policy
  (``Simulation._make_server_select`` non-random branch), or -- with
  ``server_random_selection`` -- a counter hash (splitmix64 of (client,
  send-sequence), reference random policy ``simulate.h:401-444``):
  stateless and reproducible.
- Multi-thread servers serve ``threads * q`` requests per slice (the
  harness's aggregate-rate model: op_time = threads/iops,
  ``sim_server.h:136-139``).

QoS semantics (tags, phases, AtLimit, idle reactivation, the tracker
algebra) are the engine's: ``engine.kernels.ingest_wave`` /
``engine_run``, the prefix and calendar batches of ``engine.fastpath``
and ``parallel.tracker``.  Every ``DeviceSim`` field equals the JAX
package's after the same slices (``tests/test_torch_device_sim.py``).

Where the JAX step ``vmap``s over servers, the port loops over S on
views ``x[s]`` of the stacked tensors (a leading-index view is
contiguous, as kernel K1 requires): the ingest waves (``ingest_wave``'s
idle-reactivation minimum runs over one server's clients), the serve
batches and ``engine_run``.  The tracker and the stats folds are one
call over ``[S, C]``.  The JAX ``lax.while_loop`` over serve batches is
a host loop that reads each batch's count back; the ring window of each
prefix batch and of each calendar batch is kernel K1 on the card, and
the wheel's scans kernel K2.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.qos import ClientInfo
from ..core.timebase import NS_PER_SEC
from ..device import DEFAULT_DEVICE, resolve_device
from ..engine import kernels
from ..engine.bridge import _check_fields, _tensor_from_numpy
from ..engine.fastpath import (_window_heads, calendar_batch,
                               calendar_batch_bucketed,
                               calendar_batch_wheel, ring_window,
                               speculate_prefix_batch)
from ..engine.state import FIELD_DTYPES, EngineState, init_state
from ..parallel.tracker import (TRACKER_DTYPES, TrackerState,
                                global_counters, init_tracker,
                                tracker_prepare, tracker_track,
                                tracker_track_counts)
from .config import ClientGroup, ServerGroup, SimConfig


class ClientLoad(NamedTuple):
    """Per-client ([C]) load-generator state, shared by every server."""

    gap_ns: torch.Tensor        # int64[C] inter-send gap
    next_send: torch.Tensor     # int64[C] next send time (TIME-like ns)
    sent: torch.Tensor          # int32[C] requests sent so far
    total_ops: torch.Tensor     # int32[C]
    outstanding: torch.Tensor   # int32[C]
    window: torch.Tensor        # int32[C] max outstanding
    cost: torch.Tensor          # int64[C]
    sel_base: torch.Tensor      # int32[C] server-select base offset
    sel_range: torch.Tensor     # int32[C] server-select range


class DeviceSim(NamedTuple):
    engine: EngineState         # [S, ...]
    tracker: TrackerState       # [S, C]
    load: ClientLoad            # [C]
    served_resv: torch.Tensor   # int64[S, C] completions by phase
    served_prop: torch.Tensor   # int64[S, C]
    last_served: torch.Tensor   # int64[S, C] slice-end of last completion
    t: torch.Tensor             # int64 0-d slice-aligned clock
    guard_trips: torch.Tensor   # int32 0-d: prefix rebase-guard trips
    #                             (must stay 0 -- init_device_sim
    #                             validates the only dynamic inputs;
    #                             run_device_sim raises otherwise)


# dtypes of the load and the counters (the engine's are engine.state's
# FIELD_DTYPES, the tracker's parallel.tracker's TRACKER_DTYPES): the
# JAX package's, checked by device_sim_from_numpy
LOAD_DTYPES = dict(gap_ns=torch.int64, next_send=torch.int64,
                   sent=torch.int32, total_ops=torch.int32,
                   outstanding=torch.int32, window=torch.int32,
                   cost=torch.int64, sel_base=torch.int32,
                   sel_range=torch.int32)
SIM_DTYPES = dict(served_resv=torch.int64, served_prop=torch.int64,
                  last_served=torch.int64, t=torch.int64,
                  guard_trips=torch.int32)


@dataclass
class DeviceSimSpec:
    """Static launch parameters derived from a SimConfig."""

    n_servers: int
    n_clients: int
    op_time_ns: int            # uniform across servers
    q_per_slice: int           # serves per server per slice
    max_sends: int             # per client per slice (static bound)
    slice_ns: int
    allow_limit_break: bool
    all_weights_positive: bool = True  # Allow-fastpath restriction
    random_select: bool = False
    force_scan: bool = False   # test hook: disable the prefix serve
    select_impl: str = "sort"  # prefix selection backend
    #                            ("sort"|"radix"; bit-identical
    #                            decisions -- fastpath select_impl)
    calendar_impl: Optional[str] = None  # None = prefix/scan serving
    #                            only; "minstop"|"bucketed"|"wheel"
    #                            front-loads each slice with sortless
    #                            calendar batches (whole batches only,
    #                            budget-gated; the capped prefix loop
    #                            finishes the slice), so service is
    #                            EXACTLY the q-step serial stream either
    #                            way
    calendar_steps: int = 8    # per-client serve budget per calendar
    #                            batch (<= ring_capacity)
    ladder_levels: int = 4     # ladder levels ("bucketed", "wheel")


@dataclass
class StepCounts:
    """What the host loop of :func:`device_sim_step` did, for the
    caller that passes one in: slices run, serve batches launched, and
    the values read back from the card (one count per batch)."""

    slices: int = 0
    prefix_batches: int = 0
    calendar_batches: int = 0
    read_backs: int = 0


def _make_spec(cfg: SimConfig, q_per_slice: int = 4) -> DeviceSimSpec:
    iops = {g.server_iops for g in cfg.srv_group}
    threads = {g.server_threads for g in cfg.srv_group}
    assert len(iops) == 1 and len(threads) == 1, \
        "device_sim: uniform server groups (iops and threads)"
    n_servers = sum(g.server_count for g in cfg.srv_group)
    n_clients = sum(g.client_count for g in cfg.cli_group)
    n_threads = threads.pop()
    # aggregate service rate stays iops: T threads each at op_time =
    # T/iops (sim_server.h:136-139) -> T*q serves per q*op_time slice
    op_time_ns = int(0.5 + n_threads * 1e6 / iops.pop()) * 1000
    slice_ns = op_time_ns * q_per_slice
    q_per_slice = q_per_slice * n_threads
    # static bound on sends per client per slice; refuse configs whose
    # offered load cannot be expressed (a silent clamp would misreport
    # a simulator artifact as a QoS limit)
    min_gap = min(int(0.5 + 1e6 / g.client_iops_goal) * 1000
                  for g in cfg.cli_group)
    max_sends = max(1, slice_ns // max(min_gap, 1) + 1)
    assert max_sends <= 16, (
        f"client iops goals need {max_sends} sends/client/slice; the "
        "wave unroll caps at 16 -- raise server_iops (shorter slices) "
        "or lower client_iops_goal")
    return DeviceSimSpec(
        n_servers=n_servers, n_clients=n_clients,
        op_time_ns=op_time_ns, q_per_slice=q_per_slice,
        max_sends=max_sends, slice_ns=slice_ns,
        allow_limit_break=cfg.server_soft_limit,
        all_weights_positive=all(g.client_weight > 0
                                 for g in cfg.cli_group),
        random_select=cfg.server_random_selection)


def _stack(one: torch.Tensor, s: int) -> torch.Tensor:
    """``one`` repeated on a new leading axis of ``s``, as its own
    contiguous tensor (kernel K1 reads each server's rings in place)."""
    return one.unsqueeze(0).expand((s,) + tuple(one.shape)).contiguous()


def init_device_sim(cfg: SimConfig, ring_capacity: int = 256,
                    select_impl: str = "sort",
                    calendar_impl: Optional[str] = None,
                    calendar_steps: int = 8,
                    ladder_levels: int = 4, *,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> tuple[DeviceSim, DeviceSimSpec]:
    assert calendar_impl in (None, "minstop", "bucketed",
                             "wheel"), calendar_impl
    assert 1 <= calendar_steps <= ring_capacity, \
        "calendar_steps must fit the ring window"
    assert ladder_levels >= 1
    dev = resolve_device(device)
    spec = _make_spec(cfg)
    spec.select_impl = select_impl
    spec.calendar_impl = calendar_impl
    spec.calendar_steps = calendar_steps
    spec.ladder_levels = ladder_levels
    s, c = spec.n_servers, spec.n_clients
    max_window = max(g.client_outstanding_ops for g in cfg.cli_group)
    assert max_window <= ring_capacity, (
        f"client_outstanding_ops {max_window} can exceed a per-client "
        f"ring of {ring_capacity}; raise ring_capacity")
    # the prefix serve path's rebase guards depend on request cost and
    # creation-order spread; both are static here (costs from config,
    # order = arange(C) fixed at init), so validating cost once makes a
    # guard failure impossible by construction -- the serve loop relies
    # on this to skip the per-batch guards_ok check
    max_cost = max(g.client_req_cost for g in cfg.cli_group)
    assert 0 < max_cost < (1 << 31), (
        f"client_req_cost {max_cost} overflows the int32 sort payload "
        "of the prefix serve path")

    infos, gaps, waits, totals, windows, costs, ranges = \
        [], [], [], [], [], [], []
    for g in cfg.cli_group:
        for _ in range(g.client_count):
            infos.append(ClientInfo(g.client_reservation,
                                    g.client_weight, g.client_limit))
            gaps.append(int(0.5 + 1e6 / g.client_iops_goal) * 1000)
            waits.append(int(g.client_wait_s * NS_PER_SEC))
            totals.append(g.client_total_ops)
            windows.append(g.client_outstanding_ops)
            costs.append(g.client_req_cost)
            ranges.append(min(g.client_server_select_range, s))

    factor = s / max(1, c)
    sel_base = np.asarray([int(0.5 + i * factor) % s for i in range(c)],
                          dtype=np.int32)

    def col(values, dtype):
        return torch.as_tensor(np.asarray(values, dtype=dtype)).to(dev)

    one = init_state(c, ring_capacity, device=dev)._replace(
        active=torch.ones((c,), dtype=torch.bool, device=dev),
        order=torch.arange(c, dtype=torch.int64, device=dev),
        resv_inv=col([i.reservation_inv_ns for i in infos], np.int64),
        weight_inv=col([i.weight_inv_ns for i in infos], np.int64),
        limit_inv=col([i.limit_inv_ns for i in infos], np.int64))
    engine = EngineState(*(_stack(f, s) for f in one))
    tracker = init_tracker(c, n_servers=s, device=dev)
    load = ClientLoad(
        gap_ns=col(gaps, np.int64),
        next_send=col(waits, np.int64),
        sent=torch.zeros((c,), dtype=torch.int32, device=dev),
        total_ops=col(totals, np.int32),
        outstanding=torch.zeros((c,), dtype=torch.int32, device=dev),
        window=col(windows, np.int32),
        cost=col(costs, np.int64),
        sel_base=col(sel_base, np.int32),
        sel_range=col(ranges, np.int32),
    )

    def zsc():
        return torch.zeros((s, c), dtype=torch.int64, device=dev)

    sim = DeviceSim(engine=engine, tracker=tracker, load=load,
                    served_resv=zsc(), served_prop=zsc(),
                    last_served=zsc(),
                    t=torch.zeros((), dtype=torch.int64, device=dev),
                    guard_trips=torch.zeros((), dtype=torch.int32,
                                            device=dev))
    return sim, spec


def _slice_sends(load: ClientLoad, t0, slice_ns: int, max_sends: int):
    """How many sends each client performs this slice (bounded by rate,
    window, and remaining ops), all from slice-start state.

    Model bound: a client catching up after a window stall emits at
    most ``max_sends`` per slice even if its rate debt is larger (the
    wave unroll is static); the debt carries over via ``next_send``, so
    offered load is deferred, never lost.  _make_spec's assert covers
    the steady-state rate; this bound only shapes post-stall bursts."""
    t_end = t0 + slice_ns
    by_rate = torch.where(
        load.next_send < t_end,
        torch.div((t_end - load.next_send) + load.gap_ns - 1,
                  load.gap_ns, rounding_mode="floor"),
        0).to(torch.int32)
    n = torch.minimum(torch.clamp(by_rate, max=max_sends),
                      torch.minimum(load.window - load.outstanding,
                                    load.total_ops - load.sent))
    return torch.clamp(n, min=0)


# splitmix64's constants as signed int64 (0x9E3779B97F4A7C15,
# 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)
_SM_GAMMA = -7046029254386353131
_SM_MUL1 = -4658895280553007687
_SM_MUL2 = -7723592293110705685


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Stateless counter hash (splitmix64 finalizer) on int64: the RNG
    of random server selection, the same value for a given (client,
    sequence) on every device.  The adds and multiplies wrap modulo
    2^64 and ``>>`` is arithmetic, as in the JAX version."""
    x = x + _SM_GAMMA
    z = x
    z = (z ^ (z >> 30)) * _SM_MUL1
    z = (z ^ (z >> 27)) * _SM_MUL2
    return z ^ (z >> 31)


def _sends_to_server(load: ClientLoad, n, wave: int, server_ids,
                     n_servers: int, random_select: bool):
    """``[S, C]``: does client c's ``wave``-th send this slice target
    server s?  Deterministic policy: (sel_base + seq % range) %
    n_servers; random policy: sel_base + hash(client, seq) % range (the
    reference picks uniformly within the client's server window,
    simulate.h:401-444).  ``torch.remainder`` takes the divisor's sign
    (``jnp.remainder``'s rule), and ``abs`` of INT64_MIN stays
    negative in both."""
    seq = load.sent + wave
    if random_select:
        c = seq.shape[0]
        h = _splitmix64(seq.to(torch.int64) * (1 << 20)
                        + torch.arange(c, dtype=torch.int64,
                                       device=seq.device))
        pick = torch.remainder(torch.abs(h),
                               load.sel_range.to(torch.int64))
        target = torch.remainder(load.sel_base + pick.to(torch.int32),
                                 n_servers)
    else:
        target = torch.remainder(
            load.sel_base + torch.remainder(seq, load.sel_range),
            n_servers)
    return (n > wave)[None, :] & (target[None, :] == server_ids[:, None])


def server_view(engine: EngineState, s: int) -> EngineState:
    """Server ``s``'s engine state: views ``x[s]`` of the stacked
    ``[S, ...]`` tensors (contiguous, as kernel K1 requires)."""
    return EngineState(*(f[s] for f in engine))


def _restack(engines) -> EngineState:
    return EngineState(*(torch.stack(fs) for fs in zip(*engines)))


def _empty_decisions(q: int, dev: torch.device) -> kernels.Decision:
    return kernels.Decision(
        type=torch.full((q,), kernels.NONE, dtype=torch.int32, device=dev),
        slot=torch.full((q,), -1, dtype=torch.int32, device=dev),
        phase=torch.zeros((q,), dtype=torch.int32, device=dev),
        cost=torch.zeros((q,), dtype=torch.int64, device=dev),
        when=torch.zeros((q,), dtype=torch.int64, device=dev),
        limit_break=torch.zeros((q,), dtype=torch.bool, device=dev))


def _calendar_front(eng: EngineState, t_end, spec: DeviceSimSpec,
                    counts: StepCounts):
    """Commit WHOLE sortless calendar batches while they fit the slice
    budget: each batch is an exact serial prefix, and a batch that would
    overshoot q (or commits nothing) is discarded untaken, so the capped
    prefix loop finishes the slice exactly.  Returns ``(eng, served,
    served_resv, total)`` with the per-client counts as int32[C]."""
    q = spec.q_per_slice
    steps = min(spec.calendar_steps, eng.ring_capacity)
    zc = torch.zeros((spec.n_clients,), dtype=torch.int32,
                     device=eng.device)
    srv, rsv, total = zc, zc, 0
    while True:
        if spec.calendar_impl == "wheel":
            b = calendar_batch_wheel(
                eng, t_end, steps=steps, levels=spec.ladder_levels,
                anticipation_ns=0,
                allow_limit_break=spec.allow_limit_break)
        elif spec.calendar_impl == "bucketed":
            b = calendar_batch_bucketed(
                eng, t_end, steps=steps, levels=spec.ladder_levels,
                anticipation_ns=0,
                allow_limit_break=spec.allow_limit_break)
        else:
            b = calendar_batch(eng, t_end, steps=steps, anticipation_ns=0,
                               allow_limit_break=spec.allow_limit_break)
        counts.calendar_batches += 1
        counts.read_backs += 1
        count = int(b.count)
        if count <= 0 or total + count > q:
            return eng, srv, rsv, total
        eng = b.state
        srv = srv + b.served
        rsv = rsv + b.served_resv
        total += count


def _prefix_serve(eng: EngineState, t_end, spec: DeviceSimSpec,
                  cal_total: int, counts: StepCounts):
    """Prefix-commit batches, each capped at the remaining slice budget
    (which keeps the concatenated stream the exact serial prefix),
    until the budget is met or a batch commits nothing.  Returns
    ``(eng, decisions [q], guard trips)``; the decision buffer holds
    only the prefix-loop decisions (calendar serves are folded as
    counts)."""
    q = spec.q_per_slice
    # the selection sort yields one row per client, so a batch is at
    # most n_clients wide; the loop covers q
    kb = min(q, spec.n_clients)
    dbuf = _empty_decisions(q, eng.device)
    gt = torch.zeros((), dtype=torch.int32, device=eng.device)
    total, last = cal_total, 1
    while total < q and last > 0:
        # guards_ok cannot legitimately fail here: its only dynamic
        # inputs (cost, creation-order spread) are static in this sim
        # and validated at init_device_sim.  The trip counter makes
        # that invariant CHECKED: run_device_sim raises if it ever goes
        # nonzero.  The ring-head read is kernel K1 at w=1 on the card.
        heads = _window_heads(eng, ring_window(eng, 1))
        batch = speculate_prefix_batch(
            eng, t_end, kb, anticipation_ns=0, max_count=q - total,
            heads=heads, allow_limit_break=spec.allow_limit_break,
            select_impl=spec.select_impl)
        gt = gt + (~batch.guards_ok).to(torch.int32)
        counts.prefix_batches += 1
        counts.read_backs += 1
        count = int(batch.count)
        off = total - cal_total
        # rows at and past count are left unwritten (the JAX scatter
        # drops them): the buffer we own takes the committed prefix
        for buf, vals in zip(dbuf, batch.decisions):
            buf[off:off + count] = vals[:count]
        eng = batch.state
        total += count
        last = count
    return eng, dbuf, gt


def device_sim_step(sim: DeviceSim, spec: DeviceSimSpec, slices: int, *,
                    counts: Optional[StepCounts] = None) -> DeviceSim:
    """Advance ``slices`` time slices.  Pass a :class:`StepCounts` to
    have the host loop's batches and read backs counted into it."""
    counts = counts if counts is not None else StepCounts()
    s_total = spec.n_servers
    c = spec.n_clients
    dev = sim.t.device
    server_ids = torch.arange(s_total, dtype=torch.int32, device=dev)
    # opting into the calendar serve path implies the budgeted batch
    # loop (it is exact at any q; the q >= 256 heuristic only picks the
    # default).  AtLimit::Allow rides the prefix path too (limit-break
    # candidates are a third unified class), PROVIDED every client has
    # weight > 0: a ready weight-0 client switches the reference's
    # Allow fallback to reservation order globally, which per-client
    # classification cannot express (fastpath module docstring) --
    # that shape keeps the scan.
    use_prefix = ((spec.q_per_slice >= 256
                   or spec.calendar_impl is not None)
                  and (not spec.allow_limit_break
                       or spec.all_weights_positive)
                  and not spec.force_scan)
    use_cal = use_prefix and spec.calendar_impl is not None
    if spec.calendar_impl is not None and not use_cal:
        # refuse rather than silently A/B two identical scan-path runs:
        # the Allow-with-weight-0 shape (and the force_scan test hook)
        # cannot serve through the batch loop at all
        raise ValueError(
            "calendar_impl requires the batch serve loop: "
            "incompatible with force_scan, and with "
            "allow_limit_break unless every client weight "
            "is positive")

    engines = [server_view(sim.engine, s) for s in range(s_total)]
    tracker, load = sim.tracker, sim.load
    sresv, sprop, slast = sim.served_resv, sim.served_prop, \
        sim.last_served
    t, trips = sim.t, sim.guard_trips
    for _ in range(slices):
        # the client-global counters: a sum over the server axis
        g_delta, g_rho = global_counters(tracker)
        n = _slice_sends(load, t, spec.slice_ns, spec.max_sends)

        # the ingest waves (max_sends is static and small): one request
        # per client per wave, slots distinct; the tracker once over
        # [S, C], the engines server by server
        for wave in range(spec.max_sends):
            mine = _sends_to_server(load, n, wave, server_ids, s_total,
                                    spec.random_select)
            tracker, d_out, r_out = tracker_prepare(tracker, mine,
                                                    g_delta, g_rho)
            rho = torch.where(mine, r_out, 1)
            delta = torch.where(mine, d_out, 1)
            engines = [kernels.ingest_wave(
                engines[s], mine[s], t, load.cost, rho[s], delta[s],
                anticipation_ns=0) for s in range(s_total)]

        # serve q decisions per server at the slice boundary
        t_end = t + spec.slice_ns
        decs, cal_srv, cal_rsv = [], [], []
        for s in range(s_total):
            eng = engines[s]
            if use_prefix:
                cal_total = 0
                if use_cal:
                    eng, srv_c, rsv_c, cal_total = _calendar_front(
                        eng, t_end, spec, counts)
                    cal_srv.append(srv_c)
                    cal_rsv.append(rsv_c)
                eng, d, gt = _prefix_serve(eng, t_end, spec, cal_total,
                                           counts)
                trips = (trips + gt).to(torch.int32)
            else:
                eng, _, d = kernels.engine_run(
                    eng, t_end, spec.q_per_slice,
                    allow_limit_break=spec.allow_limit_break,
                    anticipation_ns=0, advance_now=False)
            engines[s] = eng
            decs.append(d)
        decs = kernels.Decision(*(torch.stack(col) for col in zip(*decs)))
        served = decs.type == kernels.RETURNING

        tracker = tracker_track(tracker, decs.slot, decs.cost,
                                decs.phase, served)
        if use_cal:
            cal_srv = torch.stack(cal_srv)
            cal_rsv = torch.stack(cal_rsv)
            # calendar serves arrive as per-client totals; the counts
            # fold computes the same sums as the decision-stream fold
            # (per-client cost is constant here)
            tracker = tracker_track_counts(tracker, cal_srv, cal_rsv,
                                           load.cost)

        # stats + completion feedback (one [S, q] scatter-add per phase)
        one = served.to(torch.int64)
        idx = torch.where(served, decs.slot, 0).to(torch.int64)
        sresv = sresv.scatter_add(1, idx, one * (decs.phase == 0))
        sprop = sprop.scatter_add(1, idx, one * (decs.phase == 1))
        slast = slast.scatter_reduce(1, idx,
                                     torch.where(served, t_end, 0),
                                     "amax", include_self=True)
        done_here = torch.zeros((s_total, c), dtype=torch.int32,
                                device=dev).scatter_add(
            1, idx, one.to(torch.int32))
        if use_cal:
            sresv = sresv + cal_rsv.to(torch.int64)
            sprop = sprop + (cal_srv - cal_rsv).to(torch.int64)
            slast = torch.maximum(slast, torch.where(cal_srv > 0, t_end,
                                                     0))
            done_here = done_here + cal_srv
        completions = done_here.sum(dim=0)

        load = load._replace(
            sent=(load.sent + n).to(torch.int32),
            outstanding=(load.outstanding + n
                         - completions).to(torch.int32),
            next_send=load.next_send + n.to(torch.int64) * load.gap_ns,
        )
        t = t_end
        counts.slices += 1
    return DeviceSim(engine=_restack(engines), tracker=tracker, load=load,
                     served_resv=sresv, served_prop=sprop,
                     last_served=slast, t=t, guard_trips=trips)


def check_guard_trips(sim: DeviceSim) -> None:
    """Raise if any prefix batch tripped a rebase guard.  The guards'
    only dynamic inputs (request cost, creation-order spread) are
    validated statically by init_device_sim, so a trip means that
    validation no longer covers the workload and committed counts are
    untrustworthy."""
    trips = int(sim.guard_trips)
    if trips:
        raise RuntimeError(
            f"device_sim: {trips} prefix rebase-guard trip(s) -- "
            "init_device_sim's static validation no longer covers the "
            "workload (cost or creation-order spread past the int32 "
            "sort payload); committed counts are untrustworthy")


def served_total(sim: DeviceSim) -> int:
    """Completions so far over every server and client (one read back)."""
    return int(sim.served_resv.sum() + sim.served_prop.sum())


def run_device_sim(cfg: SimConfig, *, ring_capacity: int = 256,
                   slices_per_launch: int = 64,
                   max_launches: int = 200,
                   check_guards: bool = True,
                   select_impl: str = "sort",
                   calendar_impl: Optional[str] = None,
                   calendar_steps: int = 8,
                   ladder_levels: int = 4,
                   device: str | torch.device = DEFAULT_DEVICE,
                   counts: Optional[StepCounts] = None):
    """Run to completion (all clients' ops served) or the launch cap.
    A "launch" is one :func:`device_sim_step` of ``slices_per_launch``
    slices; the served totals are read back after each (counted in
    ``counts.read_backs`` with the serve batches' counts).

    ``check_guards`` (default on) raises after any launch whose prefix
    batches tripped a rebase guard -- the invariant init_device_sim
    validates statically, made CHECKED so future edits that weaken the
    validation surface instead of silently under-serving.

    ``calendar_impl`` (None|"minstop"|"bucketed"|"wheel") front-loads
    each slice with sortless calendar batches
    (DeviceSimSpec.calendar_impl) -- service stays exactly the q-step
    serial stream.

    Returns (sim, spec, report_str)."""
    counts = counts if counts is not None else StepCounts()
    sim, spec = init_device_sim(cfg, ring_capacity=ring_capacity,
                                select_impl=select_impl,
                                calendar_impl=calendar_impl,
                                calendar_steps=calendar_steps,
                                ladder_levels=ladder_levels,
                                device=device)
    total_ops = int(sim.load.total_ops.sum())
    launches = 0
    completed = 0
    for launches in range(1, max_launches + 1):
        sim = device_sim_step(sim, spec, slices_per_launch, counts=counts)
        if check_guards:
            check_guard_trips(sim)
            counts.read_backs += 1
        completed = served_total(sim)
        counts.read_backs += 1
        if completed >= total_ops:
            break
    return sim, spec, format_report(cfg, sim, spec, launches,
                                    completed=completed,
                                    total_ops=total_ops)


def format_report(cfg: SimConfig, sim: DeviceSim, spec: DeviceSimSpec,
                  launches: int, *, completed: Optional[int] = None,
                  total_ops: Optional[int] = None) -> str:
    sresv = sim.served_resv.cpu().numpy().sum(axis=0)   # [C]
    sprop = sim.served_prop.cpu().numpy().sum(axis=0)
    t_s = int(sim.t) / NS_PER_SEC
    lines = ["=== device sim report ===",
             f"servers: {spec.n_servers}  clients: {spec.n_clients}  "
             f"slice: {spec.slice_ns} ns x {launches} launches",
             f"virtual duration: {t_s:.3f} s",
             f"total ops: {int(sresv.sum() + sprop.sum())} "
             f"(reservation {int(sresv.sum())}, "
             f"priority {int(sprop.sum())})"]
    last = sim.last_served.cpu().numpy().max(axis=0)  # [C]
    ci = 0
    for gi, g in enumerate(cfg.cli_group):
        sl = slice(ci, ci + g.client_count)
        ops = int(sresv[sl].sum() + sprop[sl].sum())
        finish_s = last[sl].max() / NS_PER_SEC
        rate = ops / finish_s / g.client_count if finish_s else 0.0
        lines.append(
            f"group {gi}: {g.client_count} clients  "
            f"r={g.client_reservation} w={g.client_weight} "
            f"l={g.client_limit} | ops {ops} "
            f"(res {int(sresv[sl].sum())} / prop {int(sprop[sl].sum())})"
            f" | done @ {finish_s:.2f}s | average {rate:.2f} ops/s")
        ci += g.client_count
    if completed is not None and total_ops is not None \
            and completed < total_ops:
        # partial runs must not read as converged QoS shares
        lines.append(f"INCOMPLETE: served {completed}/{total_ops} ops "
                     f"after {launches} launches (raise --max-launches)")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# the numpy bridge: a DeviceSim carried across frameworks
# ----------------------------------------------------------------------

def _tuple_from_numpy(cls, arrays, dtypes: dict, dev: torch.device,
                      what: str):
    _check_fields(arrays, cls._fields, what)
    return cls(**{f: _tensor_from_numpy(arrays[f], dtypes[f], dev,
                                        f"{what}.{f}")
                  for f in cls._fields})


def device_sim_from_numpy(arrays, device: str | torch.device =
                          DEFAULT_DEVICE) -> DeviceSim:
    """A ``DeviceSim`` from a nested mapping of numpy arrays:
    ``engine``, ``tracker`` and ``load`` each a mapping with one array
    per field (the JAX package's ``DeviceSim`` fetched field by field),
    and ``served_resv``, ``served_prop``, ``last_served``, ``t``,
    ``guard_trips`` arrays.  Raises ValueError on a missing or extra
    field or a dtype that differs from the JAX package's."""
    dev = resolve_device(device)
    _check_fields(arrays, DeviceSim._fields, "device sim")
    return DeviceSim(
        engine=_tuple_from_numpy(EngineState, arrays["engine"],
                                 FIELD_DTYPES, dev, "engine"),
        tracker=_tuple_from_numpy(TrackerState, arrays["tracker"],
                                  TRACKER_DTYPES, dev, "tracker"),
        load=_tuple_from_numpy(ClientLoad, arrays["load"], LOAD_DTYPES,
                               dev, "load"),
        **{f: _tensor_from_numpy(arrays[f], dt, dev, f)
           for f, dt in SIM_DTYPES.items()})


def device_sim_to_numpy(sim: DeviceSim) -> dict:
    """Every field of a ``DeviceSim`` as host numpy arrays in the nested
    layout :func:`device_sim_from_numpy` takes, dtypes kept."""
    out = {}
    for f, v in zip(sim._fields, sim):
        if isinstance(v, tuple):
            out[f] = {g: x.detach().cpu().numpy()
                      for g, x in zip(v._fields, v)}
        else:
            out[f] = v.detach().cpu().numpy()
    return out


# ----------------------------------------------------------------------
# the closed-loop headline (the JAX package's benchmark/run_sweeps.py
# device_sim_headline, :356-443)
# ----------------------------------------------------------------------

HEADLINE_CLIENTS = 100_000
HEADLINE_RING = 64
HEADLINE_Q = 4096        # serves per thread per slice (x2 threads)
HEADLINE_SLICES = 2      # slices a launch
HEADLINE_WARM = 1        # warm-up launches before the timed chains
HEADLINE_LO = 4          # launches of the short and the long timed chain
HEADLINE_HI = 10


def headline_config(n: int = HEADLINE_CLIENTS) -> SimConfig:
    """The headline's cluster: ``n`` clients in two halves of weight 1
    and 3 (reservation 2 ops/s, no limit, 80 ops/s goal, window 32,
    select range 8, random selection, hard limit), 8 servers at 500,000
    iops with 2 threads."""
    groups = [
        ClientGroup(client_count=n // 2, client_total_ops=10**9,
                    client_iops_goal=80.0, client_outstanding_ops=32,
                    client_reservation=2.0, client_limit=0.0,
                    client_weight=w, client_server_select_range=8)
        for w in (1.0, 3.0)]
    return SimConfig(client_groups=2, server_groups=1,
                     server_random_selection=True,
                     server_soft_limit=False, cli_group=groups,
                     srv_group=[ServerGroup(server_count=8,
                                            server_iops=500_000.0,
                                            server_threads=2)])


def headline_setup(n: int = HEADLINE_CLIENTS, *,
                   calendar_impl: Optional[str] = None,
                   device: str | torch.device = DEFAULT_DEVICE):
    """The headline's config, initial state and spec: a 64-slot ring,
    and the spec rebuilt at the throughput slice (``HEADLINE_Q`` serves
    per thread) through ``_make_spec``, so ``max_sends`` is re-derived
    for the longer slice (a stale one would clamp offered load below
    the goal).  ``calendar_impl`` front-loads the slices with calendar
    batches (exact: the decisions are the prefix run's)."""
    cfg = headline_config(n)
    sim, _ = init_device_sim(cfg, ring_capacity=HEADLINE_RING,
                             device=device)
    spec = _make_spec(cfg, q_per_slice=HEADLINE_Q)
    spec.calendar_impl = calendar_impl
    assert spec.q_per_slice >= 256
    assert not spec.force_scan
    return cfg, sim, spec


def device_sim_headline(n: int = HEADLINE_CLIENTS, *,
                        device: str | torch.device = DEFAULT_DEVICE,
                        lo: int = HEADLINE_LO,
                        hi: int = HEADLINE_HI) -> dict:
    """Closed-loop ops per wall second of the device sim:
    ``HEADLINE_WARM`` launches of ``HEADLINE_SLICES`` slices, then a
    chain of ``lo`` and one of ``hi`` launches, each synchronized; the
    rate is differenced over the two chains ((hi ops - lo ops) / (hi s -
    lo s)), which cancels a chain's fixed cost.  Also the weight 3:1
    served ratio and the virtual seconds, the slices' ms and the read
    backs per slice."""
    dev = resolve_device(device)
    _cfg, sim, spec = headline_setup(n, device=dev)
    counts = StepCounts()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def chain(launches, s):
        before = served_total(s)          # syncs the previous chain
        rb0 = counts.read_backs
        t0 = time.perf_counter()
        for _ in range(launches):
            s = device_sim_step(s, spec, HEADLINE_SLICES,
                                counts=counts)
            sync()
        secs = time.perf_counter() - t0
        return s, served_total(s) - before, secs, counts.read_backs - rb0

    sim, _, _, _ = chain(HEADLINE_WARM, sim)
    sim, d_lo, t_lo, _ = chain(lo, sim)
    sim, d_hi, t_hi, rb_hi = chain(hi, sim)
    check_guard_trips(sim)
    per_client = (sim.served_resv + sim.served_prop).sum(dim=0).cpu() \
        .numpy()
    g2 = per_client[n // 2:].sum() / max(per_client[:n // 2].sum(), 1)
    return {"ops_per_sec": (d_hi - d_lo) / (t_hi - t_lo),
            "total_ops": served_total(sim),
            "virtual_s": int(sim.t) / 1e9,
            "weight_ratio_3_1": float(g2),
            "ms_per_slice": t_hi * 1e3 / (hi * HEADLINE_SLICES),
            "read_backs_per_slice": rb_hi / (hi * HEADLINE_SLICES),
            "ops_per_slice": d_hi / (hi * HEADLINE_SLICES),
            "guard_trips": int(sim.guard_trips),
            "slices": counts.slices, "device": str(dev)}


def main(argv=None) -> int:
    import argparse
    from .config import parse_config_file

    p = argparse.ArgumentParser(
        prog="device_sim", description=__doc__.splitlines()[0])
    p.add_argument("-c", "--conf", required=True)
    p.add_argument("--ring-capacity", type=int, default=256)
    p.add_argument("--slices-per-launch", type=int, default=64)
    p.add_argument("--max-launches", type=int, default=200)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device of the sim state (default cuda)")
    args = p.parse_args(argv)
    cfg = parse_config_file(args.conf)
    counts = StepCounts()
    _sim, _spec, report = run_device_sim(
        cfg, ring_capacity=args.ring_capacity,
        slices_per_launch=args.slices_per_launch,
        max_launches=args.max_launches, device=args.device,
        counts=counts)
    print(report)
    print(f"# host loop: {counts.slices} slices, {counts.prefix_batches} "
          f"prefix and {counts.calendar_batches} calendar batches, "
          f"{counts.read_backs} read backs")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
