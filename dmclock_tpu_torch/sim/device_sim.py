"""Device-resident batch-synchronous QoS simulator.

Counterpart of ``dmclock_tpu/sim/device_sim.py``: the whole closed loop
-- client load generation, the delta/rho piggyback protocol, dmClock
scheduling and service completion -- lives on the card, with the
servers as a leading axis S of every ``[S, C]`` and ``[S, C, Q]``
tensor.  The host drives the slices; the program the entry points run
(:func:`jit_device_sim_step`) reads back one loop status a block of
serve batches, the op-by-op step one count a batch.

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
call over ``[S, C]``.  In :func:`device_sim_step` (the op-by-op body,
the reference) the JAX ``lax.while_loop`` over serve batches is a host
loop that reads each batch's count back.  :func:`jit_device_sim_step`
is the JAX ``jax.jit`` of the step: captured legs (the head's ingest,
a block of masked batches a server, the tail) that replay until one
read back of the loop state says every server left its loop.  The ring
window of each prefix batch and of each calendar batch is kernel K1 on
the card, and the wheel's scans kernel K2.

Across devices (:func:`shard_device_sim`, ``device_sim_step(mesh=)``,
``run_device_sim(devices=)``), the servers go in contiguous groups, one
stack a group on its device (``parallel.groups``), as the JAX package's
``shard_map`` over its ``servers`` mesh places them; the client load,
the clock and the guard-trip count are replicated, one copy a group.
Each slice takes the JAX step's three reductions between groups: the
tracker's counter sum, the guard trips and the completions, each an
exact int sum that hands every group the same value.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.qos import ClientInfo
from ..core.timebase import NS_PER_SEC
from ..device import (DEFAULT_DEVICE, parse_devices, resolve_device,
                      resolve_devices)
from ..engine import kernels
from ..engine.bridge import _check_fields, _tensor_from_numpy
from ..engine.fastpath import (_window_heads, calendar_batch,
                               calendar_batch_bucketed,
                               calendar_batch_wheel, ring_window,
                               speculate_prefix_batch)
from ..engine.state import FIELD_DTYPES, EngineState, init_state
from ..obs import compile_plane
from ..parallel import groups
from ..parallel.cluster import MeshLayout, make_mesh
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
    """What the host loop of :func:`device_sim_step` (or the program of
    :func:`jit_device_sim_step`) did, for the caller that passes one in:
    slices run, serve batches launched, the batches of a server still
    in its loop (``*_live``: the eager loop's batches; the program's
    blocks also launch masked ones), and the values read back from the
    card (the eager loop one count a batch, the program one status a
    block replay)."""

    slices: int = 0
    prefix_batches: int = 0
    calendar_batches: int = 0
    read_backs: int = 0
    prefix_live: int = 0
    calendar_live: int = 0


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


def _empty_decisions(shape, dev: torch.device) -> kernels.Decision:
    """The no-decision fill (type NONE, slot -1, zeros) of ``shape`` (an
    int or a tuple)."""
    shape = tuple(shape) if isinstance(shape, tuple) else (shape,)
    return kernels.Decision(
        type=torch.full(shape, kernels.NONE, dtype=torch.int32, device=dev),
        slot=torch.full(shape, -1, dtype=torch.int32, device=dev),
        phase=torch.zeros(shape, dtype=torch.int32, device=dev),
        cost=torch.zeros(shape, dtype=torch.int64, device=dev),
        when=torch.zeros(shape, dtype=torch.int64, device=dev),
        limit_break=torch.zeros(shape, dtype=torch.bool, device=dev))


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
        counts.calendar_live += 1
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
        counts.prefix_live += 1
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


# the fields a server group holds a block of; the rest are replicated
SERVER_FIELDS = ("engine", "tracker", "served_resv", "served_prop",
                 "last_served")


def shard_device_sim(sim: DeviceSim, mesh: MeshLayout) -> DeviceSim:
    """Lay a sim out on ``mesh`` (the JAX package's
    ``shard_device_sim``): the servers' leaves go by group, one stack a
    group on its device, and the replicated ``load``, ``t`` and
    ``guard_trips`` get one copy on every group's device.  A one-device
    mesh moves the sim to its device."""
    sim = gather_device_sim(sim)
    if groups.leading(sim.engine) != mesh.n_shards:
        raise ValueError(f"{groups.leading(sim.engine)} servers on a "
                         f"{mesh.n_shards}-shard mesh")
    devs = mesh.devices
    if len(devs) == 1:
        return groups.tree_map(lambda a: a.to(devs[0]), sim)
    return DeviceSim(**{
        f: groups.place(v, devs) if f in SERVER_FIELDS
        else groups.replicate(v, devs)
        for f, v in zip(sim._fields, sim)})


def gather_device_sim(sim: DeviceSim, device=None) -> DeviceSim:
    """A grouped sim as one stacked sim on ``device`` (default the first
    group's); the replicated leaves are every group's same value, so the
    first group's copy stands for them."""
    if not groups.is_grouped(sim.engine):
        return sim if device is None else groups.tree_map(
            lambda a: a.to(torch.device(device)), sim)
    dev = sim.engine.devices[0] if device is None else torch.device(device)
    return DeviceSim(**{
        f: groups.gather(v, dev) if f in SERVER_FIELDS
        else groups.tree_map(lambda a: a.to(dev), v[0])
        for f, v in zip(sim._fields, sim)})


def _serve_paths(spec: DeviceSimSpec) -> tuple:
    """``(use_prefix, use_cal)``: the budgeted batch loop, and its
    calendar front-load.  Opting into the calendar serve path implies
    the batch loop (it is exact at any q; the q >= 256 heuristic only
    picks the default).  AtLimit::Allow rides the prefix path too
    (limit-break candidates are a third unified class), PROVIDED every
    client has weight > 0: a ready weight-0 client switches the
    reference's Allow fallback to reservation order globally, which
    per-client classification cannot express (fastpath module
    docstring) -- that shape keeps the scan."""
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
    return use_prefix, use_cal


def _group_parts(sim: DeviceSim) -> list:
    """Every group's block of the stacks and its copy of the replicated
    leaves, one ``DeviceSim`` a group (a stacked sim is one group)."""
    if not groups.is_grouped(sim.engine):
        return [sim]
    return [DeviceSim(*(groups.pick(v, g) for v in sim))
            for g in range(len(sim.engine.devices))]


def device_sim_step(sim: DeviceSim, spec: DeviceSimSpec, slices: int, *,
                    counts: Optional[StepCounts] = None,
                    mesh: Optional[MeshLayout] = None) -> DeviceSim:
    """Advance ``slices`` time slices.  Pass a :class:`StepCounts` to
    have the host loop's batches and read backs counted into it.

    ``mesh`` lays the sim out first (:func:`shard_device_sim`); a sim
    already grouped keeps its layout.  On a grouped sim every group
    runs its own servers on its device, and the counter sum, the guard
    trips and the completions reduce between the groups each slice, as
    the JAX step's three ``psum``s do."""
    counts = counts if counts is not None else StepCounts()
    if mesh is not None and (mesh.grouped
                             or groups.is_grouped(sim.engine)):
        sim = shard_device_sim(sim, mesh)
    grouped = groups.is_grouped(sim.engine)
    s_total = spec.n_servers
    c = spec.n_clients
    # every group's block of the stacks, and its copy of the rest
    parts = _group_parts(sim)
    devs = sim.engine.devices if grouped else (sim.t.device,)
    per = s_total // len(parts)
    n_groups = len(devs)
    use_prefix, use_cal = _serve_paths(spec)

    # each group's server ids: the global ids of its block
    server_ids = [torch.arange(g * per, (g + 1) * per, dtype=torch.int32,
                               device=devs[g]) for g in range(n_groups)]
    engines = [[server_view(p.engine, j) for j in range(per)]
               for p in parts]
    tracker = [p.tracker for p in parts]
    load = [p.load for p in parts]
    sresv = [p.served_resv for p in parts]
    sprop = [p.served_prop for p in parts]
    slast = [p.last_served for p in parts]
    t = [p.t for p in parts]
    trips = [p.guard_trips for p in parts]
    for _ in range(slices):
        # the client-global counters: a sum over the server axis, within
        # each group and then between the groups
        if grouped:
            g_delta, g_rho = global_counters(
                groups.Grouped(tracker, devs))
        else:
            g_delta, g_rho = global_counters(tracker[0])
        n = [_slice_sends(load[g], t[g], spec.slice_ns, spec.max_sends)
             for g in range(n_groups)]

        # the ingest waves (max_sends is static and small): one request
        # per client per wave, slots distinct; the tracker once over a
        # group's [S, C], the engines server by server
        for wave in range(spec.max_sends):
            for g in range(n_groups):
                mine = _sends_to_server(load[g], n[g], wave,
                                        server_ids[g], s_total,
                                        spec.random_select)
                tracker[g], d_out, r_out = tracker_prepare(
                    tracker[g], mine, groups.pick(g_delta, g),
                    groups.pick(g_rho, g))
                rho = torch.where(mine, r_out, 1)
                delta = torch.where(mine, d_out, 1)
                engines[g] = [kernels.ingest_wave(
                    engines[g][j], mine[j], t[g], load[g].cost, rho[j],
                    delta[j], anticipation_ns=0) for j in range(per)]

        # serve q decisions per server at the slice boundary
        gts, dones = [], []
        for g in range(n_groups):
            t_end = t[g] + spec.slice_ns
            decs, cal_srv, cal_rsv = [], [], []
            gt_g = None
            for j in range(per):
                eng = engines[g][j]
                if use_prefix:
                    cal_total = 0
                    if use_cal:
                        eng, srv_c, rsv_c, cal_total = _calendar_front(
                            eng, t_end, spec, counts)
                        cal_srv.append(srv_c)
                        cal_rsv.append(rsv_c)
                    eng, d, gt = _prefix_serve(eng, t_end, spec,
                                               cal_total, counts)
                    gt_g = gt if gt_g is None else gt_g + gt
                else:
                    eng, _, d = kernels.engine_run(
                        eng, t_end, spec.q_per_slice,
                        allow_limit_break=spec.allow_limit_break,
                        anticipation_ns=0, advance_now=False)
                engines[g][j] = eng
                decs.append(d)
            gts.append(gt_g)
            decs = kernels.Decision(*(torch.stack(col)
                                      for col in zip(*decs)))
            served = decs.type == kernels.RETURNING

            tracker[g] = tracker_track(tracker[g], decs.slot, decs.cost,
                                       decs.phase, served)
            if use_cal:
                cal_srv = torch.stack(cal_srv)
                cal_rsv = torch.stack(cal_rsv)
                # calendar serves arrive as per-client totals; the
                # counts fold computes the same sums as the decision-
                # stream fold (per-client cost is constant here)
                tracker[g] = tracker_track_counts(tracker[g], cal_srv,
                                                  cal_rsv, load[g].cost)

            # stats + completion feedback (one [S, q] scatter-add per
            # phase)
            one = served.to(torch.int64)
            idx = torch.where(served, decs.slot, 0).to(torch.int64)
            sresv[g] = sresv[g].scatter_add(1, idx, one * (decs.phase == 0))
            sprop[g] = sprop[g].scatter_add(1, idx, one * (decs.phase == 1))
            slast[g] = slast[g].scatter_reduce(
                1, idx, torch.where(served, t_end, 0), "amax",
                include_self=True)
            done_here = torch.zeros((per, c), dtype=torch.int32,
                                    device=devs[g]).scatter_add(
                1, idx, one.to(torch.int32))
            if use_cal:
                sresv[g] = sresv[g] + cal_rsv.to(torch.int64)
                sprop[g] = sprop[g] + (cal_srv - cal_rsv).to(torch.int64)
                slast[g] = torch.maximum(
                    slast[g], torch.where(cal_srv > 0, t_end, 0))
                done_here = done_here + cal_srv
            dones.append(done_here.sum(dim=0))
        if use_prefix:
            trips = [(trips[g] + tg).to(torch.int32)
                     for g, tg in enumerate(groups.sum_parts(gts, devs))]
        completions = groups.sum_parts(dones, devs)

        for g in range(n_groups):
            load[g] = load[g]._replace(
                sent=(load[g].sent + n[g]).to(torch.int32),
                outstanding=(load[g].outstanding + n[g]
                             - completions[g]).to(torch.int32),
                next_send=load[g].next_send
                + n[g].to(torch.int64) * load[g].gap_ns,
            )
        t = [x + spec.slice_ns for x in t]
        counts.slices += 1
    out = [DeviceSim(engine=_restack(engines[g]), tracker=tracker[g],
                     load=load[g], served_resv=sresv[g],
                     served_prop=sprop[g], last_served=slast[g], t=t[g],
                     guard_trips=trips[g]) for g in range(n_groups)]
    return _join_parts(out, devs)


def check_guard_trips(sim: DeviceSim) -> None:
    """Raise if any prefix batch tripped a rebase guard.  The guards'
    only dynamic inputs (request cost, creation-order spread) are
    validated statically by init_device_sim, so a trip means that
    validation no longer covers the workload and committed counts are
    untrustworthy."""
    trips = int(groups.pick(sim.guard_trips, 0))
    if trips:
        raise RuntimeError(
            f"device_sim: {trips} prefix rebase-guard trip(s) -- "
            "init_device_sim's static validation no longer covers the "
            "workload (cost or creation-order spread past the int32 "
            "sort payload); committed counts are untrustworthy")


def served_total(sim: DeviceSim) -> int:
    """Completions so far over every server and client (one read back
    a group)."""
    if groups.is_grouped(sim.served_resv):
        return sum(int(a.sum() + b.sum()) for a, b in
                   zip(sim.served_resv.parts, sim.served_prop.parts))
    return int(sim.served_resv.sum() + sim.served_prop.sum())


# ----------------------------------------------------------------------
# the step as a captured program (the JAX package's jitted step)
# ----------------------------------------------------------------------

# prefix batches a server's captured block holds.  The headline takes
# about 3.4 prefix batches a server a slice: a block of 4 ends most
# slices' loops after one round, but its masked batches cost the card
# more than the extra read backs of smaller blocks do, and the headline
# runs fastest at one batch a block (PERF.md, the device sim's rows)
PREFIX_BLOCK = 1
# calendar batches a server's captured block holds: the headline's
# front-load ends after its first batch (which does not fit the slice
# budget), and one batch of the wheel's ladder is a large graph
CALENDAR_BLOCK = 1


def _write_back(dst, new, old) -> None:
    """Copy every field of the tuple ``new`` that is not ``old``'s own
    tensor into ``dst``'s (views of the stacked buffers), in place."""
    for d, n, o in zip(dst, new, old):
        if n is not o:
            d.copy_(n)


def _loop_state(parts: list, spec: DeviceSimSpec, use_cal: bool) -> list:
    """The program's loop state, one dict a group on its device (the
    JAX step's ``while_loop`` carries beside the engine): the slice's
    sends ``n``; per server the slice's budget used ``total``, the loop
    flag ``live``, the last batch's count ``last``, the guard trips
    ``gt``, the prefix decisions so far ``off``, the batches taken in
    the loop (calendar, prefix) ``taken``; the calendar's per-client
    counts ``srv``/``rsv``; and the decision buffer ``dbuf`` of ``q +
    1`` rows, the last one the dropped row of the JAX scatter."""
    out = []
    c, q = spec.n_clients, spec.q_per_slice
    for p in parts:
        dev, per = p.t.device, p.served_resv.shape[0]

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        st = dict(n=z(c), total=z(per), live=z(per, dtype=torch.bool),
                  last=z(per), gt=z(per), off=z(per), taken=z(per, 2),
                  dbuf=_empty_decisions((per, q + 1), dev))
        if use_cal:
            st.update(srv=z(per, c), rsv=z(per, c))
        out.append(st)
    return out


def _head_leg(p: DeviceSim, c: dict, glob, *, spec: DeviceSimSpec,
              g: int):
    """A slice's head for group ``g`` (``p`` its part of the sim, ``c``
    its loop state), one graph: the loop state reset, the sends and
    every ingest wave of the group's servers, written into its tensors
    in place.  ``glob`` is the sum of every server's completion counters
    ``int64[2, C]`` (delta, rho) on the group's device, taken between
    the legs; None takes the one group's own sum in the graph."""
    if glob is None:
        g_delta, g_rho = global_counters(p.tracker)
    else:
        # the protocol's counters start at 1
        g_delta, g_rho = glob[0] + 1, glob[1] + 1
    for k in ("total", "gt", "off", "taken", "srv", "rsv"):
        if k in c:
            c[k].zero_()
    c["last"].fill_(1)
    c["live"].fill_(True)
    for buf, fill in zip(c["dbuf"], (kernels.NONE, -1, 0, 0, 0, False)):
        buf.fill_(fill)
    per = p.served_resv.shape[0]
    n = _slice_sends(p.load, p.t, spec.slice_ns, spec.max_sends)
    c["n"].copy_(n)
    ids = torch.arange(g * per, (g + 1) * per, dtype=torch.int32,
                       device=p.t.device)
    base = [server_view(p.engine, j) for j in range(per)]
    engs = list(base)
    tracker = p.tracker
    for wave in range(spec.max_sends):
        mine = _sends_to_server(p.load, n, wave, ids, spec.n_servers,
                                spec.random_select)
        tracker, d_out, r_out = tracker_prepare(tracker, mine, g_delta,
                                                g_rho)
        rho = torch.where(mine, r_out, 1)
        delta = torch.where(mine, d_out, 1)
        engs = [kernels.ingest_wave(
            engs[j], mine[j], p.t, p.load.cost, rho[j], delta[j],
            anticipation_ns=0) for j in range(per)]
    for j in range(per):
        _write_back(base[j], engs[j], base[j])
    _write_back(p.tracker, tracker, p.tracker)
    return p, c


def _completions(p: DeviceSim) -> torch.Tensor:
    """The group's completion counters summed over its servers,
    ``int64[2, C]`` (delta, rho): its partial of the head's sum."""
    return torch.stack([p.tracker.completed_delta.sum(dim=0),
                        p.tracker.completed_rho.sum(dim=0)])


def _calendar_leg(p: DeviceSim, c: dict, *, spec: DeviceSimSpec, j: int,
                  block: int):
    """``block`` calendar batches of server ``j`` of a group, each
    taken where the JAX loop's ``ok`` holds (the server still in its
    loop, a nonzero count that fits the budget) and merged by
    ``torch.where``, as the JAX ``tree.map(where)`` is; the first batch
    that fails takes the server out of its loop.  Only the fields a
    batch returns as new tensors merge (the rings stay the sim's)."""
    q = spec.q_per_slice
    base = server_view(p.engine, j)
    eng = base
    steps = min(spec.calendar_steps, eng.ring_capacity)
    t_end = p.t + spec.slice_ns
    live, total = c["live"][j], c["total"][j]
    srv, rsv, taken = c["srv"][j], c["rsv"][j], c["taken"][j, 0]
    for _ in range(block):
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
        ok = live & (b.count > 0) & (total + b.count <= q)
        eng = EngineState(*(old if new is old else torch.where(ok, new, old)
                            for new, old in zip(b.state, eng)))
        srv = srv + torch.where(ok, b.served, 0)
        rsv = rsv + torch.where(ok, b.served_resv, 0)
        total = (total + torch.where(ok, b.count, 0)).to(torch.int32)
        taken = taken + live.to(torch.int32)
        live = ok
    _write_back(server_view(p.engine, j), eng, base)
    for dst, v in ((c["live"][j], live), (c["total"][j], total),
                   (c["srv"][j], srv), (c["rsv"][j], rsv),
                   (c["taken"][j, 0], taken)):
        dst.copy_(v)
    return p, c


def _prefix_leg(p: DeviceSim, c: dict, *, spec: DeviceSimSpec, j: int,
                block: int):
    """``block`` prefix batches of server ``j`` of a group.  A batch
    is active while the JAX loop's condition holds (``total < q`` and
    the last batch committed); an inactive one is capped at 0 decisions,
    which leaves the state bit for bit as it was.  Committed rows
    scatter into the decision buffer at the JAX ``pos`` (the rest into
    its dropped row ``q``); guard trips add up on the device."""
    q = spec.q_per_slice
    kb = min(q, spec.n_clients)
    base = server_view(p.engine, j)
    eng = base
    t_end = p.t + spec.slice_ns
    total, last, gt = c["total"][j], c["last"][j], c["gt"][j]
    off, taken = c["off"][j], c["taken"][j, 1]
    rows = [buf[j] for buf in c["dbuf"]]
    lane = torch.arange(kb, dtype=torch.int64, device=p.t.device)
    for _ in range(block):
        active = (total < q) & (last > 0)
        heads = _window_heads(eng, ring_window(eng, 1))
        batch = speculate_prefix_batch(
            eng, t_end, kb, anticipation_ns=0,
            max_count=torch.where(active, q - total, 0), heads=heads,
            allow_limit_break=spec.allow_limit_break,
            select_impl=spec.select_impl)
        gt = gt + (active & ~batch.guards_ok).to(torch.int32)
        pos = torch.where(lane < batch.count, off.to(torch.int64) + lane, q)
        for buf, vals in zip(rows, batch.decisions):
            buf.index_put_((pos,), vals)
        eng = batch.state
        total = (total + batch.count).to(torch.int32)
        off = (off + batch.count).to(torch.int32)
        last = torch.where(active, batch.count, last)
        taken = taken + active.to(torch.int32)
    _write_back(server_view(p.engine, j), eng, base)
    for dst, v in ((c["total"][j], total), (c["last"][j], last),
                   (c["gt"][j], gt), (c["off"][j], off),
                   (c["taken"][j, 1], taken),
                   (c["live"][j], (total < q) & (last > 0))):
        dst.copy_(v)
    return p, c


def _tail_fold(p: DeviceSim, c: dict, *, spec: DeviceSimSpec):
    """The first half of a slice's tail for one group: the tracker folds
    and the stats scatters, written into its tensors in place.  Returns
    ``(p, c, (trips, done))``: the group's guard trips and per-client
    completions, its partials of the slice's reductions between
    groups."""
    use_cal = _serve_paths(spec)[1]
    q = spec.q_per_slice
    per = p.served_resv.shape[0]
    t_end = p.t + spec.slice_ns
    decs = kernels.Decision(*(buf[:, :q] for buf in c["dbuf"]))
    served = decs.type == kernels.RETURNING
    tracker = tracker_track(p.tracker, decs.slot, decs.cost, decs.phase,
                            served)
    if use_cal:
        tracker = tracker_track_counts(tracker, c["srv"], c["rsv"],
                                       p.load.cost)
    _write_back(p.tracker, tracker, p.tracker)
    one = served.to(torch.int64)
    idx = torch.where(served, decs.slot, 0).to(torch.int64)
    sresv = p.served_resv.scatter_add(1, idx, one * (decs.phase == 0))
    sprop = p.served_prop.scatter_add(1, idx, one * (decs.phase == 1))
    slast = p.last_served.scatter_reduce(
        1, idx, torch.where(served, t_end, 0), "amax", include_self=True)
    done_here = torch.zeros((per, spec.n_clients), dtype=torch.int32,
                            device=p.t.device).scatter_add(
        1, idx, one.to(torch.int32))
    if use_cal:
        sresv = sresv + c["rsv"].to(torch.int64)
        sprop = sprop + (c["srv"] - c["rsv"]).to(torch.int64)
        slast = torch.maximum(slast, torch.where(c["srv"] > 0, t_end, 0))
        done_here = done_here + c["srv"]
    for dst, v in ((p.served_resv, sresv), (p.served_prop, sprop),
                   (p.last_served, slast)):
        dst.copy_(v)
    return p, c, (c["gt"].sum(), done_here.sum(dim=0))


def _tail_load(p: DeviceSim, c: dict, trips, completions, *,
               spec: DeviceSimSpec):
    """The second half of a slice's tail for one group, from the
    slice's guard trips and completions summed over every group: the
    trip count, the load update and the clock, in place."""
    n = c["n"]
    if _serve_paths(spec)[0]:
        p.guard_trips.copy_((p.guard_trips + trips).to(torch.int32))
    load = p.load
    load.outstanding.copy_((load.outstanding + n - completions)
                           .to(torch.int32))
    load.next_send.add_(n.to(torch.int64) * load.gap_ns)
    load.sent.add_(n)
    p.t.add_(spec.slice_ns)
    return p, c


def _tail_leg(p: DeviceSim, c: dict, *, spec: DeviceSimSpec):
    """A one-group slice's tail, one graph: :func:`_tail_fold` and
    :func:`_tail_load` on the group's own sums."""
    p, c, (trips, done) = _tail_fold(p, c, spec=spec)
    return _tail_load(p, c, trips, done, spec=spec)


def _distinct(sim: DeviceSim) -> DeviceSim:
    """``sim`` with no tensor in two places: a value the layout
    replicates onto one device is one tensor for every group, and the
    program's legs write each group's copy in place."""
    leaves, spec = pytree.tree_flatten(sim)
    seen: set = set()
    out = []
    for x in leaves:
        out.append(x.clone() if id(x) in seen else x)
        seen.add(id(x))
    return pytree.tree_unflatten(out, spec)


def _read_status(ctl: list, counts: StepCounts) -> list:
    """Every server's ``(live, total, taken calendar, taken prefix)``,
    in group order: one read back a device."""
    by_dev: dict = {}
    for g, c in enumerate(ctl):
        by_dev.setdefault(c["total"].device, []).append(g)
    rows: dict = {}
    for gs in by_dev.values():
        host = torch.cat([torch.stack(
            [ctl[g]["live"].to(torch.int32), ctl[g]["total"],
             ctl[g]["taken"][:, 0], ctl[g]["taken"][:, 1]], dim=1)
            for g in gs]).cpu()
        counts.read_backs += 1
        at = 0
        for g in gs:
            per = ctl[g]["total"].shape[0]
            rows[g] = host[at:at + per].tolist()
            at += per
    return [r for g in range(len(ctl)) for r in rows[g]]


def sim_devices(sim: DeviceSim) -> tuple:
    """A sim's layout: its groups' devices, or a stacked sim's one."""
    return tuple(sim.engine.devices) if groups.is_grouped(sim.engine) \
        else (sim.t.device,)


# the device-sim programs, by spec, slices, blocks and layout
_STEP_JIT_CACHE: dict = {}


def jit_device_sim_step(spec: DeviceSimSpec, slices: int, *, devices,
                        block: int = PREFIX_BLOCK,
                        cal_block: int = CALENDAR_BLOCK):
    """:func:`device_sim_step` of ``slices`` slices as a program, the
    counterpart of the JAX package's ``jax.jit(partial(device_sim_step,
    ...), donate_argnums=(0,))``: a ``compile_plane.StagedJit`` outside
    the plane's records (cache ``device_sim.step``), whose body runs a
    slice on the host around captured legs
    (``compile_plane.InstrumentedJit``, cache ``device_sim.leg``, that
    share one set of donated buffers): the head (counters, sends,
    ingest waves), per server a block of ``cal_block`` masked calendar
    batches and a block of ``block`` masked prefix batches, and the
    tail (tracker folds, stats, reductions, load, clock).  A block
    replays, for the servers still in their loop, until one read back
    of the loop state says none is: one read back a block replay, not
    one a batch.  The scan path's serve is ``kernels.serial_leg`` once
    a server, read back nothing.  Every field equals
    :func:`device_sim_step`'s.

    ``devices`` is the sim's layout (:func:`sim_devices`).  Every leg
    is one a group (``compile_plane.group_legs``), on the group's part
    of the sim: on a layout of several groups the head's counter sum,
    and the guard trips and completions between the tail's two halves
    (``_tail_fold``, ``_tail_load``), are summed between the legs, with
    no read back; the plan is read from the layout before any capture.
    The program donates the sim: its result is the legs' buffers (a first
    call copies the sim in once), and a chain that passes it back
    copies nothing; on the CPU the legs write into the sim passed in (a
    caller that keeps its sim passes a copy).  Returns ``call(sim, *,
    counts=None) -> sim`` with ``call.program`` the ``StagedJit`` and
    ``call.legs`` its legs; inside ``compile_plane.eager()`` it runs the
    same body with every leg op by op."""
    devices = tuple(torch.device(d) for d in devices)
    key = (tuple(vars(spec).items()), int(slices), int(block),
           int(cal_block), devices)
    if key in _STEP_JIT_CACHE:
        return _STEP_JIT_CACHE[key]
    if block < 1 or cal_block < 1:
        raise ValueError(f"blocks of {block} and {cal_block} batches")
    use_prefix, use_cal = _serve_paths(spec)
    n_groups = len(devices)
    per = groups.check_split(spec.n_servers, n_groups)
    entry = (spec.n_servers, spec.n_clients, spec.q_per_slice,
             spec.calendar_impl, int(slices), int(block), int(cal_block),
             tuple(str(d) for d in devices))
    grouped = n_groups > 1

    def legs(fn, name, **kw):
        return compile_plane.group_legs(
            lambda g: functools.partial(fn, spec=spec, **kw), devices,
            name=name, cache="device_sim.leg", entry=entry,
            donate_argnums=(0, 1))

    head = compile_plane.group_legs(
        lambda g: functools.partial(_head_leg, spec=spec, g=g), devices,
        name="head", cache="device_sim.leg", entry=entry,
        donate_argnums=(0, 1))
    if grouped:
        fold, load = legs(_tail_fold, "fold"), legs(_tail_load, "load")
        tails = fold + load
    else:
        tails = legs(_tail_leg, "tail")
    servers = [(g, j) for g in range(n_groups) for j in range(per)]
    cal = {s: leg for j in range(per) for s, leg in zip(
        [(g, j) for g in range(n_groups)],
        legs(_calendar_leg, f"calendar {j}", j=j, block=int(cal_block)))} \
        if use_cal else {}
    prefix = {s: leg for j in range(per) for s, leg in zip(
        [(g, j) for g in range(n_groups)],
        legs(_prefix_leg, f"prefix {j}", j=j, block=int(block)))} \
        if use_prefix else {}
    scan = None if use_prefix else kernels.serial_leg(
        spec.q_per_slice, allow_limit_break=spec.allow_limit_break,
        anticipation_ns=0)
    held: dict = {}         # the loop state, kept from call to call
    box: dict = {}

    def rounds(parts, ctl, legs, todo, size, counts, kind):
        """Replay each server's block of ``legs`` for the servers in
        ``todo`` until a read back says none is still in its loop."""
        rows = None
        while todo:
            for s in todo:
                g = s[0]
                parts[g], ctl[g] = legs[s](parts[g], ctl[g])
            setattr(counts, f"{kind}_batches",
                    getattr(counts, f"{kind}_batches") + size * len(todo))
            rows = _read_status(ctl, counts)
            todo = [s for s in todo if rows[s[0] * per + s[1]][0]]
        if rows is not None:
            col = 2 if kind == "calendar" else 3
            setattr(counts, f"{kind}_live", getattr(counts, f"{kind}_live")
                    + sum(r[col] for r in rows))
        return rows

    def serial_serve(parts, ctl):
        """The scan path: ``engine_run`` of ``q`` steps a server
        (``kernels.serial_leg``, captured blocks), written back."""
        q = spec.q_per_slice
        for g, p in enumerate(parts):
            with _on_device(devices[g]):
                for j in range(per):
                    base = server_view(p.engine, j)
                    eng, _, d = scan(base, p.t + spec.slice_ns)
                    _write_back(server_view(p.engine, j), eng, base)
                    for buf, v in zip(ctl[g]["dbuf"], d):
                        buf[j, :q].copy_(v)

    def body(sim: DeviceSim) -> DeviceSim:
        counts = box.get("counts") or StepCounts()
        parts = _group_parts(_distinct(sim))
        ctl = held.get("ctl")
        if ctl is None:
            ctl = _loop_state(parts, spec, use_cal)
        q = spec.q_per_slice
        for _ in range(slices):
            # the client-global counters: the sum over every server,
            # within each group and then between the groups
            glob = groups.sum_parts([_completions(p) for p in parts],
                                    devices) if grouped else [None]
            for g in range(n_groups):
                parts[g], ctl[g] = head[g](parts[g], ctl[g], glob[g])
            if use_prefix:
                todo = servers
                if use_cal:
                    rows = rounds(parts, ctl, cal, servers, int(cal_block),
                                  counts, "calendar")
                    todo = [s for s in servers
                            if rows[s[0] * per + s[1]][1] < q]
                rounds(parts, ctl, prefix, todo, int(block), counts,
                       "prefix")
            else:
                serial_serve(parts, ctl)
            if grouped:
                sums = []
                for g in range(n_groups):
                    parts[g], ctl[g], part = fold[g](parts[g], ctl[g])
                    sums.append(part)
                trips, done = (groups.sum_parts([x[i] for x in sums],
                                                devices) for i in range(2))
                for g in range(n_groups):
                    parts[g], ctl[g] = load[g](parts[g], ctl[g], trips[g],
                                               done[g])
            else:
                parts[0], ctl[0] = tails[0](parts[0], ctl[0])
            counts.slices += 1
        held["ctl"] = ctl
        return _join_parts(parts, devices)

    all_legs = head + tails + tuple(cal.values()) + tuple(prefix.values())
    program = compile_plane.StagedJit(body, cache="device_sim.step",
                                      entry=entry, record=False,
                                      legs=all_legs)

    def call(sim: DeviceSim, *, counts: Optional[StepCounts] = None):
        box["counts"] = counts
        try:
            return program(sim)
        finally:
            box.clear()

    call.program = program
    call.legs = [leg.program for leg in all_legs]
    _STEP_JIT_CACHE[key] = call
    return call


def _on_device(dev: torch.device):
    """``dev`` current where it is a card (its graphs replay on its
    stream), nothing on the CPU."""
    import contextlib

    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _join_parts(parts: list, devs) -> DeviceSim:
    """Per-group sims as one: the one group's, or the servers' leaves
    grouped and the rest one copy a group."""
    if len(parts) == 1:
        return parts[0]
    return DeviceSim(**{
        f: groups.Grouped([getattr(p, f) for p in parts], devs)
        if f in SERVER_FIELDS
        else groups.Replicated([getattr(p, f) for p in parts])
        for f in DeviceSim._fields})


def run_device_sim(cfg: SimConfig, *, ring_capacity: int = 256,
                   slices_per_launch: int = 64,
                   max_launches: int = 200,
                   check_guards: bool = True,
                   select_impl: str = "sort",
                   calendar_impl: Optional[str] = None,
                   calendar_steps: int = 8,
                   ladder_levels: int = 4,
                   device: str | torch.device = DEFAULT_DEVICE,
                   counts: Optional[StepCounts] = None,
                   mesh: Optional[MeshLayout] = None, devices=None):
    """Run to completion (all clients' ops served) or the launch cap.
    A "launch" is one call of the program of ``slices_per_launch``
    slices (:func:`jit_device_sim_step`, donated: each launch passes the
    last one's sim back); the served totals are read back after each
    (counted in ``counts.read_backs`` with the blocks' reads).

    ``check_guards`` (default on) raises after any launch whose prefix
    batches tripped a rebase guard -- the invariant init_device_sim
    validates statically, made CHECKED so future edits that weaken the
    validation surface instead of silently under-serving.

    ``calendar_impl`` (None|"minstop"|"bucketed"|"wheel") front-loads
    each slice with sortless calendar batches
    (DeviceSimSpec.calendar_impl) -- service stays exactly the q-step
    serial stream.

    ``devices`` spreads the servers over a layout of devices in
    contiguous groups (``parallel.groups``; a name may repeat), and
    falls back to one group on its first device when the server count
    does not divide, as the JAX package's ``run_device_sim`` does with
    its device mesh; ``mesh`` is such a layout already made (its shard
    count must be the server count).  Without either, one stack on
    ``device``.

    Returns (sim, spec, report_str)."""
    counts = counts if counts is not None else StepCounts()
    total = sum(g.server_count for g in cfg.srv_group)
    if mesh is None and devices is not None:
        devs = resolve_devices(devices)
        mesh = make_mesh(total, devices=devs if total % len(devs) == 0
                         else devs[:1])
    if mesh is not None:
        device = mesh.device
    sim, spec = init_device_sim(cfg, ring_capacity=ring_capacity,
                                select_impl=select_impl,
                                calendar_impl=calendar_impl,
                                calendar_steps=calendar_steps,
                                ladder_levels=ladder_levels,
                                device=device)
    if mesh is not None:
        sim = shard_device_sim(sim, mesh)
    total_ops = int(groups.pick(sim.load, 0).total_ops.sum())
    step = jit_device_sim_step(spec, slices_per_launch,
                               devices=sim_devices(sim))
    launches = 0
    completed = 0
    for launches in range(1, max_launches + 1):
        sim = step(sim, counts=counts)
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
    sim = gather_device_sim(sim)
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
    """Every field of a ``DeviceSim`` (stacked or grouped) as host numpy
    arrays in the nested layout :func:`device_sim_from_numpy` takes,
    dtypes kept."""
    sim = gather_device_sim(sim)
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
                        hi: int = HEADLINE_HI,
                        program: bool = True,
                        block: int = PREFIX_BLOCK) -> dict:
    """Closed-loop ops per wall second of the device sim:
    ``HEADLINE_WARM`` launches of ``HEADLINE_SLICES`` slices, then a
    chain of ``lo`` and one of ``hi`` launches, each synchronized; the
    rate is differenced over the two chains ((hi ops - lo ops) / (hi s -
    lo s)), which cancels a chain's fixed cost.  A launch is a call of
    the program (:func:`jit_device_sim_step` with ``block``, donated;
    its capture falls in the warm-up), or with ``program=False`` the
    op-by-op :func:`device_sim_step`.  Also the weight 3:1 served ratio
    and the virtual seconds, the slices' ms, the read backs per slice,
    and the long chain's prefix batches a slice, launched and live
    (``StepCounts``)."""
    dev = resolve_device(device)
    _cfg, sim, spec = headline_setup(n, device=dev)
    counts = StepCounts()
    step = jit_device_sim_step(spec, HEADLINE_SLICES,
                               devices=sim_devices(sim), block=block) \
        if program else functools.partial(device_sim_step, spec=spec,
                                          slices=HEADLINE_SLICES)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def chain(launches, s):
        before = served_total(s)          # syncs the previous chain
        c0 = dataclasses.replace(counts)
        t0 = time.perf_counter()
        for _ in range(launches):
            s = step(s, counts=counts)
            sync()
        secs = time.perf_counter() - t0
        return s, served_total(s) - before, secs, c0

    sim, _, _, _ = chain(HEADLINE_WARM, sim)
    sim, d_lo, t_lo, _ = chain(lo, sim)
    sim, d_hi, t_hi, c_hi = chain(hi, sim)
    slices_hi = hi * HEADLINE_SLICES
    check_guard_trips(sim)
    per_client = (sim.served_resv + sim.served_prop).sum(dim=0).cpu() \
        .numpy()
    g2 = per_client[n // 2:].sum() / max(per_client[:n // 2].sum(), 1)
    return {"ops_per_sec": (d_hi - d_lo) / (t_hi - t_lo),
            "total_ops": served_total(sim),
            "virtual_s": int(sim.t) / 1e9,
            "weight_ratio_3_1": float(g2),
            "ms_per_slice": t_hi * 1e3 / slices_hi,
            "read_backs_per_slice": (counts.read_backs - c_hi.read_backs)
            / slices_hi,
            "prefix_batches_per_slice":
                (counts.prefix_batches - c_hi.prefix_batches) / slices_hi,
            "prefix_live_per_slice":
                (counts.prefix_live - c_hi.prefix_live) / slices_hi,
            "ops_per_slice": d_hi / slices_hi,
            "guard_trips": int(sim.guard_trips),
            "slices": counts.slices, "counts": dataclasses.asdict(counts),
            "program": bool(program),
            "block": int(block) if program else None, "device": str(dev)}


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
    p.add_argument("--devices", default=None,
                   help="spread the servers over devices: a list "
                        "(cuda:0,cuda:1; a name may repeat) or a count "
                        "of cards (4 = the first four)")
    args = p.parse_args(argv)
    cfg = parse_config_file(args.conf)
    counts = StepCounts()
    _sim, _spec, report = run_device_sim(
        cfg, ring_capacity=args.ring_capacity,
        slices_per_launch=args.slices_per_launch,
        max_launches=args.max_launches, device=args.device,
        counts=counts, devices=None if args.devices is None
        else parse_devices(args.devices))
    print(report)
    print(f"# host loop: {counts.slices} slices, {counts.prefix_batches} "
          f"prefix and {counts.calendar_batches} calendar batches "
          f"({counts.prefix_live} and {counts.calendar_live} in a "
          f"server's loop), {counts.read_backs} read backs")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
