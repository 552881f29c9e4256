"""The multi-server dmClock cluster on one card.

Counterpart of ``dmclock_tpu/parallel/cluster.py``: every server's
scheduler state is one row of a stacked ``EngineState`` (a leading
server axis ``S`` on every field), its per-client completion counters
sit beside it in an ``[S, C]`` tracker, and one :func:`cluster_step`
advances every server by ``k`` serial-engine decisions.  The dmClock
wire protocol's global counters are the sum of the per-server counters
over the server axis (``parallel.tracker.server_sum``): the JAX
package's ``psum`` over its ``servers`` mesh axis.

Where the JAX step ``vmap``s over the servers of a ``shard_map``, the
port loops over ``s`` on contiguous views ``x[s]`` of the stacked
tensors and stacks the results.  The counter sum is taken at the top
of each round, before the loop over servers, so every server reads the
counters as they stood at the round's entry -- the values the JAX
package's ``psum`` reads.

:func:`make_mesh` returns a :class:`MeshLayout` (the shard count and
the devices of its groups), not a process group.  With one device the
stack lies whole on it; with D devices the shards go in D contiguous
blocks, each stacked on its own device (``parallel.groups``), and the
counter sum reduces within each group and then between the groups, as
the JAX package's ``shard_map`` over a ``servers`` mesh of devices
does.

The JAX package's jit caches keep their names, keys and records:
:func:`mesh_step_jit` (cache ``cluster.<step>``, the healthy and the
robust step) and :func:`jit_mesh_rounds` (``cluster.mesh_rounds``) are
``compile_plane.InstrumentedJit`` programs captured whole: each wave's
op batch is built on the device and ingested in one fixed-shape pass
(``kernels.ingest``), each server's serial leg is a
``kernels.serial_leg`` program whose block graph the step's graph holds
as a child node (one block capture serves every server: the views
``x[s]`` share their strides), and the tracker folds and the decisions
follow inside the graph, with no read back.  On a layout of several
groups (a repeated card included) each program runs one graph a group
a round (``compile_plane.StagedJit`` over ``compile_plane.group_legs``:
:func:`group_round`, :func:`round_leg`), with the round's counter sum
and the merges between the graphs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_devices
from ..engine import kernels
from ..engine.state import EngineState, init_state
from ..obs import compile_plane
from ..obs import device as obsdev
from . import groups
from .groups import Grouped, stack_trees, tree_map  # noqa: F401
from .tracker import (BorrowTrackerState,
                      borrow_tracker_prepare, borrow_tracker_track,
                      global_counters, init_borrow_tracker,
                      init_tracker, tracker_prepare, tracker_track)

SERVER_AXIS = "servers"


class MeshLayout(NamedTuple):
    """Where a cluster's shards live: ``n_shards`` servers in
    ``len(devices)`` contiguous groups, group ``g`` stacked on
    ``devices[g]``; ``device`` is ``devices[0]``."""

    n_shards: int
    device: torch.device
    devices: tuple

    @property
    def n_groups(self) -> int:
        return len(self.devices)

    @property
    def grouped(self) -> bool:
        """More than one group (a repeated device counts)."""
        return len(self.devices) > 1


class ClusterState(NamedTuple):
    """Stacked per-server state; every leaf's leading axis is servers."""

    engine: EngineState       # [S, ...] scheduler state per server
    tracker: object           # [S, C] TrackerState or BorrowTrackerState
    now: torch.Tensor         # int64[S] per-server virtual clock


def make_mesh(n_shards: int = 1,
              device: Optional[str | torch.device] = None,
              devices: Optional[Sequence] = None) -> MeshLayout:
    """The layout of an ``n_shards``-server cluster.

    ``devices`` lays the shards out in ``len(devices)`` contiguous
    groups, shard ``s`` on ``devices[s // (S // D)]``; ``S % D`` must be
    0 unless there is one device, which takes any ``n_shards``.  A
    device may repeat (several groups on one device).  ``device`` alone
    is the one-group layout on it.  With neither, every visible CUDA
    device by index (``cuda:0`` .. ``cuda:{D-1}``); that raises where
    there is no CUDA device."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got "
                         f"{n_shards}")
    if devices is None:
        devs = (resolve_device(device),) if device is not None \
            else resolve_devices(None)
    else:
        if device is not None:
            raise ValueError("make_mesh takes device= or devices=, not "
                             "both")
        devs = resolve_devices(devices)
    if len(devs) > 1:
        groups.check_split(n_shards, len(devs))
    return MeshLayout(n_shards, devs[0], devs)


# ----------------------------------------------------------------------
# stacked-tree helpers (NamedTuples of tensors, None leaves kept)
# ----------------------------------------------------------------------

def shard_view(tree, s: int):
    """Shard ``s`` of a stacked or grouped tree: leading-index views on
    the shard's device (contiguous for a contiguous stack)."""
    return groups.view(tree, s)


def place_shards(tree, mesh: MeshLayout):
    """A stacked ``[S, ...]`` tree laid out on ``mesh``: the stack on
    its one device, or one stack a group on each group's device."""
    return groups.place(tree, mesh.devices)


def gather_shards(tree, device=None):
    """A grouped tree back as one ``[S, ...]`` stack on ``device``
    (default the first group's device; ``"cpu"`` for the host)."""
    return groups.gather(tree, device)


def restack_shards(per_shard: list, mesh: MeshLayout):
    """Per-shard trees, each on its group's device, stacked by
    ``mesh``'s layout."""
    return groups.restack(per_shard, mesh.devices)


def broadcast_tree(tree, n: int):
    """Every leaf repeated ``n`` times on a new leading axis, as a
    contiguous copy (so each ``x[s]`` is contiguous)."""
    return tree_map(lambda a: a.unsqueeze(0).expand(
        (n,) + tuple(a.shape)).contiguous(), tree)


def decisions_to_numpy(decs) -> kernels.Decision:
    """A Decision of tensors (stacked or grouped) as a Decision of host
    numpy arrays."""
    return kernels.Decision(*(x.detach().cpu().numpy()
                              for x in groups.gather(decs, "cpu")))


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------

def init_cluster(n_servers: int, n_clients: int, ring_capacity: int = 64,
                 tracker_kind: str = "orig", *,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> ClusterState:
    """``n_clients`` slots per server (slot i is client i cluster-wide,
    which is what lets the completion counters sum by position).
    ``tracker_kind``: "orig" or "borrowing" (the reference's two
    accounting policies)."""
    dev = resolve_device(device)
    inits = {"orig": init_tracker, "borrowing": init_borrow_tracker}
    if tracker_kind not in inits:
        raise ValueError(f"unknown tracker_kind {tracker_kind!r}")
    engine = broadcast_tree(init_state(n_clients, ring_capacity,
                                       device=dev), n_servers)
    tracker = inits[tracker_kind](n_clients, n_servers=n_servers,
                                  device=dev)
    return ClusterState(engine=engine, tracker=tracker,
                        now=torch.zeros((n_servers,), dtype=torch.int64,
                                        device=dev))


def shard_cluster(cluster: ClusterState, mesh: MeshLayout) -> ClusterState:
    """Lay every leaf out on the mesh: the leading server axis split
    over its groups (the JAX package's ``NamedSharding(mesh,
    P(SERVER_AXIS))``), or the whole stack on its one device.  Returns
    a ClusterState whose leaves are grouped on a multi-group mesh."""
    if groups.leading(cluster.now) != mesh.n_shards:
        raise ValueError(f"{groups.leading(cluster.now)} servers on a "
                         f"{mesh.n_shards}-shard mesh")
    return ClusterState(*(place_shards(x, mesh) for x in cluster))


def device_tensor(x, dtype, dev) -> torch.Tensor:
    """``x`` (a tensor or array-like) as a ``dtype`` tensor on ``dev``."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)


def install_clients(cluster: ClusterState, resv_inv, weight_inv,
                    limit_inv, active_mask=None) -> ClusterState:
    """Register the same client population on every server (QoS
    inverses are ``[C]`` int64).  Creation order = client index, the
    cross-backend tie-break.  ``active_mask`` bool ``[C]`` restricts the
    initial population (the rest join later through
    :func:`create_clients`); default: all C slots.  A grouped cluster
    keeps its layout."""
    devs = groups.group_devices(cluster.now)
    cluster = gather_shards(cluster)
    dev = cluster.now.device
    n_servers = cluster.now.shape[0]
    c = int(np.shape(resv_inv)[0])
    if active_mask is None:
        active_mask = np.ones((c,), dtype=bool)

    def bcast(a, dtype):
        return device_tensor(a, dtype, dev).unsqueeze(0) \
            .expand(n_servers, c).contiguous()

    eng = cluster.engine._replace(
        active=bcast(active_mask, torch.bool),
        order=bcast(np.arange(c, dtype=np.int64), torch.int64),
        resv_inv=bcast(resv_inv, torch.int64),
        weight_inv=bcast(weight_inv, torch.int64),
        limit_inv=bcast(limit_inv, torch.int64))
    return place_fields(cluster._replace(engine=eng), devs)


def place_fields(cluster, devs):
    """Every field of a stacked ClusterState-like container (a
    RobustClusterState too) laid out over ``devs``, each its own grouped
    tree; unchanged on one device."""
    if len(devs) == 1:
        return cluster
    return type(cluster)(*(place_fields(x, devs)
                           if isinstance(x, ClusterState)
                           else groups.place(x, devs) for x in cluster))


def on_mesh(tree, mesh: MeshLayout):
    """``tree`` in ``mesh``'s layout: placed when either is grouped (a
    ClusterState field by field), as it is otherwise (the one-device
    path moves nothing)."""
    if tree is None:
        return None
    if mesh.grouped and isinstance(tree, ClusterState):
        return place_fields(tree, mesh.devices)
    if mesh.grouped or isinstance(groups.first_node(tree), Grouped):
        return groups.place(tree, mesh.devices)
    return tree


def shard_inputs(x, dtype, mesh: MeshLayout):
    """A host or device ``[S, ...]`` input as a ``dtype`` stack laid out
    on ``mesh`` (each shard's rows on its group's device)."""
    return on_mesh(device_tensor(x, dtype, mesh.device), mesh)


# ----------------------------------------------------------------------
# one server's round, and the cluster step
# ----------------------------------------------------------------------

def server_round(engine: EngineState, tracker, now, arrivals_per_client,
                 cost, g_delta, g_rho, *, decisions_per_step: int,
                 anticipation_ns: int, allow_limit_break: bool,
                 max_arrivals: int, with_metrics: bool = False):
    """One server's round against a caller-supplied view of the global
    counters (``g_delta``/``g_rho``, ``[C]`` int64): the fresh sum in a
    healthy step, a possibly stale held view under faults
    (``robust.cluster``) -- the protocol tolerates stale counters.

    Phase A: client c sends ``min(arrivals_per_client[c],
    max_arrivals)`` requests, each carrying view-derived ReqParams;
    arrivals interleave wave-major (every client's j-th request before
    any client's j+1-th, clients in slot order within a wave), each
    wave one ``kernels.ingest`` batch.
    Phase B: the serial engine makes ``decisions_per_step`` decisions
    with the clock jumping over FUTUREs (``kernels.serial_leg``).
    Phase C: completions fold into the tracker counters.

    ``engine`` and ``tracker`` are one server's (``[C]`` leaves),
    ``now`` its 0-d clock.  Returns ``(engine, tracker, now, decs)``
    (and the metrics vector with ``with_metrics``)."""
    borrowing = isinstance(tracker, BorrowTrackerState)
    prepare = borrow_tracker_prepare if borrowing else tracker_prepare
    c = arrivals_per_client.shape[0]
    dev = now.device
    slots = torch.arange(c, dtype=torch.int64, device=dev)
    zeros = torch.zeros((c,), dtype=torch.int64, device=dev)
    cost_c = torch.broadcast_to(cost, (c,)).to(torch.int64)
    for wave in range(max_arrivals):
        requesting = arrivals_per_client > wave
        # later waves re-mark an unchanged global counter: (0, 0) for
        # Orig, floored at (1, 1) for Borrowing
        tracker, delta_out, rho_out = prepare(tracker, requesting,
                                              g_delta, g_rho)
        # the wave's [10, C] op batch, built on the device (no CREATE)
        ops = torch.stack([
            torch.where(requesting, kernels.OP_ADD, kernels.OP_NOP),
            slots, now.expand(c), cost_c,
            torch.where(requesting, rho_out, 1),
            torch.where(requesting, delta_out, 1), zeros, zeros, zeros,
            zeros])
        engine = kernels.ingest(engine, ops, anticipation_ns=anticipation_ns)
    out = kernels.serial_leg(
        decisions_per_step, allow_limit_break=allow_limit_break,
        anticipation_ns=anticipation_ns, advance_now=True,
        with_metrics=with_metrics)(engine, now)
    engine, now, decs = out[:3]
    served = decs.type == kernels.RETURNING
    track = borrow_tracker_track if borrowing else tracker_track
    tracker = track(tracker, decs.slot, decs.cost, decs.phase, served)
    if with_metrics:
        return engine, tracker, now, decs, out[3]
    return engine, tracker, now, decs


def group_round(engine: EngineState, tracker, now, arrivals, cost,
                g_d, g_r, *, decisions_per_step: int, max_arrivals: int,
                anticipation_ns: int, allow_limit_break: bool,
                advance_ns: int, with_metrics: bool = False,
                with_pressure: bool = False) -> tuple:
    """One group's servers' rounds (stacked ``[per, ...]`` trees on the
    group's device, ``g_d``/``g_r`` its copy of the round's counter
    sum): every server's :func:`server_round` from its clock moved by
    ``advance_ns``, stacked again.  Returns ``(engine, tracker, now,
    decs)``, then the per-server metrics with ``with_metrics`` and the
    post-round pressure vectors with ``with_pressure``: a grouped
    program's leg."""
    now0 = now + int(advance_ns)
    outs = [server_round(
        shard_view(engine, j), shard_view(tracker, j), now0[j],
        arrivals[j], cost, g_d, g_r, decisions_per_step=decisions_per_step,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, max_arrivals=max_arrivals,
        with_metrics=with_metrics) for j in range(groups.leading(now))]
    res = tuple(stack_trees([o[i] for o in outs])
                for i in range(5 if with_metrics else 4))
    if with_pressure:
        res = res + (group_pressure(res[0], res[2]),)
    return res


def join_groups(parts: list, mesh: MeshLayout):
    """Per-group results, stacked by ``mesh``'s layout: the one group's
    own, or a :class:`Grouped` of them."""
    if parts[0] is None:
        return None
    return parts[0] if len(parts) == 1 else Grouped(parts, mesh.devices)


def cluster_step(cluster: ClusterState, arrivals, cost,
                 mesh: MeshLayout, *, decisions_per_step: int,
                 max_arrivals: int = 1, anticipation_ns: int = 0,
                 allow_limit_break: bool = False, advance_ns: int = 0,
                 with_metrics: bool = False, with_pressure: bool = False):
    """Advance the whole cluster one round.  ``arrivals`` is int32
    ``[S, C]`` request counts (honored up to ``max_arrivals`` per client
    per round, wave-major); ``cost`` a scalar or an int64 ``[C]``
    per-client cost vector.  ``advance_ns`` moves every server's clock
    forward at round start.  Returns ``(cluster, decisions)`` with
    ``[S, k]`` decision leaves.

    ``with_metrics`` adds ``(per_shard int64[S, NUM_METRICS], merged
    int64[NUM_METRICS])``: each server's metrics vector from its run
    and the cluster total (``obs.device.metrics_mesh_reduce``).
    ``with_pressure`` adds ``(per_shard int64[S, PRESS_FIELDS],
    merged)``: each server's post-round pressure vector and the cluster
    total (``obs.provenance.pressure_mesh_reduce``).  Decisions are the
    same with either flag on or off.

    The round's counter sum is taken before any server runs (the
    psum); then each group runs its servers (:func:`group_round`), and
    the merges cross the groups."""
    body = functools.partial(
        group_round, decisions_per_step=decisions_per_step,
        max_arrivals=max_arrivals, anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, advance_ns=advance_ns,
        with_metrics=with_metrics, with_pressure=with_pressure)
    return _cluster_step_over(cluster, arrivals, cost, mesh,
                              legs=[body] * len(mesh.devices),
                              with_metrics=with_metrics,
                              with_pressure=with_pressure)


def _cluster_step_over(cluster: ClusterState, arrivals, cost,
                       mesh: MeshLayout, *, legs, with_metrics: bool = False,
                       with_pressure: bool = False):
    """:func:`cluster_step` with ``legs[g]`` running group ``g``'s
    servers: :func:`group_round` bound to the step's settings and flags,
    or a grouped program's captured leg (:func:`mesh_step_jit`, no
    flags)."""
    from ..obs import provenance as obsprov

    n = groups.leading(cluster.now)
    if n != mesh.n_shards:
        raise ValueError(f"{n} servers on a {mesh.n_shards}-shard mesh")
    devs = mesh.devices
    cluster = on_mesh(cluster, mesh)
    cost = groups.replicate(device_tensor(cost, torch.int64, devs[0]),
                            devs)
    arrivals = shard_inputs(arrivals, torch.int32, mesh)
    # the round's counter sum, before any server runs (the psum)
    g_d, g_r = global_counters(cluster.tracker)
    outs = [leg(*(groups.pick(x, g) for x in (
        cluster.engine, cluster.tracker, cluster.now, arrivals, cost, g_d,
        g_r))) for g, leg in enumerate(legs)]
    res = tuple(join_groups([o[i] for o in outs], mesh)
                for i in range(len(outs[0])))
    engine, tracker, now, decs = res[:4]
    out = (ClusterState(engine=engine, tracker=tracker, now=now), decs)
    rest = list(res[4:])
    if with_metrics:
        met = rest.pop(0)
        out = out + (met, obsdev.metrics_mesh_reduce(met))
    if with_pressure:
        press = rest.pop(0)
        out = out + (press, obsprov.pressure_mesh_reduce(press))
    return out


def run_cluster_rounds(cluster: ClusterState, arrivals_seq, cost,
                       mesh: MeshLayout, *, decisions_per_step: int,
                       max_arrivals: int = 1, anticipation_ns: int = 0,
                       allow_limit_break: bool = False,
                       advance_ns: int = 0, tracer=None):
    """Drive ``arrivals_seq.shape[0]`` healthy cluster steps from the
    host.  ``tracer`` (``obs.spans.SpanTracer`` or None) records one
    ``cluster.round`` dispatch span per step and a ``cluster.fetch``
    span per decision read back.  Returns ``(cluster, decs_seq)`` with
    each step's decisions as host numpy."""
    from ..obs import spans as _spans

    step = mesh_step_jit(_ROUNDS_JIT_CACHE, cluster_step, mesh,
                         (decisions_per_step, max_arrivals,
                          anticipation_ns, allow_limit_break, advance_ns))
    arrivals_seq = program_input(arrivals_seq, mesh)
    cost = program_input(cost, mesh)
    n_servers = groups.leading(cluster.now)
    decs_seq = []
    for t in range(arrivals_seq.shape[0]):
        with _spans.span(tracer, "cluster.round", "dispatch",
                         step=t, servers=n_servers):
            cluster, decs = step(cluster, arrivals_seq[t], cost)
        with _spans.span(tracer, "cluster.fetch", "fetch", step=t):
            decs_seq.append(decisions_to_numpy(decs))
    return cluster, decs_seq


# ----------------------------------------------------------------------
# fused multi-round launches with a batched delta/rho exchange
# ----------------------------------------------------------------------

class MeshRounds(NamedTuple):
    """One fused launch's outputs (:func:`run_mesh_rounds`).  ``decs``
    leaves are ``[S, E, k]``; :func:`mesh_decs_seq` re-slices them per
    round.  ``metrics`` is the per-shard ``int64[S, NUM_METRICS]``
    vector over all E rounds, with the robust path's accounting."""

    cluster: ClusterState
    view_delta: torch.Tensor  # int64[S, C] held counter views
    view_rho: torch.Tensor    # int64[S, C]
    metrics: torch.Tensor     # int64[S, NUM_METRICS]
    decs: object              # kernels.Decision, [S, E, k] leaves
    merged: object = None     # int64[NUM_METRICS] (with_merged)
    pressure: object = None   # int64[S, PRESS_FIELDS] (with_pressure)
    pressure_merged: object = None


def round_sync_mask(epochs: int, counter_sync_every: int,
                    round0: int = 0) -> np.ndarray:
    """The global counter-sync grid over one launch's rounds: round
    ``round0 + t`` syncs iff it lies on the ``counter_sync_every``
    grid."""
    every = max(int(counter_sync_every), 1)
    return (int(round0) + np.arange(int(epochs))) % every == 0


def init_mesh_views(n_servers: int, n_clients: int, *,
                    device: str | torch.device = DEFAULT_DEVICE):
    """Held counter views at the protocol origin (counters start at 1,
    ``dmclock_client.h:191-198``)."""
    dev = resolve_device(device)
    return (torch.ones((n_servers, n_clients), dtype=torch.int64,
                       device=dev),
            torch.ones((n_servers, n_clients), dtype=torch.int64,
                       device=dev))


def round_metrics(met, engine: EngineState, decs, **fault_rows):
    """Fold one round's decisions into a server's metrics vector with
    the degraded path's accounting: served decisions by phase, limit
    breaks, the ring high-water mark, and any fault rows."""
    served = decs.type == kernels.RETURNING
    n_served = torch.sum(served, dtype=torch.int64)
    n_resv = torch.sum(served & (decs.phase == 0), dtype=torch.int64)
    return obsdev.metrics_combine(met, obsdev.metrics_delta(
        device=met.device, decisions=n_served, resv=n_resv,
        prop=n_served - n_resv,
        limit_break=torch.sum(decs.limit_break, dtype=torch.int64),
        ring_hwm=torch.max(engine.depth).to(torch.int64), **fault_rows))


def _synced(sync, fresh, held):
    """The view a round serves from: ``fresh`` on a sync round; ``sync``
    a Python bool, or a 0-d bool tensor in a captured leg."""
    if torch.is_tensor(sync):
        return torch.where(sync, fresh, held)
    return fresh if sync else held


def round_leg(carry, arrivals, cost, glob, sync, *, decisions_per_step: int,
              max_arrivals: int, anticipation_ns: int,
              allow_limit_break: bool, advance_ns: int):
    """One round of one group's servers in a :func:`run_mesh_rounds`
    launch: ``carry`` a list, one ``(engine, tracker, now, view_d,
    view_r, metrics)`` a server; ``arrivals`` the group's ``[per, C]``;
    ``glob`` the sum of every server's completions ``int64[2, C]``
    (delta, rho) at the round's entry, on the group's device; ``sync``
    whether the round refreshes the held views.  Returns ``(carry,
    decs, part)``: the round's decision fields stacked ``[per, k]`` (a
    plain tuple) and the group's completion partial ``int64[2, C]``
    after the round.  A grouped program's leg."""
    # the protocol's counters start at 1
    g_d, g_r = glob[0] + 1, glob[1] + 1
    out, decs = [], []
    for j, (eng, trk, now, vd, vr, met) in enumerate(carry):
        vd, vr = _synced(sync, g_d, vd), _synced(sync, g_r, vr)
        eng, trk, now, d = server_round(
            eng, trk, now + int(advance_ns), arrivals[j], cost, vd, vr,
            decisions_per_step=decisions_per_step,
            anticipation_ns=anticipation_ns,
            allow_limit_break=allow_limit_break, max_arrivals=max_arrivals)
        out.append((eng, trk, now, vd, vr, round_metrics(met, eng, d)))
        decs.append(d)
    return out, tuple(stack_trees(decs)), _completions(
        [c[1] for c in out])


def _completions(trackers: list) -> torch.Tensor:
    """The summed completion counters ``int64[2, C]`` (delta, rho) of a
    group's per-server trackers."""
    return torch.stack([
        torch.stack([t.completed_delta for t in trackers]).sum(dim=0),
        torch.stack([t.completed_rho for t in trackers]).sum(dim=0)])


def group_pressure(engine: EngineState, now) -> torch.Tensor:
    """The pressure vectors ``int64[per, PRESS_FIELDS]`` of one group's
    servers (stacked ``engine`` and ``now``)."""
    from ..obs import provenance as obsprov

    return torch.stack([obsprov.pressure_vec(shard_view(engine, j), now[j])
                        for j in range(groups.leading(now))])


def run_mesh_rounds(cluster: ClusterState, arrivals_seq, cost,
                    mesh: MeshLayout, *, decisions_per_step: int,
                    max_arrivals: int = 1, anticipation_ns: int = 0,
                    allow_limit_break: bool = False,
                    advance_ns: int = 0, counter_sync_every: int = 1,
                    round0: int = 0, view_delta=None, view_rho=None,
                    metrics=None, with_merged: bool = False,
                    with_pressure: bool = False) -> MeshRounds:
    """``E = arrivals_seq.shape[0]`` whole rounds of every server in
    one call, with the ``[C]``-sized delta/rho counter sum exchanged
    once per round boundary and the held views refreshed only on
    rounds where ``(round0 + t) % counter_sync_every == 0``; between
    syncs every server serves from its held view (the stale-counter
    tolerance ``robust.cluster`` injects as ``delay_counters``).

    ``arrivals_seq`` is int32 ``[E, S, C]`` in round order.  At K=1 the
    launch equals ``E`` host-driven ``robust_cluster_step``s under a
    zero-fault plan, decision for decision and view for view.
    ``view_delta``/``view_rho``/``metrics`` resume held state across
    launches (None = the protocol origin / zeros) and ``round0``
    anchors this launch on the global round grid.  ``with_merged``
    adds the merged metrics vector; ``with_pressure`` the post-run
    per-shard pressure vectors and their merged total.

    Rounds are the outer loop: the counter sum of round t is taken from
    every server's counters at the round's entry, within each group and
    then between the groups; then each group runs its servers' round
    (:func:`round_leg`)."""
    body = functools.partial(
        round_leg, decisions_per_step=decisions_per_step,
        max_arrivals=max_arrivals, anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, advance_ns=advance_ns)
    return _mesh_rounds_over(
        cluster, arrivals_seq, cost, mesh, legs=[body] * len(mesh.devices),
        pressure_legs=[group_pressure] * len(mesh.devices),
        counter_sync_every=counter_sync_every, round0=round0,
        view_delta=view_delta, view_rho=view_rho, metrics=metrics,
        with_merged=with_merged, with_pressure=with_pressure)


def _mesh_rounds_over(cluster: ClusterState, arrivals_seq, cost,
                      mesh: MeshLayout, *, legs, pressure_legs,
                      counter_sync_every: int, round0: int, view_delta,
                      view_rho, metrics, with_merged: bool,
                      with_pressure: bool) -> MeshRounds:
    """:func:`run_mesh_rounds` with ``legs[g]`` running group ``g``'s
    round (:func:`round_leg` bound to the settings, or a grouped
    program's captured leg) and ``pressure_legs[g]`` its
    :func:`group_pressure`."""
    from ..obs import provenance as obsprov

    devs = mesh.devices
    dev = devs[0]
    arrivals_seq = device_tensor(arrivals_seq, torch.int32, dev)
    epochs = int(arrivals_seq.shape[0])
    n_servers = groups.leading(cluster.now)
    n_clients = arrivals_seq.shape[2]
    per = groups.check_split(n_servers, len(devs))
    # [S, E, C]: each shard's rounds on its group's device
    arrivals_s = on_mesh(arrivals_seq.transpose(0, 1), mesh)
    cost = groups.replicate(device_tensor(cost, torch.int64, dev), devs)
    sync_mask = round_sync_mask(epochs, counter_sync_every, round0)
    if view_delta is None or view_rho is None:
        view_delta, view_rho = init_mesh_views(n_servers, n_clients,
                                               device=dev)
    if metrics is None:
        metrics = torch.zeros((n_servers, obsdev.NUM_METRICS),
                              dtype=torch.int64, device=dev)
    cluster, view_delta, view_rho, metrics = (
        on_mesh(x, mesh) for x in (cluster, view_delta, view_rho, metrics))
    carries, parts = [], []
    for g in range(len(devs)):
        mine = [groups.pick(x, g) for x in (
            cluster.engine, cluster.tracker, cluster.now, view_delta,
            view_rho, metrics)]
        carries.append([tuple(groups.view(x, j) for x in mine)
                        for j in range(per)])
        parts.append(torch.stack([mine[1].completed_delta.sum(dim=0),
                                  mine[1].completed_rho.sum(dim=0)]))
    decs = [[] for _ in devs]
    for t in range(epochs):
        glob = groups.sum_parts(parts, devs)
        for g, leg in enumerate(legs):
            carries[g], d, parts[g] = leg(
                carries[g], groups.pick(arrivals_s, g)[:, t],
                groups.pick(cost, g), glob[g], bool(sync_mask[t]))
            decs[g].append(d)
    eng, trk, now, vd, vr, met_s = (
        join_groups([stack_trees([c[i] for c in carry])
                     for carry in carries], mesh) for i in range(6))
    res = MeshRounds(
        cluster=ClusterState(engine=eng, tracker=trk, now=now),
        view_delta=vd, view_rho=vr, metrics=met_s,
        decs=join_groups([kernels.Decision(*(
            torch.stack(col, dim=1) for col in zip(*ds))) for ds in decs],
            mesh))
    if with_merged:
        res = res._replace(merged=obsdev.metrics_mesh_reduce(met_s))
    if with_pressure:
        press = join_groups([pressure_legs[g](groups.pick(eng, g),
                                              groups.pick(now, g))
                             for g in range(len(devs))], mesh)
        res = res._replace(pressure=press,
                           pressure_merged=obsprov.pressure_mesh_reduce(
                               press))
    return res


def mesh_decs_seq(decs) -> list:
    """Re-slice a fused launch's ``[S, E, k]`` decision leaves (stacked
    or grouped) into the per-round ``[S, k]`` stream of host numpy the
    host loops produce (``robust.cluster.run_with_plan``)."""
    host = decisions_to_numpy(decs)
    epochs = host.type.shape[1]
    return [kernels.Decision(*(a[:, t] for a in host))
            for t in range(epochs)]


def create_clients(cluster: ClusterState, new_mask, resv_inv, weight_inv,
                   limit_inv, mesh: MeshLayout) -> ClusterState:
    """Mid-run client creation on every server: an OP_CREATE ingest of
    the ``new_mask`` slots (bool ``[C]``; the QoS inverses are ``[C]``,
    read only where masked), creation order = slot index.  New clients
    join every server; their tracker counters start fresh."""
    def host(x, dtype):
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        return np.asarray(x).astype(dtype)

    mask = host(new_mask, bool)
    c = mask.shape[0]
    slots = np.arange(c, dtype=np.int64)
    ones = np.ones((c,), dtype=np.int64)
    ops = kernels.IngestOps(
        kind=np.where(mask, kernels.OP_CREATE, kernels.OP_NOP),
        slot=slots, time=np.zeros((c,), dtype=np.int64), cost=ones,
        rho=ones, delta=ones, resv_inv=host(resv_inv, np.int64),
        weight_inv=host(weight_inv, np.int64),
        limit_inv=host(limit_inv, np.int64), order=slots)
    engine = restack_shards([
        kernels.ingest(shard_view(cluster.engine, s), ops,
                       anticipation_ns=0)
        for s in range(mesh.n_shards)], mesh)
    return cluster._replace(engine=engine)


# ----------------------------------------------------------------------
# the JAX package's mesh-program caches, by name
# ----------------------------------------------------------------------

_ROUNDS_JIT_CACHE: dict = {}
_MESH_ROUNDS_JIT_CACHE: dict = {}
# the cluster step outside the plane's records (the dry run and the
# full-scale check, as their bare ``jax.jit`` in JAX)
_BARE_STEP_JIT_CACHE: dict = {}


def mesh_shape(mesh: MeshLayout) -> tuple:
    """The JAX key's mesh shape of a layout: JAX places one shard a
    device, so its mesh of ``S`` shards is ``(S,)``."""
    return (mesh.n_shards,)


def program_input(x, mesh: MeshLayout):
    """A host argument (a numpy array or a tensor on the CPU) as the
    tensor a program takes, on the mesh's first device (a numpy array
    can be neither a program's input nor its constant, and a captured
    program's inputs lie on its card); anything else as it is."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(mesh.device) if torch.is_tensor(x) else x


def mesh_cache_key(mesh: MeshLayout, cfg: tuple) -> tuple:
    """The key of every mesh-program cache (:func:`mesh_step_jit`,
    :func:`jit_mesh_rounds`): the layout (its shard count and group
    devices) and the static configuration."""
    return (int(mesh.n_shards), tuple(mesh.devices)) + tuple(cfg)


def mesh_step_jit(cache: dict, step_fn, mesh: MeshLayout, cfg: tuple,
                  record: bool = True):
    """The program of ``step_fn`` bound to ``mesh`` and the five-tuple
    ``cfg`` (decisions_per_step, max_arrivals, anticipation_ns,
    allow_limit_break, advance_ns), cached in ``cache`` per
    :func:`mesh_cache_key`: cache ``cluster.<step_fn.__name__>``, entry
    ``cfg + (mesh_shape,)`` as in JAX.  ``record=False`` keeps it out of
    the plane's records (a bare ``jax.jit``).

    On a one-group layout the step is one CUDA graph
    (``compile_plane.InstrumentedJit``).  On D >= 2 groups it is a
    ``compile_plane.StagedJit`` whose body is the step's grouped form
    (:data:`GROUPED_STEPS`): for each ``(kwarg, body)`` of its leg
    bodies one leg a group (``compile_plane.group_legs``, cache
    ``<cache>.leg``) of ``body`` bound to ``cfg``, passed as ``kwarg``;
    the step's counter sum and merges run between the legs.  Read from
    the layout before any capture."""
    key = mesh_cache_key(mesh, cfg)
    if key not in cache:
        (decisions_per_step, max_arrivals, anticipation_ns,
         allow_limit_break, advance_ns) = cfg
        static = dict(decisions_per_step=decisions_per_step,
                      max_arrivals=max_arrivals,
                      anticipation_ns=anticipation_ns,
                      allow_limit_break=allow_limit_break,
                      advance_ns=advance_ns)
        name = f"cluster.{getattr(step_fn, '__name__', 'step')}"
        entry = tuple(cfg) + (mesh_shape(mesh),)
        if not mesh.grouped:
            cache[key] = compile_plane.InstrumentedJit(
                functools.partial(step_fn, mesh=mesh, **static),
                cache=name, entry=entry, record=record)
        else:
            over, leg_bodies = GROUPED_STEPS[step_fn]
            legs = {kw: compile_plane.group_legs(
                lambda g, fn=fn: functools.partial(fn, **static),
                mesh.devices, name=kw, cache=f"{name}.leg", entry=entry)
                for kw, fn in leg_bodies}
            cache[key] = compile_plane.StagedJit(
                functools.partial(over, mesh=mesh, **legs), cache=name,
                entry=entry, record=record,
                legs=[leg for kw in legs for leg in legs[kw]])
    return cache[key]


# each step function's grouped form for mesh_step_jit: the body that
# runs the step over per-group legs, and the leg bodies it takes, by
# keyword (``robust.cluster`` adds ``robust_cluster_step``'s)
GROUPED_STEPS: dict = {
    cluster_step: (_cluster_step_over, (("legs", group_round),))}


def bare_step_jit(mesh: MeshLayout, cfg: tuple):
    """:func:`cluster_step` as a program outside the plane's records
    (the cluster dry run's and the full-scale check's step, a bare
    ``jax.jit`` in JAX): ``(cluster, arrivals, cost) -> (cluster,
    decisions)``."""
    return mesh_step_jit(_BARE_STEP_JIT_CACHE, cluster_step, mesh, cfg,
                         record=False)


def jit_mesh_rounds(mesh: MeshLayout, *, epochs: int,
                    decisions_per_step: int, max_arrivals: int = 1,
                    anticipation_ns: int = 0,
                    allow_limit_break: bool = False,
                    advance_ns: int = 0, counter_sync_every: int = 1,
                    round0: int = 0, with_merged: bool = False,
                    with_pressure: bool = False):
    """:func:`run_mesh_rounds` as the program of one (mesh,
    static-config) pair: ``(cluster, arrivals_seq, cost, view_d,
    view_r, metrics) -> MeshRounds`` (cache ``cluster.mesh_rounds``,
    entry ``cfg + (mesh_shape,)``), host arrays taken as tensors.  The
    key holds ``round0 % counter_sync_every``, as JAX's: the sync grid
    depends on ``round0`` only through it, so at K=1 every chunk
    position shares one program (``epochs`` must match the arrivals'
    rounds)."""
    every = max(int(counter_sync_every), 1)
    cfg = (epochs, decisions_per_step, max_arrivals, anticipation_ns,
           allow_limit_break, advance_ns, counter_sync_every,
           int(round0) % every, with_merged, with_pressure)
    key = mesh_cache_key(mesh, cfg)
    if key not in _MESH_ROUNDS_JIT_CACHE:
        static = dict(decisions_per_step=decisions_per_step,
                      max_arrivals=max_arrivals,
                      anticipation_ns=anticipation_ns,
                      allow_limit_break=allow_limit_break,
                      advance_ns=advance_ns)

        def run(legs, pressure_legs, cluster, arrivals_seq, cost, view_d,
                view_r, met):
            if int(np.shape(arrivals_seq)[0]) != epochs:
                raise ValueError(f"{np.shape(arrivals_seq)[0]} rounds of "
                                 f"arrivals for a {epochs}-round program")
            return _mesh_rounds_over(
                cluster, arrivals_seq, cost, mesh, legs=legs,
                pressure_legs=pressure_legs,
                counter_sync_every=counter_sync_every, round0=round0,
                view_delta=view_d, view_rho=view_r, metrics=met,
                with_merged=with_merged, with_pressure=with_pressure)

        entry = cfg + (mesh_shape(mesh),)
        if not mesh.grouped:
            prog = compile_plane.InstrumentedJit(
                functools.partial(run, [functools.partial(round_leg,
                                                          **static)],
                                  [group_pressure]),
                cache="cluster.mesh_rounds", entry=entry)
        else:
            legs = compile_plane.group_legs(
                lambda g: functools.partial(round_leg, **static),
                mesh.devices, name="round", cache="cluster.mesh_rounds.leg",
                entry=entry, donate_argnums=(0,))
            plegs = compile_plane.group_legs(
                lambda g: group_pressure, mesh.devices, name="pressure",
                cache="cluster.mesh_rounds.leg", entry=entry) \
                if with_pressure else ()
            prog = compile_plane.StagedJit(
                functools.partial(run, legs, plegs),
                cache="cluster.mesh_rounds", entry=entry, legs=legs + plegs)

        def call(cluster, arrivals_seq, cost, view_d, view_r, met):
            return prog(cluster, program_input(arrivals_seq, mesh),
                        program_input(cost, mesh), view_d, view_r, met)

        call.program = prog
        _MESH_ROUNDS_JIT_CACHE[key] = call
    return _MESH_ROUNDS_JIT_CACHE[key]
