"""The multi-server dmClock cluster on one card.

Counterpart of ``dmclock_tpu/parallel/cluster.py``: every server's
scheduler state is one row of a stacked ``EngineState`` (a leading
server axis ``S`` on every field), its per-client completion counters
sit beside it in an ``[S, C]`` tracker, and one :func:`cluster_step`
advances every server by ``k`` serial-engine decisions.  The dmClock
wire protocol's global counters are the sum of the per-server counters
over the server axis (``parallel.tracker.server_sum``): the JAX
package's ``psum`` over its ``servers`` mesh axis, on one card.

Where the JAX step ``vmap``s over the servers of a ``shard_map``, the
port loops over ``s`` on contiguous views ``x[s]`` of the stacked
tensors and stacks the results.  The counter sum is taken at the top
of each round, before the loop over servers, so every server reads the
counters as they stood at the round's entry -- the values the JAX
package's ``psum`` reads.

:func:`make_mesh` returns a :class:`MeshLayout` (the shard count and
the card), not a process group: one card holds every shard.  The JAX
package's jit caches (``mesh_cache_key``, ``mesh_step_jit``,
``jit_mesh_rounds``) have no counterpart: nothing is compiled per
shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..engine import kernels
from ..engine.state import EngineState, init_state
from ..obs import device as obsdev
from .tracker import (BorrowTrackerState,
                      borrow_tracker_prepare, borrow_tracker_track,
                      global_counters, global_counters_from,
                      init_borrow_tracker, init_tracker, tracker_prepare,
                      tracker_track)

SERVER_AXIS = "servers"


class MeshLayout(NamedTuple):
    """Where a cluster's shards live: ``n_shards`` servers stacked on a
    leading axis, all on ``device``."""

    n_shards: int
    device: torch.device


class ClusterState(NamedTuple):
    """Stacked per-server state; every leaf's leading axis is servers."""

    engine: EngineState       # [S, ...] scheduler state per server
    tracker: object           # [S, C] TrackerState or BorrowTrackerState
    now: torch.Tensor         # int64[S] per-server virtual clock


def make_mesh(n_shards: int = 1, device: str | torch.device =
              DEFAULT_DEVICE) -> MeshLayout:
    """The layout of an ``n_shards``-server cluster on one card."""
    if int(n_shards) < 1:
        raise ValueError(f"a mesh needs at least one shard, got "
                         f"{n_shards}")
    return MeshLayout(int(n_shards), resolve_device(device))


# ----------------------------------------------------------------------
# stacked-tree helpers (NamedTuples of tensors, None leaves kept)
# ----------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a NamedTuple/tuple/dict tree
    (and parallel trees of the same structure); None stays None."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    raise TypeError(f"not a tensor tree leaf: {type(tree)!r}")


def shard_view(tree, s: int):
    """Shard ``s`` of a stacked tree: leading-index views (contiguous
    for a contiguous stack)."""
    return tree_map(lambda a: a[s], tree)


def stack_trees(trees: list):
    """Stack per-shard trees on a new leading axis (None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    items = [stack_trees(list(col)) for col in zip(*trees)]
    return type(first)(*items) if hasattr(first, "_fields") \
        else tuple(items)


def broadcast_tree(tree, n: int):
    """Every leaf repeated ``n`` times on a new leading axis, as a
    contiguous copy (so each ``x[s]`` is contiguous)."""
    return tree_map(lambda a: a.unsqueeze(0).expand(
        (n,) + tuple(a.shape)).contiguous(), tree)


def decisions_to_numpy(decs: kernels.Decision) -> kernels.Decision:
    """A Decision of tensors as a Decision of host numpy arrays."""
    return kernels.Decision(*(x.detach().cpu().numpy() for x in decs))


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
    """Place every leaf on the mesh's card (the JAX package splits the
    leading axis over its devices; here one card holds the stack)."""
    if cluster.now.shape[0] != mesh.n_shards:
        raise ValueError(f"{cluster.now.shape[0]} servers on a "
                         f"{mesh.n_shards}-shard mesh")
    return tree_map(lambda a: a.to(mesh.device), cluster)


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
    :func:`create_clients`); default: all C slots."""
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
    return cluster._replace(engine=eng)


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
    Phase B: the serial engine makes ``decisions_per_step`` decisions.
    Phase C: completions fold into the tracker counters.

    ``engine`` and ``tracker`` are one server's (``[C]`` leaves),
    ``now`` its 0-d clock.  Returns ``(engine, tracker, now, decs)``
    (and the metrics vector with ``with_metrics``)."""
    borrowing = isinstance(tracker, BorrowTrackerState)
    prepare = borrow_tracker_prepare if borrowing else tracker_prepare
    c = arrivals_per_client.shape[0]
    slots = np.arange(c, dtype=np.int64)
    zeros = np.zeros((c,), dtype=np.int64)
    cost_c = torch.broadcast_to(cost, (c,))
    for wave in range(max_arrivals):
        requesting = arrivals_per_client > wave
        # later waves re-mark an unchanged global counter: (0, 0) for
        # Orig, floored at (1, 1) for Borrowing
        tracker, delta_out, rho_out = prepare(tracker, requesting,
                                              g_delta, g_rho)
        cols = torch.stack([
            requesting.to(torch.int64), now.expand(c), cost_c,
            torch.where(requesting, rho_out, 1),
            torch.where(requesting, delta_out, 1)]).cpu().numpy()
        ops = kernels.IngestOps(
            kind=np.where(cols[0] > 0, kernels.OP_ADD, kernels.OP_NOP),
            slot=slots, time=cols[1], cost=cols[2], rho=cols[3],
            delta=cols[4], resv_inv=zeros, weight_inv=zeros,
            limit_inv=zeros, order=zeros)
        engine = kernels.ingest(engine, ops,
                                anticipation_ns=anticipation_ns)
    out = kernels.engine_run(engine, now, decisions_per_step,
                             allow_limit_break=allow_limit_break,
                             anticipation_ns=anticipation_ns,
                             advance_now=True, with_metrics=with_metrics)
    engine, now, decs = out[:3]
    served = decs.type == kernels.RETURNING
    track = borrow_tracker_track if borrowing else tracker_track
    tracker = track(tracker, decs.slot, decs.cost, decs.phase, served)
    if with_metrics:
        return engine, tracker, now, decs, out[3]
    return engine, tracker, now, decs


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
    same with either flag on or off."""
    from ..obs import provenance as obsprov

    n = cluster.now.shape[0]
    if n != mesh.n_shards:
        raise ValueError(f"{n} servers on a {mesh.n_shards}-shard mesh")
    dev = cluster.now.device
    cost = device_tensor(cost, torch.int64, dev)
    arrivals = device_tensor(arrivals, torch.int32, dev)
    now0 = cluster.now + int(advance_ns)
    # the round's counter sum, before any server runs (the psum)
    g_d, g_r = global_counters(cluster.tracker)
    outs = [server_round(
        shard_view(cluster.engine, s), shard_view(cluster.tracker, s),
        now0[s], arrivals[s], cost, g_d, g_r,
        decisions_per_step=decisions_per_step,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, max_arrivals=max_arrivals,
        with_metrics=with_metrics) for s in range(n)]
    engine, tracker, now, decs = (stack_trees([o[i] for o in outs])
                                  for i in range(4))
    res = (ClusterState(engine=engine, tracker=tracker, now=now), decs)
    if with_metrics:
        met = torch.stack([o[4] for o in outs])
        res = res + (met, obsdev.metrics_mesh_reduce(met))
    if with_pressure:
        press = torch.stack([obsprov.pressure_vec(shard_view(engine, s),
                                                  now[s])
                             for s in range(n)])
        res = res + (press, obsprov.pressure_mesh_reduce(press))
    return res


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

    arrivals_seq = np.asarray(arrivals_seq)
    n_servers = cluster.now.shape[0]
    decs_seq = []
    for t in range(arrivals_seq.shape[0]):
        with _spans.span(tracer, "cluster.round", "dispatch",
                         step=t, servers=n_servers):
            cluster, decs = cluster_step(
                cluster, arrivals_seq[t], cost, mesh,
                decisions_per_step=decisions_per_step,
                max_arrivals=max_arrivals,
                anticipation_ns=anticipation_ns,
                allow_limit_break=allow_limit_break,
                advance_ns=advance_ns)
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

    Rounds are the outer loop and servers the inner one: the counter
    sum of round t is taken from every server's counters at the
    round's entry."""
    from ..obs import provenance as obsprov

    dev = cluster.now.device
    arrivals_seq = device_tensor(arrivals_seq, torch.int32, dev)
    epochs = int(arrivals_seq.shape[0])
    n_servers = cluster.now.shape[0]
    n_clients = arrivals_seq.shape[2]
    cost = device_tensor(cost, torch.int64, dev)
    sync_mask = round_sync_mask(epochs, counter_sync_every, round0)
    if view_delta is None or view_rho is None:
        view_delta, view_rho = init_mesh_views(n_servers, n_clients,
                                               device=dev)
    if metrics is None:
        metrics = torch.zeros((n_servers, obsdev.NUM_METRICS),
                              dtype=torch.int64, device=dev)
    eng = [shard_view(cluster.engine, s) for s in range(n_servers)]
    trk = [shard_view(cluster.tracker, s) for s in range(n_servers)]
    now = [cluster.now[s] for s in range(n_servers)]
    vd = [view_delta[s] for s in range(n_servers)]
    vr = [view_rho[s] for s in range(n_servers)]
    met = [metrics[s] for s in range(n_servers)]
    decs = [[] for _ in range(n_servers)]
    for t in range(epochs):
        g_d, g_r = global_counters_from(
            torch.stack([x.completed_delta for x in trk]),
            torch.stack([x.completed_rho for x in trk]))
        for s in range(n_servers):
            if sync_mask[t]:
                vd[s], vr[s] = g_d, g_r
            eng[s], trk[s], now[s], d = server_round(
                eng[s], trk[s], now[s] + int(advance_ns),
                arrivals_seq[t, s], cost, vd[s], vr[s],
                decisions_per_step=decisions_per_step,
                anticipation_ns=anticipation_ns,
                allow_limit_break=allow_limit_break,
                max_arrivals=max_arrivals)
            met[s] = round_metrics(met[s], eng[s], d)
            decs[s].append(d)
    engine = stack_trees(eng)
    out_now = torch.stack(now)
    met_s = torch.stack(met)
    res = MeshRounds(
        cluster=ClusterState(engine=engine, tracker=stack_trees(trk),
                             now=out_now),
        view_delta=torch.stack(vd), view_rho=torch.stack(vr),
        metrics=met_s,
        decs=stack_trees([stack_trees(ds) for ds in decs]))
    if with_merged:
        res = res._replace(merged=obsdev.metrics_mesh_reduce(met_s))
    if with_pressure:
        press = torch.stack([obsprov.pressure_vec(eng[s], now[s])
                             for s in range(n_servers)])
        res = res._replace(pressure=press,
                           pressure_merged=obsprov.pressure_mesh_reduce(
                               press))
    return res


def mesh_decs_seq(decs) -> list:
    """Re-slice a fused launch's ``[S, E, k]`` decision leaves into the
    per-round ``[S, k]`` stream of host numpy the host loops
    produce (``robust.cluster.run_with_plan``)."""
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
    engine = stack_trees([
        kernels.ingest(shard_view(cluster.engine, s), ops,
                       anticipation_ns=0)
        for s in range(mesh.n_shards)])
    return cluster._replace(engine=engine)

