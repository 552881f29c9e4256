"""Mesh serving plane: full per-server epoch engines, stacked on one card.

Counterpart of ``dmclock_tpu/parallel/mesh.py``.  The paper's
distributed story -- many servers each running a complete mClock queue,
coordinated only by piggybacked per-client delta/rho counters -- as one
program: each shard owns a full client state and rings (the
``parallel.cluster`` stacked layout, a leading axis ``S`` of every
tensor) and runs the complete fused epoch of the stream chunk
(admission clamp, superwave ingest and one epoch of any of the three
engines, the telemetry accumulators riding it) for a whole chunk of
epochs in one call.  The only traffic between shards is the
``[C]``-sized counter-view sum, refreshed on epochs where ``epoch %
counter_sync_every == 0``; the protocol tolerates stale views, which is
what makes K > 1 safe.

Model: each shard is one server owning a distinct ``n``-client
partition with the same contract layout (slot i has the same QoS
triple on every shard), so the shards start from identical states and
only their independent arrival streams diverge them; aggregate
throughput is the sum of the shards' decision streams.  Counters count
unit-cost completions, folded per epoch from the SLO window block's
delivered columns, so the fold cannot move a decision.

On one device the JAX package's ``psum`` over the ``servers`` axis is
a sum over dim 0, and its ``vmap`` over a shard's servers is a loop
over ``s`` on contiguous views ``x[s]``.  On a layout of D groups
(``make_mesh(S, devices=...)``, ``parallel.groups``) every stacked
input and output is grouped: shard ``s`` runs on its group's device,
so the D devices run concurrently behind the one launching thread, and
the counter sum reduces within each group and then between the groups
(``parallel.tracker.global_counters_from``), each group reading its
own copy.  Epochs are the outer loop and shards the inner one: the
counter sum of an epoch (or of a group head under
``collective_skipping``) is taken from every shard's counters as they
stood before any shard ran it.  Every shard runs on its device's
current stream: kernel K2 merges through one workspace per device
(``engine/kernels.py``), so shards on separate streams of one device
would race.

S=1 is bit-identical to the stream chunk by construction: both run
``engine.stream.make_epoch_step``.  The guarded chunk and its host
replay are ``robust.guarded.run_mesh_chunk_guarded`` and
``mesh_chunk_host_replay``; the supervisor's mesh loop runs one chunk per
checkpoint interval through them (``EpochJob(engine_loop="mesh")``).

A chunk runs as a captured program of the module cache
:func:`jit_mesh_chunk` (cache ``mesh.chunk``, the JAX package's key):
one CUDA graph on a layout whose groups all lie on one card.  A layout
over several distinct cards runs the chunk eagerly on them (one graph
holds one device; ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..engine import fastpath
from ..engine import stream as stream_mod
from ..engine.kernels import as_scalar
from ..obs import device as obsdev
from ..obs import slo as obsslo
from . import groups
from .cluster import (SERVER_AXIS, MeshLayout, broadcast_tree,  # noqa: F401
                      gather_shards, make_mesh, on_mesh,
                      place_shards, restack_shards, shard_view,
                      stack_trees, tree_map)
from .tracker import global_counters_from


class MeshChunk(NamedTuple):
    """One mesh chunk's outputs.

    ``outs`` holds the engine's per-epoch fields stacked ``[S, E,
    ...]``; ``cd``/``cr`` are the per-shard per-client completion
    counters (``int64[S, N]``, the sum's source), ``view_d``/``view_r``
    the held views after the chunk.  ``slo_merged`` is the cluster-wide
    window block (``obs.slo.window_mesh_reduce``; ``int64[N,
    W_FIELDS]``).  ``flight`` is the stacked per-shard flight ring.
    On a layout of several groups every ``[S, ...]`` field is grouped
    (``parallel.groups.Grouped``) and ``slo_merged`` lies on the first
    group's device."""

    state: object             # stacked EngineState, [S, ...] leaves
    outs: dict                # [S, E, ...] stacked engine fields
    cd: torch.Tensor          # int64[S, N] completions (delta source)
    cr: torch.Tensor          # int64[S, N] resv-phase completions
    view_d: torch.Tensor      # int64[S, N] held global-delta views
    view_r: torch.Tensor      # int64[S, N]
    hists: object = None      # stacked telemetry accumulators
    ledger: object = None
    slo: object = None        # int64[S, N, W_FIELDS] per-shard blocks
    prov: object = None
    slo_merged: object = None  # int64[N, W_FIELDS]
    flight: object = None     # stacked obs.flight.FlightState [S, ...]


def stack_shards(tree, n_shards: int, mesh: Optional[MeshLayout] = None):
    """Broadcast a single-engine tree to the stacked ``[S, ...]``
    layout (every shard's partition starts from the same state), as a
    contiguous copy; with ``mesh``, laid out on it (one stack a group on
    each group's device)."""
    stacked = broadcast_tree(tree, n_shards)
    if mesh is not None:
        stacked = place_shards(stacked, mesh)
    return stacked


def unstack_shard(tree, s: int = 0):
    """Shard ``s`` of a stacked tree (the S=1 canonical form)."""
    return shard_view(tree, s)


def counter_init(n_shards: int, n: int, *,
                 device: str | torch.device = DEFAULT_DEVICE,
                 mesh: Optional[MeshLayout] = None):
    """A fresh counter plane: zero per-shard completions, views at the
    protocol's counters-start-at-1 origin; with ``mesh``, laid out on
    it (``device`` is then ignored)."""
    dev = resolve_device(device) if mesh is None else mesh.device

    def fill(v):
        x = torch.full((n_shards, n), v, dtype=torch.int64, device=dev)
        return x if mesh is None else place_shards(x, mesh)

    return fill(0), fill(0), fill(1), fill(1)


def mask_epoch_outs(outs: dict, up, fault_vec) -> dict:
    """Mask one down epoch's outputs to their committed-nothing
    neutrals: guard vectors read True, slots -1, every count, cost and
    class 0.  ``metrics`` is zeroed and replaced by the epoch's
    fault-event delta ``fault_vec`` (also added on live epochs, where
    the engine metrics are kept)."""
    masked = {}
    for name, arr in outs.items():
        if name == "metrics":
            masked[name] = torch.where(up, arr, 0) + fault_vec
        elif name in ("guards_ok", "progress_ok"):
            masked[name] = torch.where(up, arr, torch.ones_like(arr))
        elif name == "slot":
            masked[name] = torch.where(up, arr, torch.full_like(arr, -1))
        else:
            masked[name] = torch.where(up, arr, torch.zeros_like(arr))
    return masked


def _fault_leaf(a, dtype, dev):
    """One FaultChunk array (numpy, a tensor, or grouped) as ``dtype``;
    host arrays go to ``dev``."""
    if groups.is_grouped(a):
        return tree_map(lambda x: x.to(dtype=dtype), a)
    a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


_FAULT_DTYPES = (torch.bool, torch.int64, torch.bool, torch.bool,
                 torch.bool)


def fault_inputs(faults, mesh: MeshLayout):
    """A ``robust.faults.FaultChunk`` (numpy arrays, tensors or grouped)
    as tensors of the chunk's dtypes laid out on ``mesh``: what a
    captured chunk takes, since a numpy array cannot be a program's
    input.  Tensors already so laid out pass through uncopied."""
    if faults is None:
        return None
    vals = [on_mesh(_fault_leaf(a, dt, mesh.device), mesh)
            for a, dt in zip(faults, _FAULT_DTYPES)]
    return type(faults)(*vals) if hasattr(faults, "_fields") \
        else tuple(vals)


def build_mesh_chunk(mesh: MeshLayout, *, engine: str, epochs: int,
                     m: int, k: int = 0, chain_depth: int = 4,
                     dt_epoch_ns: int, waves: int,
                     anticipation_ns: int = 0,
                     allow_limit_break: bool = False,
                     with_metrics: bool = True, select_impl: str = "sort",
                     tag_width: int = 64, window_m: Optional[int] = None,
                     calendar_impl: str = "minstop",
                     ladder_levels: int = 8,
                     counter_sync_every: int = 1,
                     collective_skipping: Optional[bool] = None,
                     ingest: bool = True, with_faults: bool = False,
                     with_pressure: bool = False):
    """The mesh chunk ``(state, cd, cr, view_d, view_r, epoch0, counts,
    hists, ledger, slo, prov, flight, faults) -> MeshChunk`` of one
    configuration.

    ``counts`` is ``int32[S, E, N]`` of raw per-shard Poisson draws;
    ``epoch0`` an int or a 0-d int64 tensor, and the sync mask ``(epoch0
    + i) % counter_sync_every == 0`` is computed on the device, so the
    sync grid is global, not per chunk.  ``slo`` must be a window block
    (``int64[S, N, W_FIELDS]``): the counter plane diffs its delivered
    columns per epoch (pass a zero block when the SLO plane is off).

    ``with_faults`` runs the fault model inside the chunk: ``faults``
    is a ``robust.faults.FaultChunk``-shaped 5-tuple (``up`` /
    ``skew_ns`` / ``delay_counters`` / ``dup_completions`` ``[S, E]``
    and ``up_prev`` ``[S]``), copied to the card.  Per epoch and shard:
    a down shard commits nothing (state, accumulators and SLO block keep
    their entry values, its outputs read :func:`mask_epoch_outs`'s
    neutrals, its frozen counters keep the sum monotone); a live shard
    refreshes its view on the sync grid unless delayed, and a restart
    always re-syncs; ``dup_completions`` folds the epoch's completions
    twice; ``skew_ns`` lenses the epoch clock; every event lands in the
    epoch's metrics rows.  An all-benign fault tuple equals
    ``with_faults=False``.

    ``collective_skipping`` groups the epochs into ``epochs //
    counter_sync_every`` sync groups and takes the counter sum once per
    group head; equal to the flat chunk when ``epoch0`` lies on the
    sync grid.  Default None: on for fault-free chunks with ``epochs``
    divisible by K > 1.  ``with_pressure`` adds the mid-epoch pressure
    probe (``outs["pressure"]``).  As in the stream chunk, the JAX
    package's ``wheel_kernel`` and ``with_flight`` knobs have no
    counterpart: the device picks kernel K2's route, and a flight ring
    rides along whenever one is passed."""
    if engine not in fastpath.EPOCH_ENGINES:
        raise ValueError(f"unknown epoch engine {engine!r}")
    epochs = int(epochs)
    if epochs < 1:
        raise ValueError("a mesh chunk needs at least one epoch")
    kw = fastpath.epoch_scan_kwargs(
        engine, k=k, chain_depth=chain_depth, select_impl=select_impl,
        tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics)
    dt = int(dt_epoch_ns)
    every = max(int(counter_sync_every), 1)
    if collective_skipping is None:
        collective_skipping = (not with_faults and every > 1
                               and epochs % every == 0)
    if collective_skipping and with_faults:
        raise ValueError("collective skipping needs the fault-free chunk "
                         "(a mid-group restart must re-sync from a fresh "
                         "sum)")
    if collective_skipping and epochs % every:
        raise ValueError(f"collective skipping needs epochs ({epochs}) "
                         f"divisible by counter_sync_every ({every})")
    epoch_step = stream_mod.make_epoch_step(
        engine=engine, m=m, kw=kw, dt_epoch_ns=dt, waves=waves,
        ingest=ingest, with_pressure=with_pressure)

    devs = mesh.devices

    def chunk(state, cd, cr, vd, vr, epoch0, counts=None, hists=None,
              ledger=None, slo=None, prov=None, flight=None,
              faults=None) -> MeshChunk:
        n_shards = groups.leading(cd)
        if n_shards != mesh.n_shards:
            raise ValueError(f"{n_shards} shards on a {mesh.n_shards}-"
                             "shard mesh")
        if slo is None:
            raise ValueError("a mesh chunk needs the SLO window block "
                             "(the counter plane folds its columns)")
        if ingest and counts is None:
            raise ValueError("ingest=True needs raw counts")
        owner = groups.group_of(n_shards, len(devs))
        state, cd, cr, vd, vr, hists, ledger, slo, prov, flight = (
            on_mesh(x, mesh) for x in (state, cd, cr, vd, vr, hists,
                                       ledger, slo, prov, flight))
        # each group's epoch0 on its device
        e0s = [as_scalar(epoch0, d) for d in devs]
        if with_faults:
            if faults is None:
                raise ValueError("with_faults=True needs the FaultChunk "
                                 "arrays")
            f_up, f_skew, f_delay, f_dup, f_prev = fault_inputs(faults,
                                                                mesh)
            f_up, f_skew, f_delay, f_dup = (
                [shard_view(a, s) for s in range(n_shards)]
                for a in (f_up, f_skew, f_delay, f_dup))
            up_prev = [shard_view(f_prev, s) for s in range(n_shards)]
        if ingest:
            counts = on_mesh(torch.as_tensor(counts).to(devs[0])
                             if not groups.is_grouped(counts) else counts,
                             mesh)
            counts = [shard_view(counts, s) for s in range(n_shards)]
        st = [shard_view(state, s) for s in range(n_shards)]
        acc = [[shard_view(x, s) for x in (hists, ledger, flight, slo,
                                           prov)]
               for s in range(n_shards)]
        cds = [shard_view(cd, s) for s in range(n_shards)]
        crs = [shard_view(cr, s) for s in range(n_shards)]
        vds = [shard_view(vd, s) for s in range(n_shards)]
        vrs = [shard_view(vr, s) for s in range(n_shards)]
        per_epoch = [[] for _ in range(n_shards)]
        for i in range(epochs):
            if not collective_skipping or i % every == 0:
                # the batched delta/rho exchange: every shard's counters
                # as they stood before any shard ran this epoch (under
                # collective skipping, once per group head); on a
                # grouped layout each group gets its own copy
                g_d, g_r = global_counters_from(
                    restack_shards(cds, mesh), restack_shards(crs, mesh))
            syncs = [torch.remainder(e + i, every) == 0 for e in e0s]
            for s in range(n_shards):
                g = owner[s]
                dev = devs[g]
                sync = syncs[g]
                h, l, f, w, p = acc[s]
                if with_faults:
                    up, skew = f_up[s][i], f_skew[s][i]
                    delay, dup = f_delay[s][i], f_dup[s][i]
                    restart = up & ~up_prev[s]
                    dropout = ~up & up_prev[s]
                    refresh = (sync & up & ~delay) | restart
                else:
                    refresh = sync
                vds[s] = torch.where(refresh, groups.pick(g_d, g), vds[s])
                vrs[s] = torch.where(refresh, groups.pick(g_r, g), vrs[s])
                t_base = (e0s[g] + i) * dt
                if with_faults:
                    t_base = t_base + skew
                (st2, h2, l2, f2, w2, p2), outs = epoch_step(
                    st[s], t_base, counts[s][i] if ingest else None,
                    h, l, f, w, p)
                if with_faults:
                    # commit gate: a down shard keeps last-good state
                    def keep(new, old):
                        return tree_map(
                            lambda a, b: torch.where(up, a, b), new, old)

                    st2, h2, l2, f2, p2, w2 = (
                        keep(st2, st[s]), keep(h2, h), keep(l2, l),
                        keep(f2, f), keep(p2, p), keep(w2, w))
                    perturb = ((dup & up).to(torch.int64)
                               + (delay & up).to(torch.int64)
                               + ((skew != 0) & up).to(torch.int64))
                    events = dropout.to(torch.int64) \
                        + restart.to(torch.int64)
                    outs = mask_epoch_outs(outs, up, obsdev.metrics_delta(
                        device=dev,
                        server_dropouts=dropout.to(torch.int64),
                        tracker_resyncs=restart.to(torch.int64),
                        faults_injected=events + perturb))
                # completions -> counters: the window block's delivered
                # columns are exact per-client counts, so the per-epoch
                # diff is this epoch's completion fold
                d_ops = w2[:, obsslo.W_OPS] - w[:, obsslo.W_OPS]
                d_resv = w2[:, obsslo.W_RESV_OPS] - w[:, obsslo.W_RESV_OPS]
                if with_faults:
                    mult = 1 + (dup & up).to(torch.int64)
                    d_ops, d_resv = d_ops * mult, d_resv * mult
                    up_prev[s] = up
                cds[s] = cds[s] + d_ops
                crs[s] = crs[s] + d_resv
                st[s] = st2
                acc[s] = [h2, l2, f2, w2, p2]
                per_epoch[s].append(outs)
        outs = {name: restack_shards([torch.stack([o[name] for o in po])
                                      for po in per_epoch], mesh)
                for name in per_epoch[0][0]}
        h, l, f, w, p = (restack_shards([a[j] for a in acc], mesh)
                         for j in range(5))
        return MeshChunk(state=restack_shards(st, mesh), outs=outs,
                         cd=restack_shards(cds, mesh),
                         cr=restack_shards(crs, mesh),
                         view_d=restack_shards(vds, mesh),
                         view_r=restack_shards(vrs, mesh),
                         hists=h, ledger=l, slo=w, prov=p,
                         slo_merged=obsslo.window_mesh_reduce(w),
                         flight=f)

    return chunk


# module cache of captured mesh chunks keyed by the layout and the full
# static configuration, as the JAX package's ``_MESH_CHUNK_JIT_CACHE``
_MESH_CHUNK_JIT_CACHE: dict = {}

# the JAX chunk's knobs the port keeps in the key but does not build on
_KEY_ONLY = ("wheel_kernel", "with_flight")


def mesh_shape(mesh: MeshLayout) -> tuple:
    """The JAX key's mesh shape of a layout: JAX places one shard a
    device, so its mesh of ``S`` shards is ``(S,)``."""
    return (mesh.n_shards,)


def jit_mesh_chunk(mesh: MeshLayout, **cfg):
    """The captured :func:`build_mesh_chunk` of ``mesh`` and ``cfg``
    (cache ``mesh.chunk``, entry ``(mesh_shape,) + sorted(cfg.items())``
    as in JAX; ``wheel_kernel`` and ``with_flight`` are kept in the key
    and not built on: the device picks K2's route, and a flight ring
    rides whenever one is passed).  Not donated, as in JAX.

    On the stacked layout, and on groups that all lie on one card, the
    chunk is one CUDA graph.  A layout over two or more distinct cards
    cannot be (one graph, one device): its program runs the body
    eagerly on those cards, with the same records.  That is read from
    the layout before any capture, never from a failed one."""
    from ..obs import compile_plane

    key = (mesh_shape(mesh),) + tuple(sorted(cfg.items()))
    full_key = (mesh,) + key
    if full_key not in _MESH_CHUNK_JIT_CACHE:
        build = {k: v for k, v in cfg.items() if k not in _KEY_ONLY}
        _MESH_CHUNK_JIT_CACHE[full_key] = compile_plane.instrumented_jit(
            build_mesh_chunk(mesh, **build), cache="mesh.chunk", entry=key,
            capture=len(set(mesh.devices)) == 1)
    return _MESH_CHUNK_JIT_CACHE[full_key]


def shard_epoch_view(engine: str, outs: dict, s: int, i: int):
    """Shard ``s``'s epoch ``i`` result object from the stacked (or
    grouped) ``[S, E, ...]`` outputs (the stream loop's ``epoch_view``
    over one shard's slice)."""
    return stream_mod.epoch_view(
        engine, {name: shard_view(arr, s) for name, arr in outs.items()},
        i)


def mesh_epoch_results(engine: str, outs: dict, i: int) -> tuple:
    """Epoch ``i``'s result rows: one per-shard tuple of result views in
    shard order; at S=1 the flattened row is the stream loop's."""
    n_shards = groups.leading(next(iter(outs.values())))
    return tuple((shard_epoch_view(engine, outs, s, i),)
                 for s in range(n_shards))


def mesh_epoch_decisions(engine: str, outs: dict, i: int) -> int:
    """Decisions epoch ``i`` committed across all shards (reads the
    device back)."""
    del engine
    count = outs["count"]
    if groups.is_grouped(count):
        return sum(int(p[:, i].sum()) for p in count.parts)
    return int(count[:, i].sum())
