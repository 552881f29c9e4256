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
(``parallel.groups.sum_parts``), each group reading its own copy.  The
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
one CUDA graph on a one-group layout; on a layout of several groups,
one graph a group a segment (the epochs between two counter sums), the
sums between the graphs (ROADMAP.md section 3).
"""

from __future__ import annotations

import functools
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
                      gather_shards, join_groups, make_mesh, mesh_shape,
                      on_mesh, place_shards, restack_shards, shard_view,
                      stack_trees, tree_map)


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
    rides along whenever one is passed.  The chunk's ``plan`` (its
    segments and its legs' body) is an attribute of the function."""
    plan = _ChunkPlan(
        mesh, engine=engine, epochs=epochs, m=m, k=k,
        chain_depth=chain_depth, dt_epoch_ns=dt_epoch_ns, waves=waves,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics,
        select_impl=select_impl, tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        counter_sync_every=counter_sync_every,
        collective_skipping=collective_skipping, ingest=ingest,
        with_faults=with_faults, with_pressure=with_pressure)
    chunk = functools.partial(plan.run, [plan.leg] * mesh.n_groups)
    chunk.plan = plan
    return chunk


class _ChunkPlan:
    """One configuration of the mesh chunk, cut into segments: the
    epochs between two counter sums (every epoch of the flat chunk and
    of the chaos chunk, whose restarts re-sync from a fresh sum; each
    sync group of K epochs under collective skipping).  :meth:`leg` runs
    one group's shards through one segment; :meth:`run` takes the sums
    between the segments and runs every group's leg in each.  Within a
    segment the shards are independent, so running them group by group
    equals the epochs-outer, shards-inner order bit for bit.

    Epochs are the outer loop of a segment and shards the inner one: the
    counter sum of a segment is taken from every shard's counters as
    they stood before any shard ran it, within each group and then
    between the groups (``parallel.groups.sum_parts``), each group
    reading its own copy.  Every shard runs on its device's current
    stream: kernel K2 merges through one workspace per device
    (``engine/kernels.py``), so shards on separate streams of one device
    would race."""

    def __init__(self, mesh: MeshLayout, *, engine: str, epochs: int,
                 m: int, k: int, chain_depth: int, dt_epoch_ns: int,
                 waves: int, anticipation_ns: int, allow_limit_break: bool,
                 with_metrics: bool, select_impl: str, tag_width: int,
                 window_m: Optional[int], calendar_impl: str,
                 ladder_levels: int, counter_sync_every: int,
                 collective_skipping: Optional[bool], ingest: bool,
                 with_faults: bool, with_pressure: bool):
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
        every = max(int(counter_sync_every), 1)
        if collective_skipping is None:
            collective_skipping = (not with_faults and every > 1
                                   and epochs % every == 0)
        if collective_skipping and with_faults:
            raise ValueError("collective skipping needs the fault-free "
                             "chunk (a mid-group restart must re-sync from "
                             "a fresh sum)")
        if collective_skipping and epochs % every:
            raise ValueError(f"collective skipping needs epochs ({epochs}) "
                             f"divisible by counter_sync_every ({every})")
        self.mesh = mesh
        self.epochs = epochs
        self.every = every
        # epochs a segment: the sync group, or one
        self.span = every if collective_skipping else 1
        self.dt = int(dt_epoch_ns)
        self.ingest = bool(ingest)
        self.with_faults = bool(with_faults)
        self.epoch_step = stream_mod.make_epoch_step(
            engine=engine, m=m, kw=kw, dt_epoch_ns=self.dt, waves=waves,
            ingest=ingest, with_pressure=with_pressure)
        # the order of the per-epoch output fields (a leg returns their
        # values, so no output is taken for a donated input by its name)
        self.out_names: list = []

    def leg(self, carry, counts, faults, e0, i, glob):
        """One group's shards through the segment of ``span`` epochs
        starting at chunk epoch ``i`` (an int, or a 0-d tensor in a
        captured leg).  ``carry`` is a list, one tuple a shard: ``(state,
        cd, cr, view_d, view_r, hists, ledger, flight, slo, prov,
        up_prev)`` (``up_prev`` None without faults); ``counts`` the
        group's ``[per, span, N]`` draws (or None), ``faults`` its
        ``(up, skew_ns, delay_counters, dup_completions)`` ``[per,
        span]`` (or None), ``e0`` the chunk's first epoch, ``glob`` the
        sum of every shard's counters ``int64[2, N]`` (delta, rho) at
        the segment's start, on the group's device.  Returns ``(carry,
        outs, part)``: ``outs`` the per-epoch fields' values stacked
        ``[per, span, ...]`` in :attr:`out_names` order, ``part`` the
        group's counter partial ``int64[2, N]`` after the segment."""
        every, dt = self.every, self.dt
        with_faults = self.with_faults
        # the protocol's counters start at 1
        g_d, g_r = glob[0] + 1, glob[1] + 1
        e0 = as_scalar(e0, glob.device)
        carry = [list(c) for c in carry]
        per_epoch = [[] for _ in carry]
        for kk in range(self.span):
            e = e0 + i + kk
            sync = torch.remainder(e, every) == 0
            for j, c in enumerate(carry):
                st, cd, cr, vd, vr, h, l, f, w, p, up_prev = c
                if with_faults:
                    up, skew, delay, dup = (a[j, kk] for a in faults)
                    restart = up & ~up_prev
                    dropout = ~up & up_prev
                    refresh = (sync & up & ~delay) | restart
                else:
                    refresh = sync
                vd = torch.where(refresh, g_d, vd)
                vr = torch.where(refresh, g_r, vr)
                t_base = e * dt
                if with_faults:
                    t_base = t_base + skew
                (st2, h2, l2, f2, w2, p2), outs = self.epoch_step(
                    st, t_base, counts[j, kk] if self.ingest else None,
                    h, l, f, w, p)
                if with_faults:
                    # commit gate: a down shard keeps last-good state
                    def keep(new, old):
                        return tree_map(
                            lambda a, b: torch.where(up, a, b), new, old)

                    st2, h2, l2, f2, p2, w2 = (
                        keep(st2, st), keep(h2, h), keep(l2, l),
                        keep(f2, f), keep(p2, p), keep(w2, w))
                    perturb = ((dup & up).to(torch.int64)
                               + (delay & up).to(torch.int64)
                               + ((skew != 0) & up).to(torch.int64))
                    events = dropout.to(torch.int64) \
                        + restart.to(torch.int64)
                    outs = mask_epoch_outs(outs, up, obsdev.metrics_delta(
                        device=cd.device,
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
                    up_prev = up
                carry[j] = [st2, cd + d_ops, cr + d_resv, vd, vr, h2, l2,
                            f2, w2, p2, up_prev]
                per_epoch[j].append(outs)
        if not self.out_names:
            self.out_names = list(per_epoch[0][0])
        outs = [torch.stack([torch.stack([o[name] for o in po])
                             for po in per_epoch])
                for name in self.out_names]
        part = torch.stack([torch.stack([c[1] for c in carry]).sum(dim=0),
                            torch.stack([c[2] for c in carry]).sum(dim=0)])
        return [tuple(c) for c in carry], outs, part

    def run(self, legs, state, cd, cr, vd, vr, epoch0, counts=None,
            hists=None, ledger=None, slo=None, prov=None, flight=None,
            faults=None) -> MeshChunk:
        """The chunk over ``legs`` (one a group: :meth:`leg` itself, or
        its captured program), the counter sums between the segments."""
        mesh = self.mesh
        devs = mesh.devices
        n_groups = len(devs)
        n_shards = groups.leading(cd)
        if n_shards != mesh.n_shards:
            raise ValueError(f"{n_shards} shards on a {mesh.n_shards}-"
                             "shard mesh")
        if slo is None:
            raise ValueError("a mesh chunk needs the SLO window block "
                             "(the counter plane folds its columns)")
        if self.ingest and counts is None:
            raise ValueError("ingest=True needs raw counts")
        if self.with_faults and faults is None:
            raise ValueError("with_faults=True needs the FaultChunk arrays")
        per = groups.check_split(n_shards, n_groups)
        trees = [on_mesh(x, mesh) for x in (state, cd, cr, vd, vr, hists,
                                             ledger, flight, slo, prov)]
        f_prev = None
        if self.with_faults:
            *flt, f_prev = fault_inputs(faults, mesh)
        if self.ingest:
            counts = on_mesh(torch.as_tensor(counts).to(devs[0])
                             if not groups.is_grouped(counts) else counts,
                             mesh)

        carries, cnts, flts, e0s, parts = [], [], [], [], []
        for g, dev in enumerate(devs):
            mine = [groups.pick(x, g) for x in trees + [f_prev]]
            carries.append([tuple(groups.view(x, j) for x in mine)
                            for j in range(per)])
            cnts.append(groups.pick(counts, g))
            flts.append([groups.pick(a, g) for a in flt] if self.with_faults
                        else None)
            # a Python epoch0 stays one (a captured leg lifts it)
            e0s.append(epoch0.to(dev) if torch.is_tensor(epoch0)
                       else epoch0)
            parts.append(torch.stack([mine[1].sum(dim=0),
                                      mine[2].sum(dim=0)]))
        seg_outs = [[] for _ in devs]
        span = self.span
        for i in range(0, self.epochs, span):
            glob = groups.sum_parts(parts, devs)
            for g in range(n_groups):
                carries[g], outs, parts[g] = legs[g](
                    carries[g],
                    cnts[g][:, i:i + span] if self.ingest else None,
                    [a[:, i:i + span] for a in flts[g]]
                    if self.with_faults else None,
                    e0s[g], i, glob[g])
                seg_outs[g].append(outs)

        outs = {name: join_groups([torch.cat([o[f] for o in so], dim=1)
                                   if len(so) > 1 else so[0][f]
                                   for so in seg_outs], mesh)
                for f, name in enumerate(self.out_names)}
        st, cd, cr, vd, vr, h, l, f, w, p = (
            join_groups([stack_trees([c[idx] for c in carry])
                         for carry in carries], mesh) for idx in range(10))
        return MeshChunk(state=st, outs=outs, cd=cd, cr=cr, view_d=vd,
                         view_r=vr, hists=h, ledger=l, slo=w, prov=p,
                         slo_merged=obsslo.window_mesh_reduce(w),
                         flight=f)


# module cache of captured mesh chunks keyed by the layout and the full
# static configuration, as the JAX package's ``_MESH_CHUNK_JIT_CACHE``
_MESH_CHUNK_JIT_CACHE: dict = {}

# the JAX chunk's knobs the port keeps in the key but does not build on
_KEY_ONLY = ("wheel_kernel", "with_flight")


def jit_mesh_chunk(mesh: MeshLayout, **cfg):
    """The captured :func:`build_mesh_chunk` of ``mesh`` and ``cfg``
    (cache ``mesh.chunk``, entry ``(mesh_shape,) + sorted(cfg.items())``
    as in JAX; ``wheel_kernel`` and ``with_flight`` are kept in the key
    and not built on: the device picks K2's route, and a flight ring
    rides whenever one is passed).  Not donated, as in JAX.

    A one-group layout's chunk is one CUDA graph
    (``compile_plane.InstrumentedJit``).  A layout of D >= 2 groups,
    whether its groups share a card or not, is a
    ``compile_plane.StagedJit`` with one leg a group
    (``compile_plane.group_legs``, cache ``mesh.leg``): each segment
    (the epochs between two counter sums) replays every group's leg on
    its device, and the sum between the segments runs as plain
    operations and copies, with no read back.  The segment's draws, its
    fault values, ``epoch0`` and the segment's first epoch are the
    leg's inputs, so one capture a group serves every segment, and a
    group's carry passes from segment to segment in the leg's donated
    buffers, restacked into the caller's own outputs after the last.
    The plan is read from the layout before any capture, never from a
    failed one."""
    from ..obs import compile_plane

    key = (mesh_shape(mesh),) + tuple(sorted(cfg.items()))
    full_key = (mesh,) + key
    if full_key not in _MESH_CHUNK_JIT_CACHE:
        build = {k: v for k, v in cfg.items() if k not in _KEY_ONLY}
        if not mesh.grouped:
            prog = compile_plane.instrumented_jit(
                build_mesh_chunk(mesh, **build), cache="mesh.chunk",
                entry=key)
        else:
            plan = build_mesh_chunk(mesh, **build).plan
            legs = compile_plane.group_legs(
                lambda g: plan.leg, mesh.devices, name="segment",
                cache="mesh.leg", entry=key, donate_argnums=(0,))
            prog = compile_plane.StagedJit(
                functools.partial(plan.run, legs), cache="mesh.chunk",
                entry=key, legs=legs)
        _MESH_CHUNK_JIT_CACHE[full_key] = prog
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
