"""Crash-equivalent supervised epoch runs on one card (the single-device
half of ``dmclock_tpu/robust/supervisor.py``).

The epoch loop is a resumable job under a supervisor:

- the job runs epochs of any of the three epoch engines through the
  guarded-commit contract (``robust.guarded.run_epoch_guarded``),
  ingesting Poisson arrivals drawn from a checkpointed host RNG (the
  round loop's ingest is the captured program :func:`_jit_ingest`, the
  JAX package's ``supervisor.ingest`` cache);
- at checkpoint boundaries it writes rotating crash-safe snapshots
  (``utils.checkpoint.save_pytree_rotating``) of the full run state: the
  engine state, the metrics vector, the RNG state, the decision-stream
  chain digest, the epoch and decision counters, the degradation
  ladder's position, the telemetry, SLO, provenance and lifecycle planes;
- the supervisor (a child process per incarnation in ``spawn`` mode, or
  an in-process trampoline) restarts a killed job with bounded
  exponential backoff; the resume lands on the newest intact snapshot
  and replays forward deterministically.

The invariant is the crash-equivalence gate
(:func:`assert_crash_equivalent`): a run killed at any
:class:`~.host_faults.HostFaultPlan` point and resumed gives the
uninterrupted run's decision digest, final state, metric totals (but the
resume row), telemetry, SLO, provenance and lifecycle outputs.  The
digest is a sha256 chain carried inside the snapshot, so decisions
before the last snapshot are hashed once and those after it replay.

Jobs, snapshots and results are the JAX package's: an ``EpochJob`` JSON
loads in either package, either restores the other's snapshots, and the
same job gives the same digests in both.  The device is not a field of
the job (so its JSON stays the JAX package's): :func:`run_job` and
:func:`run_supervised` take ``device=`` (default ``"cuda"``), and the
spawn child reads it from ``job.json``.

``engine_loop="stream"`` runs one fused chunk (``engine.stream``) per
checkpoint interval through ``robust.guarded.run_stream_chunk_guarded``,
drawing chunk T+1's arrivals while the card runs chunk T.

``engine_loop="mesh"`` runs ``n_shards`` full engines, stacked as a
leading axis on one card (``parallel.mesh``), one fused mesh chunk per
checkpoint interval through ``robust.guarded.run_mesh_chunk_guarded``
(a chunk that trips a guard replays on the host loop:
``mesh_fallbacks``).  The delta/rho counter plane rides the snapshots
as the ``mesh_*`` leaves.  ``fault_plan`` samples a ``FaultPlan`` over
(epochs, shards) from its spec at every incarnation and runs it inside
the chunks; ``churn`` runs per-shard lifecycle planes, routed by
``cid % n_shards`` or, with ``placement="p2c"``, by a checkpointed
``lifecycle.placement.PlacementMap``.  S=1 equals the stream loop bit
for bit.  Unlike the JAX loop, which needs one device a shard, any
``n_shards`` runs on the one card.

``controller`` runs the closed-loop controller (``control``) on all
three loops at the checkpoint boundaries: the admission clamp on the
drawn counts, the conceded ladder rungs, the mesh's
``counter_sync_every``, an out-of-band compaction, and on a p2c mesh
live migration (``_mesh_migrate``), each decision journaled and fsynced
before it applies.  ``controller=None`` (or ``False``) builds no
controller state at all and is bit-identical to the bare runner.

Kernel launches are counted per process (``engine._ext.LAUNCHES``), so a
spawn child's launches are not visible to its parent.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time as _time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..control import Controller, as_spec
from ..device import DEFAULT_DEVICE, resolve_device
from ..obs import slo as obsslo
from ..utils import checkpoint as ckpt_mod
from .digest import digest_update
from .guarded import (RECOVERABLE_ERRORS, DegradationLadder,
                      run_epoch_guarded)
from .host_faults import (HostFaultInjector, HostFaultPlan, HostKill,
                          describe_host, plan_from_json, plan_to_json,
                          zero_host_plan)


class SupervisorGaveUp(RuntimeError):
    """The job died more times than ``max_restarts`` allows."""


@dataclasses.dataclass(frozen=True)
class EpochJob:
    """A deterministic, resumable epoch-loop workload.  Every field is
    plain data and matches the JAX package's ``EpochJob`` (names,
    defaults, JSON), so a job round-trips into a spawned child and two
    runs of one job are bit-identical."""

    engine: str = "prefix"          # prefix | chain | calendar
    n: int = 512                    # clients
    depth: int = 12                 # preloaded queue depth
    ring: int = 16
    epochs: int = 8
    m: int = 4                      # batches per epoch
    k: int = 64                     # per-batch cap / calendar steps
    chain_depth: int = 4
    select_impl: str = "sort"
    tag_width: int = 64
    calendar_impl: str = "minstop"
    ladder_levels: int = 4
    # the JAX package's wheel bucket kernel switch ("xla" | "pallas"),
    # kept so its job JSON loads unchanged; on CUDA the wheel always
    # runs kernel K2
    wheel_kernel: str = "xla"
    seed: int = 11                  # arrival RNG seed
    arrival_lam: float = 2.0        # Poisson mean arrivals/client/epoch
    waves: int = 4
    dt_epoch_ns: int = 10 ** 8
    ckpt_every: int = 2             # checkpoint every N epochs
    keep: int = 4                   # rotation depth
    ladder: bool = False            # degradation ladder enabled
    ladder_threshold: int = 2
    metrics_port: Optional[int] = None   # scrape endpoint (fail-soft)
    # offset of client 0's head proportion tag (ns): past +-2^31 it trips
    # the tag32 window every epoch, the way to exercise the ladder
    tag_spread_ns: int = 0
    # telemetry accumulators (they ride the snapshots, so crash
    # equivalence covers them)
    with_hists: bool = False
    with_ledger: bool = False
    flight_records: int = 0         # flight-ring rows (0 = off)
    flight_dump: Optional[str] = None  # JSONL the ring is dumped to when
    #                                    an incarnation crashes
    # span JSONL, appended at checkpoint boundaries only (a resume
    # replays from the last snapshot, so a later flush would count the
    # replayed epochs' spans twice)
    span_log: Optional[str] = None
    # a lifecycle.churn spec: an open-population run whose engine state
    # starts empty at the spec's capacity0 and whose lifecycle plane
    # registers, updates, evicts and compacts on the ckpt_every grid;
    # the digest hashes client-id-space views.  None = closed population
    churn: Optional[dict] = None
    # SLO windows, rolled on the ckpt_every grid
    with_slo: bool = False
    slo_ring: int = 64              # closed-window ring depth per client
    slo_log: Optional[str] = None   # judged windows, appended after each
    #                                 checkpoint commits
    with_prov: bool = False         # the provenance block
    # "round": ingest and one guarded epoch per epoch; "stream": one
    # fused chunk per checkpoint interval; "mesh": one fused mesh chunk
    # of n_shards engines per checkpoint interval
    engine_loop: str = "round"
    # mesh knobs: shard count and the counter-exchange grid (views
    # refresh on epochs where epoch % counter_sync_every == 0)
    n_shards: int = 1
    counter_sync_every: int = 1
    # "static" (cid % n_shards, no map built), "p2c" or {"mode": "p2c",
    # "overrides": {cid: shard}}: placement of a mesh churn job's
    # registrations (lifecycle.placement)
    placement: object = "static"
    # a fault-plan spec (dict, or the "seed=..,p_dropout=.." string) of
    # a mesh job, sampled per incarnation and run inside the chunks
    fault_plan: object = None
    # the closed-loop controller (control.as_spec: None/False = off, True,
    # a spec dict or a ControllerConfig)
    controller: object = None
    # a mesh job's layout: device names, one a group of contiguous
    # shards (parallel.groups; a name may repeat).  None = every shard
    # on the run's one device.  Snapshots are the same bytes whatever
    # the layout, so a job resumes on any layout whose length divides
    # n_shards
    devices: object = None

    def to_json(self) -> dict:
        """The job as JSON; ``devices`` only when set, so a job on the
        default layout is the JAX package's ``EpochJob`` key for key."""
        out = dataclasses.asdict(self)
        if out["devices"] is None:
            del out["devices"]
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "EpochJob":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})


class SupervisedResult(NamedTuple):
    """What a completed (bare or supervised) run reports: the JAX
    package's fields (the controller's with ``controller`` set, the
    placement map's and the move log with ``placement="p2c"``)."""

    digest: str         # hex decision-stream chain digest
    state_digest: str   # sha256 over the final engine state leaves
    decisions: int
    epochs: int
    metrics: np.ndarray  # int64[NUM_METRICS], resume row included
    restarts: int
    ladder_steps: list   # DegradationLadder.describe() rows
    scrape_rebinds: int  # by the final incarnation (not checkpointed)
    resumed_from: Optional[str] = None   # snapshot the final
    #                                      incarnation resumed from
    hists: Optional[np.ndarray] = None
    ledger: Optional[np.ndarray] = None
    flight_buf: Optional[np.ndarray] = None
    flight_seq: int = 0
    stream_fallbacks: int = 0   # stream chunks re-run on the round path
    lifecycle: Optional[dict] = None     # plane.snapshot() of a churn job
    slo_window: Optional[np.ndarray] = None
    slo_ring: Optional[np.ndarray] = None
    slo_cepoch: Optional[np.ndarray] = None
    slo: Optional[dict] = None
    prov_margin_hist: Optional[np.ndarray] = None
    prov_scal: Optional[np.ndarray] = None
    prov_last_served: Optional[np.ndarray] = None
    mesh_counters: Optional[np.ndarray] = None
    mesh_views: Optional[np.ndarray] = None
    mesh_fallbacks: int = 0
    mesh_chaos_fallbacks: int = 0
    controller_decisions: int = 0
    controller_replays: int = 0
    controller_knobs: Optional[list] = None
    controller_trajectory: Optional[list] = None
    placement: Optional[str] = None
    migrations: int = 0
    migration_log: Optional[list] = None
    placement_counters: Optional[dict] = None


# array outputs the gate compares bit for bit (None on both sides, or
# equal arrays)
_GATE_ARRAYS = ("hists", "ledger", "flight_buf", "slo_window",
                "slo_ring", "slo_cepoch", "prov_margin_hist",
                "prov_scal", "prov_last_served", "mesh_counters",
                "mesh_views")
# plain outputs the gate compares with ==
_GATE_VALUES = ("flight_seq", "lifecycle", "slo", "controller_decisions",
                "controller_knobs", "controller_trajectory", "placement",
                "migrations", "migration_log", "placement_counters")


def assert_crash_equivalent(interrupted: SupervisedResult,
                            reference: SupervisedResult) -> None:
    """The digest gate: decision stream, final state, metric totals and
    every plane's outputs must match bit for bit, but the resume rows an
    interrupted run legitimately grows."""
    from ..obs import device as obsdev

    assert interrupted.digest == reference.digest, \
        (f"decision digest diverged: {interrupted.digest[:16]} vs "
         f"{reference.digest[:16]}")
    assert interrupted.state_digest == reference.state_digest, \
        "final engine state diverged"
    assert interrupted.decisions == reference.decisions
    a = np.asarray(interrupted.metrics, dtype=np.int64).copy()
    b = np.asarray(reference.metrics, dtype=np.int64).copy()
    for row in obsdev.RESUME_ROWS:
        a[row] = b[row] = 0
    assert np.array_equal(a, b), \
        (f"metric totals diverged outside the resume rows: "
         f"{a.tolist()} vs {b.tolist()}")
    for field in _GATE_ARRAYS:
        x, y = getattr(interrupted, field), getattr(reference, field)
        assert (x is None) == (y is None), \
            f"{field} enabled on only one side"
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), \
                f"{field} diverged across the crash"
    for field in _GATE_VALUES:
        x, y = getattr(interrupted, field), getattr(reference, field)
        assert x == y, f"{field} diverged across the crash: {x} vs {y}"


# ----------------------------------------------------------------------
# the job loop
# ----------------------------------------------------------------------

def _check_job(job: EpochJob) -> None:
    """The JAX loop's composition checks (the controller spec included:
    an unknown key fails here).  Not checked: ``n_shards`` against the
    device count (the shards share the one card)."""
    from ..lifecycle.placement import parse_placement
    from .faults import parse_fault_spec

    if job.engine_loop not in ("round", "stream", "mesh"):
        raise ValueError(f"unknown engine_loop {job.engine_loop!r} "
                         "(one of 'round', 'stream', 'mesh')")
    pl_mode, _ = parse_placement(job.placement)   # validates the spec
    if pl_mode != "static" and (job.engine_loop != "mesh"
                                or job.churn is None):
        raise ValueError(
            "EpochJob(placement='p2c') is the mesh churn placement "
            "plane (engine_loop='mesh' + churn=...): power-of-two-"
            "choices needs per-shard pressure to choose between and "
            "an open population to place")
    if job.engine_loop == "mesh":
        if job.churn is not None and job.with_slo:
            raise ValueError(
                "EpochJob(engine_loop='mesh', churn=...) does not "
                "compose with with_slo: the cluster-wide window table "
                "is slot-indexed, and per-shard slot layouts diverge "
                "under churn")
        if job.churn is not None and job.fault_plan is not None \
                and pl_mode == "static":
            raise ValueError(
                "EpochJob(engine_loop='mesh') does not compose churn "
                "with fault_plan under placement='static': a static "
                "map has no answer for a registration routed to a "
                "DOWN shard.  placement='p2c' does (re-route to the "
                "live sampled choice, defer one boundary when both "
                "are down) -- pass placement='p2c'")
        if job.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, "
                             f"got {job.n_shards}")
        if job.devices is not None and len(job.devices) > 1 and \
                job.n_shards % len(job.devices):
            raise ValueError(f"{job.n_shards} shards do not split over "
                             f"{len(job.devices)} devices (S % D must "
                             f"be 0)")
        if job.churn is not None and \
                job.churn.get("scenario") == "shard_skew" and \
                int(job.churn.get("n_shards", 0)) != job.n_shards:
            raise ValueError(
                f"shard_skew spec was built for "
                f"n_shards={job.churn.get('n_shards')} but the job "
                f"runs {job.n_shards} shards -- pass "
                f"make_spec('shard_skew', n_shards={job.n_shards})")
    if job.devices is not None and job.engine_loop != "mesh":
        raise ValueError("EpochJob(devices=...) lays out a mesh job's "
                         "shards (engine_loop='mesh')")
    if job.fault_plan is not None:
        if job.engine_loop != "mesh":
            raise ValueError(
                "EpochJob(fault_plan=...) is the in-chunk mesh fault "
                "model (engine_loop='mesh'); the round and stream loops "
                "take faults through robust.cluster")
        if parse_fault_spec(job.fault_plan) is None:
            raise ValueError(f"fault_plan spec did not parse: "
                             f"{job.fault_plan!r} (expected keys like "
                             f"seed=.., p_dropout=..)")
    as_spec(job.controller)
    if job.wheel_kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown wheel_kernel {job.wheel_kernel!r}")


def _job_state(job: EpochJob, device):
    """The preloaded engine state (staggered proportion tags, ``depth``
    queued ops per client), or for a churn job an empty state at the
    spec's initial capacity.  A mesh job's is the stacked ``[S, ...]``
    layout: every shard owns a distinct ``n``-client partition with this
    same contract layout."""
    from ..core.timebase import rate_to_inv_ns
    from ..engine.state import init_state

    dev = resolve_device(device)
    if job.engine_loop == "mesh":
        from ..parallel import mesh as mesh_mod

        single = dataclasses.replace(job, engine_loop="stream")
        return mesh_mod.stack_shards(_job_state(single, dev), job.n_shards)
    if job.churn is not None:
        return init_state(int(job.churn["capacity0"]), job.ring,
                          device=dev)
    st = init_state(job.n, job.ring, device=dev)
    c = np.arange(job.n)
    rinv = np.full(job.n, rate_to_inv_ns(100.0), dtype=np.int64)
    winv = np.asarray([rate_to_inv_ns(1.0 + (i % 4)) for i in c],
                      dtype=np.int64)
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    jitter = (phase * 2.0 * winv).astype(np.int64)
    if job.tag_spread_ns:
        jitter[0] += np.int64(job.tag_spread_ns)
    q_arr = np.zeros((job.n, job.ring), dtype=np.int64)
    q_arr[:, :job.depth - 1] = np.tile(np.arange(1, job.depth),
                                       (job.n, 1))

    def put(a):
        return torch.from_numpy(a).to(dev)

    return st._replace(
        active=torch.ones(job.n, dtype=torch.bool, device=dev),
        idle=torch.zeros(job.n, dtype=torch.bool, device=dev),
        order=torch.arange(job.n, dtype=torch.int64, device=dev),
        resv_inv=put(rinv), weight_inv=put(winv), head_resv=put(rinv),
        head_prop=put(winv + jitter),
        head_limit=torch.full((job.n,), -(1 << 62), dtype=torch.int64,
                              device=dev),
        depth=torch.full((job.n,), job.depth, dtype=torch.int32,
                         device=dev),
        q_arrival=put(q_arr),
        q_cost=torch.ones((job.n, job.ring), dtype=torch.int64,
                          device=dev))


def _rng_state_array(rng: np.random.Generator) -> np.ndarray:
    """PCG64 state as uint64[6] (128-bit state and increment split lo/hi,
    then the uint32 spill): the checkpointable host RNG."""
    s = rng.bit_generator.state
    mask = (1 << 64) - 1
    st, inc = s["state"]["state"], s["state"]["inc"]
    return np.asarray([st & mask, (st >> 64) & mask,
                       inc & mask, (inc >> 64) & mask,
                       int(s["has_uint32"]), int(s["uinteger"])],
                      dtype=np.uint64)


def _rng_from_array(a) -> np.random.Generator:
    a = np.asarray(a, dtype=np.uint64)
    rng = np.random.Generator(np.random.PCG64(0))
    rng.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": int(a[0]) | (int(a[1]) << 64),
                  "inc": int(a[2]) | (int(a[3]) << 64)},
        "has_uint32": int(a[4]), "uinteger": int(a[5])}
    return rng


def _host64(x) -> np.ndarray:
    """A tensor (stacked or grouped) or array read to the host as int64
    (blocking)."""
    from ..parallel import groups

    if groups.is_grouped(x):
        x = groups.gather(x, "cpu")
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)


# the mesh counter plane's leaves (zero-size off the mesh): every payload
# carries them, so its structure is the JAX package's whatever the job
_MESH_KEYS = ("mesh_cd", "mesh_cr", "mesh_vd", "mesh_vr")


def _payload(job: EpochJob, state, rng, met, digest: bytes,
             epoch: int, decisions: int, ladder_vec, hists=None,
             ledger=None, flight=None, plane=None, slo=None,
             prov=None, mesh=None, pm=None, ctl=None) -> dict:
    """The snapshot: the JAX package's leaves, key for key.  Every leaf
    is present whatever the job (zero-size when off), so the restore
    template's structure depends on the config only.  ``rng`` is the
    live generator (round loop) or a state array (stream and mesh
    loops, whose draws run ahead of the boundary).  A mesh churn job's
    ``plane`` is the list of per-shard planes, each encoded under
    ``lc_s{s}_*``; ``mesh`` is its ``(cd, cr, vd, vr)`` counter plane
    and ``pm`` its placement map; ``ctl`` the controller (its
    ``ctl_*`` leaves are zeros without one)."""
    from ..lifecycle import placement as placement_mod
    from ..lifecycle.plane import LifecyclePlane
    from ..obs import flight as obsflight
    from ..obs.alerts import SloEvaluator

    z = np.zeros((0,), dtype=np.int64)
    rng_arr = np.asarray(rng, dtype=np.uint64) \
        if isinstance(rng, np.ndarray) else _rng_state_array(rng)
    if isinstance(plane, (list, tuple)):
        lc = dict(LifecyclePlane.empty_leaves())
        for s, pl in enumerate(plane):
            lc.update({f"lc_s{s}{k[2:]}": v
                       for k, v in pl.encode().items()})
    elif plane is not None:
        lc = plane.encode()
    else:
        lc = LifecyclePlane.empty_leaves()
    mz = {k: z if mesh is None else _host64(v)
          for k, v in zip(_MESH_KEYS, mesh or (None,) * 4)}
    pmz = pm.encode() if pm is not None else placement_mod.empty_leaves()
    if slo is not None:
        sl = {"slo_window": _host64(slo[0]), **slo[1].encode(),
              **slo[2].encode()}
    else:
        sl = {"slo_window": np.zeros((0, obsslo.W_FIELDS),
                                     dtype=np.int64),
              **obsslo.SloPlane.empty_leaves(),
              **SloEvaluator.empty_leaves()}
    ct = ctl.encode() if ctl is not None else Controller.empty_leaves()
    return {**lc, **sl, **mz, **ct, **pmz,
            "digest": np.frombuffer(digest, dtype=np.uint8).copy(),
            "decisions": np.int64(decisions),
            "engine": state,
            "epoch": np.int64(epoch),
            "ladder": np.asarray(ladder_vec, dtype=np.int64),
            "metrics": np.asarray(met, dtype=np.int64),
            "rng": rng_arr,
            "tele_hists": z if hists is None else _host64(hists),
            "tele_ledger": z if ledger is None else _host64(ledger),
            "tele_flight_buf":
                np.zeros((0, obsflight.FLIGHT_COLS), dtype=np.int64)
                if flight is None else _host64(flight.buf),
            "tele_flight_seq": np.int64(0) if flight is None
            else _host64(flight.seq),
            "tele_flight_batch": np.int64(0) if flight is None
            else _host64(flight.batch),
            "prov_margin_hist": z if prov is None
            else _host64(prov.margin_hist),
            "prov_scal": z if prov is None else _host64(prov.scal),
            "prov_last_served": z if prov is None
            else _host64(prov.last_served)}


def _tele_init(job: EpochJob, device):
    """Fresh telemetry accumulators per the job's flags (a churn job's
    per-client ones sized to the spec's initial capacity)."""
    from ..obs import flight as obsflight
    from ..obs import histograms as obshist
    from ..obs import provenance as obsprov

    n = int(job.churn["capacity0"]) if job.churn is not None else job.n
    hists = obshist.hist_zero(device) if job.with_hists else None
    ledger = obshist.ledger_zero(n, device) if job.with_ledger else None
    flight = obsflight.flight_init(job.flight_records, device) \
        if job.flight_records else None
    prov = obsprov.prov_init(n, device=device) if job.with_prov else None
    if job.engine_loop == "mesh":
        # per-shard stacks: each shard's epochs carry their own
        from ..parallel import mesh as mesh_mod

        hists, ledger, flight, prov = (
            None if acc is None else mesh_mod.stack_shards(acc,
                                                           job.n_shards)
            for acc in (hists, ledger, flight, prov))
    return hists, ledger, flight, prov


def _placement_map(job: EpochJob, *, payload=None):
    """The shared ``lifecycle.placement.PlacementMap`` of a mesh churn
    job with ``placement != "static"``, None otherwise (the static path
    builds no map).  Pins and overrides re-derive from the job; the
    assignment, RNG, counters and deferrals restore from the ``pm_*``
    leaves of ``payload``."""
    from ..lifecycle import placement as placement_mod

    mode, overrides = placement_mod.parse_placement(job.placement)
    if mode == "static" or job.churn is None \
            or job.engine_loop != "mesh":
        return None
    pm = placement_mod.PlacementMap(
        job.n_shards, int(job.churn["total_ids"]), mode=mode,
        seed=job.seed,
        pins=placement_mod.placement_pins(job.churn, job.n_shards),
        overrides=overrides)
    if payload is not None:
        pm.load(payload)
    return pm


def _mesh_planes(job: EpochJob, *, tracer=None, payload=None, pm=None):
    """The per-shard lifecycle planes of a mesh churn job (ids routed by
    ``pm`` when there is one, else by ``cid % n_shards``), fresh or
    restored from the ``lc_s{s}_*`` leaves.  They run without a workdir:
    mesh churn is scripted events only (the admin API and its WAL are a
    single plane's)."""
    from ..lifecycle.plane import LifecyclePlane

    planes = []
    for s in range(job.n_shards):
        if payload is not None:
            pre = f"lc_s{s}_"
            sub = {"lc_" + k[len(pre):]: v
                   for k, v in payload.items() if k.startswith(pre)}
            planes.append(LifecyclePlane.load(
                sub, job.churn, tracer=tracer, shard=(s, job.n_shards)))
        else:
            planes.append(LifecyclePlane(job.churn, tracer=tracer,
                                         shard=(s, job.n_shards)))
        if pm is not None:
            planes[-1].attach_placement(pm)
    return planes


def _payload_like(job: EpochJob, device) -> dict:
    """The restore template.  Its SLO leaves stay the empty-leaf shapes
    even for SLO jobs: their axis 0 is runtime state, so such jobs
    restore with the axis-0 relaxation (a mesh job's stacked window
    block keeps its rank and trailing dims)."""
    from ..lifecycle.plane import LifecyclePlane
    from ..obs import device as obsdev
    from ..obs import slo as obsslo

    hists, ledger, flight, prov = _tele_init(job, device)
    mesh = plane = None
    pm = _placement_map(job)
    if job.engine_loop == "mesh":
        from ..parallel import mesh as mesh_mod

        n0 = int(job.churn["capacity0"]) if job.churn is not None \
            else job.n
        mesh = mesh_mod.counter_init(job.n_shards, n0, device=device)
    if job.churn is not None:
        plane = _mesh_planes(job, pm=pm) if job.engine_loop == "mesh" \
            else LifecyclePlane(job.churn)
    tmpl = _payload(job, _job_state(job, device),
                    np.random.Generator(np.random.PCG64(job.seed)),
                    np.zeros(obsdev.NUM_METRICS, dtype=np.int64),
                    b"\x00" * 32, 0, 0, DegradationLadder().encode(),
                    hists=hists, ledger=ledger, flight=flight,
                    prov=prov, plane=plane, mesh=mesh, pm=pm)
    if job.engine_loop == "mesh" and job.with_slo:
        tmpl["slo_window"] = np.zeros((0, job.n, obsslo.W_FIELDS),
                                      dtype=np.int64)
    return tmpl


def _slo_log_flush(slo_plane, slo_log, closed) -> None:
    """Append one roll's judged windows to the slo_log JSONL (fail-soft:
    telemetry must never kill the run), right after a checkpoint
    commits, in both loops."""
    if not closed or not slo_log or slo_plane is None:
        return
    try:
        slo_plane.export_jsonl(slo_log, closed)
    except OSError as e:
        print(f"# supervisor: slo_log write failed: {e}",
              file=sys.stderr)


def _healthz_ok(scrape, timeout_s: float = 2.0) -> bool:
    """One probe of a scrape endpoint's ``/healthz``."""
    import urllib.request

    try:
        with urllib.request.urlopen(scrape.healthz_url,
                                    timeout=timeout_s) as resp:
            return resp.status == 200 and b"ok" in resp.read()
    except Exception:
        return False


class _ScrapeCtl:
    """The scrape endpoint of both loops: (re)bind at the loop's host
    points, pin an ephemeral port, probe ``/healthz`` after a rebind,
    and honor the plan's port-loss points.  Host telemetry only,
    outside the checkpointed state."""

    def __init__(self, port, start_epoch: int, on_bind=None):
        self.port = port
        self.start_epoch = start_epoch
        self.scrape = None
        self.rebinds = 0
        # called with the server after every (re)bind: mounts are per
        # server, so a rebind re-mounts the admin and SLO APIs
        self.on_bind = on_bind

    def tick(self, epoch: int, injector) -> None:
        from ..obs.registry import start_http_server

        if self.port is not None and self.scrape is None:
            self.scrape = start_http_server(port=self.port)
            if self.scrape is not None:
                self.port = self.scrape.port
                if self.on_bind is not None:
                    self.on_bind(self.scrape)
                if epoch > self.start_epoch:
                    self.rebinds += 1
                    if not _healthz_ok(self.scrape):
                        print("# supervisor: scrape rebind on "
                              f"port {self.scrape.port} failed its "
                              "healthz probe", file=sys.stderr)
        if injector is not None and injector.drop_scrape(epoch) \
                and self.scrape is not None:
            self.scrape.close()      # the plan yanks the port; the
            self.scrape = None       # loop rebinds next tick

    def close(self) -> None:
        if self.scrape is not None:
            self.scrape.close()
            self.scrape = None


def _draw_counts(rng: np.random.Generator, job: EpochJob,
                 epochs: int) -> np.ndarray:
    """Raw per-epoch Poisson draws ``int32[epochs, N]``: the round
    loop's consumption sequence, so drawing a chunk ahead advances the
    generator exactly as per-epoch draws would."""
    return np.stack([rng.poisson(job.arrival_lam, job.n)
                     .astype(np.int32) for _ in range(epochs)])


# module cache of the round loop's captured ingest, as the JAX
# package's ``_INGEST_JIT_CACHE``
_INGEST_JIT_CACHE: dict = {}


def _jit_ingest(job: EpochJob):
    """The captured superwave ingest ``(state, counts, t_base) -> state``
    of the job's static shape (cache ``supervisor.ingest``): waves
    ``dt_epoch_ns // waves`` apart from ``t_base``, unit costs.  The
    counts come clamped to the ring's headroom by the host, which reads
    the depth as the JAX loop does."""
    key = (job.n, job.ring, job.waves, job.dt_epoch_ns)
    if key not in _INGEST_JIT_CACHE:
        from ..engine.kernels import ingest_superwave
        from ..obs import compile_plane

        n, waves, dt_wave = job.n, job.waves, job.dt_epoch_ns // job.waves

        def ingest(st, counts, t_base):
            dev = st.device
            wave_times = t_base + torch.arange(
                waves, dtype=torch.int64, device=dev) * dt_wave
            cost = torch.ones((n,), dtype=torch.int64, device=dev)
            return ingest_superwave(st, counts, wave_times, cost, cost,
                                    cost, anticipation_ns=0)

        _INGEST_JIT_CACHE[key] = compile_plane.instrumented_jit(
            ingest, cache="supervisor.ingest", entry=key)
    return _INGEST_JIT_CACHE[key]


def _draw_counts_churn(rng: np.random.Generator, spec: dict,
                       e0: int, e1: int) -> np.ndarray:
    """Raw per-epoch draws of a churn spec, ``int32[e1 - e0,
    total_ids]`` in client-id space (mapped onto slots at the boundary,
    after the plane has applied it)."""
    from ..lifecycle import churn as churn_mod

    return np.stack([rng.poisson(churn_mod.lam_vector(spec, e))
                     .astype(np.int32) for e in range(e0, e1)])


def _boundary_with_prov(plane, state, b, every, ledger, slo_block,
                        prov):
    """One lifecycle boundary with every rider: the ledger, the SLO
    block and the provenance watermark (padded with 0 = never served,
    so a recycled slot's new tenant inherits no serve history)."""
    from ..obs.provenance import ProvBlock

    extras = None if prov is None else [(prov.last_served, 0)]
    out = plane.boundary(state, b, every, ledger=ledger,
                         slo_block=slo_block, extras=extras)
    state, ledger = out[0], out[1]
    i = 2
    if slo_block is not None:
        slo_block = out[i]
        i += 1
    if extras is not None:
        prov = ProvBlock(prov.margin_hist, prov.scal, out[i][0][0])
    return state, ledger, slo_block, prov


def _ctl_compact(plane, state, ledger, slo_block, prov, b: int):
    """The controller's ``compact`` actuation: an out-of-band compaction
    through the plane's own transform (digest-neutral: the chain digest
    hashes client-id-space views), with the ledger, the SLO block and
    the provenance watermark riding it.  Runs before the boundary's
    checkpoint save, so the snapshot holds the compacted layout and a
    replayed decision re-compacts the replayed layout."""
    from ..obs.provenance import ProvBlock

    extras = None if prov is None else [(prov.last_served, 0)]
    out = plane.force_compact(state, ledger=ledger, slo_block=slo_block,
                              extras=extras, b=b)
    state, ledger = out[0], out[1]
    i = 2
    if slo_block is not None:
        slo_block = out[i]
        i += 1
    if extras is not None:
        prov = ProvBlock(prov.margin_hist, prov.scal, out[i][0][0])
    return state, ledger, slo_block, prov


def _crash_dump(job: EpochJob, flight) -> None:
    """The crash hook: dump the flight ring (a mesh job's per-shard
    rings with a shard column) before the incarnation dies (best effort:
    it must never mask the original error).  No span flush: spans since
    the last boundary describe epochs a resume will replay."""
    if job.flight_dump and flight is not None:
        from ..obs import flight as obsflight
        try:
            n = obsflight.flight_dump_any(flight, job.flight_dump)
            print(f"# supervisor: dumped {n} flight records to "
                  f"{job.flight_dump}", file=sys.stderr)
        except Exception:
            pass


class _Run:
    """One incarnation's mutable run state, shared by both loops."""

    def __init__(self, job: EpochJob, workdir, injector, device,
                 spawned_ns: Optional[int] = None):
        from ..obs import device as obsdev
        from ..obs import spans as _spans

        self.job = job
        self.dev = dev = resolve_device(device)
        self.injector = injector
        self.state = _job_state(job, dev)
        self.rng = np.random.Generator(np.random.PCG64(job.seed))
        self.met = np.zeros(obsdev.NUM_METRICS, dtype=np.int64)
        self.digest = b"\x00" * 32
        self.start_epoch = 0
        self.decisions = 0
        self.tracer = _spans.SpanTracer() if job.span_log else None
        if spawned_ns is not None:
            # a spawn child's start, on the wall clock both processes
            # share: from the parent's spawn through the interpreter, the
            # imports and the device's context to the initial state
            _spans.instant(self.tracer, "supervisor.child_start",
                           "host_prep",
                           start_s=(_time.time_ns() - spawned_ns) / 1e9)
        self.ladder = DegradationLadder(enabled=job.ladder,
                                        threshold=job.ladder_threshold,
                                        tracer=self.tracer)
        self.hists, self.ledger, self.flight, self.prov = \
            _tele_init(job, dev)
        self.ckpt_dir = os.path.join(workdir, "ckpt") if workdir \
            else None
        self.stream_fallbacks = 0
        # the controller is built before the restore, so load() finds
        # the journal (read from the workdir here) to replay against
        self.ctl = None
        ctl_spec = as_spec(job.controller)
        if ctl_spec is not None:
            self.ctl = Controller(
                ctl_spec, n=job.n, ring=job.ring,
                counter_sync_every=job.counter_sync_every,
                capacity0=int(job.churn["capacity0"])
                if job.churn is not None else 0,
                n_shards=job.n_shards, workdir=workdir)
        payload = self.resumed_from = None
        if self.ckpt_dir is not None and \
                ckpt_mod.rotation_paths(self.ckpt_dir):
            # a previous incarnation died: resume from the newest intact
            # snapshot; every entry torn means replay from scratch
            # (deterministic, so still crash-equivalent)
            try:
                with _spans.span(self.tracer, "supervisor.resume",
                                 "checkpoint"):
                    # churn and SLO payloads hold leaves whose axis 0 is
                    # runtime state: dtype and rank still gate
                    payload, self.resumed_from = \
                        ckpt_mod.restore_pytree_rotating(
                            self.ckpt_dir, _payload_like(job, dev),
                            strict_shapes=job.churn is None
                            and not job.with_slo, device=dev)
            except ckpt_mod.CheckpointCorruptError:
                payload = None
        if payload is not None:
            self._resume(payload, workdir)
        self.mesh_ctrs = self.planes = self.pm = None
        self.mesh_fallbacks = self.mesh_chaos_fallbacks = 0
        if job.engine_loop == "mesh":
            from ..parallel import mesh as mesh_mod

            if payload is not None:
                self.mesh_ctrs = tuple(
                    torch.from_numpy(np.ascontiguousarray(
                        payload[k], dtype=np.int64)).to(dev)
                    for k in _MESH_KEYS)
            else:
                # per-slot counters follow the slot layout: a churn
                # job's start at the spec's capacity0
                n0 = int(job.churn["capacity0"]) \
                    if job.churn is not None else job.n
                self.mesh_ctrs = mesh_mod.counter_init(job.n_shards, n0,
                                                       device=dev)
        self.plane = None
        if job.churn is not None and job.engine_loop == "mesh":
            self.pm = _placement_map(job, payload=payload)
            self.planes = _mesh_planes(job, tracer=self.tracer,
                                       payload=payload, pm=self.pm)
        elif job.churn is not None:
            from ..lifecycle.plane import LifecyclePlane
            self.plane = LifecyclePlane.load(
                payload, job.churn, workdir=workdir,
                tracer=self.tracer) if payload is not None \
                else LifecyclePlane(job.churn, workdir=workdir,
                                    tracer=self.tracer)
        self._slo_init(payload)
        if self.ctl is not None:
            # delta baselines pinned to the restored accumulators: the
            # previous boundary's snapshot is what the killed
            # incarnation's controller last observed
            from ..control import publish_controller
            from ..obs.registry import default_registry

            self.ctl.observe_baseline(met=self.met, slo_eval=self.slo_eval)
            publish_controller(default_registry(), self.ctl)
        self.scr = _ScrapeCtl(job.metrics_port, self.start_epoch,
                              self._on_bind())
        self.base_cfg = {"select_impl": job.select_impl,
                         "tag_width": job.tag_width,
                         "calendar_impl": job.calendar_impl}

    def _resume(self, payload: dict, workdir: str) -> None:
        from ..obs import flight as obsflight
        from ..obs import provenance as obsprov

        job, dev = self.job, self.dev
        # the durable resume journal: a restart that restored a
        # snapshot is a resume, one that replays from scratch is not
        with open(os.path.join(workdir, RESUME_LOG), "a") as fh:
            fh.write(f"{self.resumed_from}\n")
        self.state = payload["engine"]
        self.rng = _rng_from_array(payload["rng"])
        self.met = np.asarray(payload["metrics"], dtype=np.int64).copy()
        self.digest = np.asarray(payload["digest"],
                                 dtype=np.uint8).tobytes()
        self.start_epoch = int(payload["epoch"])
        self.decisions = int(payload["decisions"])
        self.ladder.load(payload["ladder"])
        if self.ctl is not None:
            # the applied cursor can only trail the journal, so loading
            # both re-arms the replay of journaled, unapplied decisions
            self.ctl.load(payload)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        if job.with_hists:
            self.hists = put(payload["tele_hists"])
        if job.with_ledger:
            self.ledger = put(payload["tele_ledger"])
        if job.flight_records:
            self.flight = obsflight.flight_from_arrays(
                payload["tele_flight_buf"], payload["tele_flight_seq"],
                payload["tele_flight_batch"], device=dev)
        if job.with_prov:
            self.prov = obsprov.prov_from_arrays(
                payload["prov_margin_hist"], payload["prov_scal"],
                payload["prov_last_served"], device=dev)

    def _slo_init(self, payload) -> None:
        """The SLO plane: window block, contract epochs and ring, and
        the burn-rate evaluator.  Rolls happen on the ckpt_every grid
        only, in bare and supervised runs alike."""
        job = self.job
        self.slo_block = self.slo_plane = self.slo_eval = None
        self.slo_w0 = self.start_epoch
        if not job.with_slo:
            return
        from ..obs.alerts import SloEvaluator

        if payload is not None:
            self.slo_block = torch.from_numpy(
                np.ascontiguousarray(payload["slo_window"])).to(self.dev)
            self.slo_plane = obsslo.SloPlane.load(
                payload, capacity=int(self.slo_block.shape[-2]),
                dt_epoch_ns=job.dt_epoch_ns,
                ring_depth=max(job.slo_ring, 1))
            self.slo_eval = SloEvaluator(self.slo_plane)
            self.slo_eval.load(payload)
        else:
            n0 = int(job.churn["capacity0"]) if job.churn is not None \
                else job.n
            self.slo_plane = obsslo.SloPlane(
                n0, dt_epoch_ns=job.dt_epoch_ns, ring_depth=job.slo_ring)
            self.slo_block = obsslo.window_zero(n0, self.dev)
            if job.churn is None:
                # closed population: every slot a client with a fixed
                # contract, registered once from the device's rates (a
                # mesh job reads shard 0: every partition shares one
                # contract layout, and the rolled table sums the S
                # like-contracted clients of a slot)
                st = self.state
                if job.engine_loop == "mesh":
                    from ..parallel import mesh as mesh_mod
                    st = mesh_mod.unstack_shard(st)
                self.slo_plane.register_from_inv(
                    st.resv_inv, st.weight_inv, st.limit_inv)
                self.slo_block = self.slo_plane.stamp(self.slo_block)
            if job.engine_loop == "mesh":
                from ..parallel import mesh as mesh_mod
                self.slo_block = mesh_mod.stack_shards(self.slo_block,
                                                       job.n_shards)
            self.slo_eval = SloEvaluator(self.slo_plane)
        if self.plane is not None:
            self.plane.attach_slo(self.slo_plane)

    def _on_bind(self):
        plane, slo_plane, slo_eval = self.plane, self.slo_plane, \
            self.slo_eval
        if plane is None and slo_eval is None:
            return None

        def on_bind(server):
            # the admin API and the SLO view ride the run's scrape
            # endpoint, re-mounted on every rebind; accepted admin ops
            # are WAL-fsynced, so a kill between accept and the boundary
            # still applies them exactly once
            if plane is not None:
                from ..lifecycle.api import mount_admin_api
                mount_admin_api(server, plane, slo=slo_plane)
            if slo_eval is not None:
                from ..obs.alerts import mount_slo_api
                mount_slo_api(server, slo_eval)
        return on_bind

    # -- shared per-epoch and per-boundary steps -----------------------
    def boundary(self, epoch: int) -> None:
        """The lifecycle boundary at ``epoch`` (on the ckpt_every grid):
        registrations, QoS updates, evictions and compaction apply
        before the window they precede."""
        from ..obs import spans as _spans

        with _spans.span(self.tracer, "lifecycle.boundary", "host_prep",
                         epoch=epoch):
            self.state, self.ledger, self.slo_block, self.prov = \
                _boundary_with_prov(self.plane, self.state, epoch,
                                    self.job.ckpt_every, self.ledger,
                                    self.slo_block, self.prov)

    def take_tele(self, ep) -> None:
        job = self.job
        if job.with_hists:
            self.hists = ep.hists
        if job.with_ledger:
            self.ledger = ep.ledger
        if job.flight_records:
            self.flight = ep.flight
        if job.with_prov:
            self.prov = ep.prov
        if job.with_slo:
            self.slo_block = ep.slo

    def drain_epoch(self, results, count: int, cfg: dict,
                    guard_trips: int) -> None:
        """One epoch's bookkeeping, in both loops' order: decisions,
        chain digest (client-id-space views for churn), metric fold,
        ladder note, the plan's kill points."""
        from ..obs import device as obsdev

        self.decisions += count
        self.digest = digest_update(
            self.digest, self.plane.canon_results(results)
            if self.plane is not None else results)
        for r in results:
            if getattr(r, "metrics", None) is not None:
                self.met = obsdev.metrics_combine_np(self.met, r.metrics)
        self.met[obsdev.MET_LADDER_STEPS] += self.ladder.note_epoch(
            cfg, guard_trips=guard_trips)
        if self.injector is not None:
            self.injector.after_decisions(self.decisions)

    def guarded(self, launch):
        """``launch(cfg)`` under the ladder: retries exhausted inside
        the guarded runner step a rung down and re-attempt (each failed
        attempt counts toward the threshold); with nothing left to
        concede, or the ladder off, the error surfaces to the restart
        loop.  Returns ``(result, cfg)``."""
        from ..obs import device as obsdev

        while True:
            cfg = self.ladder.apply(self.ctl.overlay(self.base_cfg)
                                    if self.ctl is not None
                                    else self.base_cfg)
            try:
                return launch(cfg), cfg
            except RECOVERABLE_ERRORS:
                if not self.ladder.can_step(cfg):
                    raise
                self.met[obsdev.MET_LADDER_STEPS] += \
                    self.ladder.note_epoch(cfg, launch_failures=1)

    def slo_roll(self, e1: int):
        """Close the window ending at boundary ``e1`` and judge it;
        returns the rows to flush after the checkpoint commits."""
        cid_of_slot = self.plane.slots.cid_of_slot \
            if self.plane is not None else None
        self.slo_block, closed = self.slo_plane.roll(
            self.slo_block, self.slo_w0, e1, cid_of_slot=cid_of_slot,
            depth=self.state.depth)
        self.slo_w0 = e1
        self.slo_eval.observe_roll(closed)
        return closed

    def clamp(self, counts):
        """The controller's admission clamp on drawn counts (after the
        draw, so the RNG's consumption never depends on the knob)."""
        if self.ctl is None or counts is None:
            return counts
        return self.ctl.clamp_counts(counts, self.job.waves)

    def control(self, b: int, press=None) -> list:
        """The controller boundary at ``b``, before the snapshot: one
        signal snapshot, the policy's decisions journaled (fsync before
        apply; a resumed run replays them), then the ``compact``
        actuation.  Returns the rules that fired."""
        planes = self.planes if self.planes is not None \
            else (None if self.plane is None else [self.plane])
        sig = self.ctl.collect(b, state=self.state, met=self.met,
                               slo_eval=self.slo_eval, prov=self.prov,
                               planes=planes, press=press)
        fired = self.ctl.step(b, sig, fault=None if self.injector is None
                              else self.injector.controller_point)
        if "compact" in fired and self.plane is not None:
            self.state, self.ledger, self.slo_block, self.prov = \
                _ctl_compact(self.plane, self.state, self.ledger,
                             self.slo_block, self.prov, b)
        return fired

    def save(self, epoch: int, plan_epoch: int, rng) -> None:
        """The checkpoint at boundary ``epoch`` (the plan's save points
        are keyed by ``plan_epoch``, the epoch that ends there)."""
        from ..obs import spans as _spans

        job = self.job
        with _spans.span(self.tracer, "supervisor.checkpoint_save",
                         "checkpoint", epoch=epoch):
            # a grouped mesh saves its stacks gathered: the same
            # [S, ...] leaves, byte for byte, whatever the layout
            g = _gathered(self)
            payload = _payload(
                job, g["state"], rng, self.met, self.digest, epoch,
                self.decisions, self.ladder.encode(), hists=g["hists"],
                ledger=g["ledger"], flight=g["flight"], prov=g["prov"],
                plane=self.planes if self.planes is not None
                else self.plane,
                slo=None if self.slo_plane is None
                else (g["slo_block"], self.slo_plane, self.slo_eval),
                mesh=g["mesh_ctrs"], pm=self.pm, ctl=self.ctl)

            def save():
                return ckpt_mod.save_pytree_rotating(
                    self.ckpt_dir, payload, keep=job.keep)

            if self.injector is not None:
                self.injector.around_save(plan_epoch, save)
            else:
                save()

    def flush_spans(self) -> None:
        if self.tracer is not None:
            self.tracer.drain_jsonl(self.job.span_log)

    def result(self) -> SupervisedResult:
        job = self.job
        g = _gathered(self)
        state, hists, ledger, prov, flight, slo_block = (
            g["state"], g["hists"], g["ledger"], g["prov"], g["flight"],
            g["slo_block"])
        kw = {}
        if self.ctl is not None:
            kw.update(controller_decisions=int(self.ctl.applied),
                      controller_replays=int(self.ctl.replays),
                      controller_knobs=[int(k) for k in self.ctl.knobs],
                      controller_trajectory=self.ctl.trajectory())
        if self.pm is not None:
            kw.update(placement=self.pm.mode,
                      migrations=int(self.pm.counters["migrations"]),
                      migration_log=self.pm.move_log(),
                      placement_counters={
                          k: int(v) for k, v in self.pm.counters.items()})
        if self.mesh_ctrs is not None and job.n_shards == 1:
            # S=1 canonical form: a 1-shard mesh is a single engine, so
            # the result drops the unit shard axis and compares like
            # for like with the round and stream loops
            from ..parallel import mesh as mesh_mod

            state = mesh_mod.unstack_shard(state)
            hists = None if hists is None else hists[0]
            ledger = None if ledger is None else ledger[0]
            prov = None if prov is None else mesh_mod.unstack_shard(prov)
            flight = None if flight is None \
                else mesh_mod.unstack_shard(flight)
            slo_block = None if slo_block is None else slo_block[0]
        elif self.mesh_ctrs is not None and flight is not None:
            # S > 1: the per-shard rings merged in shard order
            from ..obs import flight as obsflight

            buf, seq = obsflight.flight_merge_stacked(flight)
            flight = obsflight.FlightState(
                buf=buf, seq=seq, batch=int(_host64(flight.batch).sum()))
        if self.mesh_ctrs is not None:
            cd, cr, vd, vr = (_host64(x) for x in g["mesh_ctrs"])
            kw.update(mesh_counters=np.stack([cd, cr]),
                      mesh_views=np.stack([vd, vr]),
                      mesh_fallbacks=self.mesh_fallbacks,
                      mesh_chaos_fallbacks=self.mesh_chaos_fallbacks)
        if prov is not None:
            kw.update(prov_margin_hist=_host64(prov.margin_hist),
                      prov_scal=_host64(prov.scal),
                      prov_last_served=_host64(prov.last_served))
        if self.slo_plane is not None:
            enc = self.slo_plane.encode()
            kw.update(slo_window=_host64(slo_block),
                      slo_ring=enc["slo_ring"],
                      slo_cepoch=enc["slo_cepoch"],
                      slo=self.slo_eval.summary())
        if self.planes is not None:
            # one snapshot a shard, and the cluster's rollup
            shots = [p.snapshot() for p in self.planes]
            lifecycle = {
                "live_clients": sum(x["live_clients"] for x in shots),
                "peak_clients": sum(x["peak_clients"] for x in shots),
                "capacity": sum(x["capacity"] for x in shots),
                **{key: sum(x[key] for x in shots) for key in shots[0]
                   if key not in ("live_clients", "peak_clients",
                                  "capacity", "pending_ops")},
                "pending_ops": sum(x["pending_ops"] for x in shots),
                "shards": shots}
        else:
            lifecycle = self.plane.snapshot() if self.plane is not None \
                else None
        return SupervisedResult(
            **kw,
            lifecycle=lifecycle,
            digest=hashlib.sha256(self.digest).hexdigest(),
            state_digest=ckpt_mod.tree_digest(state),
            decisions=self.decisions, epochs=job.epochs,
            metrics=self.met, restarts=0,
            ladder_steps=self.ladder.describe(),
            scrape_rebinds=self.scr.rebinds,
            resumed_from=self.resumed_from,
            hists=None if hists is None else _host64(hists),
            ledger=None if ledger is None else _host64(ledger),
            flight_buf=None if flight is None else _host64(flight.buf),
            flight_seq=0 if flight is None else int(flight.seq),
            stream_fallbacks=self.stream_fallbacks)


# the run's per-shard stacks, which a grouped mesh lays out by group
_RUN_STACKS = ("state", "hists", "ledger", "flight", "prov", "slo_block",
               "mesh_ctrs")


def _gathered(run: "_Run") -> dict:
    """The run's stacks as single ``[S, ...]`` stacks (gathered onto the
    first group's device where grouped; as they are otherwise)."""
    from ..parallel import groups

    return {k: groups.gather(getattr(run, k, None)) for k in _RUN_STACKS}


def _regroup(run: "_Run", devices) -> None:
    """Lay the run's stacks out over ``devices`` (one device gathers
    them)."""
    from ..parallel import groups

    for k in _RUN_STACKS:
        v = getattr(run, k)
        if k == "mesh_ctrs" and v is not None:
            setattr(run, k, tuple(groups.place(x, devices) for x in v))
        else:
            setattr(run, k, groups.place(v, devices))


def _job_loop(job: EpochJob, workdir: Optional[str],
              injector: Optional[HostFaultInjector],
              device=DEFAULT_DEVICE,
              spawned_ns: Optional[int] = None) -> SupervisedResult:
    """Run the job to completion once (restore, epochs, result).
    ``workdir=None`` is the bare runner: no restore, no checkpoints, no
    injector, the uninterrupted reference of the gate.  ``spawned_ns``
    (a spawn child's) is the parent's ``time.time_ns()`` at the spawn."""
    _check_job(job)
    run = _Run(job, workdir, injector, device, spawned_ns)
    try:
        if job.engine_loop == "mesh":
            _mesh_epochs(run)
        elif job.engine_loop == "stream":
            _stream_epochs(run)
        else:
            _round_epochs(run)
    except BaseException:
        _crash_dump(job, run.flight)
        raise
    finally:
        run.scr.close()
    run.flush_spans()    # a resume past the last epoch records only
    #                      its resume span
    return run.result()


def _round_epochs(run: _Run) -> None:
    """The round loop: per epoch, the lifecycle boundary on the grid,
    the host-clamped superwave ingest, one guarded epoch, the drain; an
    SLO roll and a checkpoint at each boundary."""
    from ..engine import stream as stream_mod
    from ..lifecycle import churn as churn_mod
    from ..obs import spans as _spans

    job, dev, plane = run.job, run.dev, run.plane
    ingest = _jit_ingest(job) if plane is None and job.arrival_lam > 0 \
        else None
    for epoch in range(run.start_epoch, job.epochs):
        # the epoch span stays open across a crash: the tracer dies with
        # the incarnation and the flushed stream keeps completed epochs
        ep_span = _spans.span(run.tracer, "supervisor.epoch",
                              "host_prep", epoch=epoch)
        ep_span.__enter__()
        run.scr.tick(epoch, run.injector)
        if plane is not None and epoch % job.ckpt_every == 0:
            run.boundary(epoch)
        t_base = epoch * job.dt_epoch_ns
        if plane is not None:
            with _spans.span(run.tracer, "supervisor.ingest", "ingest"):
                raw = run.rng.poisson(churn_mod.lam_vector(
                    job.churn, epoch)).astype(np.int32)
                counts = torch.from_numpy(
                    run.clamp(plane.map_counts(raw))).to(dev)
                run.state = stream_mod.jit_ingest_step(
                    dt_epoch_ns=job.dt_epoch_ns, waves=job.waves)(
                        run.state, counts, t_base)
        elif ingest is not None:
            # the host clamps to the headroom (one read of the depth, as
            # in the JAX loop); the ingest is a captured program
            with _spans.span(run.tracer, "supervisor.ingest", "ingest"):
                headroom = job.ring - run.state.depth.cpu().numpy() \
                    .astype(np.int64)
                counts = run.clamp(np.minimum(
                    run.rng.poisson(job.arrival_lam, job.n),
                    np.minimum(headroom, job.waves)).astype(np.int32))
                run.state = ingest(run.state,
                                   torch.from_numpy(counts).to(dev), t_base)

        def launch(cfg, t=t_base + job.dt_epoch_ns):
            return run_epoch_guarded(
                run.state, t, engine=job.engine, m=job.m, k=job.k,
                chain_depth=job.chain_depth, with_metrics=True,
                select_impl=cfg["select_impl"],
                tag_width=cfg["tag_width"],
                calendar_impl=cfg["calendar_impl"],
                ladder_levels=job.ladder_levels, hists=run.hists,
                ledger=run.ledger, flight=run.flight, slo=run.slo_block,
                prov=run.prov, tracer=run.tracer)

        ep, cfg = run.guarded(launch)
        run.state = ep.state
        run.take_tele(ep)
        with _spans.span(run.tracer, "supervisor.digest", "drain"):
            run.drain_epoch(ep.results, ep.count, cfg,
                            ep.rebase_fallbacks + ep.serial_fallbacks)
        at_boundary = ((epoch + 1) % job.ckpt_every == 0
                       or epoch + 1 == job.epochs)
        closed = None
        if run.slo_plane is not None and at_boundary:
            # before the snapshot: the saved block is a fresh window
            closed = run.slo_roll(epoch + 1)
        if run.ctl is not None and at_boundary:
            run.control(epoch + 1)
        if run.ckpt_dir is not None and at_boundary:
            run.save(epoch + 1, epoch, run.rng)
            ep_span.__exit__(None, None, None)
            # spans and judged windows flush only right after a snapshot
            # commits: what is flushed is what a resume never replays
            run.flush_spans()
            _slo_log_flush(run.slo_plane, job.slo_log, closed)
        else:
            ep_span.__exit__(None, None, None)
            if run.ckpt_dir is None:
                # the bare runner never replays: per-epoch flushes
                _slo_log_flush(run.slo_plane, job.slo_log, closed)
                run.flush_spans()


def _stream_epochs(run: _Run) -> None:
    """The stream loop: one fused chunk per checkpoint interval, the
    host drawing chunk T+1's arrivals while the card runs chunk T, the
    accumulated outputs drained only at the boundary.

    The RNG state a boundary's snapshot carries is the one taken right
    after that chunk's own draws: the double buffer's lookahead stays
    out of the persisted state, so a resume re-draws it bit for bit.
    The drain runs the round loop's per-epoch bookkeeping over the
    chunk's rows, in epoch order."""
    from ..engine import stream as stream_mod
    from ..obs import spans as _spans
    from .guarded import run_stream_chunk_guarded

    job, plane, tracer = run.job, run.plane, run.tracer
    do_ingest = job.arrival_lam > 0 or plane is not None

    def draw(e0: int, e1: int):
        with _spans.span(tracer, "stream.pregen", "host_prep"):
            return _draw_counts_churn(run.rng, job.churn, e0, e1) \
                if plane is not None \
                else _draw_counts(run.rng, job, e1 - e0)

    counts = None
    if do_ingest and run.start_epoch < job.epochs:
        counts = draw(*next(stream_mod.chunk_bounds(
            run.start_epoch, job.epochs, job.ckpt_every)))
    rng_ckpt = _rng_state_array(run.rng)
    for e0, b in stream_mod.chunk_bounds(run.start_epoch, job.epochs,
                                         job.ckpt_every):
        # bind the endpoint before the launch (a chunk can run for
        # seconds); the drain's ticks below only honor port-loss points
        run.scr.tick(e0, run.injector)
        if plane is not None:
            # e0 is on the ckpt_every grid: the boundary settles the slot
            # layout, then the id-space draws map onto it
            run.boundary(e0)
            counts_dev = plane.map_counts(counts)
        else:
            counts_dev = counts
        # the whole chunk admits under the knob set at its starting
        # boundary: the round loop's per-epoch clamp, since the knob
        # moves only on the chunk grid
        counts_dev = run.clamp(counts_dev)
        nxt: dict = {}

        def overlap(b=b):
            # idempotent: a retried launch must not re-advance the RNG
            if "rng" in nxt:
                return
            if do_ingest and b < job.epochs:
                nxt["counts"] = draw(*next(stream_mod.chunk_bounds(
                    b, job.epochs, job.ckpt_every)))
            nxt["rng"] = _rng_state_array(run.rng)

        def launch(cfg, e0=e0, b=b, counts_dev=counts_dev,
                   overlap=overlap):
            return run_stream_chunk_guarded(
                run.state, e0, counts_dev, engine=job.engine,
                epochs=b - e0, m=job.m, k=job.k,
                chain_depth=job.chain_depth, dt_epoch_ns=job.dt_epoch_ns,
                waves=job.waves, with_metrics=True,
                select_impl=cfg["select_impl"],
                tag_width=cfg["tag_width"],
                calendar_impl=cfg["calendar_impl"],
                ladder_levels=job.ladder_levels, hists=run.hists,
                ledger=run.ledger, flight=run.flight, slo=run.slo_block,
                prov=run.prov, tracer=tracer, overlap=overlap)

        g, cfg = run.guarded(launch)
        if "rng" not in nxt:
            overlap()     # every dispatch attempt failed fast
        run.state = g.state
        run.take_tele(g)
        run.stream_fallbacks += g.stream_fallback
        with _spans.span(tracer, "stream.drain", "drain", chunk=b - e0):
            for i in range(b - e0):
                run.scr.tick(e0 + i, run.injector)
                run.drain_epoch(g.epochs[i], g.counts[i], cfg,
                                g.guard_trips[i])
        _spans.instant(tracer, "stream.heartbeat", "drain", epoch=b)
        closed = None
        if run.slo_plane is not None:
            closed = run.slo_roll(b)   # b is on the window grid
        if run.ctl is not None:
            run.control(b)             # b is a controller boundary
        if run.ckpt_dir is not None:
            run.save(b, b - 1, rng_ckpt)
        # after the snapshot commits (or every chunk, bare)
        run.flush_spans()
        _slo_log_flush(run.slo_plane, job.slo_log, closed)
        counts = nxt.get("counts")
        rng_ckpt = nxt["rng"]


def _draw_counts_mesh(rng: np.random.Generator, job: EpochJob,
                      epochs: int) -> np.ndarray:
    """Raw per-epoch per-shard Poisson draws ``int32[S, epochs, N]``.
    Drawn epoch-major, ``(S, N)`` an epoch: at S=1 the generator yields
    the stream loop's :func:`_draw_counts` variates (numpy fills C
    order), so the S=1 mesh digest equals the stream digest arrival
    stream included."""
    draws = np.stack([rng.poisson(job.arrival_lam, (job.n_shards, job.n))
                      .astype(np.int32) for _ in range(epochs)])
    return np.swapaxes(draws, 0, 1)


def _mesh_boundary(job: EpochJob, planes, state, ledger, ctrs, b: int,
                   mesh, prov=None, pm=None, up=None):
    """One mesh churn job's lifecycle boundary: every shard's plane
    applies its own due ops to its own slice, the counter plane's
    ``cd``/``cr`` (fill 0) and held views (fill 1) and the provenance
    watermark (fill 0) riding each shard's grow/evict/compact transforms
    as boundary extras; then every shard grows to the largest capacity,
    so the stacked layout stays rectangular, and the slices restack (a
    copy).

    With a placement map ``pm`` the p2c routing pass runs first: every
    registration due here -- last boundary's deferrals first, then this
    cohort in ascending id order -- gets its shard against the current
    per-shard backlog and the boundary's liveness row ``up`` before any
    plane filters its due ops.  A deferral placed now re-enters as a
    pending op of its shard's plane (its scripted event fired at the
    earlier boundary).  Each shard's boundary runs on its group's device
    of ``mesh`` and the slices restack by its layout.
    Returns ``(state, ledger, ctrs, prov)``."""
    from ..lifecycle import churn as churn_mod
    from ..parallel.cluster import restack_shards, shard_view

    S = job.n_shards
    if pm is not None:
        deferred = pm.take_deferred()
        if job.churn.get("static") and b == 0:
            due = list(range(int(job.churn["total_ids"])))
        else:
            due = [int(e["cid"]) for e in churn_mod.events(
                job.churn, b, job.ckpt_every) if e["op"] == "register"]
        cohort = [cid for cid in due if pm.shard_of(cid) < 0]
        if deferred or cohort:
            backlog = _host64(state.depth).sum(axis=-1)
            placed = pm.place_batch(deferred + cohort, backlog=backlog,
                                    up=up)
            for cid in placed:
                if cid in deferred:
                    r, w, l = churn_mod.init_qos(job.churn, cid)
                    planes[pm.shard_of(cid)].pending.append(
                        {"op": "register", "cid": cid, "r": r, "w": w,
                         "l": l, "apply_at": b})
    sts, leds, exs = [], [], []
    for s in range(S):
        extras = [(shard_view(c, s), fill)
                  for c, fill in zip(ctrs, (0, 0, 1, 1))]
        if prov is not None:
            extras.append((shard_view(prov.last_served, s), 0))
        st_s, led_s, extras = planes[s].boundary(
            shard_view(state, s), b, job.ckpt_every,
            ledger=shard_view(ledger, s), extras=extras)
        sts.append(st_s)
        leds.append(led_s)
        exs.append(extras)
    cap = max(int(st.capacity) for st in sts)
    for s in range(S):
        out = planes[s].ensure_capacity(cap, sts[s], ledger=leds[s],
                                        extras=exs[s])
        sts[s], leds[s], exs[s] = out[0], out[1], out[-1]
    state = restack_shards(sts, mesh)
    ledger = None if ledger is None else restack_shards(leds, mesh)
    ctrs = tuple(restack_shards([exs[s][j][0] for s in range(S)], mesh)
                 for j in range(4))
    if prov is not None:
        prov = prov._replace(last_served=restack_shards(
            [exs[s][4][0] for s in range(S)], mesh))
    return state, ledger, ctrs, prov


def _mesh_migrate(run: _Run, b: int, up=None, press=None) -> None:
    """The controller's ``migrate`` actuation: move up to
    ``migrate_max`` drained clients off the hottest live shard as the
    existing digest-neutral lifecycle ops -- EVICT on the source (its
    final ledger row folded into the departed report first), REGISTER on
    the destination with the carried counter views (``cd``/``cr``
    completions, ``vd``/``vr`` held views) and the provenance
    ``last_served`` watermark installed at the destination slot.

    The trigger is journaled, the destinations draw from the
    checkpointed placement RNG and the candidate order is a pure
    function of the boundary's state, so a kill at any stage of evict
    -> handoff -> register (the ``placement._migrate_hook`` seam)
    replays the same moves from the previous checkpoint.  Runs after
    the controller boundary and before the checkpoint save.

    The JAX package unstacks the shards and restacks them; here the
    moved rows are written in place on the shard views of the stacked
    tensors (one stack, or one a device group), each on its shard's own
    device, and only a destination's slot growth reallocates the stacks:
    every shard of every group grows to one capacity together.  That is
    safe because each stack is a fresh one made by the chunk (fused or
    host-replayed), the boundary or the restore, which nothing else
    holds (the last snapshot was copied to the host when it was saved);
    the one value read before a reset, the carried riders, is copied to
    the host first and written at the destination shard's device.  The
    boundary depth is the host copy the controller's ``collect`` read at
    ``b`` (nothing has moved since), so only ``cd`` is copied here."""
    from ..lifecycle import placement as placement_mod
    from ..lifecycle.plane import LC_EVICT, LC_NOP, _pad_len, \
        apply_op_vector
    from ..parallel import groups

    job, pm, ctl, planes = run.job, run.pm, run.ctl, run.planes
    S = job.n_shards
    cd, cr, vd, vr = run.mesh_ctrs
    read_at, depth = ctl.boundary_depth
    if read_at != b or depth is None:
        raise RuntimeError(f"migrate at boundary {b} without the "
                           f"controller's depth read there ({read_at})")
    depth = depth.reshape(S, -1)
    cd_host = groups.host(cd).reshape(S, -1)
    backlog = depth.sum(axis=-1)
    # source: the hottest live shard (a down shard has no pressure to
    # shed; its rows stay put until it returns)
    eligible = np.asarray(
        [int(backlog[s]) if (up is None or bool(up[s])) else -1
         for s in range(S)], dtype=np.int64)
    src = int(np.argmax(eligible))
    if eligible[src] <= 0:
        # the boundary depth is zero on calendar engines (deadline
        # commits drain within the epoch): fall back to the chunk's
        # mid-epoch pressure peaks, the signal that armed the rule
        if press is None:
            return
        from ..obs import provenance as obsprov

        peaks = np.asarray(press, dtype=np.int64)[:, obsprov.PRESS_BACKLOG]
        eligible = np.asarray(
            [int(peaks[s]) if (up is None or bool(up[s])) else -1
             for s in range(S)], dtype=np.int64)
        src = int(np.argmax(eligible))
        if eligible[src] <= 0:
            return
    plane_src = planes[src]
    pick = ctl.migrate_pick()
    keyed = []
    for cid in sorted(plane_src.slots.slot_of):
        slot = plane_src.slots.slot_of[cid]
        # only drained clients move: no queued ops to carry, so the
        # whole handoff is counter state and the contract
        if depth[src, slot] != 0:
            continue
        served = int(cd_host[src, slot])
        if pick == "cold" and served == 0:
            keyed.append((0, cid))          # quiet since start
        elif pick != "cold" and served > 0:
            keyed.append((-served, cid))    # largest demand first
    moves = pm.plan_moves(b, src=src,
                          candidates=[cid for _k, cid in sorted(keyed)],
                          backlog=backlog, up=up,
                          max_moves=ctl.migrate_batch())
    if not moves:
        return

    riders = [cd, cr, vd, vr] + (
        [run.prov.last_served] if run.prov is not None else [])
    fills = (0, 0, 1, 1, 0)
    ledger = run.ledger
    # source half: fold the final ledger rows and release the slots,
    # read the carried riders, then EVICT on the source shard's device
    handoff, slots_out = [], []
    for cid, dst in moves:
        out = plane_src.migrate_out(cid, groups.view(ledger, src))
        if out is None:
            continue
        slot, qos = out
        slots_out.append(slot)
        handoff.append((cid, dst, qos))
    carried = {}
    if slots_out:
        vals = torch.stack([groups.read_rows(r, src, slots_out)
                            for r in riders]).cpu().numpy()
        for j, (cid, _dst, _qos) in enumerate(handoff):
            carried[cid] = [int(v) for v in vals[:, j]]
        pad = _pad_len(len(slots_out))
        arr = np.asarray([(LC_EVICT, sl, 0, 0, 0, 0) for sl in slots_out]
                         + [(LC_NOP, 0, 0, 0, 0, 0)]
                         * (pad - len(slots_out)), dtype=np.int64)
        apply_op_vector(groups.view(run.state, src), *arr.T, inplace=True)
        if ledger is not None:
            groups.fill_rows(ledger, src, slots_out, 0)
        for r, f in zip(riders, fills):
            groups.fill_rows(r, src, slots_out, f)
    if placement_mod._migrate_hook is not None:
        placement_mod._migrate_hook("evicted")

    # destination half: REGISTER with the carried QoS contract
    reg_rows: dict = {s: [] for s in range(S)}
    for cid, dst, qos in handoff:
        reg_rows[dst] += planes[dst].migrate_in(cid, qos)
    if placement_mod._migrate_hook is not None:
        placement_mod._migrate_hook("handoff")

    cap = max(int(p.slots.capacity) for p in planes)
    if cap > groups.view(run.state, 0).capacity:
        # a destination grew: every shard of every group grows to one
        # rectangle, which reallocates the stacks (the one restack this
        # actuation makes)
        def grow(s, st, led, *rs):
            out = planes[s].ensure_capacity(
                cap, st, ledger=led,
                extras=[(r, f) for r, f in zip(rs, fills)])
            return (out[0], out[1]) + tuple(x for x, _f in out[-1])

        run.state, ledger, *riders = groups.rebuild(
            grow, [run.state, ledger] + riders)
    for s in range(S):
        rows = reg_rows[s]
        if not rows:
            continue
        rows = list(rows) + [(LC_NOP, 0, 0, 0, 0, 0)] \
            * (_pad_len(len(rows)) - len(rows))
        arr = np.asarray(rows, dtype=np.int64)
        apply_op_vector(groups.view(run.state, s), *arr.T, inplace=True)
    # install the carried riders at the destination slots, a shard at a
    # time on its device: the counter views arrive with the client, and
    # the last_served watermark keeps its starvation clock across the
    # move
    by_dst: dict = {}
    for cid, dst, _qos in handoff:
        by_dst.setdefault(dst, []).append(cid)
    for dst, cids in sorted(by_dst.items()):
        at = [planes[dst].slots.slot_of[cid] for cid in cids]
        vals = np.asarray([carried[cid] for cid in cids], dtype=np.int64)
        for j, r in enumerate(riders):
            groups.write_rows(r, dst, at, vals[:, j])
    if placement_mod._migrate_hook is not None:
        placement_mod._migrate_hook("registered")

    run.ledger = ledger
    run.mesh_ctrs = tuple(riders[:4])
    if run.prov is not None:
        run.prov = run.prov._replace(last_served=riders[4])


def _mesh_epochs(run: _Run) -> None:
    """The mesh loop: ``n_shards`` engines stacked on the card advance a
    whole checkpoint interval in one fused mesh chunk, the delta/rho
    views exchanged on the global ``counter_sync_every`` grid and the
    per-shard SLO blocks merged into one cluster-wide table that the SLO
    plane rolls.

    - ``fault_plan`` samples a ``FaultPlan`` over (epochs, shards), and
      each chunk runs its slice; a chunk that trips a guard replays the
      same schedule on the host loop (``mesh_chaos_fallbacks``).
    - mesh churn runs every shard's lifecycle boundary before the chunk,
      on the chunk grid; one id-space draw an epoch is mapped onto each
      shard's post-boundary slot layout, and the digest hashes each
      shard's results through that shard's canonical slot->cid view.
    - the chunk's draws are taken right before the launch and the
      snapshot carries the RNG as it is after them; the counter plane
      rides the snapshots, and the fault plan is recomputed from its
      spec.  The drain is the stream loop's, so S=1 equals it bit for
      bit."""
    from ..engine import stream as stream_mod
    from ..obs import spans as _spans
    from ..parallel import mesh as mesh_mod
    from .faults import parse_fault_spec, plan_chunk, plan_from_spec
    from .guarded import run_mesh_chunk_guarded

    job, planes, tracer = run.job, run.planes, run.tracer
    if job.devices is None:
        mesh = mesh_mod.make_mesh(job.n_shards, run.dev)
    else:
        mesh = mesh_mod.make_mesh(job.n_shards, devices=job.devices)
    if mesh.grouped:
        # the build or the restore made single stacks: one a group now
        _regroup(run, mesh.devices)
    plan = None
    if job.fault_plan is not None:
        plan = plan_from_spec(parse_fault_spec(job.fault_plan),
                              job.epochs, job.n_shards)
    do_ingest = job.arrival_lam > 0 or planes is not None
    for e0, b in stream_mod.chunk_bounds(run.start_epoch, job.epochs,
                                         job.ckpt_every):
        run.scr.tick(e0, run.injector)
        up_row = None if plan is None \
            else plan.up[min(e0, plan.up.shape[0] - 1)]
        if planes is not None:
            with _spans.span(tracer, "lifecycle.boundary", "host_prep",
                             epoch=e0):
                run.state, run.ledger, run.mesh_ctrs, run.prov = \
                    _mesh_boundary(job, planes, run.state, run.ledger,
                                   run.mesh_ctrs, e0, mesh, run.prov,
                                   pm=run.pm, up=up_row)
        counts = None
        if do_ingest:
            with _spans.span(tracer, "mesh.pregen", "host_prep"):
                if planes is not None:
                    raw = _draw_counts_churn(run.rng, job.churn, e0, b)
                    counts = np.stack([pl.map_counts(raw)
                                       for pl in planes])
                else:
                    counts = _draw_counts_mesh(run.rng, job, b - e0)
                counts = run.clamp(counts)
        rng_ckpt = _rng_state_array(run.rng)
        faults = plan_chunk(plan, e0, b) if plan is not None else None

        def launch(cfg, e0=e0, b=b, counts=counts, faults=faults):
            cd, cr, vd, vr = run.mesh_ctrs
            return run_mesh_chunk_guarded(
                run.state, cd, cr, vd, vr, e0, counts, mesh=mesh,
                engine=job.engine, epochs=b - e0, m=job.m, k=job.k,
                chain_depth=job.chain_depth, dt_epoch_ns=job.dt_epoch_ns,
                waves=job.waves, with_metrics=True,
                select_impl=cfg["select_impl"],
                tag_width=cfg["tag_width"],
                calendar_impl=cfg["calendar_impl"],
                ladder_levels=job.ladder_levels,
                counter_sync_every=run.ctl.knob_sync()
                if run.ctl is not None else job.counter_sync_every,
                with_pressure=run.ctl is not None,
                hists=run.hists, ledger=run.ledger, slo=run.slo_block,
                prov=run.prov, flight=run.flight, faults=faults,
                tracer=tracer)

        g, cfg = run.guarded(launch)
        run.state = g.state
        run.mesh_ctrs = (g.cd, g.cr, g.view_d, g.view_r)
        run.take_tele(g)
        run.mesh_fallbacks += g.mesh_fallback
        if plan is not None:
            # the fallback carried the same fault schedule: on plan,
            # only slower
            run.mesh_chaos_fallbacks += g.mesh_fallback
        with _spans.span(tracer, "mesh.drain", "drain", chunk=b - e0,
                         shards=job.n_shards):
            for i in range(b - e0):
                run.scr.tick(e0 + i, run.injector)
                if planes is not None:
                    flat = tuple(r for s, grp in enumerate(g.epochs[i])
                                 for r in planes[s].canon_results(grp))
                else:
                    flat = tuple(r for grp in g.epochs[i] for r in grp)
                run.drain_epoch(flat, g.counts[i], cfg, g.guard_trips[i])
        _spans.instant(tracer, "mesh.heartbeat", "drain", epoch=b)
        closed = None
        if run.slo_plane is not None:
            # roll the cluster-wide merged table; the fresh stamped
            # block goes back to every shard.  The starvation backlog is
            # the cluster total (at S=1 the stream loop's depth)
            from ..parallel import groups

            merged, closed = run.slo_plane.roll(
                g.slo_merged, run.slo_w0, b,
                depth=groups.reduce(
                    run.state.depth, lambda a: a.to(torch.int64).sum(dim=0),
                    torch.add))
            run.slo_w0 = b
            run.slo_eval.observe_roll(closed)
            run.slo_block = mesh_mod.stack_shards(merged, job.n_shards,
                                                  mesh)
        if run.ctl is not None:
            # the cluster-level controller boundary: backlog is the
            # cluster's depth, press_backlog the hottest shard's, and
            # the chunk's mid-epoch pressure peaks arm the migrate rule
            # on calendar engines; a fired migrate moves drained
            # clients off the hottest shard before the snapshot; on a
            # grouped layout both work group by group on the stacks
            if g.press is not None and run.scr.scrape is not None:
                try:
                    from ..obs import provenance as obsprov
                    obsprov.publish_shard_pressure(
                        run.scr.scrape.registry, g.press)
                except Exception:
                    pass
            fired = run.control(b, press=g.press)
            if "migrate" in fired and run.pm is not None:
                with _spans.span(tracer, "lifecycle.migrate", "host_prep",
                                 epoch=b):
                    up_b = None if plan is None \
                        else plan.up[min(b, plan.up.shape[0] - 1)]
                    _mesh_migrate(run, b, up=up_b, press=g.press)
        if run.ckpt_dir is not None:
            run.save(b, b - 1, rng_ckpt)
        run.flush_spans()
        _slo_log_flush(run.slo_plane, job.slo_log, closed)


def run_job(job: EpochJob, *, device=DEFAULT_DEVICE) -> SupervisedResult:
    """The bare runner: the uninterrupted, unsupervised reference.
    ``run_supervised(job, wd, zero_host_plan())`` is bit-identical to
    it."""
    return _job_loop(job, None, None, device)


# ----------------------------------------------------------------------
# the supervisor
# ----------------------------------------------------------------------

JOB_FILE = "job.json"
RESULT_FILE = "result.json"
RESUME_LOG = "resume.log"


class _ChildKilled(RuntimeError):
    """A spawn-mode child died (signal or nonzero exit) before writing
    its result."""


# what the restart loop treats as "the runner died": plan kills, a dead
# child (whatever killed it: a fresh process gets a fresh CUDA context)
# and a transient host error that outlived the retries and the ladder.
# A CUDA error in the trampoline is none of these: the context is sticky,
# so it propagates instead of looping.
_RESTART_ERRORS = (HostKill, _ChildKilled) + RECOVERABLE_ERRORS


def run_supervised(job: EpochJob, workdir,
                   plan: Optional[HostFaultPlan] = None, *,
                   mode: str = "trampoline", max_restarts: int = 8,
                   backoff_base_s: float = 0.01, backoff_max_s: float = 1.0,
                   sleep: Callable[[float], None] = _time.sleep,
                   device=DEFAULT_DEVICE) -> SupervisedResult:
    """Run ``job`` to completion under the supervisor, injecting ``plan``
    (None or empty = no host faults) and restarting a killed job with
    bounded exponential backoff until it completes or ``max_restarts``
    is spent (:class:`SupervisorGaveUp`).

    ``mode="trampoline"`` restarts in process (plan kills raise
    :class:`HostKill`); ``mode="spawn"`` runs each incarnation as
    ``python -m dmclock_tpu_torch.robust.supervisor <workdir>`` and plan
    kills are real ``SIGKILL``s.  ``workdir`` must be fresh per logical
    run: it holds the rotation, the fired-points journal and, in spawn
    mode, the job and result files."""
    if mode not in ("trampoline", "spawn"):
        raise ValueError(f"unknown supervisor mode {mode!r}")
    _check_job(job)
    dev = resolve_device(device)
    workdir = os.fspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    if mode == "spawn" and dev.type == "cuda":
        # build the kernels once here: a child killed during its own
        # nvcc run would spend a restart on the build
        from ..engine import _ext
        _ext.build()
    restarts = 0
    while True:
        try:
            if mode == "trampoline":
                injector = HostFaultInjector(plan, workdir,
                                             kill_mode="raise")
                result = _job_loop(job, workdir, injector, dev)
            else:
                result = _spawn_once(job, workdir, plan, dev)
            break
        except _RESTART_ERRORS as e:
            restarts += 1
            if restarts > max_restarts:
                raise SupervisorGaveUp(
                    f"{restarts - 1} restarts exhausted "
                    f"(last kill: {e})") from e
            sleep(min(backoff_base_s * (2.0 ** (restarts - 1)),
                      backoff_max_s))
    from ..obs import device as obsdev

    met = np.asarray(result.metrics, dtype=np.int64).copy()
    # restarts that restored a snapshot (the durable journal), not raw
    # restarts: a replay from scratch is not a resume
    resumes = 0
    resume_log = os.path.join(workdir, RESUME_LOG)
    if os.path.exists(resume_log):
        with open(resume_log) as fh:
            resumes = sum(1 for ln in fh if ln.strip())
    met[obsdev.MET_SUPERVISOR_RESUMES] = resumes
    return result._replace(metrics=met, restarts=restarts)


# result fields that travel through result.json as nested lists, and the
# column count an empty one is reshaped to
_JSON_ARRAYS = {"hists": None, "ledger": None, "flight_buf": None,
                "slo_window": obsslo.W_FIELDS,
                "slo_ring": obsslo.RING_COLS, "slo_cepoch": 2,
                "prov_margin_hist": None, "prov_scal": None,
                "prov_last_served": None, "mesh_counters": None,
                "mesh_views": None}
# plain result fields that travel through result.json as they are
_JSON_VALUES = ("flight_seq", "stream_fallbacks", "mesh_fallbacks",
                "mesh_chaos_fallbacks", "placement", "migrations",
                "migration_log", "placement_counters",
                "controller_decisions", "controller_replays",
                "controller_knobs", "controller_trajectory")


def _spawn_once(job: EpochJob, workdir: str,
                plan: Optional[HostFaultPlan],
                device: torch.device) -> SupervisedResult:
    """One child-process incarnation: write ``job.json`` (the job, the
    plan, the device and the spawn's wall time), run the child, read the
    result back.  A
    killed child leaves no result and raises :class:`_ChildKilled`."""
    job_path = os.path.join(workdir, JOB_FILE)
    res_path = os.path.join(workdir, RESULT_FILE)
    if os.path.exists(res_path):
        os.unlink(res_path)
    with open(job_path, "w") as fh:
        json.dump({"job": job.to_json(), "plan": plan_to_json(plan),
                   "device": str(device), "spawned_ns": _time.time_ns()},
                  fh)
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(
        [sys.executable, "-m", "dmclock_tpu_torch.robust.supervisor",
         workdir], env=env)
    if proc.returncode != 0 or not os.path.exists(res_path):
        raise _ChildKilled(f"child exited {proc.returncode} "
                           f"({describe_host(plan)})")
    with open(res_path) as fh:
        obj = json.load(fh)
    arrays = {}
    for key, cols in _JSON_ARRAYS.items():
        v = obj.get(key)
        a = None if v is None else np.asarray(v, dtype=np.int64)
        if a is not None and cols is not None and \
                (a.size == 0 or a.ndim < 2):
            a = a.reshape(-1, cols)
        arrays[key] = a
    return SupervisedResult(
        digest=obj["digest"], state_digest=obj["state_digest"],
        decisions=int(obj["decisions"]), epochs=int(obj["epochs"]),
        metrics=np.asarray(obj["metrics"], dtype=np.int64),
        restarts=0, ladder_steps=obj["ladder_steps"],
        scrape_rebinds=int(obj["scrape_rebinds"]),
        resumed_from=obj.get("resumed_from"),
        lifecycle=obj.get("lifecycle"), slo=obj.get("slo"),
        **{key: obj[key] for key in _JSON_VALUES if key in obj},
        **arrays)


def _child_main(workdir: str) -> int:
    """Spawn-mode child: run one incarnation of ``<workdir>/job.json``
    on the device named there, with real SIGKILL plan points, then write
    the result atomically."""
    with open(os.path.join(workdir, JOB_FILE)) as fh:
        obj = json.load(fh)
    job = EpochJob.from_json(obj["job"])
    plan = plan_from_json(obj.get("plan", {}))
    injector = HostFaultInjector(plan, workdir, kill_mode="sigkill")
    result = _job_loop(job, workdir, injector,
                       obj.get("device", DEFAULT_DEVICE),
                       spawned_ns=obj.get("spawned_ns"))

    def lst(v):
        return None if v is None else np.asarray(v).tolist()

    out = {"digest": result.digest, "state_digest": result.state_digest,
           "decisions": result.decisions, "epochs": result.epochs,
           "metrics": np.asarray(result.metrics).tolist(),
           "ladder_steps": result.ladder_steps,
           "scrape_rebinds": result.scrape_rebinds,
           "resumed_from": result.resumed_from,
           **{key: getattr(result, key) for key in _JSON_VALUES},
           "lifecycle": result.lifecycle, "slo": result.slo,
           **{key: lst(getattr(result, key)) for key in _JSON_ARRAYS}}
    res_path = os.path.join(workdir, RESULT_FILE)
    tmp = res_path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, res_path)
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1]))
