"""Degraded-mode cluster stepping under an injected fault plan.

Counterpart of ``dmclock_tpu/robust/cluster.py``: ``parallel.cluster``
with the graceful-degradation semantics of the reference protocol.

- A **down** server commits nothing: its engine and tracker keep their
  last-good state, its clock keeps only ``advance_ns``, and its
  decision slots read NONE.  Its counters are frozen in the sum, so the
  global counters stay **monotone**.
- Surviving servers serve from whatever counter view they hold
  (``server_round`` takes the view as an argument).
- A **restarted** server re-syncs its tracker marks from the global
  counters (:func:`resync_tracker`) before serving again.
- Every injected fault is counted into the per-shard metrics vectors
  (``server_dropouts`` / ``tracker_resyncs`` / ``faults_injected``),
  and :func:`cluster_conformance` gives the per-(server, client) QoS
  table.

Plans are host numpy (``robust.faults``); a step's faults enter as
tensors (:func:`fault_step_inputs`), and each server's round is computed
whole and then masked by them, as the JAX package's program computes
and masks, so no fault value is read on the host.  ``fault=None`` takes
the plain ``cluster_step`` path; an all-benign plan
(``faults.zero_plan``) equals it bit for bit.  :func:`run_with_plan`
runs every step through the program of the module cache
``cluster.robust_cluster_step`` (``_STEP_JIT_CACHE``, ``_jit_step``),
the JAX package's.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..engine import kernels
from ..obs import device as obsdev
from ..parallel import cluster as CL
from ..parallel import groups
from ..parallel.cluster import (ClusterState, decisions_to_numpy,
                                round_metrics, server_round, shard_view,
                                stack_trees, tree_map)
from ..parallel.tracker import (BorrowTrackerState, borrow_tracker_track,
                                global_counters_from, tracker_track)
from .faults import FaultPlan, FaultStep, plan_step


class RobustClusterState(NamedTuple):
    """ClusterState plus the degradation bookkeeping: each server's
    held view of the global counters (``[S, C]`` int64), the liveness
    of the previous step (``[S]`` bool) and the per-shard metrics
    vectors (``[S, NUM_METRICS]``; merge with :func:`metrics_totals`)."""

    cluster: ClusterState
    view_delta: torch.Tensor
    view_rho: torch.Tensor
    up_prev: torch.Tensor
    metrics: torch.Tensor


def init_robust(cluster: ClusterState) -> RobustClusterState:
    """Views at the protocol's counters-start-at-1 origin, every server
    up, metrics zero; a grouped cluster gives grouped leaves in its
    layout."""
    devs = groups.group_devices(cluster.now)
    if len(devs) > 1:
        return CL.place_fields(init_robust(groups.gather(cluster)), devs)
    s, c = cluster.tracker.completed_delta.shape
    dev = cluster.now.device
    return RobustClusterState(
        cluster=cluster,
        view_delta=torch.ones((s, c), dtype=torch.int64, device=dev),
        view_rho=torch.ones((s, c), dtype=torch.int64, device=dev),
        up_prev=torch.ones((s,), dtype=torch.bool, device=dev),
        metrics=torch.zeros((s, obsdev.NUM_METRICS), dtype=torch.int64,
                            device=dev))


def shard_robust(rc: RobustClusterState, mesh) -> RobustClusterState:
    """Lay every leaf out on the mesh (the JAX package's
    ``NamedSharding(mesh, P(SERVER_AXIS))`` over each leaf's leading
    server axis)."""
    return RobustClusterState(
        cluster=CL.shard_cluster(rc.cluster, mesh),
        **{f: CL.place_shards(getattr(rc, f), mesh)
           for f in RobustClusterState._fields[1:]})


def resync_tracker(tracker, g_delta, g_rho):
    """Re-mark a restarted server's tracker against the global counters:
    the next request from each seen client carries (global movement
    since the resync) - (own completions here since the resync), so
    nothing missed during the outage is double-charged.  Unseen clients
    are untouched."""
    seen = tracker.seen
    if isinstance(tracker, BorrowTrackerState):
        return tracker._replace(
            prev_delta=torch.where(seen, g_delta, tracker.prev_delta),
            prev_rho=torch.where(seen, g_rho, tracker.prev_rho),
            borrow_delta=torch.where(seen, 0, tracker.borrow_delta),
            borrow_rho=torch.where(seen, 0, tracker.borrow_rho))
    return tracker._replace(
        last_mark_delta=torch.where(
            seen, g_delta - tracker.completed_delta,
            tracker.last_mark_delta),
        last_mark_rho=torch.where(
            seen, g_rho - tracker.completed_rho, tracker.last_mark_rho))


_FAULT_DTYPES = (torch.bool, torch.int64, torch.bool, torch.bool)


def fault_step_inputs(fault: FaultStep, mesh) -> FaultStep:
    """A :class:`FaultStep` (numpy arrays or tensors, ``[S]`` each) as
    tensors of its dtypes laid out on ``mesh``: a program's inputs,
    never its constants, so every fault step shares one signature."""
    return FaultStep(*(CL.on_mesh(CL.device_tensor(a, dt, mesh.device),
                                  mesh)
                       for a, dt in zip(fault, _FAULT_DTYPES)))


def _one_server_step_faulty(engine, tracker, now, arr, view_d, view_r,
                            met, g_d, g_r, *, up_prev, up, skew, delay,
                            dup, cost, decisions_per_step, anticipation_ns,
                            allow_limit_break, max_arrivals):
    """One server's degraded-mode round against the round's counter sum
    ``g_d``/``g_r``, computed whole and then masked by this server's
    fault values (0-d tensors: ``up_prev``, ``up``, ``delay``, ``dup``
    bool, ``skew`` int64), as the JAX package's step is.  A down server
    keeps its last-good state and hands out NONE; a live one serves from
    the fresh sum unless its piggyback updates are delayed; a restart
    re-syncs its view and re-marks its tracker.  Returns ``(engine,
    tracker, now, view_d, view_r, met, decs)``."""
    restart = up & ~up_prev
    dropout = ~up & up_prev
    sync = (up & ~delay) | restart
    view_d = torch.where(sync, g_d, view_d)
    view_r = torch.where(sync, g_r, view_r)
    tracker = tree_map(lambda a, b: torch.where(restart, a, b),
                       resync_tracker(tracker, view_d, view_r), tracker)
    new_engine, new_tracker, new_now, decs = server_round(
        engine, tracker, now + skew, arr, cost, view_d, view_r,
        decisions_per_step=decisions_per_step,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, max_arrivals=max_arrivals)
    # duplicated completions: this step's batch folds a second time
    # (masked: a scatter-add of 0 is exact)
    track = borrow_tracker_track \
        if isinstance(tracker, BorrowTrackerState) else tracker_track
    new_tracker = track(new_tracker, decs.slot, decs.cost, decs.phase,
                        (decs.type == kernels.RETURNING) & dup)

    def keep(new, old):
        return torch.where(up, new, old)

    engine = tree_map(keep, new_engine, engine)
    tracker = tree_map(keep, new_tracker, tracker)
    now = torch.where(up, new_now - skew, now)
    decs = kernels.Decision(
        type=torch.where(up, decs.type, kernels.NONE),
        slot=torch.where(up, decs.slot, -1),
        phase=torch.where(up, decs.phase, 0),
        cost=torch.where(up, decs.cost, 0),
        when=torch.where(up, decs.when, 0),
        limit_break=decs.limit_break & up)
    perturb = (dup & up).to(torch.int64) + (delay & up).to(torch.int64) \
        + ((skew != 0) & up).to(torch.int64)
    events = dropout.to(torch.int64) + restart.to(torch.int64)
    met = round_metrics(met, engine, decs,
                        server_dropouts=dropout.to(torch.int64),
                        tracker_resyncs=restart.to(torch.int64),
                        faults_injected=events + perturb)
    return engine, tracker, now, view_d, view_r, met, decs


def _merge_held_metrics(metrics: torch.Tensor) -> torch.Tensor:
    """The merged total of the ``[S, NUM_METRICS]`` held metrics vectors
    (counters add, high-water rows max)."""
    return obsdev.metrics_mesh_reduce(metrics)


def _round_sums(trackers, mesh):
    """The counter sum over per-server trackers (the psum): a
    ``groups.Replicated`` pair on a grouped mesh."""
    return global_counters_from(
        CL.restack_shards([t.completed_delta for t in trackers], mesh),
        CL.restack_shards([t.completed_rho for t in trackers], mesh))


def _on_mesh_robust(rc: RobustClusterState, mesh) -> RobustClusterState:
    if mesh.grouped:
        return shard_robust(rc, mesh)
    return CL.on_mesh(rc, mesh)


def robust_cluster_step(rc: RobustClusterState, arrivals, cost, mesh, *,
                        fault: Optional[FaultStep] = None,
                        decisions_per_step: int, max_arrivals: int = 1,
                        anticipation_ns: int = 0,
                        allow_limit_break: bool = False,
                        advance_ns: int = 0, with_merged: bool = False,
                        with_pressure: bool = False):
    """One cluster step under an optional :class:`FaultStep`.

    ``fault=None`` delegates to the plain ``cluster_step``; the views
    and the transition bookkeeping are untouched.  ``with_merged`` adds
    the merged total of the per-shard held metrics vectors (counters
    add, high-water rows max); ``with_pressure`` adds the post-round
    per-shard pressure vectors and their merged total (a down server
    reports its frozen state against the cluster clock)."""
    from ..obs import provenance as obsprov

    if fault is None:
        out = CL.cluster_step(
            rc.cluster, arrivals, cost, mesh,
            decisions_per_step=decisions_per_step,
            max_arrivals=max_arrivals, anticipation_ns=anticipation_ns,
            allow_limit_break=allow_limit_break, advance_ns=advance_ns,
            with_pressure=with_pressure)
        rc = rc._replace(cluster=out[0])
        res = (rc, out[1])
        if with_merged:
            res = res + (_merge_held_metrics(rc.metrics),)
        return res + tuple(out[2:])

    n = groups.leading(rc.cluster.now)
    devs = mesh.devices
    owner = groups.group_of(n, len(devs))
    rc = _on_mesh_robust(rc, mesh)
    cost = groups.replicate(CL.device_tensor(cost, torch.int64, devs[0]),
                            devs)
    arrivals = CL.shard_inputs(arrivals, torch.int32, mesh)
    fault = fault_step_inputs(fault, mesh)
    now0 = CL.tree_map(lambda a: a + int(advance_ns), rc.cluster.now)
    g_d, g_r = _round_sums([shard_view(rc.cluster.tracker, s)
                            for s in range(n)], mesh)
    outs = [_one_server_step_faulty(
        shard_view(rc.cluster.engine, s), shard_view(rc.cluster.tracker, s),
        shard_view(now0, s), shard_view(arrivals, s),
        shard_view(rc.view_delta, s), shard_view(rc.view_rho, s),
        shard_view(rc.metrics, s), groups.pick(g_d, owner[s]),
        groups.pick(g_r, owner[s]), up_prev=shard_view(rc.up_prev, s),
        up=shard_view(fault.up, s), skew=shard_view(fault.skew_ns, s),
        delay=shard_view(fault.delay_counters, s),
        dup=shard_view(fault.dup_completions, s),
        cost=groups.pick(cost, owner[s]),
        decisions_per_step=decisions_per_step,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, max_arrivals=max_arrivals)
        for s in range(n)]
    engine, tracker, now, vd, vr, met, decs = (
        CL.restack_shards([o[i] for o in outs], mesh) for i in range(7))
    rc = RobustClusterState(
        cluster=ClusterState(engine=engine, tracker=tracker, now=now),
        view_delta=vd, view_rho=vr, up_prev=fault.up, metrics=met)
    res = (rc, decs)
    if with_merged:
        res = res + (_merge_held_metrics(met),)
    if with_pressure:
        press = CL.restack_shards(
            [obsprov.pressure_vec(shard_view(engine, s), shard_view(now, s))
             for s in range(n)], mesh)
        res = res + (press, obsprov.pressure_mesh_reduce(press))
    return res


# the JAX package's module cache of the robust step's programs, keyed
# as ``parallel.cluster.mesh_step_jit`` keys them
_STEP_JIT_CACHE: dict = {}


def _jit_step(mesh, cfg: tuple):
    """The ``cluster.robust_cluster_step`` program of ``mesh`` and the
    five-tuple ``cfg``: ``(rc, arrivals, cost, fault=None)``."""
    return CL.mesh_step_jit(_STEP_JIT_CACHE, robust_cluster_step, mesh,
                            cfg)


def run_with_plan(rc: RobustClusterState, arrivals, cost, mesh,
                  plan: Optional[FaultPlan] = None, *,
                  decisions_per_step: int, max_arrivals: int = 1,
                  anticipation_ns: int = 0,
                  allow_limit_break: bool = False, advance_ns: int = 0,
                  tracer=None):
    """Drive ``arrivals.shape[0]`` cluster steps under ``plan`` (None =
    no fault plumbing), each through the ``cluster.robust_cluster_step``
    program (:func:`_jit_step`), a step's faults as its tensor inputs.
    Returns ``(rc, decs_seq)`` with each step's decisions as host numpy.
    ``tracer`` records a ``cluster.round`` dispatch span per step and a
    ``cluster.fetch`` span per read back."""
    from ..obs import spans as _spans

    step = _jit_step(mesh, (decisions_per_step, max_arrivals,
                            anticipation_ns, allow_limit_break,
                            advance_ns))
    arrivals = CL.program_input(arrivals, mesh)
    cost = CL.program_input(cost, mesh)
    decs_seq = []
    for t in range(arrivals.shape[0]):
        fault = plan_step(plan, t) if plan is not None else None
        with _spans.span(tracer, "cluster.round", "dispatch",
                         step=t, faulty=fault is not None):
            if fault is None:
                rc, decs = step(rc, arrivals[t], cost)
            else:
                rc, decs = step(rc, arrivals[t], cost,
                                fault=fault_step_inputs(fault, mesh))
        with _spans.span(tracer, "cluster.fetch", "fetch", step=t):
            decs_seq.append(decisions_to_numpy(decs))
    return rc, decs_seq


def effective_plan(plan: FaultPlan, counter_sync_every: int = 1,
                   round0: int = 0) -> FaultPlan:
    """Fold the ``counter_sync_every`` staleness grid into a plan's
    ``delay_counters`` mask (a non-sync round IS the delay fault), so
    the host loop under the effective plan is the exact reference for
    a fused K-grid launch under the raw plan.  At K=1 the plan is
    returned unchanged."""
    sync = CL.round_sync_mask(plan.steps, counter_sync_every, round0)
    if sync.all():
        return plan
    return plan._replace(
        delay_counters=plan.delay_counters | ~sync[:, None])


def run_mesh_rounds_with_plan(rc: RobustClusterState, arrivals_seq, cost,
                              mesh, plan: FaultPlan, *,
                              decisions_per_step: int,
                              max_arrivals: int = 1,
                              anticipation_ns: int = 0,
                              allow_limit_break: bool = False,
                              advance_ns: int = 0,
                              counter_sync_every: int = 1,
                              round0: int = 0):
    """The chaos twin of ``parallel.cluster.run_mesh_rounds``: ``E``
    whole degraded rounds of every server in one call, each round the
    same per-server program :func:`run_with_plan` runs per step, with
    the ``counter_sync_every`` grid folded into the delay mask
    (:func:`effective_plan`).  So ``run_mesh_rounds_with_plan(plan, K)
    == run_with_plan(effective_plan(plan, K))`` in decisions, views,
    tracker state and metrics.  Returns ``(rc, decs)`` with ``decs``
    leaves ``[S, E, k]`` (re-slice with ``mesh_decs_seq``)."""
    devs = mesh.devices
    arrivals_seq = CL.device_tensor(arrivals_seq, torch.int32, devs[0])
    epochs = int(arrivals_seq.shape[0])
    n = groups.leading(rc.cluster.now)
    owner = groups.group_of(n, len(devs))
    rc = _on_mesh_robust(rc, mesh)
    arr = CL.on_mesh(arrivals_seq.transpose(0, 1), mesh)
    cost = groups.replicate(CL.device_tensor(cost, torch.int64, devs[0]),
                            devs)
    eff = effective_plan(plan, counter_sync_every, round0)
    if eff.steps != epochs:
        raise ValueError(f"plan of {eff.steps} steps for {epochs} rounds")
    # the effective plan's [S, E] fault values, laid out on the mesh
    faults = FaultStep(*(CL.on_mesh(CL.device_tensor(
        np.ascontiguousarray(np.asarray(a).T), dt, devs[0]), mesh)
        for a, dt in zip((eff.up, eff.skew_ns, eff.delay_counters,
                          eff.dup_completions), _FAULT_DTYPES)))
    eng = [shard_view(rc.cluster.engine, s) for s in range(n)]
    trk = [shard_view(rc.cluster.tracker, s) for s in range(n)]
    now = [shard_view(rc.cluster.now, s) for s in range(n)]
    vd = [shard_view(rc.view_delta, s) for s in range(n)]
    vr = [shard_view(rc.view_rho, s) for s in range(n)]
    met = [shard_view(rc.metrics, s) for s in range(n)]
    arr = [shard_view(arr, s) for s in range(n)]
    up_prev = [shard_view(rc.up_prev, s) for s in range(n)]
    fs = [FaultStep(*(shard_view(x, s) for x in faults)) for s in range(n)]
    decs = [[] for _ in range(n)]
    for t in range(epochs):
        g_d, g_r = _round_sums(trk, mesh)
        for s in range(n):
            g = owner[s]
            up = fs[s].up[t]
            eng[s], trk[s], now[s], vd[s], vr[s], met[s], d = \
                _one_server_step_faulty(
                    eng[s], trk[s], now[s] + int(advance_ns),
                    arr[s][t], vd[s], vr[s], met[s],
                    groups.pick(g_d, g), groups.pick(g_r, g),
                    up_prev=up_prev[s], up=up, skew=fs[s].skew_ns[t],
                    delay=fs[s].delay_counters[t],
                    dup=fs[s].dup_completions[t],
                    cost=groups.pick(cost, g),
                    decisions_per_step=decisions_per_step,
                    anticipation_ns=anticipation_ns,
                    allow_limit_break=allow_limit_break,
                    max_arrivals=max_arrivals)
            up_prev[s] = up
            decs[s].append(d)

    def restack(xs):
        return CL.restack_shards(xs, mesh)

    rc = RobustClusterState(
        cluster=ClusterState(engine=restack(eng), tracker=restack(trk),
                             now=restack(now)),
        view_delta=restack(vd), view_rho=restack(vr),
        up_prev=restack(up_prev), metrics=restack(met))
    return rc, restack([stack_trees(ds) for ds in decs])


def decision_digest(decs_seq) -> str:
    """sha256 over the decision stream (type/slot/phase/cost per step):
    the bit-identity currency of the chaos differential gate."""
    h = hashlib.sha256()
    for d in decs_seq:
        for arr in (d.type, d.slot, d.phase, d.cost):
            if torch.is_tensor(arr):
                arr = arr.detach().cpu().numpy()
            h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
    return h.hexdigest()


def metrics_totals(rc: RobustClusterState) -> dict:
    """Merge the per-shard metrics vectors (counters add, high-water
    rows max) and name the rows -- one read back."""
    vecs = groups.gather(rc.metrics, "cpu").numpy()
    acc = np.zeros((obsdev.NUM_METRICS,), dtype=np.int64)
    return obsdev.metrics_dict(obsdev.metrics_combine_np(acc, *vecs))


# ----------------------------------------------------------------------
# per-(server, client) conformance
# ----------------------------------------------------------------------

def cluster_conformance(decs_seq, arrivals, plan, qos_triples,
                        advance_ns: int, tol: float = 0.05) -> List[dict]:
    """Per-(server, client) QoS conformance over each server's live
    window: delivered rate against min(reservation, demand) and the
    limit cap (arrivals posted to a down server are lost, so they leave
    its demand).  ``qos_triples`` is ``[(reservation, weight, limit)]``
    per client; each step spans ``advance_ns`` of virtual time."""
    arrivals = np.asarray(arrivals)
    t_steps, n_servers, n_clients = arrivals.shape
    live = np.asarray(plan.up) if plan is not None else \
        np.ones((t_steps, n_servers), dtype=bool)
    served = np.zeros((n_servers, n_clients), dtype=np.int64)
    for d in decs_seq:
        dtype = np.asarray(d.type)
        dslot = np.asarray(d.slot)
        for s in range(n_servers):
            sel = dslot[s][dtype[s] == kernels.RETURNING]
            np.add.at(served[s], sel, 1)
    demand = (arrivals * live[:, :, None]).sum(axis=0)
    rows = []
    for s in range(n_servers):
        window_s = max(live[:, s].sum() * advance_ns / 1e9, 1e-9)
        for c in range(n_clients):
            resv, weight, limit = qos_triples[c]
            rate = served[s, c] / window_s
            demand_rate = demand[s, c] / window_s
            resv_floor = min(resv, demand_rate)
            rows.append({
                "server": s, "client": c,
                "live_steps": int(live[:, s].sum()),
                "reservation": resv, "weight": weight, "limit": limit,
                "ops": int(served[s, c]), "rate": rate,
                "demand_rate": demand_rate,
                "resv_met": (rate >= resv_floor * (1.0 - tol))
                if resv > 0 else True,
                "limit_ok": (rate <= limit * (1.0 + tol))
                if limit > 0 else True,
            })
    return rows


def format_cluster_conformance(rows: List[dict]) -> str:
    """Text table over :func:`cluster_conformance` rows."""
    lines = ["-- per-(server, client) QoS conformance "
             "(live window) --",
             f"{'srv':>4} {'client':>6} {'live':>5} {'resv':>8} "
             f"{'limit':>8} {'ops':>8} {'rate':>9} {'demand':>9} "
             f"{'verdict':>12}"]
    for r in rows:
        verdict = ("ok" if r["resv_met"] else "RESV-MISS") + \
            ("" if r["limit_ok"] else "+LIMIT-EXCESS")
        lines.append(
            f"{r['server']:>4} {r['client']:>6} {r['live_steps']:>5} "
            f"{r['reservation']:>8.1f} {r['limit']:>8.1f} "
            f"{r['ops']:>8} {r['rate']:>9.2f} "
            f"{r['demand_rate']:>9.2f} {verdict:>12}")
    misses = sum(1 for r in rows if not r["resv_met"])
    excess = sum(1 for r in rows if not r["limit_ok"])
    lines.append(f"rows {len(rows)} | reservation misses {misses} "
                 f"| limit excesses {excess}")
    return "\n".join(lines)
