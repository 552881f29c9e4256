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

Plans are host numpy (``robust.faults``), so each step's faults are
host values here: a down server's round is not run at all, which gives
the values the JAX package's compute-then-mask program gives.
``fault=None`` takes the plain ``cluster_step`` path; an all-benign
plan (``faults.zero_plan``) equals it bit for bit.
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
                                stack_trees)
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


def _neutral_decisions(k: int, dev) -> kernels.Decision:
    """A down server's decision slots: NONE, slot -1, nothing served."""
    def fill(v, dtype):
        return torch.full((k,), v, dtype=dtype, device=dev)

    return kernels.Decision(
        type=fill(kernels.NONE, torch.int32), slot=fill(-1, torch.int32),
        phase=fill(0, torch.int32), cost=fill(0, torch.int64),
        when=fill(0, torch.int64), limit_break=fill(False, torch.bool))


def _one_server_step_faulty(engine, tracker, now, arr, view_d, view_r,
                            met, g_d, g_r, *, up_prev: bool, up: bool,
                            skew: int, delay: bool, dup: bool, cost,
                            decisions_per_step, anticipation_ns,
                            allow_limit_break, max_arrivals):
    """One server's degraded-mode round against the round's counter sum
    ``g_d``/``g_r``; the fault values are this server's host scalars.
    Returns ``(engine, tracker, now, view_d, view_r, met, decs)``."""
    restart = up and not up_prev
    dropout = up_prev and not up
    fault_rows = dict(server_dropouts=int(dropout),
                      tracker_resyncs=int(restart),
                      faults_injected=int(dropout) + int(restart)
                      + (int(dup) + int(delay) + int(skew != 0)
                         if up else 0))
    if not up:
        # commit gate: a down server keeps last-good state and hands
        # out nothing; its view and tracker are not re-synced
        decs = _neutral_decisions(decisions_per_step, now.device)
        return (engine, tracker, now, view_d, view_r,
                round_metrics(met, engine, decs, **fault_rows), decs)
    # live servers pull the fresh sum unless the plan delays their
    # piggyback updates; a restart always re-syncs and re-marks
    if not delay or restart:
        view_d, view_r = g_d, g_r
    if restart:
        tracker = resync_tracker(tracker, view_d, view_r)
    engine, new_tracker, new_now, decs = server_round(
        engine, tracker, now + skew, arr, cost, view_d, view_r,
        decisions_per_step=decisions_per_step,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, max_arrivals=max_arrivals)
    if dup:
        # duplicated completions: this step's batch folds twice
        track = borrow_tracker_track \
            if isinstance(tracker, BorrowTrackerState) else tracker_track
        new_tracker = track(new_tracker, decs.slot, decs.cost, decs.phase,
                            decs.type == kernels.RETURNING)
    return (engine, new_tracker, new_now - skew, view_d, view_r,
            round_metrics(met, engine, decs, **fault_rows), decs)


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


def _host_bools(t) -> list:
    return [bool(x) for x in groups.gather(t, "cpu").numpy()]


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
    now0 = CL.tree_map(lambda a: a + int(advance_ns), rc.cluster.now)
    g_d, g_r = _round_sums([shard_view(rc.cluster.tracker, s)
                            for s in range(n)], mesh)
    up_prev = _host_bools(rc.up_prev)
    outs = [_one_server_step_faulty(
        shard_view(rc.cluster.engine, s), shard_view(rc.cluster.tracker, s),
        shard_view(now0, s), shard_view(arrivals, s),
        shard_view(rc.view_delta, s), shard_view(rc.view_rho, s),
        shard_view(rc.metrics, s), groups.pick(g_d, owner[s]),
        groups.pick(g_r, owner[s]), up_prev=up_prev[s],
        up=bool(fault.up[s]), skew=int(fault.skew_ns[s]),
        delay=bool(fault.delay_counters[s]),
        dup=bool(fault.dup_completions[s]),
        cost=groups.pick(cost, owner[s]),
        decisions_per_step=decisions_per_step,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, max_arrivals=max_arrivals)
        for s in range(n)]
    engine, tracker, now, vd, vr, met, decs = (
        CL.restack_shards([o[i] for o in outs], mesh) for i in range(7))
    rc = RobustClusterState(
        cluster=ClusterState(engine=engine, tracker=tracker, now=now),
        view_delta=vd, view_rho=vr,
        up_prev=CL.shard_inputs(np.asarray(fault.up, dtype=bool),
                                torch.bool, mesh),
        metrics=met)
    res = (rc, decs)
    if with_merged:
        res = res + (_merge_held_metrics(met),)
    if with_pressure:
        press = CL.restack_shards(
            [obsprov.pressure_vec(shard_view(engine, s), shard_view(now, s))
             for s in range(n)], mesh)
        res = res + (press, obsprov.pressure_mesh_reduce(press))
    return res


def run_with_plan(rc: RobustClusterState, arrivals, cost, mesh,
                  plan: Optional[FaultPlan] = None, *,
                  decisions_per_step: int, max_arrivals: int = 1,
                  anticipation_ns: int = 0,
                  allow_limit_break: bool = False, advance_ns: int = 0,
                  tracer=None):
    """Drive ``arrivals.shape[0]`` cluster steps under ``plan`` (None =
    no fault plumbing).  Returns ``(rc, decs_seq)`` with each step's
    decisions as host numpy.  ``tracer`` records a ``cluster.round``
    dispatch span per step and a ``cluster.fetch`` span per read
    back."""
    from ..obs import spans as _spans

    arrivals = np.asarray(arrivals)
    decs_seq = []
    for t in range(arrivals.shape[0]):
        fault = plan_step(plan, t) if plan is not None else None
        with _spans.span(tracer, "cluster.round", "dispatch",
                         step=t, faulty=fault is not None):
            rc, decs = robust_cluster_step(
                rc, arrivals[t], cost, mesh, fault=fault,
                decisions_per_step=decisions_per_step,
                max_arrivals=max_arrivals,
                anticipation_ns=anticipation_ns,
                allow_limit_break=allow_limit_break,
                advance_ns=advance_ns)
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
    eng = [shard_view(rc.cluster.engine, s) for s in range(n)]
    trk = [shard_view(rc.cluster.tracker, s) for s in range(n)]
    now = [shard_view(rc.cluster.now, s) for s in range(n)]
    vd = [shard_view(rc.view_delta, s) for s in range(n)]
    vr = [shard_view(rc.view_rho, s) for s in range(n)]
    met = [shard_view(rc.metrics, s) for s in range(n)]
    arr = [shard_view(arr, s) for s in range(n)]
    up_prev = _host_bools(rc.up_prev)
    decs = [[] for _ in range(n)]
    for t in range(epochs):
        g_d, g_r = _round_sums(trk, mesh)
        for s in range(n):
            up = bool(eff.up[t, s])
            g = owner[s]
            eng[s], trk[s], now[s], vd[s], vr[s], met[s], d = \
                _one_server_step_faulty(
                    eng[s], trk[s], now[s] + int(advance_ns),
                    arr[s][t], vd[s], vr[s], met[s],
                    groups.pick(g_d, g), groups.pick(g_r, g),
                    up_prev=up_prev[s], up=up,
                    skew=int(eff.skew_ns[t, s]),
                    delay=bool(eff.delay_counters[t, s]),
                    dup=bool(eff.dup_completions[t, s]),
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
        up_prev=CL.shard_inputs(np.asarray(up_prev, dtype=bool),
                                torch.bool, mesh),
        metrics=restack(met))
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
