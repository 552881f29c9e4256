"""The port's multi-server cluster (``parallel/cluster.py``) and its
degraded mode (``robust/cluster.py``) against the JAX package on its
8-device CPU mesh, exactly: ``cluster_step`` at S=8 under both trackers
with per-client costs, metrics and pressure (per shard and merged) and a
``create_clients`` mid-run; ``run_mesh_rounds`` at K = 1, 2 and 4;
``robust_cluster_step`` / ``run_with_plan`` / ``run_mesh_rounds_with_plan``
under a zero plan, a single outage and a sampled plan, with
``decision_digest`` and the conformance text byte-equal.  State crosses
through ``engine/bridge.py``.  Last, the cluster dry run's QoS assertions
(``serve.multichip_policy``) at a small width on the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.core.timebase import rate_to_inv_ns
from dmclock_tpu.parallel import cluster as JCL
from dmclock_tpu.robust import cluster as JRC
from dmclock_tpu.robust import faults as JF
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.parallel import cluster as TCL
from dmclock_tpu_torch.robust import cluster as TRC
from dmclock_tpu_torch.robust import faults as TF

from test_torch_support import assert_np_equal

S, C, K, MAX_ARR, RING = 8, 12, 8, 2, 8
ADV = 10 ** 8
QOS = [(10.0, 1.0 + (i % 3), 40.0 if i % 4 == 3 else 0.0)
       for i in range(C)]
COSTS = np.asarray([1 + (i % 2) for i in range(C)], dtype=np.int64)
STEPS = 3


def _inv(col):
    return np.asarray([rate_to_inv_ns(q[col]) for q in QOS],
                      dtype=np.int64)


def _arrivals(seed: int, steps: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, (steps, S, C)).astype(np.int32)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def assert_tree_equal(name, got, want):
    """Two trees (NamedTuples, tuples, arrays) leaf by leaf."""
    if got is None or want is None:
        assert got is None and want is None, name
        return
    if isinstance(got, tuple):
        assert len(got) == len(want), name
        fields = getattr(got, "_fields", range(len(got)))
        for f, a, b in zip(fields, got, want):
            assert_tree_equal(f"{name}.{f}", a, b)
        return
    assert_np_equal(name, _np(got), _np(want))


def _clusters(kind: str, active=None):
    """The same fresh cluster on both sides (JAX sharded on the 8-device
    mesh)."""
    mesh = JCL.make_mesh(S)
    jc = JCL.init_cluster(S, C, ring_capacity=RING, tracker_kind=kind)
    jc = JCL.install_clients(
        jc, jnp.asarray(_inv(0)), jnp.asarray(_inv(1)),
        jnp.asarray(_inv(2)),
        None if active is None else jnp.asarray(active))
    jc = JCL.shard_cluster(jc, mesh)
    tmesh = TCL.make_mesh(S, "cpu")
    tc = TCL.init_cluster(S, C, ring_capacity=RING, tracker_kind=kind,
                          device="cpu")
    tc = TCL.install_clients(tc, _inv(0), _inv(1), _inv(2), active)
    return mesh, jc, tmesh, tc


def _jax_cluster_np(jc) -> dict:
    return {"engine": {f: _np(v) for f, v in zip(jc.engine._fields,
                                                  jc.engine)},
            "tracker": {f: _np(v) for f, v in zip(jc.tracker._fields,
                                                   jc.tracker)},
            "now": _np(jc.now)}


def assert_cluster_equal(tc, jc):
    got, want = bridge.cluster_to_numpy(tc), _jax_cluster_np(jc)
    for part in ("engine", "tracker"):
        assert got[part].keys() == want[part].keys()
        for f in got[part]:
            assert_np_equal(f"{part}.{f}", got[part][f], want[part][f])
    assert_np_equal("now", got["now"], want["now"])


# ----------------------------------------------------------------------
# cluster_step
# ----------------------------------------------------------------------

def _jax_step(mesh, **kw):
    return jax.jit(functools.partial(
        JCL.cluster_step, mesh=mesh, decisions_per_step=K,
        max_arrivals=MAX_ARR, advance_ns=ADV, **kw))


@pytest.mark.parametrize("kind", ["orig", "borrowing"])
def test_cluster_step_with_metrics_pressure_and_creation(kind):
    active = np.arange(C) < C - 3
    mesh, jc, tmesh, tc = _clusters(kind, active)
    # the bridge carries a JAX cluster into the port unchanged
    assert_cluster_equal(bridge.cluster_from_numpy(_jax_cluster_np(jc),
                                                   "cpu"), jc)
    step = _jax_step(mesh, with_metrics=True, with_pressure=True)
    arrivals = _arrivals(3, STEPS)
    plain = tc
    for t in range(STEPS):
        if t == 1:
            new = ~active
            jc = JCL.create_clients(jc, jnp.asarray(new),
                                    jnp.asarray(_inv(0)),
                                    jnp.asarray(_inv(1)),
                                    jnp.asarray(_inv(2)), mesh)
            tc = TCL.create_clients(tc, new, _inv(0), _inv(1), _inv(2),
                                    tmesh)
            plain = TCL.create_clients(plain, new, _inv(0), _inv(1),
                                       _inv(2), tmesh)
            assert_cluster_equal(tc, jc)
        jout = step(jc, jnp.asarray(arrivals[t]), jnp.asarray(COSTS))
        tout = TCL.cluster_step(
            tc, arrivals[t], COSTS, tmesh, decisions_per_step=K,
            max_arrivals=MAX_ARR, advance_ns=ADV, with_metrics=True,
            with_pressure=True)
        assert len(tout) == len(jout) == 6
        jc, tc = jout[0], tout[0]
        assert_cluster_equal(tc, jc)
        for name, a, b in zip(("decs", "metrics", "merged", "pressure",
                               "pressure_merged"), tout[1:], jout[1:]):
            assert_tree_equal(name, a, b)
        # the flags only observe
        plain, pdecs = TCL.cluster_step(
            plain, arrivals[t], COSTS, tmesh, decisions_per_step=K,
            max_arrivals=MAX_ARR, advance_ns=ADV)
        assert_tree_equal("plain decs", pdecs, tout[1])
    assert int((_np(tout[1].type) == 0).sum()) > 0


def test_run_cluster_rounds_spans():
    from dmclock_tpu_torch.obs import spans as TS

    mesh, jc, tmesh, tc = _clusters("orig")
    arrivals = _arrivals(5, 2)
    jc, jseq = JCL.run_cluster_rounds(jc, arrivals, 1, mesh,
                                      decisions_per_step=K,
                                      advance_ns=ADV)
    tracer = TS.SpanTracer()
    tc, tseq = TCL.run_cluster_rounds(tc, arrivals, 1, tmesh,
                                      decisions_per_step=K,
                                      advance_ns=ADV, tracer=tracer)
    assert_cluster_equal(tc, jc)
    assert TRC.decision_digest(tseq) == JRC.decision_digest(jseq)
    assert [r["name"] for r in tracer.rows()] == \
        ["cluster.round", "cluster.fetch"] * 2


# ----------------------------------------------------------------------
# run_mesh_rounds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("every", [1, 2, 4])
def test_run_mesh_rounds(every):
    mesh, jc, tmesh, tc = _clusters("orig")
    arrivals = _arrivals(7, 4)
    kw = dict(decisions_per_step=K, max_arrivals=MAX_ARR, advance_ns=ADV,
              counter_sync_every=every, round0=1, with_merged=True,
              with_pressure=True)
    jm = JCL.run_mesh_rounds(jc, arrivals, jnp.asarray(COSTS), mesh, **kw)
    tm = TCL.run_mesh_rounds(tc, arrivals, COSTS, tmesh, **kw)
    assert_cluster_equal(tm.cluster, jm.cluster)
    for f in ("view_delta", "view_rho", "metrics", "decs", "merged",
              "pressure", "pressure_merged"):
        assert_tree_equal(f, getattr(tm, f), getattr(jm, f))
    jseq, tseq = JCL.mesh_decs_seq(jm.decs), TCL.mesh_decs_seq(tm.decs)
    assert TRC.decision_digest(tseq) == JRC.decision_digest(jseq)
    assert np.array_equal(TCL.round_sync_mask(6, every, 1),
                          JCL.round_sync_mask(6, every, 1))


# ----------------------------------------------------------------------
# the robust cluster
# ----------------------------------------------------------------------

def _plan(name: str, steps: int):
    if name == "zero":
        return JF.zero_plan(steps, S), TF.zero_plan(steps, S)
    if name == "outage":
        kw = dict(server=2, down_from=1, down_until=3)
        return (JF.single_outage_plan(steps, S, **kw),
                TF.single_outage_plan(steps, S, **kw))
    spec = "seed=7,p_dropout=0.2,mean_outage_steps=2,p_delay=0.2," \
        "p_dup=0.2,max_skew_ns=30000000"
    return (JF.plan_from_spec(JF.parse_fault_spec(spec), steps, S),
            TF.plan_from_spec(TF.parse_fault_spec(spec), steps, S))


def _robust(kind="orig"):
    mesh, jc, tmesh, tc = _clusters(kind)
    return (mesh, JRC.shard_robust(JRC.init_robust(jc), mesh), tmesh,
            TRC.shard_robust(TRC.init_robust(tc), tmesh))


def assert_robust_equal(trc, jrc):
    assert_cluster_equal(trc.cluster, jrc.cluster)
    for f in ("view_delta", "view_rho", "up_prev", "metrics"):
        assert_np_equal(f, _np(getattr(trc, f)), _np(getattr(jrc, f)))


@pytest.mark.parametrize("plan_name", ["zero", "outage", "sampled"])
def test_run_with_plan_and_fused_rounds(plan_name):
    steps = 4
    arrivals = _arrivals(11, steps)
    jplan, tplan = _plan(plan_name, steps)
    kw = dict(decisions_per_step=K, max_arrivals=MAX_ARR, advance_ns=ADV)
    mesh, jrc, tmesh, trc = _robust()
    jrc, jseq = JRC.run_with_plan(jrc, arrivals, jnp.asarray(COSTS),
                                  mesh, jplan, **kw)
    trc, tseq = TRC.run_with_plan(trc, arrivals, COSTS, tmesh, tplan,
                                  **kw)
    assert_robust_equal(trc, jrc)
    assert TRC.decision_digest(tseq) == JRC.decision_digest(jseq)
    assert TRC.metrics_totals(trc) == JRC.metrics_totals(jrc)
    if plan_name != "zero":
        assert TRC.metrics_totals(trc)["server_dropouts"] == \
            TF.plan_events(tplan)["server_dropouts"] > 0
    qos = [(r, w, lim) for r, w, lim in QOS]
    tt = TRC.format_cluster_conformance(TRC.cluster_conformance(
        tseq, arrivals, tplan, qos, ADV))
    jt = JRC.format_cluster_conformance(JRC.cluster_conformance(
        jseq, arrivals, jplan, qos, ADV))
    assert tt == jt
    # the fused chaos rounds at K=2 against the JAX fused rounds and
    # against the host loop under the effective plan
    mesh, jrc2, tmesh, trc2 = _robust()
    jrc2, jdecs = JRC.run_mesh_rounds_with_plan(
        jrc2, arrivals, jnp.asarray(COSTS), mesh, jplan,
        counter_sync_every=2, **kw)
    trc2, tdecs = TRC.run_mesh_rounds_with_plan(
        trc2, arrivals, COSTS, tmesh, tplan, counter_sync_every=2, **kw)
    assert_robust_equal(trc2, jrc2)
    assert_tree_equal("fused decs", tdecs, jdecs)
    _, _, tmesh, trc3 = _robust()
    trc3, tseq3 = TRC.run_with_plan(
        trc3, arrivals, COSTS, tmesh, TRC.effective_plan(tplan, 2), **kw)
    assert TRC.decision_digest(TCL.mesh_decs_seq(tdecs)) == \
        TRC.decision_digest(tseq3)
    for f in ("view_delta", "view_rho", "metrics"):
        assert_np_equal(f, _np(getattr(trc3, f)), _np(getattr(trc2, f)))


def test_zero_plan_equals_no_plan_and_step_flags():
    arrivals = _arrivals(13, 3)
    kw = dict(decisions_per_step=K, max_arrivals=MAX_ARR, advance_ns=ADV)
    _, _, tmesh, t0 = _robust("borrowing")
    t0, seq0 = TRC.run_with_plan(t0, arrivals, COSTS, tmesh, None, **kw)
    _, _, tmesh, tz = _robust("borrowing")
    tz, seqz = TRC.run_with_plan(tz, arrivals, COSTS, tmesh,
                                 TF.zero_plan(3, S), **kw)
    assert TRC.decision_digest(seq0) == TRC.decision_digest(seqz)
    assert_cluster_equal(t0.cluster, tz.cluster)
    # one faulty step with the merged metrics and pressure, both sides
    jplan, tplan = _plan("sampled", 3)
    mesh, jrc, tmesh, trc = _robust("borrowing")
    jstep = jax.jit(functools.partial(
        JRC.robust_cluster_step, mesh=mesh, with_merged=True,
        with_pressure=True, **kw))
    for t in range(3):
        jout = jstep(jrc, jnp.asarray(arrivals[t]), jnp.asarray(COSTS),
                     fault=JF.plan_step(jplan, t))
        tout = TRC.robust_cluster_step(
            trc, arrivals[t], COSTS, tmesh, fault=TF.plan_step(tplan, t),
            with_merged=True, with_pressure=True, **kw)
        jrc, trc = jout[0], tout[0]
        assert_robust_equal(trc, jrc)
        for name, a, b in zip(("decs", "merged", "pressure",
                               "pressure_merged"), tout[1:], jout[1:]):
            assert_tree_equal(name, a, b)
    # fault=None with the merged held metrics
    jout = jax.jit(functools.partial(
        JRC.robust_cluster_step, mesh=mesh, with_merged=True, **kw))(
            jrc, jnp.asarray(arrivals[0]), 1)
    tout = TRC.robust_cluster_step(trc, arrivals[0], 1, tmesh,
                                   with_merged=True, **kw)
    assert_robust_equal(tout[0], jout[0])
    assert_tree_equal("merged", tout[2], jout[2])


# ----------------------------------------------------------------------
# the cluster dry run's QoS, on the port
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["orig", "borrowing"])
def test_multichip_policy_qos(kind):
    """``__graft_entry__._dryrun_policy``'s assertions at 4 servers x 60
    clients and 64 decisions a step (the dry run: 8 x 10,000 and 1024):
    mostly busy rounds, every class over its reservation floor, a pure
    weight-phase drain and 1:2:3 cost-weighted drain shares."""
    row = tserve.multichip_policy(4, 60, kind, decisions_per_step=64,
                                  device="cpu")
    assert row["qos_checked"] and row["served"] > 0
    shares = np.asarray(row["weight_shares"])
    assert np.all(np.abs(shares - np.array([1, 2, 3]) / 6)
                  < 0.1 * np.array([1, 2, 3]) / 6)
