"""The serial-engine programs of the port against the JAX package's jit
caches on the CPU: the pull queue's six (``engine/queue.py`` cache
``queue``), the cluster step and the fused mesh rounds
(``parallel/cluster.py`` ``cluster.cluster_step`` and
``cluster.mesh_rounds``) and the robust cluster step
(``robust/cluster.py`` ``cluster.robust_cluster_step``).

Each is a ``compile_plane.InstrumentedJit`` captured whole on the card:
the fixed-shape device ingest, the serial steps (``kernels.serial_leg``
blocks, nested as child graphs) and the packing or the tracker folds.
On CPU tensors a program runs its body eagerly with the card's
signatures and records, so what is held here is what the card must
keep: every ``PullReq``, decision, state field, view, metric row and
digest equals the JAX package's exactly, through the programs; the
extended serial program (``advance_now``, the horizon, the metrics)
equals one ``engine_run`` at steps below, equal to and not dividing the
block; and one call sequence gives both compile planes the same
entries, compiles, retraces and retrace diff paths for the four caches,
``jit_mesh_rounds`` keyed on ``round0 % counter_sync_every`` as JAX
keys it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.engine import queue as JQ
from dmclock_tpu.obs import compile_plane as jcp
from dmclock_tpu.parallel import cluster as JCL
from dmclock_tpu.robust import cluster as JRC
from dmclock_tpu.robust import faults as JF
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.engine import queue as TQ
from dmclock_tpu_torch.obs import compile_plane as tcp
from dmclock_tpu_torch.parallel import cluster as TCL
from dmclock_tpu_torch.robust import cluster as TRC
from dmclock_tpu_torch.robust import faults as TF

from test_torch_cluster import (_inv, assert_cluster_equal,
                                assert_tree_equal)
from test_torch_queue import (JAX, PORT, assert_device_views_equal,
                              counters, device_view, norm)
from test_torch_support import (S, assert_np_equal, random_state, to_jax,
                                to_torch)

CACHES = ("queue", "cluster.cluster_step", "cluster.robust_cluster_step",
          "cluster.mesh_rounds")
NS, NC, K, MAX_ARR, RING = 4, 12, 8, 2, 8    # the cluster's cut shape
ADV = 10 ** 8
COSTS = np.asarray([1 + (i % 2) for i in range(NC)], dtype=np.int64)
KW = dict(decisions_per_step=K, max_arrivals=MAX_ARR, advance_ns=ADV)


@pytest.fixture
def fresh(monkeypatch):
    """Empty module caches and compile planes in both packages."""
    for mod, name in ((JQ, "_JIT_CACHE"), (TQ, "_JIT_CACHE"),
                      (JCL, "_ROUNDS_JIT_CACHE"), (TCL, "_ROUNDS_JIT_CACHE"),
                      (JCL, "_MESH_ROUNDS_JIT_CACHE"),
                      (TCL, "_MESH_ROUNDS_JIT_CACHE"),
                      (JRC, "_STEP_JIT_CACHE"), (TRC, "_STEP_JIT_CACHE")):
        monkeypatch.setattr(mod, name, {})
    planes = (jcp.CompilePlane(), tcp.CompilePlane())
    monkeypatch.setattr(jcp, "_PLANE", planes[0])
    monkeypatch.setattr(tcp, "_PLANE", planes[1])
    return planes


@pytest.fixture
def port_fresh(monkeypatch):
    """Empty module caches and compile plane in the port (the JAX caches
    kept, so its programs compile once for the module)."""
    for mod, name in ((TQ, "_JIT_CACHE"), (TCL, "_ROUNDS_JIT_CACHE"),
                      (TCL, "_MESH_ROUNDS_JIT_CACHE"),
                      (TRC, "_STEP_JIT_CACHE")):
        monkeypatch.setattr(mod, name, {})
    pl = tcp.CompilePlane()
    monkeypatch.setattr(tcp, "_PLANE", pl)
    return pl


def _records(pl, caches=CACHES) -> dict:
    """Per (cache, entry): compiles, retraces and the retrace diff's
    paths."""
    return {(e["cache"], e["entry"]): (
        e["compiles"], e["retraces"],
        [d.split(":")[0] for d in e["last_retrace_diff"]])
        for e in pl.entries() if e["cache"] in caches}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ----------------------------------------------------------------------
# the extended serial program
# ----------------------------------------------------------------------

FLAGS = [dict(advance_now=True), dict(with_horizon=True),
         dict(with_metrics=True),
         dict(advance_now=True, with_horizon=True, with_metrics=True)]


def _limited_state():
    """``random_state`` with every head waiting on its limit (1 op/s)
    and its reservation a fraction of a second ahead: the stream mixes
    FUTUREs, reservation and weight-phase serves, so the clock moves
    under ``advance_now`` and the horizon is a tag past ``now``."""
    arrays, now = random_state(11, 40, 8), 50 * S
    idx = np.arange(40)
    arrays["head_ready"][:] = False
    arrays["limit_inv"][:] = S
    arrays["head_limit"][:] = now + (idx % 7 + 1) * S // 4
    arrays["head_resv"][:] = now + (idx % 5 + 1) * S // 3
    return arrays, now


@pytest.mark.parametrize("steps", [5, 8, 13], ids=["below", "equal",
                                                   "not_dividing"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f))
def test_serial_program_extensions_equal_engine_run(monkeypatch, steps,
                                                    flags):
    """Blocks of 8 steps: 5 steps (fewer than a block), 8 (one block)
    and 13 (one and a remainder of 5); every output -- state, clock,
    decisions, the horizon, the metrics vector -- equals one
    ``engine_run`` of all the steps, and the JAX package's; a chained
    call continues it."""
    monkeypatch.setattr(tk, "SERIAL_BLOCK", 8)
    arrays, now = _limited_state()
    prog = tk.serial_program(steps, allow_limit_break=False,
                             anticipation_ns=0, cache="t", entry="s",
                             **flags)
    assert [(n, p.fn.keywords["steps"]) for n, p in prog._parts] == \
        [(n, s) for n, s in ((steps // 8, 8), (1, steps % 8)) if n and s]
    # at a fixed clock, half a second on: some heads due, then FUTUREs
    now += 0 if flags.get("advance_now") else S // 2
    st, jst, t = to_torch(arrays), to_jax(arrays), now
    kw = dict(allow_limit_break=False, anticipation_ns=0, **flags)
    for _ in range(2):
        got = prog(st, t)
        want = tk.engine_run(st, t, steps, **kw)
        jwant = jk.engine_run(jst, jnp.int64(t), steps, **kw)
        assert len(got) == len(want) == len(jwant)
        for f in got[0]._fields:
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
            assert_np_equal(f, _np(getattr(got[0], f)),
                            np.asarray(getattr(jwant[0], f)))
        for f in got[2]._fields:
            assert_np_equal(f, _np(getattr(got[2], f)),
                            np.asarray(getattr(jwant[2], f)))
        for i in (1,) + tuple(range(3, len(got))):
            assert_np_equal(f"out {i}", _np(got[i]), np.asarray(jwant[i]))
        st, jst, t = got[0], jwant[0], int(got[1])
    assert int((got[2].type == tk.RETURNING).sum()) > 0
    if flags.get("advance_now"):
        assert int(got[1]) > now


def test_serial_leg_is_one_program_a_configuration():
    """``serial_leg`` is a module cache: one unrecorded program a
    configuration, shared by every caller; zero steps is
    ``engine_run`` itself."""
    a = tk.serial_leg(3, allow_limit_break=False, anticipation_ns=0,
                      advance_now=True, with_metrics=True)
    assert a is tk.serial_leg(3, allow_limit_break=False, anticipation_ns=0,
                              advance_now=True, with_metrics=True)
    assert isinstance(a, tcp.SerialJit) and not a.record
    assert a.cache == "serial.leg"
    arrays, now = random_state(11, 40, 8), 50 * S
    st = to_torch(arrays)
    out = tk.serial_leg(0, allow_limit_break=False, anticipation_ns=0)(
        st, now)
    assert out[2].type.shape == (0,)


# ----------------------------------------------------------------------
# the pull queue
# ----------------------------------------------------------------------

def queue_sequence(b, spec: int):
    """Creates, adds, capacity and ring growth, an idle reactivation,
    pulls with and without the speculative buffer (an invalidated
    prefetch and its settle among them), ``pull_batch`` with
    ``advance_now`` off and on, ``pull_batch_stream`` with and without
    pending rows."""
    infos = {c: b.ClientInfo(1 + c % 3 if c % 4 == 0 else 0,
                             1 + c % 3, 8 if c % 5 == 4 else 0)
             for c in range(10)}
    clock = [0.0]
    q = b.make(lambda c: infos[c], capacity=4, ring_capacity=4,
               speculative_batch=spec, idle_age_s=10.0, erase_age_s=1e6,
               monotonic_clock=lambda: clock[0])
    out, t = [], S
    for c in range(6):                       # capacity 4 -> 8
        for i in range(3):
            q.add_request(("r", c, i), c, b.ReqParams(1, 1), time_ns=t,
                          cost=1 + c % 2)
    for _ in range(5):
        t += S // 7
        out.append(norm(q.pull_request(t)))
    # a tail append to a buffered client invalidates the prefetch
    q.add_request(("x", 0), 0, b.ReqParams(1, 1), time_ns=t, cost=1)
    out.append(norm(q.pull_request(t)))
    out.append([norm(p) for p in q.pull_batch(t + S, 6)])
    for i in range(6):                       # ring 4 -> 8
        q.add_request(("g", i), 1, b.ReqParams(2, 1), time_ns=t + i,
                      cost=1)
    out.append([norm(p) for p in q.pull_batch(t + 2 * S, 9,
                                              advance_now=True)])
    q.do_clean()
    clock[0] += 20.0
    q.do_clean()                             # every client idle
    t += 50 * S
    for c in (6, 2, 7):                      # a create, reactivations
        q.add_request(("i", c), c, b.ReqParams(1, 1), time_ns=t, cost=1)
    out.append([[norm(p) for p in w]
                for w in q.pull_batch_stream(t, S // 10, 3, 4)])
    out.append([[norm(p) for p in w]
                for w in q.pull_batch_stream(t + S, S // 10, 2, 4)])
    for c in range(6):
        q.add_request(("z", c), c, b.ReqParams(1, 1), time_ns=t + S,
                      cost=1)
    for _ in range(6):
        t += S // 3
        out.append(norm(q.pull_request(t + S)))
    out.append([norm(p) for p in q.pull_batch(t + 3 * S, 64)])
    return q, out


@pytest.mark.parametrize("spec", [0, 4], ids=["plain", "speculative"])
def test_queue_sequence_equals_jax(fresh, spec):
    """The call sequence through the port's programs and the JAX queue:
    every ``PullReq``, counter, spec counter, ledger and SLO row and the
    settled state equal; the programs are the module cache's, under the
    JAX keys."""
    qj, want = queue_sequence(JAX, spec)
    qp, got = queue_sequence(PORT, spec)
    assert got == want
    assert counters(qp) == counters(qj)
    vp, vj = device_view(qp), device_view(qj)
    assert vp["spec"][:4] == vj["spec"][:4]
    if spec:
        assert vp["spec"][2] > 0 and vp["spec"][0] > 0
    assert_device_views_equal(vp, vj)
    assert qp.state.capacity == 8 and qp.state.ring_capacity == 8
    assert sorted(TQ._JIT_CACHE, key=repr) == sorted(JQ._JIT_CACHE,
                                                     key=repr)
    # the queue's records: a retrace at each growth and each new width
    # of the op batch, with JAX's diff paths
    rec = _records(fresh[1], ("queue",))
    assert rec == _records(fresh[0], ("queue",))
    assert any(r for _, r, _ in rec.values())
    kinds = {k[0] for k in TQ._JIT_CACHE}
    assert kinds == ({"ingest", "run", "ingest_run", "run_stream",
                      "ingest_run_stream"} | ({"run_h"} if spec else set()))
    assert all(isinstance(p, tcp.InstrumentedJit) and p.cache == "queue"
               for p in TQ._JIT_CACHE.values())


def test_queue_ops_enter_as_one_tensor():
    """The pending rows reach the program as one int64 ``[10, B]``
    tensor, ``B`` a power of two; its ingest equals the ingest of the
    rows; a numpy batch cannot enter a program."""
    infos = {c: PORT.ClientInfo(0, 1, 0) for c in range(3)}
    q = PORT.make(lambda c: infos[c], capacity=8, ring_capacity=8)
    for c in range(3):
        q.add_request(("r", c), c, PORT.ReqParams(), time_ns=S)
    rows = q._build_ops()
    assert rows.shape == (10, 8) and rows.dtype == np.int64   # 3 + 3 rows
    assert (rows[0, 6:] == tk.OP_NOP).all()
    packed = tk.upload_ops(rows, "cpu")
    assert packed.dtype == torch.int64 and packed.shape == (10, 8)
    a = tk.ingest(q.state, packed, anticipation_ns=0)
    b = tk.ingest(q.state, tk.IngestOps(*rows), anticipation_ns=0)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    prog = TQ._shared_jit_ingest(0)
    with pytest.raises(TypeError, match=r"\[0\]\[1\].*numpy"):
        prog(q.state, rows)


# ----------------------------------------------------------------------
# the cluster programs
# ----------------------------------------------------------------------

def _clusters(kind: str, n_clients: int = NC):
    mesh = JCL.make_mesh(NS)
    jc = JCL.init_cluster(NS, n_clients, ring_capacity=RING,
                          tracker_kind=kind)
    inv = [np.resize(_inv(i), n_clients) for i in range(3)]
    jc = JCL.shard_cluster(JCL.install_clients(
        jc, *(jnp.asarray(a) for a in inv)), mesh)
    tmesh = TCL.make_mesh(NS, "cpu")
    tc = TCL.install_clients(TCL.init_cluster(
        NS, n_clients, ring_capacity=RING, tracker_kind=kind,
        device="cpu"), *inv)
    return mesh, jc, tmesh, tc


def _arrivals(seed: int, steps: int, n_clients: int = NC) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, (steps, NS, n_clients)).astype(np.int32)


def _digest_equal(tseq, jseq):
    assert TRC.decision_digest(tseq) == JRC.decision_digest(jseq)


@pytest.mark.parametrize("kind", ["orig", "borrowing"])
def test_run_cluster_rounds_equals_jax(port_fresh, kind):
    """``run_cluster_rounds`` through ``cluster.cluster_step``: the
    cluster and every round's decisions equal JAX's; one entry under
    JAX's key, ``cfg + (mesh_shape,)``, compiled once."""
    mesh, jc, tmesh, tc = _clusters(kind)
    arrivals = _arrivals(5, 3)
    jc, jseq = JCL.run_cluster_rounds(jc, arrivals, jnp.asarray(COSTS),
                                      mesh, **KW)
    tc, tseq = TCL.run_cluster_rounds(tc, arrivals, COSTS, tmesh, **KW)
    assert_cluster_equal(tc, jc)
    for t, (a, b) in enumerate(zip(tseq, jseq)):
        assert_tree_equal(f"round {t}", a, b)
    _digest_equal(tseq, jseq)
    (prog,) = TCL._ROUNDS_JIT_CACHE.values()
    assert isinstance(prog, tcp.InstrumentedJit) and prog.capture
    assert prog.cache == "cluster.cluster_step"
    assert prog.entry == repr((K, MAX_ARR, 0, False, ADV, (NS,)))
    assert list(_records(port_fresh).values()) == [(1, 0, [])]


def _plan(name: str, steps: int = 4):
    """One fault of each kind on a zero plan (both packages' types)."""
    up = np.ones((steps, NS), dtype=bool)
    skew = np.zeros((steps, NS), dtype=np.int64)
    delay = np.zeros((steps, NS), dtype=bool)
    dup = np.zeros((steps, NS), dtype=bool)
    if name == "outage":
        up[1:3, 2] = False                   # down at 1-2, back at 3
    elif name == "restart":
        up[0, 1] = False                     # down from the start
    elif name == "delay":
        delay[1:3, 1] = True
    elif name == "dup":
        dup[1, 3] = True
        dup[2, 0] = True
    elif name == "skew":
        skew[1, 0] = 30_000_000
        skew[2, 3] = -20_000_000
    return (JF.FaultPlan(up, skew, delay, dup),
            TF.FaultPlan(up.copy(), skew.copy(), delay.copy(), dup.copy()))


@pytest.mark.parametrize("plan_name", ["outage", "restart", "delay", "dup",
                                       "skew"])
def test_run_with_plan_equals_jax(port_fresh, plan_name):
    """``run_with_plan`` through ``cluster.robust_cluster_step``, a
    step's faults its tensor inputs: the robust state (views, liveness,
    metrics), the decisions and the metrics totals equal JAX's; every
    fault step shares the one signature (one compile)."""
    jplan, tplan = _plan(plan_name)
    mesh, jc, tmesh, tc = _clusters("orig")
    arrivals = _arrivals(11, 4)
    jrc, jseq = JRC.run_with_plan(
        JRC.shard_robust(JRC.init_robust(jc), mesh), arrivals,
        jnp.asarray(COSTS), mesh, jplan, **KW)
    trc, tseq = TRC.run_with_plan(
        TRC.shard_robust(TRC.init_robust(tc), tmesh), arrivals, COSTS,
        tmesh, tplan, **KW)
    assert_cluster_equal(trc.cluster, jrc.cluster)
    for f in ("view_delta", "view_rho", "up_prev", "metrics"):
        assert_np_equal(f, _np(getattr(trc, f)),
                        np.asarray(getattr(jrc, f)))
    for t, (a, b) in enumerate(zip(tseq, jseq)):
        assert_tree_equal(f"step {t}", a, b)
    assert TRC.metrics_totals(trc) == JRC.metrics_totals(jrc)
    assert TRC.metrics_totals(trc)["faults_injected"] > 0
    (prog,) = TRC._STEP_JIT_CACHE.values()
    assert prog.cache == "cluster.robust_cluster_step"
    assert prog.entry == repr((K, MAX_ARR, 0, False, ADV, (NS,)))
    assert list(_records(port_fresh).values()) == [(1, 0, [])]


def test_fault_step_inputs_are_tensors_on_the_layout():
    """A fault step enters as tensors of its dtypes laid out on the
    mesh: on a grouped layout each group holds its servers' values."""
    _, tplan = _plan("skew")
    fault = TF.plan_step(tplan, 1)
    mesh = TCL.make_mesh(NS, devices=("cpu", "cpu"))
    f = TRC.fault_step_inputs(fault, mesh)
    assert [TCL.groups.gather(x).dtype for x in f] == \
        [torch.bool, torch.int64, torch.bool, torch.bool]
    assert TCL.groups.is_grouped(f.up)
    assert np.array_equal(TCL.groups.gather(f.skew_ns).numpy(),
                          fault.skew_ns)


@pytest.mark.parametrize("every", [1, 4])
def test_jit_mesh_rounds_equals_jax_and_keys_by_remainder(fresh, every):
    """``jit_mesh_rounds`` at two chunk positions (``round0`` 0, then
    the next chunk's 2): the cluster, views, metrics, merged metrics,
    pressure and decisions equal JAX's.  The key holds ``round0 %
    counter_sync_every``: at K=1 both positions are one entry, compiled
    once; at K=4 each remainder is an entry of its own."""
    mesh, jc, tmesh, tc = _clusters("orig")
    arrivals = _arrivals(7, 4)
    kw = dict(KW, counter_sync_every=every, with_merged=True,
              with_pressure=True)
    jv = (None, None, None)
    tv = (None, None, None)
    for r0 in (0, 2):
        jm = JCL.jit_mesh_rounds(mesh, epochs=2, round0=r0, **kw)(
            jc, jnp.asarray(arrivals[r0:r0 + 2]), jnp.asarray(COSTS), *jv)
        tm = TCL.jit_mesh_rounds(tmesh, epochs=2, round0=r0, **kw)(
            tc, arrivals[r0:r0 + 2], COSTS, *tv)
        assert_cluster_equal(tm.cluster, jm.cluster)
        for f in ("view_delta", "view_rho", "metrics", "decs", "merged",
                  "pressure", "pressure_merged"):
            assert_tree_equal(f, getattr(tm, f), getattr(jm, f))
        jc, tc = jm.cluster, tm.cluster
        jv = (jm.view_delta, jm.view_rho, jm.metrics)
        tv = (tm.view_delta, tm.view_rho, tm.metrics)
    assert sorted(k[2:] for k in TCL._MESH_ROUNDS_JIT_CACHE) == \
        sorted(k[1:] for k in JCL._MESH_ROUNDS_JIT_CACHE)
    rec = _records(fresh[1])
    assert rec == _records(fresh[0])
    assert len(TCL._MESH_ROUNDS_JIT_CACHE) == (1 if every == 1 else 2)
    # the first call's views are None, the second's tensors: a retrace
    assert sorted(v[:2] for v in rec.values()) == \
        ([(2, 1)] if every == 1 else [(1, 0), (1, 0)])


# ----------------------------------------------------------------------
# the four caches' records against JAX's
# ----------------------------------------------------------------------

def _sequence(pkg: str):
    """One call sequence through the three cluster caches of ``pkg``
    (the queue's records are held by :func:`test_queue_sequence_equals_jax`):
    the cluster step and the mesh rounds at two populations, the robust
    step under a plan and then without one."""
    CL, RC = (JCL, JRC) if pkg == "jax" else (TCL, TRC)
    for n in (NC, NC + 4):
        mesh, jc, tmesh, tc = _clusters("orig", n)
        m, c = (mesh, jc) if pkg == "jax" else (tmesh, tc)
        costs = np.resize(COSTS, n)
        costs = jnp.asarray(costs) if pkg == "jax" else costs
        arrivals = _arrivals(3, 2, n)
        arr = jnp.asarray(arrivals) if pkg == "jax" else arrivals
        CL.run_cluster_rounds(c, arrivals, costs, m, **KW)
        if n == NC:
            rc = RC.shard_robust(RC.init_robust(c), m)
            plan = _plan("outage", 2)[0 if pkg == "jax" else 1]
            rc, _ = RC.run_with_plan(rc, arrivals, costs, m, plan, **KW)
            RC.run_with_plan(rc, arrivals, costs, m, None, **KW)
        for every, r0 in (((1, 0), (1, 3), (4, 1)) if n == NC
                          else ((1, 0),)):
            CL.jit_mesh_rounds(m, epochs=2, round0=r0,
                               counter_sync_every=every, **KW)(
                c, arr, costs, None, None, None)


def test_plane_records_equal_jax(fresh):
    """The same sequence in both packages: per cache and entry the
    compiles, retraces and retrace diff paths equal JAX's.  The cluster
    step and the K=1 mesh rounds retrace at the second population (the
    diff names the state's first leaf); the robust step when the plan
    ends (the diff names the fault's leaves); the K=1 mesh rounds at
    ``round0`` 0 and 3 are one entry."""
    jpl, tpl = fresh
    _sequence("jax")
    _sequence("port")
    jrec, trec = _records(jpl), _records(tpl)
    assert trec == jrec
    assert {c for c, _ in trec} == set(CACHES) - {"queue"}
    by_cache = {}
    for (c, _), (n, r, paths) in trec.items():
        by_cache.setdefault(c, []).append((n, r, paths))
    (step,) = by_cache["cluster.cluster_step"]
    assert step[:2] == (2, 1) and step[2][0] == "[0][0].engine.active"
    (robust,) = by_cache["cluster.robust_cluster_step"]
    assert robust[:2] == (2, 1) and robust[2] == [
        f"[1]['fault'].{f}" for f in TF.FaultStep._fields]
    assert sorted(v[:2] for v in by_cache["cluster.mesh_rounds"]) == \
        [(1, 0), (2, 1)]
    assert tpl.totals()["retraces"] == jpl.totals()["retraces"]
    assert tpl.totals()["dispatch_fallbacks"] == 0


def test_bare_step_is_outside_the_records(fresh):
    """The dry run's step (``bare_step_jit``) equals ``cluster_step``
    and records nothing, as a bare ``jax.jit``; inside
    ``compile_plane.eager`` a program runs its body with no record
    either."""
    _, _, tmesh, tc = _clusters("orig")
    arrivals = _arrivals(9, 1)[0]
    prog = TCL.bare_step_jit(tmesh, (K, MAX_ARR, 0, False, ADV))
    got = prog(tc, torch.from_numpy(arrivals), torch.from_numpy(COSTS))
    want = TCL.cluster_step(tc, arrivals, COSTS, tmesh, **KW)
    a, b = bridge.cluster_to_numpy(got[0]), bridge.cluster_to_numpy(want[0])
    for part in ("engine", "tracker"):
        for f in a[part]:
            assert_np_equal(f"{part}.{f}", a[part][f], b[part][f])
    assert_np_equal("now", a["now"], b["now"])
    assert_tree_equal("decs", got[1], want[1])
    with tcp.eager():
        TCL.run_cluster_rounds(tc, arrivals[None], COSTS, tmesh, **KW)
    assert fresh[1].entries() == []


def test_queue_state_never_becomes_a_constant():
    """Two queues share the programs (module cache); each one's state
    and ops are the programs' inputs, so one queue's call never replays
    another's values."""
    infos = {c: PORT.ClientInfo(0, 1 + c, 0) for c in range(3)}
    qa = PORT.make(lambda c: infos[c], capacity=4, ring_capacity=4)
    qb = PORT.make(lambda c: infos[c], capacity=4, ring_capacity=4)
    for c in range(3):
        qa.add_request(("a", c), c, PORT.ReqParams(), time_ns=S)
    qb.add_request(("b", 2), 2, PORT.ReqParams(), time_ns=S)
    a = [norm(p) for p in qa.pull_batch(2 * S, 4)]
    b = [norm(p) for p in qb.pull_batch(2 * S, 4)]
    assert sorted(p[2] for p in a[:3]) == [("a", 0), ("a", 1), ("a", 2)]
    assert a[3][0] == "NONE"
    assert b[0][2] == ("b", 2) and b[1][0] == "NONE"


# ----------------------------------------------------------------------
# the queue's ingest programs, captured whole
# ----------------------------------------------------------------------

INGEST_PROGRAMS = {
    "ingest": (lambda m: m._shared_jit_ingest(0), ()),
    "ingest_run": (lambda m: m._shared_jit_ingest_run(5, True, False, 0),
                   (60 * S,)),
    "ingest_run_stream": (
        lambda m: m._shared_jit_ingest_run_stream(3, 2, False, 0),
        (60 * S, S // 10)),
}


@pytest.mark.parametrize("name", list(INGEST_PROGRAMS))
def test_queue_ingest_programs_equal_jax(fresh, name):
    """The queue's three ingest programs (the device ingest, then the
    serial steps and the packing, one body) on a batch with re-created
    slots, reactivations and NOP rows, then on a batch twice as wide (a
    retrace): the state and the packed decisions equal the JAX
    programs', and so do the records."""
    from test_torch_ingest_dense import _rows, _state

    make, extra = INGEST_PROGRAMS[name]
    rng = np.random.default_rng(17)
    arrays = _state(17, 24, 8, max_depth=3)
    for b in (32, 64):
        rows = _rows(rng, arrays, b, p_create=0.2)
        want = make(JQ)(to_jax(arrays), jnp.asarray(rows), *extra)
        got = make(TQ)(to_torch(arrays), torch.from_numpy(rows), *extra)
        if name == "ingest":
            want, got = (want,), (got,)
        for f in got[0]._fields:
            assert_np_equal(f, _np(getattr(got[0], f)),
                            np.asarray(getattr(want[0], f)))
        for i in range(1, len(got)):
            assert_np_equal(f"out {i}", _np(got[i]), np.asarray(want[i]))
    rec = _records(fresh[1], ("queue",))
    assert rec == _records(fresh[0], ("queue",))
    assert [v[:2] for v in rec.values()] == [(2, 1)]
    (prog,) = TQ._JIT_CACHE.values()
    assert isinstance(prog, tcp.InstrumentedJit) and prog.capture


def test_server_round_reads_nothing_back(monkeypatch):
    """A cluster server's round builds each wave's op batch on the
    device and ingests it in one fixed-shape pass: no op that reads a
    value to the host or sizes a tensor by the data runs in it (K3's
    plain version, the CPU's stand-in for the kernel, set aside)."""
    from test_torch_ingest_dense import _Ops

    _, _, _, tc = _clusters("orig")
    arrivals = torch.from_numpy(_arrivals(3, 1)[0])
    g_d, g_r = TCL.global_counters(tc.tracker)
    monkeypatch.setattr(tk, "ingest_scan",
                        lambda r, c: torch.zeros_like(r[0]))
    seen = _Ops()
    with seen:
        out = TCL.server_round(
            TCL.shard_view(tc.engine, 1), TCL.shard_view(tc.tracker, 1),
            TCL.shard_view(tc.now, 1), arrivals[1], torch.from_numpy(COSTS),
            g_d, g_r, decisions_per_step=K, anticipation_ns=0,
            allow_limit_break=False, max_arrivals=MAX_ARR)
    assert int((out[3].type == tk.RETURNING).sum()) > 0
    banned = {"nonzero", "unique", "_unique2", "masked_select",
              "_local_scalar_dense", "item", "copy_between_devices"}
    assert not seen.names & banned, seen.names & banned


def test_cluster_programs_capture_on_one_device():
    """The cluster programs are captured wherever the layout holds one
    device (several groups on it included) and run eagerly only over
    several distinct cards (one CUDA graph holds one device)."""
    cfg = (K, MAX_ARR, 0, False, ADV)
    for mesh in (TCL.make_mesh(NS, "cpu"),
                 TCL.make_mesh(NS, devices=("cpu", "cpu"))):
        assert TCL.captured(mesh)
        prog = TCL.mesh_step_jit({}, TCL.cluster_step, mesh, cfg)
        assert isinstance(prog, tcp.InstrumentedJit) and prog.capture
        rounds = TCL.jit_mesh_rounds(mesh, epochs=1, decisions_per_step=K)
        assert rounds.program.capture
