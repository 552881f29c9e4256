"""The mesh across devices (``parallel/groups.py`` and the grouped paths
of ``parallel/``, ``obs/``, ``robust/`` and ``sim/``) on the CPU, held
exactly.

The port lays a mesh's shards out in D contiguous groups, one stack a
group on its device; here every group names the CPU (``("cpu",) * D``),
which runs the grouped code the way several cards do.  Held: the layout
helpers (round trips, views, the ``S % D`` rule, ``devices=None`` never
picking the CPU), the exact reductions between groups (the counter sum
and maximum and the six telemetry merges, near the int64 range), the
mesh chunk over D in {1, 2, S} against the JAX package's ``jit_mesh_chunk``
on S virtual devices (one JAX run a configuration, reused for every D),
``cluster_step`` / ``run_mesh_rounds`` and the robust cluster over 2, 4
and 8 groups against the JAX ``shard_map`` (one server a device, as the
JAX cluster programs place them), and ``run_device_sim``
over groups against the JAX package's ``run_device_sim(mesh=
make_mesh(D))``.  The tolerance is zero."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cluster as C
import test_torch_mesh as M
from dmclock_tpu.parallel import cluster as JCL
from dmclock_tpu.robust import cluster as JRC
from dmclock_tpu.robust import faults as JF
from dmclock_tpu.sim import config as jcfg
from dmclock_tpu.sim import device_sim as JDS
from dmclock_tpu_torch import device as tdevice
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.obs import histograms as thist
from dmclock_tpu_torch.obs import provenance as tprov
from dmclock_tpu_torch.obs import slo as tslo
from dmclock_tpu_torch.parallel import cluster as TCL
from dmclock_tpu_torch.parallel import groups
from dmclock_tpu_torch.parallel import mesh as TM
from dmclock_tpu_torch.parallel import tracker as TT
from dmclock_tpu_torch.robust import cluster as TRC
from dmclock_tpu_torch.robust import faults as TF
from dmclock_tpu_torch.sim import config as tcfg
from dmclock_tpu_torch.sim import device_sim as TDS

from test_torch_support import assert_np_equal


def cpus(d: int) -> tuple:
    return ("cpu",) * d


def _leaves(tree) -> list:
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in _leaves(v)]


def assert_same_tree(name, got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b), name
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{name}[{i}]"


# ----------------------------------------------------------------------
# the layout
# ----------------------------------------------------------------------

def _stacked_state(s=8):
    st = bridge.state_from_numpy(M._state_np("prefix-sort"), "cpu")
    return TM.stack_shards(st, s)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_place_gather_round_trip_and_views(d):
    st = _stacked_state()
    placed = TCL.place_shards(st, TCL.make_mesh(8, devices=cpus(d)))
    assert groups.is_grouped(placed) == (d > 1)
    assert groups.leading(placed) == 8
    assert_same_tree("round trip", TCL.gather_shards(placed), st)
    for s in range(8):
        assert_same_tree(f"view {s}", TCL.shard_view(placed, s),
                         TCL.shard_view(st, s))
    if d > 1:
        # contiguous blocks: shard s on group s // (S // D), own storage
        per = 8 // d
        for g, part in enumerate(placed.parts):
            assert_same_tree(f"part {g}", part, groups.tree_map(
                lambda a, g=g: a[g * per:(g + 1) * per], st))
            assert part.depth.data_ptr() != st.depth.data_ptr()
        assert groups.locate(placed, 5) == divmod(5, per)


def test_layout_rules():
    with pytest.raises(ValueError, match="S % D"):
        TCL.make_mesh(6, devices=cpus(4))
    with pytest.raises(ValueError, match="S % D"):
        groups.place(torch.zeros((6, 3)), cpus(4))
    with pytest.raises(ValueError, match="not both"):
        TCL.make_mesh(4, device="cpu", devices=cpus(2))
    # one device takes any shard count
    one = TCL.make_mesh(6, devices=("cpu",))
    assert one.n_groups == 1 and not one.grouped
    m = TCL.make_mesh(8, devices=cpus(4))
    assert m.devices == (torch.device("cpu"),) * 4 and m.grouped
    assert m.device == torch.device("cpu")
    assert TCL.make_mesh(3, "cpu").devices == (torch.device("cpu"),)
    assert tdevice.parse_devices("4") == 4
    assert tdevice.parse_devices("cuda:0, cuda:1") == ("cuda:0", "cuda:1")
    # the JAX caches' names, bound to the layout
    assert TCL.mesh_cache_key(m, (1, 2)) == (8, m.devices, 1, 2)
    cache = {}
    f1 = TCL.mesh_step_jit(cache, TCL.cluster_step, m, (4, 1, 0, False, 0))
    assert TCL.mesh_step_jit(cache, TCL.cluster_step, m,
                             (4, 1, 0, False, 0)) is f1
    assert TCL.jit_mesh_rounds(m, epochs=2, decisions_per_step=4) is \
        TCL.jit_mesh_rounds(m, epochs=2, decisions_per_step=4)


def test_devices_none_needs_cuda_and_never_picks_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    for call in (lambda: TCL.make_mesh(4),
                 lambda: TCL.make_mesh(4, devices=None),
                 lambda: tdevice.resolve_devices(None),
                 lambda: tdevice.resolve_devices(2),
                 lambda: TCL.make_mesh(2, devices=("cuda:0", "cuda:1")),
                 lambda: TDS.run_device_sim(tcfg.SimConfig(),
                                            devices=None, device="cuda")):
        with pytest.raises(RuntimeError, match="cuda|CUDA"):
            call()


# ----------------------------------------------------------------------
# the reductions between groups
# ----------------------------------------------------------------------

# counters the planes can reach: sums of eight stay inside int64
BIG = 1 << 59


def _rnd(gen, *shape):
    return torch.randint(-BIG, BIG, shape, generator=gen,
                         dtype=torch.int64)


def _telemetry_blocks(gen, s=8, n=40):
    return {
        "metrics": (tobs.metrics_mesh_reduce,
                    _rnd(gen, s, tobs.NUM_METRICS)),
        "hists": (thist.hist_mesh_reduce,
                  _rnd(gen, s, thist.NUM_HISTS, thist.NUM_BUCKETS + 1)),
        "ledger": (thist.ledger_mesh_reduce,
                   _rnd(gen, s, n, thist.LED_COLS)),
        "window": (tslo.window_mesh_reduce, _rnd(gen, s, n, tslo.W_FIELDS)),
        "pressure": (tprov.pressure_mesh_reduce,
                     _rnd(gen, s, tprov.PRESS_FIELDS)),
        "prov": (tprov.prov_mesh_reduce, tprov.ProvBlock(
            margin_hist=_rnd(gen, s, thist.NUM_BUCKETS + 1),
            scal=_rnd(gen, s, tprov.PS_FIELDS),
            last_served=_rnd(gen, s, n))),
    }


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["metrics", "hists", "ledger", "window",
                                  "pressure", "prov"])
def test_telemetry_reducers_over_groups_equal_stacked(name, d):
    fn, block = _telemetry_blocks(torch.Generator().manual_seed(11))[name]
    got = fn(groups.place(block, cpus(d)))
    assert_same_tree(name, got, fn(block))
    # and the JAX package's host merges agree on the stacked block
    if name == "metrics":
        from dmclock_tpu.obs import device as jobs
        assert_np_equal("jax", got.numpy(), jobs.metrics_combine_np(
            np.zeros(jobs.NUM_METRICS, np.int64), *block.numpy()))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_counter_sum_and_max_over_groups_equal_stacked(d):
    gen = torch.Generator().manual_seed(3)
    x = _rnd(gen, 8, 50)
    g = groups.place(x, cpus(d))
    total = TT.server_sum(g)
    copies = total if d > 1 else [total]
    assert len(copies) == d
    for c in copies:
        assert torch.equal(c, x.sum(0))
    assert torch.equal(TT.server_max(g), x.max(0).values)
    mask = torch.arange(50) % 3 == 0
    assert torch.equal(TT.server_max(g, mask),
                       torch.where(mask, x.max(0).values, x.sum(0)))
    gd, gr = TT.global_counters_from(g, groups.place(-x, cpus(d)))
    for a, b in zip(gd if d > 1 else [gd], gr if d > 1 else [gr]):
        assert torch.equal(a, 1 + x.sum(0)) and torch.equal(b, 1 - x.sum(0))


# ----------------------------------------------------------------------
# the mesh chunk against the JAX package's on S virtual devices
# ----------------------------------------------------------------------

def _port_chunk(name, cfg, e0, counts, d, *, full=False, faults=None):
    mesh = TM.make_mesh(M.S, devices=cpus(d))
    fn = TM.build_mesh_chunk(mesh, **cfg)
    state = TM.stack_shards(bridge.state_from_numpy(M._state_np(name),
                                                    "cpu"), M.S, mesh)
    tele = (TM.place_shards(x, mesh)
            for x in M._tele("torch", M.S, full=full))
    out = fn(state, *TM.counter_init(M.S, M.N, mesh=mesh), e0, counts,
             *tele, faults)
    assert groups.is_grouped(out.cd) == (d > 1)
    return groups.gather(out)


CHUNK_CASES = [("prefix-sort", 1, False), ("prefix-sort", 4, False),
               ("prefix-sort", 1, True), ("prefix-sort", 4, True),
               ("calendar-wheel", 1, False)]


@pytest.mark.parametrize("d", [1, 2, M.S])
@pytest.mark.parametrize("name, every, faulty", CHUNK_CASES)
def test_mesh_chunk_over_groups_equals_jax(name, every, faulty, d):
    cfg = M._cfg(name, counter_sync_every=every, with_faults=faulty,
                 with_pressure=faulty)
    counts = M._counts(31)
    jfc = tfc = None
    if faulty:
        _, jfc = M._fault_chunk("jax")
        _, tfc = M._fault_chunk("torch")
    want = M._ref(("multidevice", name, every, faulty), lambda: M._run_jax(
        name, cfg, 1, counts, full=faulty, faults=jfc))
    got = _port_chunk(name, cfg, 1, counts, d, full=faulty, faults=tfc)
    M.assert_chunk_equal(got, want)
    assert int(got.outs["count"].sum()) > 0


def test_grouped_chunk_outputs_stay_on_their_groups():
    """A grouped chunk's outputs chain into the next chunk as they are,
    and two chained chunks equal one of twice the epochs."""
    name = "prefix-sort"
    counts = M._counts(37, e=2 * M.E)
    mesh = TM.make_mesh(M.S, devices=cpus(2))
    state = TM.stack_shards(bridge.state_from_numpy(M._state_np(name),
                                                    "cpu"), M.S, mesh)
    w = TM.place_shards(M._tele("torch", M.S, full=False)[2], mesh)
    one = TM.build_mesh_chunk(mesh, **M._cfg(name))
    out = None
    cd, cr, vd, vr = TM.counter_init(M.S, M.N, mesh=mesh)
    for i in range(2):
        c = torch.from_numpy(counts[:, i * M.E:(i + 1) * M.E])
        out = one(state, cd, cr, vd, vr, i * M.E, c, slo=w)
        state, cd, cr, vd, vr, w = (out.state, out.cd, out.cr,
                                    out.view_d, out.view_r, out.slo)
        assert groups.is_grouped(state) and out.slo_merged.dim() == 2
    whole = _port_chunk(name, M._cfg(name, epochs=2 * M.E), 0, counts, 1)
    assert_same_tree("state", groups.gather(state), whole.state)
    for f in ("cd", "cr", "view_d", "view_r", "slo", "slo_merged"):
        assert_same_tree(f, groups.gather(getattr(out, f)),
                         getattr(whole, f))


# ----------------------------------------------------------------------
# the cluster and the robust cluster against the JAX shard_map over D
# virtual devices
# ----------------------------------------------------------------------

# The JAX cluster programs place one server a device (their psum sits
# inside the per-server vmap, so it sums across devices only): the
# reference is the JAX run on S = 8 virtual devices, computed once and
# held against the port's layouts of 2, 4 and 8 groups.
_JAX: dict = {}


def _clusters(kind, d):
    jmesh = JCL.make_mesh(C.S)
    jc = JCL.init_cluster(C.S, C.C, ring_capacity=C.RING,
                          tracker_kind=kind)
    jc = JCL.install_clients(jc, jnp.asarray(C._inv(0)),
                             jnp.asarray(C._inv(1)),
                             jnp.asarray(C._inv(2)))
    jc = JCL.shard_cluster(jc, jmesh)
    tmesh = TCL.make_mesh(C.S, devices=cpus(d))
    tc = TCL.init_cluster(C.S, C.C, ring_capacity=C.RING,
                          tracker_kind=kind, device="cpu")
    tc = TCL.install_clients(tc, C._inv(0), C._inv(1), C._inv(2))
    return jmesh, jc, tmesh, TCL.shard_cluster(tc, tmesh)


def _gathered(x):
    return groups.gather(x, "cpu")


STEP_KW = dict(decisions_per_step=C.K, max_arrivals=C.MAX_ARR,
               advance_ns=C.ADV)
ROUNDS_KW = dict(STEP_KW, counter_sync_every=2, round0=1,
                 with_merged=True, with_pressure=True)


def _jax_cluster(kind):
    if ("cluster", kind) not in _JAX:
        jmesh, jc, _, _ = _clusters(kind, 1)
        step = jax.jit(functools.partial(
            JCL.cluster_step, mesh=jmesh, with_metrics=True,
            with_pressure=True, **STEP_KW))
        outs = []
        for t in range(2):
            jout = step(jc, jnp.asarray(C._arrivals(3, 2)[t]),
                        jnp.asarray(C.COSTS))
            jc = jout[0]
            outs.append(jout)
        jm = JCL.jit_mesh_rounds(jmesh, epochs=3, **ROUNDS_KW)(
            jc, jnp.asarray(C._arrivals(7, 3)), jnp.asarray(C.COSTS),
            None, None, None)
        _JAX[("cluster", kind)] = outs, jm
    return _JAX[("cluster", kind)]


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("kind", ["orig", "borrowing"])
def test_cluster_step_and_mesh_rounds_over_groups_equal_jax(kind, d):
    jouts, jm = _jax_cluster(kind)
    _, _, tmesh, tc = _clusters(kind, d)
    assert groups.is_grouped(tc.now)
    arrivals = C._arrivals(3, 2)
    for t in range(2):
        tout = TCL.cluster_step(tc, arrivals[t], C.COSTS, tmesh,
                                with_metrics=True, with_pressure=True,
                                **STEP_KW)
        tc = tout[0]
        C.assert_cluster_equal(_gathered(tc), jouts[t][0])
        for name, a, b in zip(("decs", "metrics", "merged", "pressure",
                               "pressure_merged"), tout[1:], jouts[t][1:]):
            C.assert_tree_equal(name, _gathered(a), b)
    tm = TCL.jit_mesh_rounds(tmesh, epochs=3, **ROUNDS_KW)(
        tc, C._arrivals(7, 3), C.COSTS, None, None, None)
    C.assert_cluster_equal(_gathered(tm.cluster), jm.cluster)
    for f in ("view_delta", "view_rho", "metrics", "decs", "merged",
              "pressure", "pressure_merged"):
        C.assert_tree_equal(f, _gathered(getattr(tm, f)), getattr(jm, f))


def _jax_robust(plan_name, steps, arrivals):
    if ("robust", plan_name) not in _JAX:
        jplan, _ = C._plan(plan_name, steps)
        jmesh, jc, _, _ = _clusters("orig", 1)
        jrc = JRC.shard_robust(JRC.init_robust(jc), jmesh)
        jstep = jax.jit(functools.partial(
            JRC.robust_cluster_step, mesh=jmesh, with_merged=True,
            with_pressure=True, **STEP_KW))
        outs = []
        for t in range(steps):
            jout = jstep(jrc, jnp.asarray(arrivals[t]),
                         jnp.asarray(C.COSTS), fault=JF.plan_step(jplan, t))
            jrc = jout[0]
            outs.append(jout)
        _JAX[("robust", plan_name)] = outs
    return _JAX[("robust", plan_name)]


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("plan_name", ["outage", "sampled"])
def test_robust_cluster_over_groups_equals_jax(plan_name, d):
    steps = 3
    arrivals = C._arrivals(11, steps)
    _, tplan = C._plan(plan_name, steps)
    jouts = _jax_robust(plan_name, steps, arrivals)
    _, _, tmesh, tc = _clusters("orig", d)
    trc = TRC.shard_robust(TRC.init_robust(tc), tmesh)
    for t in range(steps):
        tout = TRC.robust_cluster_step(
            trc, arrivals[t], C.COSTS, tmesh,
            fault=TF.plan_step(tplan, t), with_merged=True,
            with_pressure=True, **STEP_KW)
        trc = tout[0]
        C.assert_robust_equal(groups.gather(trc), jouts[t][0])
        for name, a, b in zip(("decs", "merged", "pressure",
                               "pressure_merged"), tout[1:], jouts[t][1:]):
            C.assert_tree_equal(name, _gathered(a), b)
    # the fused chaos rounds at K=2 equal the stacked ones (which
    # tests/test_torch_cluster.py holds to the JAX package's)
    fused = []
    for devices in (("cpu",), cpus(d)):
        tmesh = TCL.make_mesh(C.S, devices=devices)
        _, _, _, tc = _clusters("orig", len(devices))
        fused.append(TRC.run_mesh_rounds_with_plan(
            TRC.init_robust(tc), arrivals, C.COSTS, tmesh, tplan,
            counter_sync_every=2, **STEP_KW))
    (one, one_decs), (grp, grp_decs) = fused
    assert_same_tree("fused", groups.gather(grp), one)
    assert_same_tree("fused decs", groups.gather(grp_decs), one_decs)
    assert TRC.metrics_totals(grp) == TRC.metrics_totals(one)


# ----------------------------------------------------------------------
# the device sim against the JAX package's over D virtual devices
# ----------------------------------------------------------------------

def _sim_cfgs():
    """``tests/test_torch_device_sim.py``'s report config: 8 servers, 8
    clients of 50 ops at reservation 20, select range 4."""
    import test_torch_device_sim as DS

    return DS.make_cfgs([DS.group(8, client_total_ops=50,
                                  client_reservation=20.0,
                                  client_server_select_range=4)])


def _stacked_sim(tc):
    if "sim" not in _JAX:
        _JAX["sim"] = TDS.run_device_sim(tc, slices_per_launch=16,
                                         device="cpu")
    return _JAX["sim"]


@pytest.mark.parametrize("d", [2, 8])
def test_run_device_sim_over_groups_equals_jax(d):
    jc, tc = _sim_cfgs()
    jsim, _, want = JDS.run_device_sim(jc, mesh=JDS.make_mesh(d),
                                       slices_per_launch=16)
    counts = TDS.StepCounts()
    sim, spec, got = TDS.run_device_sim(tc, slices_per_launch=16,
                                        devices=cpus(d), counts=counts)
    assert got == want and "total ops: 400" in got
    assert groups.is_grouped(sim.engine)
    assert sim.engine.n_groups == d
    from test_torch_device_sim import assert_same, jax_numpy
    assert_same(TDS.device_sim_to_numpy(sim), jax_numpy(jsim))
    # the stacked run is the same sim
    one = _stacked_sim(tc)
    assert_same(TDS.device_sim_to_numpy(one[0]),
                TDS.device_sim_to_numpy(sim))


def test_device_sim_one_group_when_the_servers_do_not_divide():
    """Three devices do not divide 8 servers: one group on the first,
    as the JAX package falls back to one device."""
    _, tc = _sim_cfgs()
    sim, _, report = TDS.run_device_sim(tc, slices_per_launch=16,
                                        devices=cpus(3))
    assert not groups.is_grouped(sim.engine)
    assert report == _stacked_sim(tc)[2]


def test_device_sim_step_mesh_on_the_prefix_path():
    """``shard_device_sim`` + ``device_sim_step(mesh=)`` on the
    headline's prefix path (64 clients x 8 servers, 2 slices) equal the
    stacked step, the replicated leaves identical on every group."""
    _, sim0, spec = TDS.headline_setup(64, device="cpu")
    want = TDS.device_sim_step(sim0, spec, 2)
    mesh = TCL.make_mesh(spec.n_servers, devices=cpus(4))
    got = TDS.device_sim_step(TDS.shard_device_sim(sim0, mesh), spec, 2)
    for f in ("load", "t", "guard_trips"):
        copies = getattr(got, f)
        assert isinstance(copies, groups.Replicated) and len(copies) == 4
        for c in copies[1:]:
            assert_same_tree(f, c, copies[0])
    got2 = TDS.device_sim_step(sim0, spec, 2, mesh=mesh)
    for a in (got, got2):
        assert_same_tree("sim", TDS.gather_device_sim(a), want)
    assert TDS.served_total(got) == TDS.served_total(want) > 0
