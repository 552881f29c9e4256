"""The programs over a layout of several groups against the JAX
package's programs on 8 virtual CPU devices.

A layout of D >= 2 groups (``make_mesh(S, devices=...)``, a device may
repeat) runs each of the five multi-group programs as a
``compile_plane.StagedJit`` with one leg a group
(``compile_plane.group_legs``): ``mesh.chunk`` (``parallel/mesh.py``
``jit_mesh_chunk``: one segment leg a group, the counter sums between
the segments), ``cluster.cluster_step``, ``cluster.robust_cluster_step``
and ``cluster.mesh_rounds`` (``parallel/cluster.py``,
``robust/cluster.py``: one round leg a group, the round's sum and the
merges between), and the device sim's step (``sim/device_sim.py``
``jit_device_sim_step``: per group the head, the serve blocks and the
tail's two halves, the slice's three sums between).  A one-group layout
is one program, as before.

Held here: (a) the plan is read from the layout alone, before any
capture: which legs a program builds and on which device, over
``(cuda:0,)``, ``(cuda:0,) * 2``, ``(cuda:0, cuda:1)`` and four cards,
with nothing run on a card; (b) ``mesh.chunk`` over 1, 2, 4 and 8 groups
of the CPU equals JAX's 8-device chunk on every field at K=1, at K=4
with collective skipping, under a sampled fault plan, and on the wheel
(2 groups), with one leg signature a group for every segment; (c) the
cluster step, the robust step under a fault plan and the mesh rounds
through their programs over 2 and 8 groups equal JAX's ``shard_map``
programs on 8 devices; (d) the device sim's step over 8 groups equals
JAX's jitted step on 8 devices.  On the CPU a leg is its body run
eagerly; the tolerance is zero."""

import dataclasses
import functools

import jax
import pytest
import torch

import test_torch_cluster as C
import test_torch_mesh as M
import test_torch_multidevice as MD
from dmclock_tpu.robust import faults as JF
from dmclock_tpu.sim import device_sim as JDS
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.obs import compile_plane as tcp
from dmclock_tpu_torch.parallel import cluster as TCL
from dmclock_tpu_torch.parallel import groups
from dmclock_tpu_torch.parallel import mesh as TM
from dmclock_tpu_torch.robust import cluster as TRC
from dmclock_tpu_torch.robust import faults as TF
from dmclock_tpu_torch.sim import device_sim as TDS

S = 8
CHAOS = "seed=7,p_dropout=0.05,mean_outage_steps=2,p_dup=0.1"
_REFS: dict = {}


def cpus(d: int) -> tuple:
    return ("cpu",) * d


def _ref(key, thunk):
    if key not in _REFS:
        _REFS[key] = thunk()
    return _REFS[key]


# ----------------------------------------------------------------------
# (a) the plan from the layout
# ----------------------------------------------------------------------

CARDS = tuple(torch.device("cuda", i) for i in range(4))
LAYOUTS = {"one card": CARDS[:1], "one card twice": CARDS[:1] * 2,
           "two cards": CARDS[:2], "four cards": CARDS}


def _legs(prog) -> list:
    return [(leg.name, leg.group, leg.device, leg.program.device)
            for leg in prog.legs]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_is_read_from_the_layout(layout):
    """Each program over ``layout``: one group is one program captured
    whole; D >= 2 groups a staged program with its legs, one a group on
    the group's device and pinned to it.  Only programs are built."""
    devs = LAYOUTS[layout]
    d = len(devs)
    mesh = TCL.MeshLayout(S, devs[0], devs)

    def one_a_group(name):
        return [(name, g, dev, dev) for g, dev in enumerate(devs)]

    chunk = TM.jit_mesh_chunk(mesh, **M._cfg("prefix-sort"))
    cfg = (4, 1, 0, False, 0)
    step = TCL.mesh_step_jit({}, TCL.cluster_step, mesh, cfg)
    robust = TRC._jit_step(mesh, cfg)
    rounds = TCL.jit_mesh_rounds(mesh, epochs=2, decisions_per_step=4,
                                 with_pressure=True).program
    if d == 1:
        for prog in (chunk, step, robust, rounds):
            assert isinstance(prog, tcp.InstrumentedJit)
            assert prog.device is None
    else:
        for prog in (chunk, step, robust, rounds):
            assert isinstance(prog, tcp.StagedJit)
            assert not prog.captures()
        assert _legs(chunk) == one_a_group("segment")
        assert _legs(step) == one_a_group("legs")
        assert _legs(robust) == one_a_group("legs") + \
            one_a_group("faulty_legs")
        assert _legs(rounds) == one_a_group("round") + \
            one_a_group("pressure")
    # the device sim's step is staged on any layout (its loop reads);
    # over several groups the tail is two legs a group around its sums
    _, tc = MD._sim_cfgs()
    _, spec = TDS.init_device_sim(tc, device="cpu")
    spec = dataclasses.replace(spec, q_per_slice=4096)
    sim_step = TDS.jit_device_sim_step(spec, 2, devices=devs).program
    per = S // d
    servers = [(f"prefix {j}", g, dev, dev) for j in range(per)
               for g, dev in enumerate(devs)]
    tails = one_a_group("tail") if d == 1 else \
        one_a_group("fold") + one_a_group("load")
    assert _legs(sim_step) == one_a_group("head") + tails + servers
    assert not sim_step.captures()


def test_a_leg_refuses_tensors_off_its_device():
    """A leg is pinned to its group's device: a signature whose tensors
    lie elsewhere raises before anything runs."""
    (leg,) = tcp.group_legs(lambda g: (lambda x: x + 1), ("meta",),
                            name="leg", cache="t", entry=())
    with pytest.raises(ValueError, match="its leg on meta"):
        leg(torch.zeros(3))


def test_a_bare_cuda_group_is_pinned_to_the_current_card(monkeypatch):
    """A layout that names a bare ``cuda`` pins each such leg to the
    card current when the legs are built, by its index, so the exact
    device check holds and a call makes that card current."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    legs = tcp.group_legs(lambda g: (lambda x: x), ("cuda", "cuda:1"),
                          name="leg", cache="t", entry=())
    want = [torch.device("cuda", 2), torch.device("cuda", 1)]
    assert [leg.device for leg in legs] == want
    assert [leg.program.device for leg in legs] == want


# ----------------------------------------------------------------------
# (b) mesh.chunk against JAX's on 8 devices
# ----------------------------------------------------------------------

E = 8
CHUNKS = {
    "k1": ("prefix-sort", dict(counter_sync_every=1), False),
    "k4": ("prefix-sort", dict(counter_sync_every=4,
                               collective_skipping=True), False),
    "chaos": ("prefix-sort", dict(with_faults=True, with_pressure=True),
              True),
    "wheel": ("calendar-wheel", dict(epochs=2), False),
}


def _fault_chunk(pkg, epochs):
    mod = JF if pkg == "jax" else TF
    plan = mod.plan_from_spec(mod.parse_fault_spec(CHAOS), epochs + 1, S)
    return mod.plan_chunk(plan, 1, epochs + 1)


def _chunk_case(case):
    name, over, faulty = CHUNKS[case]
    cfg = M._cfg(name, **dict(dict(epochs=E), **over))
    counts = M._counts(41, s=S, e=cfg["epochs"])
    return name, cfg, counts, faulty


def _jax_chunk(case):
    name, cfg, counts, faulty = _chunk_case(case)
    faults = _fault_chunk("jax", cfg["epochs"]) if faulty else None
    return _ref(("chunk", case), lambda: M._run_jax(
        name, cfg, 1, counts, s=S, full=faulty, faults=faults))


def _port_chunk(case, d):
    name, cfg, counts, faulty = _chunk_case(case)
    mesh = TM.make_mesh(S, devices=cpus(d))
    prog = TM.jit_mesh_chunk(mesh, **cfg)
    state = TM.stack_shards(bridge.state_from_numpy(M._state_np(name),
                                                    "cpu"), S, mesh)
    tele = [TM.place_shards(x, mesh)
            for x in M._tele("torch", S, full=faulty)]
    faults = TM.fault_inputs(_fault_chunk("torch", cfg["epochs"]), mesh) \
        if faulty else None
    out = prog(state, *TM.counter_init(S, M.N, mesh=mesh), 1,
               torch.from_numpy(counts), *tele, faults)
    return prog, out


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["k1", "k4", "chaos"])
def test_mesh_chunk_program_over_groups_equals_jax(case, d):
    """``mesh.chunk`` through its program over ``d`` groups equals the
    JAX chunk on 8 devices on every field; over several groups each
    group's leg has one signature, which every segment replays."""
    want = _jax_chunk(case)
    prog, got = _port_chunk(case, d)
    assert groups.is_grouped(got.cd) == (d > 1)
    M.assert_chunk_equal(groups.gather(got), want)
    assert int(got.outs["count"].sum()) > 0 if d == 1 else \
        sum(int(p.sum()) for p in got.outs["count"].parts) > 0
    if d > 1:
        assert isinstance(prog, tcp.StagedJit) and len(prog.legs) == d
        assert all(len(leg.program._programs) == 1 for leg in prog.legs)


def test_wheel_chunk_program_over_two_groups_equals_jax():
    """The wheel calendar chunk (kernel K2's path) through its program
    over 2 groups equals JAX's on 8 devices."""
    want = _jax_chunk("wheel")
    _, got = _port_chunk("wheel", 2)
    M.assert_chunk_equal(groups.gather(got), want)


def test_grouped_chunk_program_chains_and_keeps_its_inputs():
    """Two chained calls of the grouped program equal one call of twice
    the epochs, and neither call writes the tensors it was given (the
    chunk is not donated)."""
    name = "prefix-sort"
    counts = M._counts(43, s=S, e=8)
    mesh = TM.make_mesh(S, devices=cpus(4))
    state = TM.stack_shards(bridge.state_from_numpy(M._state_np(name),
                                                    "cpu"), S, mesh)
    w = TM.place_shards(M._tele("torch", S, full=False)[2], mesh)
    ctrs = TM.counter_init(S, M.N, mesh=mesh)
    half = TM.jit_mesh_chunk(mesh, **M._cfg(name, epochs=4))
    kept = groups.gather(state)
    out = half(state, *ctrs, 0, torch.from_numpy(counts[:, :4]),
               slo=w)
    MD.assert_same_tree("input state", groups.gather(state), kept)
    out = half(out.state, out.cd, out.cr, out.view_d, out.view_r, 4,
               torch.from_numpy(counts[:, 4:]), slo=out.slo)
    whole = TM.build_mesh_chunk(TM.make_mesh(S, "cpu"),
                                **M._cfg(name, epochs=8))(
        TM.stack_shards(bridge.state_from_numpy(M._state_np(name), "cpu"),
                        S), *TM.counter_init(S, M.N, device="cpu"), 0,
        counts, slo=M._tele("torch", S, full=False)[2])
    for f in ("state", "cd", "cr", "view_d", "view_r", "slo",
              "slo_merged"):
        MD.assert_same_tree(f, groups.gather(getattr(out, f)),
                            getattr(whole, f))


# ----------------------------------------------------------------------
# (c) the three cluster programs against JAX's on 8 devices
# ----------------------------------------------------------------------

CFG = (C.K, C.MAX_ARR, 0, False, C.ADV)


@pytest.mark.parametrize("d", [2, 8])
def test_cluster_step_and_mesh_rounds_programs_equal_jax(d):
    """``cluster.cluster_step`` (2 rounds) and ``cluster.mesh_rounds``
    (3 rounds at K=2 from round 1, merged and pressure) through their
    programs over ``d`` groups equal JAX's on 8 devices."""
    jouts, jm = MD._jax_cluster("orig")
    _, _, tmesh, tc = MD._clusters("orig", d)
    step = TCL.mesh_step_jit({}, TCL.cluster_step, tmesh, CFG)
    assert isinstance(step, tcp.StagedJit)
    arrivals = torch.from_numpy(C._arrivals(3, 2))
    costs = torch.from_numpy(C.COSTS)
    for t in range(2):
        tc, decs = step(tc, arrivals[t], costs)
        C.assert_cluster_equal(MD._gathered(tc), jouts[t][0])
        C.assert_tree_equal("decs", MD._gathered(decs), jouts[t][1])
    rounds = TCL.jit_mesh_rounds(tmesh, epochs=3, **MD.ROUNDS_KW)
    tm = rounds(tc, C._arrivals(7, 3), C.COSTS, None, None, None)
    C.assert_cluster_equal(MD._gathered(tm.cluster), jm.cluster)
    for f in ("view_delta", "view_rho", "metrics", "decs", "merged",
              "pressure", "pressure_merged"):
        C.assert_tree_equal(f, MD._gathered(getattr(tm, f)),
                            getattr(jm, f))
    assert all(len(leg.program._programs) == 1
               for leg in rounds.program.legs)


@pytest.mark.parametrize("d", [2, 8])
def test_robust_step_program_equals_jax(d):
    """``cluster.robust_cluster_step`` through its program over ``d``
    groups under a sampled fault plan, each step's faults as tensors,
    equals JAX's step on 8 devices (state, views, metrics, decisions);
    a step with no faults runs the healthy legs."""
    steps = 3
    arrivals = C._arrivals(11, steps)
    _, tplan = C._plan("sampled", steps)
    jouts = MD._jax_robust("sampled", steps, arrivals)
    _, _, tmesh, tc = MD._clusters("orig", d)
    trc = TRC.shard_robust(TRC.init_robust(tc), tmesh)
    prog = TRC._jit_step(tmesh, CFG)
    for t in range(steps):
        trc, decs = prog(trc, torch.from_numpy(arrivals[t]),
                         torch.from_numpy(C.COSTS),
                         fault=TRC.fault_step_inputs(
                             TF.plan_step(tplan, t), tmesh))
        C.assert_robust_equal(groups.gather(trc), jouts[t][0])
        C.assert_tree_equal("decs", MD._gathered(decs), jouts[t][1])
    healthy, faulty = prog.legs[:d], prog.legs[d:]
    assert not any(leg.program._programs for leg in healthy)
    assert all(len(leg.program._programs) == 1 for leg in faulty)
    rc, _ = prog(trc, torch.from_numpy(arrivals[0]),
                 torch.from_numpy(C.COSTS))
    assert all(len(leg.program._programs) == 1 for leg in healthy)
    want, _ = TCL.cluster_step(groups.gather(trc.cluster), arrivals[0],
                               C.COSTS, TCL.make_mesh(S, "cpu"),
                               **MD.STEP_KW)
    MD.assert_same_tree("healthy", groups.gather(rc.cluster), want)


# ----------------------------------------------------------------------
# (d) the device sim's step against JAX's on 8 devices
# ----------------------------------------------------------------------

def test_device_sim_program_over_eight_groups_equals_jax():
    """The device sim's step over 8 groups (the prefix path, 32 clients
    on 8 servers, blocks of 2, two launches chained) equals JAX's
    jitted step on 8 devices, the sim donated, on every field."""
    from test_torch_device_sim import assert_same, jax_numpy
    from test_torch_device_sim_program import _setup

    jsim, jspec, tsim, tspec, slices = _setup("prefix", devices=cpus(S))
    jmesh = JDS.make_mesh(S)
    jstep = jax.jit(functools.partial(JDS.device_sim_step, spec=jspec,
                                      mesh=jmesh, slices=slices),
                    donate_argnums=(0,))
    jsim = JDS.shard_device_sim(jsim, jmesh)
    step = TDS.jit_device_sim_step(tspec, slices, devices=cpus(S), block=2)
    for _ in range(2):
        jsim = jstep(jsim)
        tsim = step(tsim)
    assert groups.is_grouped(tsim.engine)
    want = jax_numpy(jsim)
    assert_same(TDS.device_sim_to_numpy(tsim), want)
    assert int(want["served_resv"].sum() + want["served_prop"].sum()) > 0
