"""The device sim's step as a program (``sim.device_sim.
jit_device_sim_step``) against the JAX package's jitted step with the
sim donated (``jax.jit(partial(device_sim_step, ...),
donate_argnums=(0,))``) and against the port's op-by-op step, on every
``DeviceSim`` field: the scan path, the prefix path, Allow on the prefix
path, the three calendar schemes and 8 groups on one device, at blocks
of 1 (the default), 2 and 4.  Also: a masked prefix batch leaves the state
bit for bit; the program reads back one status a block replay; a
donated chain equals an undonated one; no leg reads the card back; and
the compile plane's shared donated buffers.  Every value is an integer:
equality is exact."""

import dataclasses
import functools
import inspect

import jax
import numpy as np
import pytest
import torch

from dmclock_tpu.sim import device_sim as JDS
from dmclock_tpu_torch.engine import fastpath as TFP
from dmclock_tpu_torch.obs import compile_plane
from dmclock_tpu_torch.parallel import cluster as TCL
from dmclock_tpu_torch.sim import device_sim as TDS

from test_torch_device_sim import (assert_same, group, jax_numpy,
                                   jax_start, make_cfgs)

_JAX_STEPS: dict = {}


def jax_donated_step(jspec, slices: int):
    """The JAX package's step as ``run_device_sim`` compiles it: jitted
    with the sim donated, on one CPU device."""
    key = (repr(jspec), slices)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(functools.partial(
            JDS.device_sim_step, spec=jspec, mesh=JDS.make_mesh(1),
            slices=slices), donate_argnums=(0,))
    return _JAX_STEPS[key]


def _q(q):
    def fn(spec):
        return dataclasses.replace(spec, q_per_slice=q,
                                   slice_ns=spec.op_time_ns * q)
    return fn


def _cal(impl):
    def fn(spec):
        return dataclasses.replace(spec, calendar_impl=impl,
                                   calendar_steps=2, ladder_levels=1)
    return fn


PREFIX = [group(16, client_iops_goal=1000, client_outstanding_ops=64,
                client_reservation=100.0, client_weight=1.0),
          group(16, client_iops_goal=1000, client_outstanding_ops=64,
                client_weight=3.0, client_server_select_range=1)]
ALLOW = [group(16, client_iops_goal=1000, client_outstanding_ops=64,
               client_reservation=20.0, client_limit=60.0,
               client_weight=2.0)]
MIXED = [group(8, client_total_ops=500, client_reservation=20.0,
               client_limit=60.0, client_server_select_range=4),
         group(8, client_iops_goal=200, client_weight=2.0,
               client_req_cost=2)]
CAL = [group(16, client_iops_goal=2000, client_outstanding_ops=60,
             client_reservation=100.0, client_weight=2.0),
       group(8, client_iops_goal=2000, client_outstanding_ops=60,
             client_weight=1.0, client_server_select_range=2)]

# name: (groups, config keywords, spec edit, slices)
CASES = {
    "scan": (MIXED, dict(iops=1600.0), None, 2),
    "prefix": (PREFIX, dict(iops=2_000_000.0), _q(4096), 2),
    "allow": (ALLOW, dict(iops=2_000_000.0, soft=True), _q(4096), 2),
    "minstop": (CAL, dict(iops=20_000.0), _cal("minstop"), 2),
    "bucketed": (CAL, dict(iops=20_000.0), _cal("bucketed"), 2),
    "wheel": (CAL, dict(iops=20_000.0), _cal("wheel"), 2),
}


def _setup(name, devices=None):
    groups_, kw, edit, slices = CASES[name]
    jc, tc = make_cfgs(groups_, **kw)
    jsim, jspec = JDS.init_device_sim(jc)
    tsim, tspec = TDS.init_device_sim(tc, device="cpu")
    if edit is not None:
        jspec, tspec = edit(jspec), edit(tspec)
    if devices is not None:
        tsim = TDS.shard_device_sim(
            tsim, TCL.make_mesh(tspec.n_servers, devices=devices))
    return jsim, jspec, tsim, tspec, slices


def _program_run(tsim, tspec, slices, launches, **kw):
    counts = TDS.StepCounts()
    step = TDS.jit_device_sim_step(tspec, slices,
                                   devices=TDS.sim_devices(tsim), **kw)
    for _ in range(launches):
        tsim = step(tsim, counts=counts)
    return TDS.device_sim_to_numpy(tsim), counts


def _eager_run(tsim, tspec, slices, launches):
    counts = TDS.StepCounts()
    for _ in range(launches):
        tsim = TDS.device_sim_step(tsim, tspec, slices, counts=counts)
    return TDS.device_sim_to_numpy(tsim), counts


@pytest.mark.parametrize("name, blocks", [
    ("scan", {}), ("prefix", {}), ("prefix", dict(block=2)),
    ("prefix", dict(block=4)), ("allow", dict(block=2)),
    ("minstop", dict(cal_block=2)), ("bucketed", dict(block=3)),
    ("wheel", {})])
def test_program_equals_jax_donated_step_and_the_eager_step(name, blocks):
    """Two launches of the program equal two of the JAX jitted step (the
    sim donated) and two of the op-by-op step on every field; its
    batches in a server's loop are the op-by-op step's batches."""
    jsim, jspec, tsim, tspec, slices = _setup(name)
    ref = TDS.device_sim_from_numpy(TDS.device_sim_to_numpy(tsim),
                                    device="cpu")
    want_e, ce = _eager_run(ref, tspec, slices, 2)
    got, cp = _program_run(tsim, tspec, slices, 2, **blocks)
    step = jax_donated_step(jspec, slices)
    jsim = jax_start(jsim)
    for _ in range(2):
        jsim = step(jsim)
    want = jax_numpy(jsim)
    assert_same(got, want)
    assert_same(want_e, want)
    assert int(want["served_resv"].sum() + want["served_prop"].sum()) > 0
    assert (cp.slices, cp.prefix_live, cp.calendar_live) == \
        (ce.slices, ce.prefix_batches, ce.calendar_batches)
    assert cp.prefix_batches >= cp.prefix_live
    assert cp.calendar_batches >= cp.calendar_live
    if name == "scan":
        assert cp.read_backs == 0 and cp.prefix_batches == 0
    else:
        assert cp.read_backs < ce.read_backs


def test_program_over_eight_groups_on_one_device_equals_jax():
    """8 groups of one server each on the CPU: the three reductions a
    slice between groups, the legs over every group, held to the JAX
    step and the stacked program."""
    jsim, jspec, tsim, tspec, slices = _setup("prefix",
                                              devices=("cpu",) * 8)
    got, counts = _program_run(tsim, tspec, slices, 1, block=2)
    jsim = jax_donated_step(jspec, slices)(jax_start(jsim))
    assert_same(got, jax_numpy(jsim))
    # one status read a round for all eight groups on their one device
    assert counts.read_backs * 2 * 8 >= counts.prefix_batches


def test_masked_prefix_batch_leaves_the_state_bit_identical():
    """A prefix batch capped at 0 decisions (a server out of its loop)
    commits nothing and returns every state field equal to its input,
    with candidates present."""
    _, _, tsim, tspec, _ = _setup("prefix")
    (ctl,) = TDS._loop_state([tsim], tspec, False)
    tsim, ctl = TDS._head_leg(tsim, ctl, None, spec=tspec, g=0)  # ingest
    eng = TDS.server_view(tsim.engine, 0)
    now = tsim.t + tspec.slice_ns
    heads = TFP._window_heads(eng, TFP.ring_window(eng, 1))
    free = TFP.speculate_prefix_batch(eng, now, 32, anticipation_ns=0,
                                      heads=heads)
    assert int(free.count) > 0
    batch = TFP.speculate_prefix_batch(
        eng, now, 32, anticipation_ns=0, heads=heads,
        max_count=torch.zeros((), dtype=torch.int32))
    assert int(batch.count) == 0
    for f, a, b in zip(eng._fields, batch.state, eng):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert bool((batch.decisions.slot == -1).all())


def test_one_read_back_a_block_replay(monkeypatch):
    """Every read back of the program is one status read after a round
    of block replays: a block of 4 ends each slice's prefix loop in one
    round here (one read a slice), a block of 1 takes one round a batch
    of the longest server loop."""
    reads = []
    real = TDS._read_status

    def counted(ctl, counts):
        reads.append(1)
        return real(ctl, counts)

    monkeypatch.setattr(TDS, "_read_status", counted)
    _, _, tsim, tspec, _ = _setup("prefix")
    _, c4 = _program_run(tsim, tspec, 2, 1, block=4)
    assert c4.read_backs == len(reads) == c4.slices == 2
    assert c4.prefix_batches == 4 * 8 * 2 >= c4.prefix_live
    reads.clear()
    _, _, tsim, tspec, _ = _setup("prefix")
    _, c1 = _program_run(tsim, tspec, 2, 1, block=1)
    assert c1.read_backs == len(reads) > c1.slices
    assert c1.prefix_batches == c1.prefix_live
    assert c1.read_backs < c1.prefix_batches


def test_donated_chain_equals_an_undonated_one():
    """Two chained calls that hand the result back (donated: the legs
    write into the sim passed in) equal two calls each on a copy of its
    input (undonated), whose inputs stay as they were."""
    _, _, tsim, tspec, slices = _setup("minstop")
    before = TDS.device_sim_to_numpy(tsim)
    keep = TDS.device_sim_from_numpy(before, device="cpu")
    step = TDS.jit_device_sim_step(tspec, slices,
                                   devices=TDS.sim_devices(tsim))

    def copy(sim):
        return TDS.device_sim_from_numpy(TDS.device_sim_to_numpy(sim),
                                         device="cpu")

    mid = step(copy(keep))
    mid_np = TDS.device_sim_to_numpy(mid)
    out = step(copy(mid))
    assert_same(TDS.device_sim_to_numpy(keep), before)
    assert_same(TDS.device_sim_to_numpy(mid), mid_np)
    chained = step(step(tsim))
    assert chained.engine.q_head is tsim.engine.q_head
    assert_same(TDS.device_sim_to_numpy(chained),
                TDS.device_sim_to_numpy(out))


def test_legs_hold_no_host_read_and_run_eagerly_under_eager():
    """No leg of the program reads the card back (the reads are the
    staged body's, one a round); inside ``compile_plane.eager()`` the
    program runs the same body op by op, equal to the plain call."""
    for fn in (TDS._head_leg, TDS._calendar_leg, TDS._prefix_leg,
               TDS._tail_leg):
        src = inspect.getsource(fn)
        for bad in ("int(", ".item()", ".tolist()", ".cpu()", "numpy("):
            assert bad not in src, (fn.__name__, bad)
    _, _, tsim, tspec, slices = _setup("bucketed")
    keep = TDS.device_sim_from_numpy(TDS.device_sim_to_numpy(tsim),
                                     device="cpu")
    step = TDS.jit_device_sim_step(tspec, slices,
                                   devices=TDS.sim_devices(tsim))
    with compile_plane.eager():
        a = TDS.device_sim_to_numpy(step(tsim))
    assert_same(a, TDS.device_sim_to_numpy(step(keep)))
    assert step.program.record is False and all(
        not leg.record and leg.share_donated and leg.donate_argnums ==
        (0, 1) for leg in step.legs)


def test_sharing_programs_take_over_each_others_donated_buffers():
    """``InstrumentedJit(share_donated=True)``: a donated input that is
    another sharing program's donated static buffer becomes the next
    graph's static buffer (not cloned); the same buffer passed twice,
    a buffer of a program that does not share, or a caller's tensor is
    cloned."""
    x, y = torch.arange(4), torch.arange(3)

    def graph(leaves, donated, share=True):
        return compile_plane._Graph(lambda *a: a, "t", leaves, None,
                                    torch.device("cpu"), donated,
                                    [None] * len(leaves), share)

    first = graph([x, y], {0})
    assert first.static[0] is not x and first.static[1] is not y
    buf = first.static[0]
    second = graph([buf, buf, first.static[1]], {0, 1, 2})
    assert second.static[0] is buf
    assert second.static[1] is not buf       # passed twice: cloned
    assert second.static[2] is not first.static[1]  # not donated there
    plain = graph([second.static[1]], {0}, share=False)
    assert plain.static[0] is not second.static[1]
    assert graph([plain.static[0]], {0}).static[0] is not plain.static[0]
