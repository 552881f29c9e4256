"""The port's device-resident sim against the JAX package's: every field
of ``DeviceSim`` (engine, tracker, load, counters, clock, guard trips)
equal after the same launches, on the scan path, the prefix path and
the three calendar schemes; the guard-trip check; the report; the
counter hash on edge values; and the numpy bridge.  The JAX side runs on
one CPU device (``make_mesh(1)``).  Every value is an integer: equality
is exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.sim import config as jcfg
from dmclock_tpu.sim import device_sim as JDS
from dmclock_tpu_torch.sim import config as tcfg
from dmclock_tpu_torch.sim import device_sim as TDS


def make_cfgs(groups, *, servers=8, iops=160.0, threads=1, soft=False,
              rand=False):
    """The same SimConfig in both packages."""
    out = []
    for mod in (jcfg, tcfg):
        out.append(mod.SimConfig(
            client_groups=len(groups), server_groups=1,
            server_random_selection=rand, server_soft_limit=soft,
            cli_group=[mod.ClientGroup(**g) for g in groups],
            srv_group=[mod.ServerGroup(server_count=servers,
                                       server_iops=iops,
                                       server_threads=threads)]))
    return out


def group(count, **kw):
    g = dict(client_count=count, client_total_ops=10**9,
             client_iops_goal=100, client_outstanding_ops=32,
             client_reservation=0.0, client_limit=0.0, client_weight=1.0,
             client_server_select_range=8)
    g.update(kw)
    return g


def jax_numpy(sim) -> dict:
    out = {}
    for f, v in zip(sim._fields, sim):
        if hasattr(v, "_fields"):
            out[f] = {g: np.asarray(x) for g, x in zip(v._fields, v)}
        else:
            out[f] = np.asarray(v)
    return out


def assert_same(a: dict, b: dict, path: str = "sim"):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            assert_same(a[k], b[k], f"{path}.{k}")
            continue
        x, y = a[k], b[k]
        assert x.dtype == y.dtype, (f"{path}.{k}", x.dtype, y.dtype)
        assert x.shape == y.shape, (f"{path}.{k}", x.shape, y.shape)
        assert np.array_equal(x, y), \
            f"{path}.{k} differs at {np.argwhere(x != y)[:4].tolist()}"


_MESH = []
_STEPS = {}


def jax_step(jspec, slices: int):
    """The JAX package's jitted step on one CPU device, compiled once
    per (spec, slices) in this module."""
    if not _MESH:
        _MESH.append(JDS.make_mesh(1))
    key = (repr(jspec), slices)
    if key not in _STEPS:
        _STEPS[key] = jax.jit(functools.partial(
            JDS.device_sim_step, spec=jspec, mesh=_MESH[0],
            slices=slices))
    return _STEPS[key]


def jax_start(jsim):
    if not _MESH:
        _MESH.append(JDS.make_mesh(1))
    return JDS.shard_device_sim(jsim, _MESH[0])


def run_both(jc, tc, *, spec_fn=None, slices=4, launches=2, counts=None,
             ring=256):
    """Both sims from init through ``launches`` launches of ``slices``
    slices, with ``spec_fn(cfg, spec)`` rebuilding the spec (a package's
    ``_make_spec`` is passed in); returns (jax dict, port dict, port
    sim)."""
    jsim, jspec = JDS.init_device_sim(jc, ring_capacity=ring)
    tsim, tspec = TDS.init_device_sim(tc, ring_capacity=ring, device="cpu")
    if spec_fn is not None:
        jspec = spec_fn(JDS, jc, jspec)
        tspec = spec_fn(TDS, tc, tspec)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    assert_same(jax_numpy(jsim), TDS.device_sim_to_numpy(tsim))
    jsim = jax_start(jsim)
    step = jax_step(jspec, slices)
    for _ in range(launches):
        jsim = step(jsim)
        tsim = TDS.device_sim_step(tsim, tspec, slices, counts=counts)
    got, want = TDS.device_sim_to_numpy(tsim), jax_numpy(jsim)
    assert_same(got, want)
    return want, got, tsim


def served(d: dict) -> int:
    return int(d["served_resv"].sum() + d["served_prop"].sum())


# ----------------------------------------------------------------------
# the scan path (q < 256)
# ----------------------------------------------------------------------

MIXED = [group(8, client_total_ops=500, client_reservation=20.0,
               client_limit=60.0, client_server_select_range=4),
         group(8, client_iops_goal=200, client_weight=2.0,
               client_req_cost=2)]


@pytest.mark.parametrize("rand", [False, True],
                         ids=["deterministic", "random"])
def test_scan_path_equals_jax(rand):
    counts = TDS.StepCounts()
    want, _, _ = run_both(*make_cfgs(MIXED, rand=rand), counts=counts)
    assert served(want) > 200
    assert counts.prefix_batches == 0 and counts.slices == 8
    per_server = want["served_resv"].sum(1) + want["served_prop"].sum(1)
    assert (per_server > 0).all()


def test_soft_limit_multi_thread_servers_equal_jax():
    want, _, _ = run_both(*make_cfgs(MIXED, soft=True, threads=2),
                          launches=1)
    assert served(want) > 150


# ----------------------------------------------------------------------
# the prefix path
# ----------------------------------------------------------------------

def _throughput_spec(q):
    def fn(ds, cfg, spec):
        return ds._make_spec(cfg, q_per_slice=q)
    return fn


PREFIX_GROUPS = [group(24, client_iops_goal=2000, client_outstanding_ops=64,
                       client_reservation=100.0, client_weight=1.0),
                 group(24, client_iops_goal=2000, client_outstanding_ops=64,
                       client_weight=3.0, client_server_select_range=2)]


def test_prefix_path_equals_jax():
    """``_make_spec(cfg, q_per_slice=4096)`` (the headline's slice):
    the budgeted prefix-batch loop, several batches a slice."""
    counts = TDS.StepCounts()
    want, _, _ = run_both(*make_cfgs(PREFIX_GROUPS, iops=2_000_000.0),
                          spec_fn=_throughput_spec(4096), slices=2,
                          counts=counts)
    assert served(want) > 1000 and want["served_resv"].sum() > 0
    assert counts.prefix_batches > counts.slices * 8
    assert counts.read_backs == counts.prefix_batches


def test_allow_on_the_prefix_path_equals_jax():
    """AtLimit::Allow (soft limit, every weight positive) rides the
    prefix path."""
    groups = [group(32, client_iops_goal=2000, client_outstanding_ops=64,
                    client_reservation=20.0, client_limit=60.0,
                    client_weight=2.0)]
    jc, tc = make_cfgs(groups, iops=2_000_000.0, soft=True)
    spec = TDS._make_spec(tc)
    assert spec.allow_limit_break and spec.all_weights_positive
    counts = TDS.StepCounts()
    want, _, _ = run_both(jc, tc, spec_fn=_throughput_spec(4096),
                          slices=2, counts=counts)
    assert counts.prefix_batches > 0 and served(want) > 500


def test_allow_with_weight_zero_keeps_the_scan():
    """A weight-0 client under Allow keeps the serial scan (the
    reference's ready-weight-0 fallback), at q = 256."""
    groups = [group(12, client_total_ops=1000, client_iops_goal=2000,
                    client_outstanding_ops=20, client_reservation=10.0,
                    client_limit=30.0, client_weight=0.0)]
    jc, tc = make_cfgs(groups, servers=4, iops=200_000.0, soft=True)
    spec = TDS._make_spec(tc)
    assert spec.allow_limit_break and not spec.all_weights_positive

    def fn(ds, cfg, spec):
        return dataclasses.replace(spec, q_per_slice=256,
                                   slice_ns=spec.op_time_ns * 256)
    counts = TDS.StepCounts()
    want, _, _ = run_both(jc, tc, spec_fn=fn, slices=2, launches=1,
                          counts=counts)
    assert counts.prefix_batches == 0 and served(want) > 0
    with pytest.raises(ValueError, match="calendar_impl requires"):
        TDS.device_sim_step(*TDS.init_device_sim(
            tc, calendar_impl="minstop", device="cpu"), 1)


# ----------------------------------------------------------------------
# the calendar front-load
# ----------------------------------------------------------------------

CAL_GROUPS = [group(24, client_iops_goal=2000, client_outstanding_ops=60,
                    client_reservation=100.0, client_weight=2.0),
              group(8, client_iops_goal=2000, client_outstanding_ops=60,
                    client_weight=1.0, client_server_select_range=2)]


@pytest.mark.parametrize("impl", ["minstop", "bucketed", "wheel"])
def test_calendar_equals_jax_and_the_prefix_run(impl):
    """Each scheme equals the JAX package's run, and (both being the
    q-step serial stream) the port's default run on every field."""
    def fn(ds, cfg, spec):
        return dataclasses.replace(spec, calendar_impl=impl,
                                   ladder_levels=3)
    jc, tc = make_cfgs(CAL_GROUPS, iops=20_000.0)
    counts = TDS.StepCounts()
    want, got, _ = run_both(jc, tc, spec_fn=fn, slices=4, counts=counts)
    # every server-slice ends on one batch that does not fit; the rest
    # committed
    assert counts.calendar_batches > counts.slices * 8
    assert served(want) > 100
    # the same slices served by the default path (the q-step scan)
    sim, spec = TDS.init_device_sim(tc, device="cpu")
    assert_same(TDS.device_sim_to_numpy(
        TDS.device_sim_step(sim, spec, 8)), got)


# ----------------------------------------------------------------------
# guards, report, the headline's construction
# ----------------------------------------------------------------------

def test_guard_trips_checked_equal_jax():
    """Corrupting the state init_device_sim validated (a request cost
    past the int32 sort payload) trips the guard counter in both
    packages alike, and check_guard_trips raises on it.  The prefix
    path's sim and step (``test_prefix_path_equals_jax``'s, compiled
    once for both tests)."""
    jc, tc = make_cfgs(PREFIX_GROUPS, iops=2_000_000.0)
    fn = _throughput_spec(4096)
    _, _, tsim = run_both(jc, tc, spec_fn=fn, slices=2, launches=1)
    assert int(tsim.guard_trips) == 0
    TDS.check_guard_trips(tsim)
    jsim, jspec = JDS.init_device_sim(jc)
    step = jax_step(fn(JDS, jc, jspec), 2)
    jsim = step(jax_start(jsim))
    _, tspec = TDS.init_device_sim(tc, device="cpu")
    tspec = fn(TDS, tc, tspec)
    jsim = jsim._replace(load=jsim.load._replace(
        cost=jnp.full_like(jsim.load.cost, jnp.int64(1) << 32)))
    tsim = tsim._replace(load=tsim.load._replace(
        cost=torch.full_like(tsim.load.cost, 1 << 32)))
    jsim = step(jsim)
    tsim = TDS.device_sim_step(tsim, tspec, 2)
    assert_same(TDS.device_sim_to_numpy(tsim), jax_numpy(jsim))
    assert int(tsim.guard_trips) > 0
    with pytest.raises(RuntimeError, match="rebase-guard"):
        TDS.check_guard_trips(tsim)


def test_run_device_sim_report_equals_jax(capsys, tmp_path):
    groups = [group(8, client_total_ops=50, client_reservation=20.0,
                    client_server_select_range=4)]
    jc, tc = make_cfgs(groups)
    _, _, want = JDS.run_device_sim(jc, mesh=JDS.make_mesh(1),
                                    slices_per_launch=16)
    counts = TDS.StepCounts()
    sim, spec, got = TDS.run_device_sim(tc, slices_per_launch=16,
                                        device="cpu", counts=counts)
    assert got == want and "total ops: 400" in got
    # the served totals and the guard trips are read after each launch
    assert counts.read_backs == 2 * (counts.slices // 16)
    partial = TDS.format_report(tc, sim, spec, 1, completed=10,
                                total_ops=400)
    assert "INCOMPLETE" in partial
    conf = tmp_path / "s.conf"
    conf.write_text("[global]\nclient_groups = 1\nserver_groups = 1\n"
                    "[client.0]\nclient_count = 8\nclient_total_ops = 50\n"
                    "client_iops_goal = 100\nclient_outstanding_ops = 32\n"
                    "client_reservation = 20.0\nclient_limit = 0.0\n"
                    "client_server_select_range = 4\n"
                    "[server.0]\nserver_count = 8\nserver_iops = 160\n")
    assert TDS.main(["-c", str(conf), "--device", "cpu",
                     "--slices-per-launch", "16"]) == 0
    out = capsys.readouterr().out
    assert "total ops: 400" in out and "# host loop:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TDS.main(["-c", str(conf)])


def test_headline_setup_equals_the_jax_construction():
    """``headline_setup`` is run_sweeps.py's construction (a 64-slot
    ring, the spec remade at q=4096 a thread), here at 64 clients: two
    slices equal the JAX package's; the calendar schemes equal the
    prefix run; the headline row's keys come out."""
    n = 64
    cfg, tsim, tspec = TDS.headline_setup(n, device="cpu")
    jc = make_cfgs([group(n // 2, client_iops_goal=80.0,
                          client_reservation=2.0, client_weight=w)
                    for w in (1.0, 3.0)], iops=500_000.0, threads=2,
                   rand=True)[0]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        make_cfgs([group(n // 2, client_iops_goal=80.0,
                         client_reservation=2.0, client_weight=w)
                   for w in (1.0, 3.0)], iops=500_000.0, threads=2,
                  rand=True)[1])
    jsim, _ = JDS.init_device_sim(jc, ring_capacity=TDS.HEADLINE_RING)
    jspec = JDS._make_spec(jc, q_per_slice=TDS.HEADLINE_Q)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jsim = jax_step(jspec, 2)(jax_start(jsim))
    prefix = TDS.device_sim_step(tsim, tspec, 2)
    assert_same(TDS.device_sim_to_numpy(prefix), jax_numpy(jsim))
    for impl in ("minstop", "wheel"):
        _, sim, spec = TDS.headline_setup(n, calendar_impl=impl,
                                          device="cpu")
        assert_same(TDS.device_sim_to_numpy(
            TDS.device_sim_step(sim, spec, 2)),
            TDS.device_sim_to_numpy(prefix))
    row = TDS.device_sim_headline(n, device="cpu", lo=1, hi=2)
    assert row["guard_trips"] == 0 and row["total_ops"] > 0
    assert row["slices"] == TDS.HEADLINE_SLICES * (TDS.HEADLINE_WARM + 1 + 2)


# ----------------------------------------------------------------------
# the counter hash and the bridge
# ----------------------------------------------------------------------

EDGE = [0, 1, -1, 2, -(1 << 63), (1 << 63) - 1, (1 << 63) - 2,
        -(1 << 63) + 1, (1 << 62), (1 << 62) + 12345, -(1 << 62),
        0x9E3779B97F4A7C15 - (1 << 64), 7 << 20, (1 << 63) - (1 << 20)]


def test_splitmix64_equals_jnp_on_edge_values():
    x = np.asarray(EDGE, dtype=np.int64)
    rng = np.random.default_rng(0)
    x = np.concatenate([x, rng.integers(-(1 << 63), (1 << 63) - 1, 500,
                                        dtype=np.int64)])
    got = TDS._splitmix64(torch.from_numpy(x)).numpy()
    want = np.asarray(JDS._splitmix64(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    # the pick: abs(INT64_MIN) stays negative, remainder takes the
    # divisor's sign, in both
    for r in (1, 3, 7, 8):
        a = torch.remainder(torch.abs(torch.from_numpy(got)), r).numpy()
        b = np.asarray(jnp.remainder(jnp.abs(jnp.asarray(want)), r))
        assert np.array_equal(a, b) and (a >= 0).all()
    t_min = torch.tensor([-(1 << 63)], dtype=torch.int64)
    assert int(torch.abs(t_min)) == int(jnp.abs(jnp.int64(-(1 << 63))))


def test_sends_to_server_equals_jax():
    rng = np.random.default_rng(1)
    jc, tc = make_cfgs([group(40, client_server_select_range=5)],
                       rand=True)
    jsim, _ = JDS.init_device_sim(jc)
    tsim, _ = TDS.init_device_sim(tc, device="cpu")
    sent = rng.integers(0, 1 << 30, 40).astype(np.int32)
    n = rng.integers(0, 4, 40).astype(np.int32)
    jl = jsim.load._replace(sent=jnp.asarray(sent))
    tl = tsim.load._replace(sent=torch.from_numpy(sent))
    for rand in (False, True):
        for wave in range(3):
            a = TDS._sends_to_server(tl, torch.from_numpy(n), wave,
                                     torch.arange(8, dtype=torch.int32),
                                     8, rand).numpy()
            b = np.asarray(JDS._sends_to_server(
                jl, jnp.asarray(n), wave, jnp.arange(8, dtype=jnp.int32),
                8, rand))
            assert np.array_equal(a, b)
    t0 = 12_345_678
    a = TDS._slice_sends(tl, torch.tensor(t0), 40_000_000, 5).numpy()
    b = np.asarray(JDS._slice_sends(jl, jnp.int64(t0), 40_000_000, 5))
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bridge_round_trip():
    """A JAX sim carried into the port runs on to the JAX result; the
    port's sim carried out and back is unchanged; a wrong dtype or a
    missing field is refused."""
    jc, tc = make_cfgs(MIXED)
    jsim, jspec = JDS.init_device_sim(jc)
    step = jax_step(jspec, 4)
    jsim = step(jax_start(jsim))
    _, tspec = TDS.init_device_sim(tc, device="cpu")
    tsim = TDS.device_sim_from_numpy(jax_numpy(jsim), device="cpu")
    assert_same(TDS.device_sim_to_numpy(tsim), jax_numpy(jsim))
    tsim = TDS.device_sim_step(tsim, tspec, 4)
    jsim = step(jsim)
    arrays = TDS.device_sim_to_numpy(tsim)
    assert_same(arrays, jax_numpy(jsim))
    again = TDS.device_sim_to_numpy(
        TDS.device_sim_from_numpy(arrays, device="cpu"))
    assert_same(again, arrays)
    bad = dict(arrays, load=dict(arrays["load"],
                                 sent=arrays["load"]["sent"].astype(
                                     np.int64)))
    with pytest.raises(ValueError, match="load.sent"):
        TDS.device_sim_from_numpy(bad, device="cpu")
    bad = dict(arrays, tracker={k: v for k, v in arrays["tracker"].items()
                                if k != "seen"})
    with pytest.raises(ValueError, match="missing"):
        TDS.device_sim_from_numpy(bad, device="cpu")
    bad = {k: v for k, v in arrays.items() if k != "t"}
    with pytest.raises(ValueError, match="missing"):
        TDS.device_sim_from_numpy(bad, device="cpu")


def test_device_sim_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    _, tc = make_cfgs(MIXED)
    with pytest.raises(RuntimeError, match="cuda"):
        TDS.init_device_sim(tc)
    with pytest.raises(RuntimeError, match="cuda"):
        TDS.device_sim_headline(64)
