"""``scripts/torch_run_sweeps.py``'s calendar grid, Allow rows and device
sim headline against the JAX repo's ``benchmark/run_sweeps.py`` on the
CPU, at the script's cut shape (``CUT``: 2,048 clients, depth 64; the
calendar at (m, steps) = (4, 8) and (2, 16); Allow at m=4, k=512 and
calendar m=4, steps 8; the headline at 64 clients, chains of 1 and 2
launches).

The JAX rows hard-code 100,000 clients, so the JAX side is rebuilt from
the JAX building blocks exactly as the script uses them
(``__graft_entry__._preloaded_state``, ``fastpath.scan_calendar_epoch``,
``scan_prefix_epoch`` and ``calendar_batch``, ``._replace``, the device
sim's init, spec, mesh and step).  Held exactly: each calendar point's
decisions, each Allow row's decisions and its limit-break flag (true on
both rows), ``limited_state``, the ``state_digest`` of every warm epoch
and chain in order, and the headline's ops, virtual seconds and 3:1
ratio."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as graft
import profile_util
from dmclock_tpu.engine.fastpath import (calendar_batch, scan_calendar_epoch,
                                         scan_prefix_epoch)
from dmclock_tpu.sim import device_sim as JDS
from dmclock_tpu.sim.config import ClientGroup, ServerGroup, SimConfig
from test_torch_sweeps import SW, record_digests, same_tree


def _digest(st):
    return jax.device_get(profile_util.state_digest(st))


def jax_limited_state(n: int, depth: int):
    """``run_sweeps.tpu_allow_regime_row``'s ``limited_state`` at ``n``."""
    st = graft._preloaded_state(n, depth, ring=depth)
    return st._replace(
        limit_inv=jnp.full((n,), 10**6, dtype=jnp.int64),
        head_limit=jnp.full((n,), 10**12, dtype=jnp.int64),
        head_ready=jnp.zeros((n,), dtype=bool))


def test_calendar_sweep_equals_the_jax_script(monkeypatch):
    sh = SW.CUT["calendar"]
    assert {steps for _, steps, _ in sh["points"]} == {8, 16}
    got_d, want_d = record_digests(monkeypatch)
    got = SW.tpu_calendar_sweep(**sh, device="cpu")
    want = []
    for m, steps, epochs in sh["points"]:
        run = jax.jit(functools.partial(
            scan_calendar_epoch, m=m, steps=steps, anticipation_ns=0))
        ep = run(graft._preloaded_state(sh["n"], sh["depth"],
                                        ring=sh["depth"]), jnp.int64(0))
        _digest(ep.state)
        st = graft._preloaded_state(sh["n"], sh["depth"], ring=sh["depth"])
        counts = []
        for _ in range(epochs):
            ep = run(st, jnp.int64(0))
            st = ep.state
            counts.append(ep.count)
        _digest(st)
        want.append((m, steps, sum(int(np.asarray(c).sum())
                                   for c in counts)))
    assert [(m, s, total) for m, s, _, total in got] == want
    assert all(total > 0 for *_, total in want)
    assert got_d == want_d and len(got_d) == 2 * len(sh["points"])


def test_allow_rows_equal_the_jax_script(monkeypatch):
    sh = SW.CUT["allow"]
    n, depth, k, m = sh["n"], sh["depth"], sh["k"], sh["m"]
    same_tree(SW.limited_state(n, depth, "cpu"), jax_limited_state(n, depth),
              "limited_state")
    got_d, want_d = record_digests(monkeypatch)
    got = SW.tpu_allow_regime_row(**sh, device="cpu")

    want = []
    run = jax.jit(functools.partial(
        scan_prefix_epoch, m=m, k=k, anticipation_ns=0,
        allow_limit_break=True))
    ep = run(jax_limited_state(n, depth), jnp.int64(0))
    _digest(ep.state)
    lb = bool(np.asarray(ep.lb).any())
    st, total = jax_limited_state(n, depth), 0
    for _ in range(sh["sorted_epochs"]):
        ep = run(st, jnp.int64(0))
        st = ep.state
        total += int(np.asarray(ep.count).sum())
    _digest(st)
    want.append((lb, total))
    b = calendar_batch(jax_limited_state(n, depth), jnp.int64(0),
                       steps=sh["cal_steps"], anticipation_ns=0,
                       allow_limit_break=True)
    lb_cal = bool(np.asarray(b.lb).sum() > 0)
    run = jax.jit(functools.partial(
        scan_calendar_epoch, m=sh["cal_m"], steps=sh["cal_steps"],
        anticipation_ns=0, allow_limit_break=True))
    _digest(run(jax_limited_state(n, depth), jnp.int64(0)).state)
    st, total = jax_limited_state(n, depth), 0
    for _ in range(sh["cal_epochs"]):
        ep = run(st, jnp.int64(0))
        st = ep.state
        total += int(np.asarray(ep.count).sum())
    _digest(st)
    want.append((lb_cal, total))

    assert [(lb, total) for _, _, lb, total in got] == want
    assert want[0][0] is True and want[1][0] is True
    assert all(total > 0 for _, total in want)
    assert got_d == want_d and len(got_d) == 4


def test_headline_row_equals_the_jax_script():
    sh = SW.CUT["devsim"]
    n = sh["n"]
    got = SW.device_sim_headline(**sh, device="cpu")
    groups = [ClientGroup(client_count=n // 2, client_total_ops=10**9,
                          client_iops_goal=80.0, client_outstanding_ops=32,
                          client_reservation=2.0, client_limit=0.0,
                          client_weight=w, client_server_select_range=8)
              for w in (1.0, 3.0)]
    cfg = SimConfig(client_groups=2, server_groups=1,
                    server_random_selection=True, server_soft_limit=False,
                    cli_group=groups,
                    srv_group=[ServerGroup(server_count=8,
                                           server_iops=500_000.0,
                                           server_threads=2)])
    sim, _ = JDS.init_device_sim(cfg, ring_capacity=64)
    spec = JDS._make_spec(cfg, q_per_slice=4096)
    mesh = JDS.make_mesh(1)
    sim = JDS.shard_device_sim(sim, mesh)
    step = jax.jit(functools.partial(JDS.device_sim_step, spec=spec,
                                     mesh=mesh, slices=2))
    for _ in range(1 + sh["lo"] + sh["hi"]):
        sim = step(sim)
    per_client = (np.asarray(sim.served_resv)
                  + np.asarray(sim.served_prop)).sum(axis=0)
    g2 = per_client[n // 2:].sum() / max(per_client[:n // 2].sum(), 1)
    assert got["total_ops"] == int(per_client.sum()) > 0
    assert got["virtual_s"] == int(np.asarray(sim.t)) / 1e9
    assert got["weight_ratio_3_1"] == float(g2)
