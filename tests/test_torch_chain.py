"""The port's chain engine and the pieces around the three epoch engines
against the JAX package, exactly: ``speculate_chain_batch``,
``expand_units``, ``scan_chain_epoch``, ``make_prefix_runner``,
``calendar_stop_ladder``, the epoch registry and
``engine_run(with_horizon=True)``; and chain epochs against the port's
own serial engine."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.core import ClientInfo
from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk

from engine_helpers import build_state, deep_state
from test_calendar_bucketed import zipf64_state
from test_prefix import mixed_qos_state
from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                assert_tuple_matches, to_torch)

_JIT: dict = {}


def _jax(fn, **kw):
    key = (fn.__name__, tuple(sorted(kw.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(functools.partial(fn, **kw))
    return _JIT[key]


def _variable_cost_state():
    """tests/test_prefix.py's variable-cost stream (offset != advance):
    chains of more than one serve fire on it."""
    rng = random.Random(99)
    infos = {c: ClientInfo(1.0 + (c % 3), 1.0 + (c % 4), 0)
             for c in range(10)}
    adds, t = [], 1 * S
    for _ in range(150):
        c = rng.randrange(10)
        t += rng.randint(0, S // 5)
        delta = rng.randint(1, 4)
        adds.append((c, t, rng.randint(1, 4), delta,
                     rng.randint(1, delta)))
    return build_state(infos, adds, capacity=16, ring=64), t


def _serial_stream(st, now, steps, allow=False):
    ser_st, _, ser = tk.engine_run(st, now, steps, allow_limit_break=allow,
                                   anticipation_ns=0)
    assert bool((ser.type == tk.RETURNING).all())
    return ser_st, ser


def _assert_expanded_is_serial(batch, pre, now, allow=False):
    """A chain batch's expanded stream and state equal the port's serial
    engine run for ``count`` steps from ``pre``."""
    slots, phases, costs, lbs = tfp.expand_units(
        batch.slot, batch.cls, batch.length, pre, limit_break=allow)
    c = int(batch.count)
    assert slots.shape == (c,)
    if c == 0:
        return
    ser_st, ser = _serial_stream(pre, now, c, allow)
    assert np.array_equal(slots, ser.slot.numpy())
    assert np.array_equal(phases, ser.phase.numpy())
    assert np.array_equal(costs, ser.cost.numpy())
    assert np.array_equal(lbs, ser.limit_break.numpy())
    for f, a, b in zip(ser_st._fields, batch.state, ser_st):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("chain_depth, allow, select_impl", [
    (2, False, "sort"), (4, False, "sort"), (4, True, "sort"),
    (4, False, "radix")])
def test_speculate_chain_batch_matches_jax(chain_depth, allow,
                                           select_impl):
    """mixed_qos_state (phase flips every few decisions): four batches
    from each side's own previous state, every field and the state; the
    expanded stream is the port's serial stream."""
    jstate, now = mixed_qos_state(n=8, depth=12)
    run = _jax(jfp.speculate_chain_batch, k=16, chain_depth=chain_depth,
               anticipation_ns=0, allow_limit_break=allow,
               select_impl=select_impl)
    st = to_torch(jstate)
    total = 0
    for _ in range(4):
        want = run(jstate, jnp.int64(now))
        got = tfp.speculate_chain_batch(
            st, now, 16, chain_depth=chain_depth, anticipation_ns=0,
            allow_limit_break=allow, select_impl=select_impl)
        assert_tuple_matches(got, want, fields=[
            f for f in got._fields if f != "state"])
        assert_state_matches(got.state, want.state)
        _assert_expanded_is_serial(got, st, now, allow)
        total += int(got.count)
        jstate, st = want.state, got.state
    assert total > 0


def test_chains_fire_on_a_variable_cost_stream():
    """Batches on the variable-cost stream equal JAX's and commit units
    of more than one decision."""
    jstate, now = _variable_cost_state()
    st = to_torch(jstate)
    max_len = 1
    run = _jax(jfp.speculate_chain_batch, k=10, chain_depth=4,
               anticipation_ns=0)
    for _ in range(100):
        want = run(jstate, jnp.int64(now))
        got = tfp.speculate_chain_batch(st, now, 10, chain_depth=4,
                                        anticipation_ns=0)
        assert_tuple_matches(got, want, fields=[
            f for f in got._fields if f != "state"])
        assert_state_matches(got.state, want.state)
        _assert_expanded_is_serial(got, st, now)
        if int(got.count) == 0:
            now += S // 2
            continue
        max_len = max(max_len, int(got.length.max()))
        jstate, st = want.state, got.state
        if max_len > 1:
            break
    assert max_len > 1, "chains never fired on a variable-cost stream"


@pytest.mark.parametrize("select_impl", ["sort", "radix"])
def test_chains_fire_on_the_variable_cost_backlog(select_impl):
    """``serve.variable_cost_state`` at a small shape: the chain epoch at
    now = 0 equals JAX's on the same backlog (``__graft_entry__``'s with
    the same costs), its first batch commits units of two decisions,
    and that batch's expanded stream and state are the serial engine's."""
    from __graft_entry__ import _preloaded_state

    n, depth, m, k = 128, 8, 3, 32
    st = tserve.variable_cost_state(n, depth, device="cpu")
    jst = _preloaded_state(n, depth, ring=depth)._replace(
        head_cost=jnp.asarray(st.head_cost.numpy()),
        q_cost=jnp.asarray(st.q_cost.numpy()))
    assert_state_matches(st, jst)
    want = _jax(jfp.scan_chain_epoch, m=m, k=k, chain_depth=4,
                anticipation_ns=0, with_metrics=True,
                select_impl=select_impl)(jst, jnp.int64(0))
    got = tserve.chain_epochs(st, 1, k=k, m=m, now_ns=0,
                              select_impl=select_impl)
    for f in ("count", "unit_count", "guards_ok", "slot", "cls", "length"):
        assert_np_equal(f, getattr(got, f)[0].numpy(),
                        np.asarray(getattr(want, f)))
    assert_np_equal("metrics", got.metrics.numpy(),
                    np.asarray(want.metrics))
    assert_state_matches(got.state, want.state)
    assert int(got.length[0, 0].max()) >= 2
    first = tfp.speculate_chain_batch(st, 0, k, chain_depth=4,
                                      anticipation_ns=0,
                                      select_impl=select_impl)
    _assert_expanded_is_serial(first, st, 0)


def test_expand_units_matches_jax():
    """The same units and pre-state through both packages' expansion;
    the port also takes a numpy dict (``bridge.state_to_numpy``)."""
    jstate, now = _variable_cost_state()
    run = _jax(jfp.speculate_chain_batch, k=10, chain_depth=4,
               anticipation_ns=0)
    for _ in range(100):
        b = run(jstate, jnp.int64(now))
        if int(np.asarray(b.length).max()) > 1:
            break
        jstate = b.state
    assert int(np.asarray(b.length).max()) > 1
    units = [np.array(jax.device_get(getattr(b, f)))
             for f in ("slot", "cls", "length")]
    want = jfp.expand_units(*units, jstate, limit_break=True)
    st = to_torch(jstate)
    for pre in (st, bridge.state_to_numpy(st)):
        got = tfp.expand_units(*(torch.from_numpy(u) for u in units), pre,
                               limit_break=True)
        for name, g, w in zip(("slots", "phases", "costs", "lbs"), got,
                              want):
            assert_np_equal(name, g, w)


@pytest.mark.parametrize("select_impl", ["sort", "radix"])
def test_scan_chain_epoch_matches_batches_and_jax(select_impl):
    """The epoch equals repeated ``speculate_chain_batch`` calls (the
    port's own) and the JAX epoch, metrics included; the concatenated
    expanded stream and the final state equal the serial engine."""
    jstate, now = mixed_qos_state(n=8, depth=8)
    m, k, cd = 6, 10, 3
    want = _jax(jfp.scan_chain_epoch, m=m, k=k, chain_depth=cd,
                anticipation_ns=0, with_metrics=True,
                select_impl=select_impl)(jstate, jnp.int64(now))
    st0 = to_torch(jstate)
    ep = tfp.scan_chain_epoch(st0, now, m, k, chain_depth=cd,
                              anticipation_ns=0, with_metrics=True,
                              select_impl=select_impl)
    assert_tuple_matches(ep, want, fields=(
        "count", "unit_count", "guards_ok", "slot", "cls", "length",
        "metrics"))
    assert_state_matches(ep.state, want.state)
    assert ep.cls.dtype == ep.length.dtype == torch.int8
    st, stream = st0, []
    for i in range(m):
        b = tfp.speculate_chain_batch(st, now, k, chain_depth=cd,
                                      anticipation_ns=0,
                                      select_impl=select_impl)
        assert int(b.count) == int(ep.count[i])
        assert torch.equal(b.slot, ep.slot[i])
        assert torch.equal(b.length.to(torch.int8), ep.length[i])
        stream.append(tfp.expand_units(b.slot, b.cls, b.length, st)[0])
        st = b.state
    for f, a, b in zip(st._fields, ep.state, st):
        assert torch.equal(a, b), f
    total = int(ep.count.sum())
    ser_st, ser = _serial_stream(st0, now, total)
    assert np.array_equal(np.concatenate(stream), ser.slot.numpy())
    for f, a, b in zip(ser_st._fields, ep.state, ser_st):
        assert torch.equal(a, b), f
    assert int(ep.metrics[0]) == total > 0


@pytest.mark.parametrize("select_impl", ["sort", "radix"])
def test_make_prefix_runner_matches_jax(select_impl):
    """An ordinary batch, then a creation-order spread past 2^28 that
    trips the guard, then four clients whose packed keys collide at the
    k-th boundary (equal tags, creation orders 2^28 apart, so the 28-bit
    order field wraps to one value): both packages' runners take their
    serial engine and return the same state, decisions and count."""
    jstate = deep_state({c: ClientInfo(1, 1 + c % 3, 0)
                         for c in range(6)}, depth=4)
    now = 3 * S
    ties = deep_state({c: ClientInfo(1, 1, 0) for c in range(6)}, depth=4)
    ties = ties._replace(order=ties.order.at[:4].set(
        jnp.arange(4, dtype=jnp.int64) << 28))
    for k, spread in ((8, False), (8, True), (2, "ties")):
        if spread is True:
            jstate = jstate._replace(
                order=jstate.order.at[0].set(jnp.int64(1) << 29))
        elif spread == "ties":
            jstate = ties
        if spread:
            assert not bool(jfp.speculate_prefix_batch(
                jstate, jnp.int64(now), k, anticipation_ns=0,
                select_impl=select_impl).guards_ok)
            b = tfp.speculate_prefix_batch(to_torch(jstate), now, k,
                                           anticipation_ns=0,
                                           select_impl=select_impl)
            assert not bool(b.guards_ok) and int(b.count) == 0
        jst, jdec, jn = jfp.make_prefix_runner(
            k, select_impl=select_impl)(jstate, jnp.int64(now))
        tst, tdec, tn = tfp.make_prefix_runner(
            k, select_impl=select_impl)(to_torch(jstate), now)
        assert tn == jn > 0
        assert_tuple_matches(tdec, jdec)
        assert_state_matches(tst, jst)
        jstate = jst


def test_calendar_stop_ladder_matches_jax():
    """The planner view on a Zipf population: the JAX ladder and stop
    packs, numpy's quantiles of the finite packs; rank 1 of the
    order statistics is the minstop boundary, min(stop_pk)."""
    jstate = zipf64_state(n=12, depth=16)
    now = 500 * S
    lad_w, stop_w = _jax(jfp.calendar_stop_ladder, steps=6, levels=4)(
        jstate, jnp.int64(now))
    lad, stop = tfp.calendar_stop_ladder(to_torch(jstate), now, steps=6,
                                         levels=4)
    assert_np_equal("stop_pk", stop.numpy(), np.asarray(stop_w))
    assert_np_equal("ladder", lad.numpy(), np.asarray(lad_w))
    fin = np.sort(stop.numpy()[stop.numpy() < tk.KEY_INF])
    assert fin.size > 0
    want = fin[[max(-(-i * fin.size // 4), 1) - 1 for i in (1, 2, 3, 4)]]
    assert_np_equal("numpy quantiles", lad.numpy(), want)
    assert int(tk.radix_kth_key(stop, 1)) == int(stop.min()) == fin[0]


def test_epoch_registry_matches_jax():
    """The same engine names, decision-field layout and kwargs; the
    JAX side's ``wheel_kernel`` key has no counterpart in the port."""
    assert tfp.EPOCH_ENGINES == jfp.EPOCH_ENGINES
    assert tfp.DECISION_SLOT_FIELDS == jfp.DECISION_SLOT_FIELDS
    assert tfp.DECISION_CAPACITY_FIELDS == jfp.DECISION_CAPACITY_FIELDS
    assert [tfp.epoch_scan_fn(e).__name__ for e in tfp.EPOCH_ENGINES] \
        == [jfp.epoch_scan_fn(e).__name__ for e in jfp.EPOCH_ENGINES]
    knob_sets = [dict(), dict(k=64, select_impl="radix", tag_width=32,
                              window_m=4, with_metrics=True),
                 dict(k=0, chain_depth=2, calendar_impl="wheel",
                      ladder_levels=3, allow_limit_break=True,
                      anticipation_ns=5)]
    for engine in tfp.EPOCH_ENGINES:
        for knobs in knob_sets:
            want = jfp.epoch_scan_kwargs(engine, **knobs)
            want.pop("wheel_kernel", None)
            assert tfp.epoch_scan_kwargs(engine, **knobs) == want
    with pytest.raises(ValueError):
        tfp.epoch_scan_kwargs("serial")
    with pytest.raises(KeyError):
        tfp.epoch_scan_fn("serial")


@pytest.mark.parametrize("engine", ["prefix", "chain", "calendar"])
def test_registry_runs_each_engine_like_jax(engine):
    """``epoch_scan_fn(engine)(state, now, m, **epoch_scan_kwargs(...))``
    on both packages at the int32 carry: the same counts, metrics and
    state."""
    jstate = deep_state({c: ClientInfo(2000, 1000 * (1 + c % 3), 0)
                         for c in range(12)}, depth=6)
    now = 4 * S
    knobs = dict(k=6, tag_width=32, with_metrics=True,
                 calendar_impl="bucketed", ladder_levels=2)
    jkw = jfp.epoch_scan_kwargs(engine, **knobs)
    want = _jax(jfp.epoch_scan_fn(engine), m=3, **jkw)(jstate,
                                                       jnp.int64(now))
    got = tfp.epoch_scan_fn(engine)(to_torch(jstate), now, 3,
                                    **tfp.epoch_scan_kwargs(engine, **knobs))
    assert_tuple_matches(got, want, fields=("count", "metrics"))
    assert_state_matches(got.state, want.state)
    assert int(got.count.sum()) > 0


@pytest.mark.parametrize("advance_now, with_metrics", [(False, False),
                                                       (True, True)])
def test_engine_run_with_horizon_matches_jax(advance_now, with_metrics):
    jstate, now = mixed_qos_state(n=8, depth=6)
    jstate = jstate._replace(head_limit=jstate.head_limit.at[3].set(
        jnp.int64(now + S)))
    kw = dict(allow_limit_break=False, anticipation_ns=0,
              advance_now=advance_now, with_horizon=True,
              with_metrics=with_metrics)
    want = _jax(jk.engine_run, steps=20, **kw)(jstate, jnp.int64(now))
    got = tk.engine_run(to_torch(jstate), now, 20, **kw)
    assert len(got) == len(want) == (5 if with_metrics else 4)
    assert_state_matches(got[0], want[0])
    assert_tuple_matches(got[2], want[2])
    horizon = got[3]
    assert horizon.dim() == 0 and horizon.dtype == torch.int64
    assert int(horizon) == int(want[3]) and int(horizon) > now
    assert int(got[1]) == int(want[1])
    if with_metrics:
        assert_np_equal("metrics", got[4].numpy(), np.asarray(want[4]))


def test_serve_chain_matches_jax():
    """The slice as a whole: ``serve_chain`` at a small shape against
    the JAX ``scan_chain_epoch`` on ``__graft_entry__._preloaded_state``
    at 20 ms, where both phases occur."""
    from __graft_entry__ import _preloaded_state

    n, depth, k, m, epochs, now = 256, 16, 128, 4, 2, 20_000_000
    res = tserve.serve_chain(n, depth, k, m, epochs, now_ns=now,
                             device="cpu")
    jst = _preloaded_state(n, depth, ring=depth)
    run = _jax(jfp.scan_chain_epoch, m=m, k=k, chain_depth=4,
               anticipation_ns=0, with_metrics=True)
    met = None
    for e in range(epochs):
        ep = run(jst, jnp.int64(now))
        jst = ep.state
        for f in ("count", "unit_count", "guards_ok", "slot", "cls",
                  "length"):
            assert_np_equal(f, getattr(res, f)[e].numpy(),
                            np.asarray(getattr(ep, f)))
        met = ep.metrics if met is None else \
            jfp.obsdev.metrics_combine(met, ep.metrics)
    assert_state_matches(res.state, jst)
    assert_np_equal("metrics", res.metrics.numpy(), np.asarray(met))
    phases = tserve.obsdev.metrics_dict(res.metrics)
    assert phases["decisions_reservation"] > 0
    assert phases["decisions_priority"] > 0
