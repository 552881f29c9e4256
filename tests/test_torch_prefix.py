"""The port's prefix-commit path against the JAX package, exactly:
flat batches, epochs, and the whole ``serve`` slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.core import ClientInfo
from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk

from engine_helpers import deep_state
from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                assert_tuple_matches, random_state,
                                to_jax, to_torch)


def _batch_pair(arrays_or_jstate, now, k, **kw):
    jstate = arrays_or_jstate
    if isinstance(jstate, dict):
        jstate = to_jax(jstate)
    want = jfp.speculate_prefix_batch(jstate, jnp.int64(now), k,
                                      anticipation_ns=0, **kw)
    got = tfp.speculate_prefix_batch(to_torch(jstate), now, k,
                                     anticipation_ns=0, **kw)
    return got, want


def _assert_batch_equal(got, want):
    assert int(got.count) == int(want.count)
    assert bool(got.guards_ok) == bool(want.guards_ok)
    assert got.count.dtype == torch.int32
    assert_tuple_matches(got.decisions, want.decisions)
    assert_state_matches(got.state, want.state)
    assert_np_equal("margins", got.margins.numpy(),
                    np.asarray(want.margins))
    assert_np_equal("cost_pc", got.cost_pc.numpy(),
                    np.asarray(want.cost_pc))


@pytest.mark.parametrize("seed, n, k, allow, spread", [
    (1, 64, 16, False, S // 50), (2, 64, 16, True, S // 50),
    (3, 40, 128, False, S // 50), (4, 40, 128, True, S // 50),
    (5, 200, 64, False, S // 50), (7, 64, 128, False, 8 * S)])
def test_speculate_prefix_batch_matches_jax(seed, n, k, allow, spread):
    """Random states (every class, sentinels, wrapped rings), k both
    below and above the population, Wait and Allow."""
    arrays = random_state(seed, n, 8, spread=spread)
    committed = 0
    for now in (50 * S - S // 100, 50 * S, 50 * S + S // 20):
        got, want = _batch_pair(arrays, now, k, allow_limit_break=allow)
        _assert_batch_equal(got, want)
        committed += int(got.count)
    assert committed > 0


def test_speculate_prefix_batch_limit_break_matches_jax():
    """Every head capped by a future limit and no reservation eligible:
    under Allow the whole batch is limit-break serves."""
    arrays = random_state(6, 48, 8, spread=S // 50)
    arrays.update(resv_inv=np.zeros(48, np.int64),
                  head_resv=np.full(48, 1 << 62, np.int64),
                  limit_inv=np.full(48, 10**7, np.int64),
                  head_limit=arrays["head_limit"] * 0 + 60 * S,
                  head_ready=np.zeros(48, bool))
    got, want = _batch_pair(arrays, 50 * S, 16, allow_limit_break=True)
    _assert_batch_equal(got, want)
    assert int(got.decisions.limit_break.sum()) == int(got.count) > 0


def test_speculate_prefix_batch_stops_at_the_rebase_clamp():
    """Weight-phase heads spread over 8 s, each the last request of its
    client (no re-entry): the prefix runs up to the first key past the
    32-bit rebase window and stops there."""
    n = 64
    arrays = random_state(12, n, 8, spread=8 * S)
    arrays.update(resv_inv=np.zeros(n, np.int64),
                  head_resv=np.full(n, 1 << 62, np.int64),
                  limit_inv=np.zeros(n, np.int64),
                  head_limit=np.full(n, -(1 << 62), np.int64),
                  active=np.ones(n, bool), depth=np.ones(n, np.int32))
    got, want = _batch_pair(arrays, 50 * S, 128)
    _assert_batch_equal(got, want)
    assert 0 < int(got.count) < n


def test_speculate_prefix_batch_max_count_matches_jax():
    arrays = random_state(9, 64, 8, spread=S // 50)
    for cap in (0, 3, 1000):
        got, want = _batch_pair(arrays, 50 * S, 32,
                                max_count=jnp.int32(cap))
        _assert_batch_equal(got, want)
        assert int(got.count) <= cap


def test_speculate_prefix_batch_on_a_reachable_state():
    infos = {c: ClientInfo(c % 3, 1 + c % 4, 0) for c in range(12)}
    jstate = deep_state(infos, depth=5, capacity=16)
    got, want = _batch_pair(jstate, 3 * S, 8)
    _assert_batch_equal(got, want)
    assert int(got.count) > 0


@pytest.mark.parametrize("m, window_m", [(6, None), (6, 2), (4, 4)])
def test_scan_prefix_epoch_matches_jax(m, window_m):
    infos = {c: ClientInfo(c % 2, 1 + c % 3, 0) for c in range(10)}
    jstate = deep_state(infos, depth=6, capacity=16)
    now, k = 4 * S, 8
    want = jfp.scan_prefix_epoch(jstate, jnp.int64(now), m, k,
                                 anticipation_ns=0, with_metrics=True,
                                 window_m=window_m)
    got = tfp.scan_prefix_epoch(to_torch(jstate), now, m, k,
                                anticipation_ns=0, with_metrics=True,
                                window_m=window_m)
    assert_state_matches(got.state, want.state)
    assert_tuple_matches(got, want, fields=("count", "guards_ok", "slot",
                                            "phase", "cost", "lb",
                                            "metrics"))
    assert int(got.count.sum()) > 0


def test_scan_prefix_epoch_equals_port_serial_engine():
    """The port against itself: the concatenated epoch prefixes are the
    port's own serial decision stream at the same ``now``."""
    infos = {c: ClientInfo(c % 3, 1 + c % 4, 0) for c in range(16)}
    st = to_torch(deep_state(infos, depth=6, capacity=16))
    now = 3 * S
    ep = tfp.scan_prefix_epoch(st, now, 6, 16, anticipation_ns=0,
                               with_metrics=True)
    total = int(ep.count.sum())
    assert total > 16 and bool(ep.guards_ok.all())
    ser_st, _, ser = tk.engine_run(st, now, total,
                                   allow_limit_break=False,
                                   anticipation_ns=0)
    assert bool((ser.type == tk.RETURNING).all())
    served = ep.slot >= 0
    assert torch.equal(ep.slot[served], ser.slot)
    assert torch.equal(ep.phase[served].to(torch.int32), ser.phase)
    assert torch.equal(ep.cost[served].to(torch.int64), ser.cost)
    for f, a, b in zip(ep.state._fields, ep.state, ser_st):
        assert torch.equal(a, b), f
    assert int(ep.metrics[0]) == total


def test_later_slices_raise_not_implemented():
    """The telemetry accumulators, radix selection and the int32 tag
    carry are ported: an accumulator that is not one is refused, and so
    are unknown values of those knobs."""
    st = tserve._preloaded_state(8, 4, ring=4, device="cpu")
    for kw in (dict(hists=object()),
               dict(ledger=torch.zeros((8, 5), dtype=torch.int32))):
        with pytest.raises(ValueError, match="telemetry accumulator"):
            tfp.scan_prefix_epoch(st, 0, 2, 4, anticipation_ns=0, **kw)
        with pytest.raises(ValueError, match="telemetry accumulator"):
            tfp.scan_chain_epoch(st, 0, 2, 4, chain_depth=2,
                                 anticipation_ns=0, **kw)
    ep = tfp.scan_prefix_epoch(
        st, 0, 2, 4, anticipation_ns=0,
        ledger=torch.zeros((8, 5), dtype=torch.int64))
    assert int(ep.ledger[:, 0].sum()) == int(ep.count.sum()) > 0
    for kw in (dict(select_impl="bitonic"), dict(tag_width=16)):
        with pytest.raises(ValueError):
            tfp.scan_prefix_epoch(st, 0, 2, 4, anticipation_ns=0, **kw)
    for kw in (dict(select_impl="radix"), dict(tag_width=32)):
        ep = tfp.scan_prefix_epoch(st, 0, 2, 4, anticipation_ns=0, **kw)
        assert int(ep.count.sum()) > 0


def test_serve_only_matches_jax_serve():
    """The whole slice: ``serve_only`` at a small shape against the JAX
    ``scan_prefix_epoch`` on ``__graft_entry__._preloaded_state``."""
    from __graft_entry__ import _preloaded_state

    n, depth, k, m, epochs = 512, 16, 256, 4, 2
    res = tserve.serve_only(n, depth, k, m, epochs, device="cpu")
    jstate = _preloaded_state(n, depth, ring=depth)
    assert_state_matches(
        tserve._preloaded_state(n, depth, ring=depth, device="cpu"),
        jstate)
    run = jax.jit(lambda s: jfp.scan_prefix_epoch(
        s, jnp.int64(0), m, k, anticipation_ns=0, with_metrics=True))
    met = None
    for e in range(epochs):
        ep = run(jstate)
        jstate = ep.state
        for f in ("count", "guards_ok", "slot", "phase", "cost"):
            assert_np_equal(f, getattr(res, f)[e].numpy(),
                            np.asarray(getattr(ep, f)))
        met = ep.metrics if met is None else \
            jfp.obsdev.metrics_combine(met, ep.metrics)
    assert_state_matches(res.state, jstate)
    assert_np_equal("metrics", res.metrics.numpy(), np.asarray(met))
    assert bool(res.guards_ok.all())
    assert int(res.metrics[0]) == int(res.count.sum()) > 0
