"""Radix selection and the int32 tag carry of the port against the JAX
package, exactly: ``rebase32``/``restore64``, ``radix_kth_key``,
``radix_quantile_ladder``, radix prefix and chain batches on every
shape ``tests/test_radix.py`` drives, and ``tag_width=32`` in the three
epoch scans -- in window, across a window trip, with stale lanes, with
an entry misfit and with chunked windows -- every output field, the
final state field by field and the metrics vector."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.core import ClientInfo
from dmclock_tpu.core.timebase import MAX_TAG, MIN_TAG
from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.obs import device as jobs
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.obs import device as tobs

from engine_helpers import build_state, deep_state
from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                assert_tuple_matches, to_torch)

# module-level jit cache: every JAX function and shape compiles once
_JIT: dict = {}


def _jax(fn, **kw):
    key = (fn.__name__, tuple(sorted(kw.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(functools.partial(fn, **kw))
    return _JIT[key]


# ----------------------------------------------------------------------
# rebase32 / restore64
# ----------------------------------------------------------------------

_ORIGIN = 123_456_789_000
_WIN = (1 << 31) - 8


def test_rebase32_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    vals = rng.integers(-_WIN + 1, _WIN, size=256) + _ORIGIN
    vals = np.concatenate([vals, [MAX_TAG, MIN_TAG, _ORIGIN + _WIN - 1,
                                  _ORIGIN - _WIN + 1]]).astype(np.int64)
    v32, ok = tk.rebase32(torch.from_numpy(vals), _ORIGIN)
    jv32, jok = jk.rebase32(jnp.asarray(vals), jnp.int64(_ORIGIN))
    assert ok.dim() == 0 and ok.dtype == torch.bool and bool(ok)
    assert bool(jok)
    assert_np_equal("vals32", v32.numpy(), np.asarray(jv32))
    back = tk.restore64(v32, torch.tensor(_ORIGIN))
    assert_np_equal("restore64", back.numpy(),
                    np.asarray(jk.restore64(jv32, jnp.int64(_ORIGIN))))
    assert_np_equal("round trip", back.numpy(), vals)


@pytest.mark.parametrize("bad", [_WIN, -_WIN, _WIN + 12345, -(_WIN + 99)])
def test_rebase32_out_of_window_flags_match_jax(bad):
    vals = np.asarray([0, bad, MAX_TAG], np.int64)
    v32, ok = tk.rebase32(torch.from_numpy(vals), 0)
    jv32, jok = jk.rebase32(jnp.asarray(vals), jnp.int64(0))
    assert not bool(ok) and not bool(jok)
    assert_np_equal("clamped vals32", v32.numpy(), np.asarray(jv32))
    # sentinels alone never trip the window
    _, ok = tk.rebase32(torch.tensor([MAX_TAG, MIN_TAG]), 0)
    assert bool(ok)


# ----------------------------------------------------------------------
# radix_kth_key / radix_quantile_ladder
# ----------------------------------------------------------------------

def test_radix_kth_key_matches_numpy_and_jax():
    """Random non-negative populations of every magnitude with
    duplicates; ``kk`` as an int and as a 0-d tensor."""
    rng = np.random.default_rng(11)
    jkth = jax.jit(jk.radix_kth_key)
    for trial in range(8):
        # two lane counts, so the JAX side compiles twice
        n = (1, 257)[trial % 2] if trial < 2 else 257
        vals = rng.integers(0, 1 << int(rng.integers(1, 63)), size=n)
        if trial % 2:
            vals[rng.random(n) < 0.3] = tk.KEY_INF
            vals[: n // 3] = vals[0]             # a run of duplicates
        vals = vals.astype(np.int64)
        for kk in {1, n, int(rng.integers(1, n + 1))}:
            want = int(np.sort(vals)[kk - 1])
            got = tk.radix_kth_key(torch.from_numpy(vals), kk)
            assert got.dim() == 0 and got.dtype == torch.int64
            assert int(got) == want, (trial, n, kk)
            got_t = tk.radix_kth_key(torch.from_numpy(vals),
                                     torch.tensor(kk, dtype=torch.int32))
            assert int(got_t) == want
            assert int(jkth(jnp.asarray(vals), jnp.int32(kk))) == want


@pytest.mark.parametrize("levels", [1, 3, 4, 8])
def test_radix_quantile_ladder_matches_jax(levels):
    rng = np.random.default_rng(levels)
    n = 200
    pk = ((rng.integers(0, 3, n) << 58)
          | rng.integers(0, 1 << 40, n)).astype(np.int64)
    pk[rng.random(n) < 0.25] = tk.KEY_INF
    cases = [pk, np.full(n, tk.KEY_INF, np.int64), pk[:1]]
    run = _jax(jk.radix_quantile_ladder, levels=levels)
    for vals in cases:
        got = tk.radix_quantile_ladder(torch.from_numpy(vals), levels)
        assert_np_equal("ladder", got.numpy(),
                        np.asarray(run(jnp.asarray(vals))))
        assert (np.diff(got.numpy()) >= 0).all()
        fin = np.sort(vals[vals < tk.KEY_INF])
        if fin.size:
            want = fin[[max(-(-i * fin.size // levels), 1) - 1
                        for i in range(1, levels + 1)]]
            assert_np_equal("numpy quantiles", got.numpy(), want)


# ----------------------------------------------------------------------
# radix batches: port radix == JAX radix == port sort, batch by batch
# ----------------------------------------------------------------------

def _zipf_infos():
    w = np.clip(64.0 / np.arange(1, 25) ** 1.1, 0.5, 64.0)
    np.random.default_rng(3).shuffle(w)
    return {c: ClientInfo(0, float(w[c]), 0) for c in range(24)}


def _radix_shapes():
    """(name, JAX state, now, k, allow, decisions to exhaustion): the
    shapes of tests/test_radix.py."""
    one = {0: ClientInfo(0, 1, 0)}
    three = {c: ClientInfo(0, 1, 0) for c in range(3)}
    return {
        "uniform": (deep_state({c: ClientInfo(0, 1 + (c % 4), 0)
                                for c in range(16)}, depth=4),
                    50 * S, 8, False, 64),
        "zipf": (deep_state(_zipf_infos(), depth=3), 200 * S, 16, False,
                 72),
        "all_ties": (deep_state({c: ClientInfo(0, 2, 0)
                                 for c in range(12)}, depth=6),
                     8 * S, 8, False, 72),
        "single_client": (build_state(one, [(0, S, 1, 1, 1)] * 10,
                                      capacity=8), 100 * S, 8, False, 10),
        "k_past_live": (build_state(three, [(c, S, 1, 1, 1)
                                            for c in range(3)],
                                    capacity=8), 1000 * S, 64, False, 3),
        "both_regimes": (deep_state({c: ClientInfo(2, 1, 0)
                                     for c in range(8)}, depth=8),
                         4 * S, 16, False, 64),
        "limit_break": (deep_state({c: ClientInfo(0, 1, 0.5)
                                    for c in range(6)}, depth=4),
                        2 * S, 8, True, 24),
    }


@pytest.mark.parametrize("shape", ["uniform", "zipf", "all_ties",
                                   "single_client", "k_past_live",
                                   "both_regimes", "limit_break"])
def test_radix_batches_match_jax_to_exhaustion(shape):
    jstate, now, k, allow, total = _radix_shapes()[shape]
    run = _jax(jfp.speculate_prefix_batch, k=k, anticipation_ns=0,
               allow_limit_break=allow, select_impl="radix")
    st = to_torch(jstate)
    committed, classes = 0, set()
    for _ in range(100):
        want = run(jstate, jnp.int64(now))
        got = tfp.speculate_prefix_batch(st, now, k, anticipation_ns=0,
                                         allow_limit_break=allow,
                                         select_impl="radix")
        srt = tfp.speculate_prefix_batch(st, now, k, anticipation_ns=0,
                                         allow_limit_break=allow)
        assert int(got.count) == int(want.count) == int(srt.count)
        assert bool(got.guards_ok) and bool(want.guards_ok)
        assert_tuple_matches(got.decisions, want.decisions)
        assert_state_matches(got.state, want.state)
        # radix == sort on every output the sort backend gives
        for f in got.decisions._fields:
            assert torch.equal(getattr(got.decisions, f),
                               getattr(srt.decisions, f)), f
        for f in got.state._fields:
            assert torch.equal(getattr(got.state, f),
                               getattr(srt.state, f)), f
        c = int(got.count)
        served = got.decisions.slot >= 0
        classes |= set(got.decisions.phase[served].tolist())
        if allow and bool(got.decisions.limit_break.any()):
            classes.add("lb")
        committed += c
        jstate, st = want.state, got.state
        if c == 0:
            break
    assert committed == total
    if shape == "both_regimes":
        assert classes == {0, 1}
    if shape == "limit_break":
        assert "lb" in classes


def test_radix_chain_batch_matches_jax():
    """chain_depth > 1: the lengths ride the small sort."""
    jstate = deep_state({c: ClientInfo(1, 2, 0) for c in range(6)},
                        depth=10)
    now, k = 3 * S, 8
    run = _jax(jfp.speculate_chain_batch, k=k, chain_depth=4,
               anticipation_ns=0, select_impl="radix")
    st = to_torch(jstate)
    for _ in range(3):
        want = run(jstate, jnp.int64(now))
        got = tfp.speculate_chain_batch(st, now, k, chain_depth=4,
                                        anticipation_ns=0,
                                        select_impl="radix")
        srt = tfp.speculate_chain_batch(st, now, k, chain_depth=4,
                                        anticipation_ns=0)
        assert_tuple_matches(got, want, fields=[
            f for f in got._fields if f != "state"])
        assert_state_matches(got.state, want.state)
        for f in ("count", "unit_count", "slot", "cls", "length"):
            assert torch.equal(getattr(got, f), getattr(srt, f)), f
        jstate, st = want.state, got.state
    assert int(got.unit_count) >= 0


@pytest.mark.parametrize("window_m", [None, 2])
def test_radix_prefix_epoch_matches_jax(window_m):
    jstate = deep_state({c: ClientInfo(c % 2, 1 + (c % 3), 0)
                         for c in range(10)}, depth=6)
    now = 4 * S
    want = _jax(jfp.scan_prefix_epoch, m=4, k=8, anticipation_ns=0,
                with_metrics=True, select_impl="radix",
                window_m=window_m)(jstate, jnp.int64(now))
    got = tfp.scan_prefix_epoch(to_torch(jstate), now, 4, 8,
                                anticipation_ns=0, with_metrics=True,
                                select_impl="radix", window_m=window_m)
    assert_tuple_matches(got, want, fields=("count", "guards_ok", "slot",
                                            "phase", "cost", "lb",
                                            "metrics"))
    assert_state_matches(got.state, want.state)
    assert int(got.count.sum()) > 0


# ----------------------------------------------------------------------
# tag_width=32
# ----------------------------------------------------------------------

def _high_rate_state(n=12, depth=6):
    """Tag advance ~1e6 ns a serve: a small epoch stays in window."""
    return deep_state({c: ClientInfo(2000, 1000 * (1 + c % 3), 0)
                       for c in range(n)}, depth=depth)


def _low_rate_state(n=12, depth=6):
    """Tag advance ~1e9 ns a serve: one batch leaves the window."""
    return deep_state({c: ClientInfo(2, 1 + (c % 3), 0) for c in range(n)},
                      depth=depth)


_PREFIX_OUT = ("count", "guards_ok", "slot", "phase", "cost", "lb",
               "metrics")
_CHAIN_OUT = ("count", "unit_count", "guards_ok", "slot", "cls", "length",
              "metrics")
_CAL_OUT = ("count", "resv_count", "progress_ok", "served", "metrics",
            "level_count")


def _prefix_pair(jstate, now, m, k, **kw):
    want = _jax(jfp.scan_prefix_epoch, m=m, k=k, anticipation_ns=0,
                with_metrics=True, **kw)(jstate, jnp.int64(now))
    got = tfp.scan_prefix_epoch(to_torch(jstate), now, m, k,
                                anticipation_ns=0, with_metrics=True, **kw)
    assert_tuple_matches(got, want, fields=_PREFIX_OUT)
    assert_state_matches(got.state, want.state)
    return got


@pytest.mark.parametrize("select_impl", ["sort", "radix"])
def test_tag32_prefix_epoch_matches_jax_and_tag64(select_impl):
    jstate = _high_rate_state()
    now = 4 * S
    e32 = _prefix_pair(jstate, now, 4, 8, tag_width=32,
                       select_impl=select_impl)
    e64 = tfp.scan_prefix_epoch(to_torch(jstate), now, 4, 8,
                                anticipation_ns=0, with_metrics=True,
                                select_impl=select_impl)
    assert bool(e32.guards_ok.all())
    for f in _PREFIX_OUT:
        assert torch.equal(getattr(e32, f), getattr(e64, f)), f
    for f in e32.state._fields:
        assert torch.equal(getattr(e32.state, f), getattr(e64.state, f)), f


def test_tag32_chain_epoch_matches_jax_and_tag64():
    jstate = _high_rate_state()
    now = 4 * S
    kw = dict(m=3, k=8, chain_depth=4, anticipation_ns=0,
              with_metrics=True)
    want = _jax(jfp.scan_chain_epoch, tag_width=32, **kw)(
        jstate, jnp.int64(now))
    tkw = dict(kw)
    m, k = tkw.pop("m"), tkw.pop("k")
    got = tfp.scan_chain_epoch(to_torch(jstate), now, m, k, tag_width=32,
                               **tkw)
    assert_tuple_matches(got, want, fields=_CHAIN_OUT)
    assert_state_matches(got.state, want.state)
    e64 = tfp.scan_chain_epoch(to_torch(jstate), now, m, k, **tkw)
    for f in _CHAIN_OUT:
        assert torch.equal(getattr(got, f), getattr(e64, f)), f
    assert int(got.count.sum()) > 0


def _cal_pair(jstate, now, m, tag_width, impl):
    kw = dict(steps=6, anticipation_ns=0, with_metrics=True,
              calendar_impl=impl, ladder_levels=3, tag_width=tag_width)
    want = _jax(jfp.scan_calendar_epoch, m=m, **kw)(jstate, jnp.int64(now))
    got = tfp.scan_calendar_epoch(to_torch(jstate), now, m, **kw)
    assert_tuple_matches(got, want, fields=_CAL_OUT)
    assert_state_matches(got.state, want.state)
    return got


@pytest.mark.parametrize("impl", ["minstop", "bucketed", "wheel"])
def test_tag32_calendar_epoch_matches_jax_and_tag64(impl):
    jstate = _high_rate_state()
    now = 4 * S
    e32 = _cal_pair(jstate, now, 2, 32, impl)
    e64 = tfp.scan_calendar_epoch(to_torch(jstate), now, 2, steps=6,
                                  with_metrics=True, calendar_impl=impl,
                                  ladder_levels=3)
    assert bool(e32.progress_ok.all())
    for f in _CAL_OUT:
        assert torch.equal(getattr(e32, f), getattr(e64, f)), f
    for f in e32.state._fields:
        assert torch.equal(getattr(e32.state, f), getattr(e64.state, f)), f


def test_tag32_window_trip_falls_back_exactly():
    """A mid-epoch trip zeroes that batch and every later one, keeps the
    last good state and bumps rebase_fallbacks once, as the JAX package
    does (metrics vector included); resuming at tag_width=64 from the
    returned state continues the int64 epoch exactly."""
    jstate = _low_rate_state()
    now = 4 * S
    e32 = _prefix_pair(jstate, now, 4, 8, tag_width=32)
    guards = e32.guards_ok.numpy()
    first_bad = int(np.argmax(~guards))
    assert not guards.all() and not guards[first_bad:].any()
    assert (e32.count.numpy()[first_bad:] == 0).all()
    assert (e32.slot.numpy()[first_bad:] == -1).all()
    met = tobs.metrics_dict(e32.metrics)
    assert met["rebase_fallbacks"] == 1
    # dead batches are no stalls and trip no guard
    assert met["limit_stalls"] == 0 and met["rebase_guard_trips"] == 0
    st0 = to_torch(jstate)
    e64 = tfp.scan_prefix_epoch(st0, now, 4, 8, anticipation_ns=0,
                                with_metrics=True)
    assert torch.equal(e32.count[:first_bad], e64.count[:first_bad])
    assert met["ring_occupancy_hwm"] <= \
        tobs.metrics_dict(e64.metrics)["ring_occupancy_hwm"]
    resume = tfp.scan_prefix_epoch(e32.state, now, 4 - first_bad, 8,
                                   anticipation_ns=0)
    assert torch.equal(resume.slot, e64.slot[first_bad:])
    for f in resume.state._fields:
        assert torch.equal(getattr(resume.state, f),
                           getattr(e64.state, f)), f


def test_tag32_trip_in_chain_and_calendar_epochs_matches_jax():
    jstate = _low_rate_state()
    now = 4 * S
    kw = dict(m=3, k=8, chain_depth=4, anticipation_ns=0,
              with_metrics=True, tag_width=32)
    want = _jax(jfp.scan_chain_epoch, **kw)(jstate, jnp.int64(now))
    tkw = dict(kw)
    m, k = tkw.pop("m"), tkw.pop("k")
    got = tfp.scan_chain_epoch(to_torch(jstate), now, m, k, **tkw)
    assert_tuple_matches(got, want, fields=_CHAIN_OUT)
    assert_state_matches(got.state, want.state)
    cal = _cal_pair(jstate, now, 3, 32, "wheel")
    for ep in (got, cal):
        assert tobs.metrics_dict(ep.metrics)["rebase_fallbacks"] == 1
    assert not bool(cal.progress_ok.all())


def test_tag32_ignores_stale_inactive_lanes():
    """An inactive lane and an active drained lane with tags far outside
    any window do not trip the carry and come back untouched."""
    jstate = _high_rate_state()
    n = jstate.capacity
    far = jnp.int64(1) << 40
    jstate = jstate._replace(
        active=jstate.active.at[n - 1].set(False),
        head_prop=jstate.head_prop.at[n - 1].set(far),
        prev_prop=jstate.prev_prop.at[n - 1].set(-far),
        depth=jstate.depth.at[n - 2].set(0),
        head_resv=jstate.head_resv.at[n - 2].set(far))
    e32 = _prefix_pair(jstate, 4 * S, 4, 8, tag_width=32)
    assert bool(e32.guards_ok.all())
    assert tobs.metrics_dict(e32.metrics)["rebase_fallbacks"] == 0
    assert int(e32.state.head_prop[n - 1]) == 1 << 40
    assert int(e32.state.prev_prop[n - 1]) == -(1 << 40)
    assert int(e32.state.head_resv[n - 2]) == 1 << 40


def test_tag32_initial_misfit_returns_input_state():
    jstate = _low_rate_state()
    n = jstate.capacity
    jstate = jstate._replace(head_prop=jstate.head_prop + jnp.arange(
        n, dtype=jnp.int64) * jnp.int64(1 << 28))
    e32 = _prefix_pair(jstate, 4 * S, 3, 8, tag_width=32)
    assert (e32.count.numpy() == 0).all()
    assert not e32.guards_ok.numpy().any()
    assert_state_matches(e32.state, jstate)
    assert tobs.metrics_dict(e32.metrics)["rebase_fallbacks"] == 1


@pytest.mark.parametrize("window_m", [1, 2])
def test_tag32_window_m_matches_jax(window_m):
    jstate = _high_rate_state()
    e32 = _prefix_pair(jstate, 4 * S, 4, 8, tag_width=32,
                       window_m=window_m)
    ref = tfp.scan_prefix_epoch(to_torch(jstate), 4 * S, 4, 8,
                                anticipation_ns=0, with_metrics=True)
    for f in _PREFIX_OUT:
        assert torch.equal(getattr(e32, f), getattr(ref, f)), f


# ----------------------------------------------------------------------
# the slice as a whole: serve_only with its knobs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(select_impl="radix"),
                                   dict(tag_width=32, high_rate=True),
                                   dict(tag_width=32)])
def test_serve_knobs_match_jax_serve(knobs):
    """``serve_epochs`` with radix selection or the int32 carry at a
    small shape against the JAX ``scan_prefix_epoch`` on the same
    preloaded state: the high-rate state stays in window, the default
    rates trip the carry."""
    from __graft_entry__ import _preloaded_state

    knobs = dict(knobs)
    n, depth, k, m, epochs = 256, 16, 128, 4, 2
    if knobs.pop("high_rate", False):
        st = tserve.high_rate_state(n, depth, device="cpu")
        jst = _preloaded_state(n, depth, ring=depth)
        jst = jst._replace(resv_inv=jst.resv_inv // 1000,
                           weight_inv=jst.weight_inv // 1000,
                           head_resv=jst.head_resv // 1000,
                           head_prop=jst.head_prop // 1000)
    else:
        st = tserve._preloaded_state(n, depth, ring=depth, device="cpu")
        jst = _preloaded_state(n, depth, ring=depth)
    assert_state_matches(st, jst)
    res = tserve.serve_epochs(st, epochs, k=k, m=m, **knobs)
    run = _jax(jfp.scan_prefix_epoch, m=m, k=k, anticipation_ns=0,
               with_metrics=True, **knobs)
    met = None
    for e in range(epochs):
        ep = run(jst, jnp.int64(0))
        jst = ep.state
        for f in ("count", "guards_ok", "slot", "phase", "cost"):
            assert_np_equal(f, getattr(res, f)[e].numpy(),
                            np.asarray(getattr(ep, f)))
        met = ep.metrics if met is None else \
            jobs.metrics_combine(met, ep.metrics)
    assert_state_matches(res.state, jst)
    assert_np_equal("metrics", res.metrics.numpy(), np.asarray(met))
    assert int(res.count.sum()) > 0
