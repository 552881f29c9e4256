"""The port's calendar engine (the cfg4 path) against the JAX package,
exactly: the three calendar batches, ``scan_calendar_epoch`` with
metrics for every scheme, and whole ``calendar_round``s; and the wheel
epoch against the port's own serial engine."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.obs import device as jobs
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk

from test_calendar_bucketed import zipf64_state
from test_prefix import mixed_qos_state
from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                assert_tuple_matches, to_torch)

# module-level jit cache: every JAX shape compiles once per process
_JIT: dict = {}


def _jax_fn(fn, state, **kw):
    key = (fn.__name__, state.capacity, state.ring_capacity,
           tuple(sorted(kw.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(functools.partial(fn, **kw))
    return _JIT[key]


_BATCHES = {
    "minstop": (jfp.calendar_batch, tfp.calendar_batch, {}),
    "bucketed": (jfp.calendar_batch_bucketed, tfp.calendar_batch_bucketed,
                 {"levels": 3}),
    "wheel": (jfp.calendar_batch_wheel, tfp.calendar_batch_wheel,
              {"levels": 3}),
}


def _states():
    state_m, now_m = mixed_qos_state(n=8, depth=12)
    return {"zipf64": (zipf64_state(n=10, depth=32), 500 * S, 8),
            "mixed_qos": (state_m, now_m, 6)}


@pytest.mark.parametrize("impl", sorted(_BATCHES))
@pytest.mark.parametrize("shape, allow", [("zipf64", False),
                                          ("zipf64", True),
                                          ("mixed_qos", False),
                                          ("mixed_qos", True)])
def test_calendar_batches_match_jax(impl, shape, allow):
    """Three successive batches from each side's own previous state:
    every batch field and the full state, field by field with dtypes."""
    jfn, tfn, kw = _BATCHES[impl]
    jstate, now, steps = _states()[shape]
    run = _jax_fn(jfn, jstate, steps=steps, allow_limit_break=allow, **kw)
    st = to_torch(jstate)
    committed = 0
    for _ in range(3):
        want = run(jstate, jnp.int64(now))
        got = tfn(st, now, steps=steps, allow_limit_break=allow, **kw)
        assert_tuple_matches(got, want, fields=[
            f for f in got._fields if f != "state"])
        assert_state_matches(got.state, want.state)
        jstate, st = want.state, got.state
        committed += int(got.count)
    assert committed > 0


def _epoch_kw(impl):
    return dict(steps=6, anticipation_ns=0, with_metrics=True,
                calendar_impl=impl, ladder_levels=3)


@pytest.mark.parametrize("impl", ["minstop", "bucketed", "wheel"])
def test_scan_calendar_epoch_matches_jax(impl):
    """m=3 batches with metrics; the wheel against JAX's XLA scan."""
    jstate, now = mixed_qos_state(n=8, depth=12)
    want = _jax_fn(jfp.scan_calendar_epoch, jstate, m=3,
                   wheel_kernel="xla", **_epoch_kw(impl))(
                       jstate, jnp.int64(now))
    got = tfp.scan_calendar_epoch(to_torch(jstate), now, 3,
                                  **_epoch_kw(impl))
    assert_tuple_matches(got, want, fields=[
        "count", "resv_count", "progress_ok", "served", "metrics",
        "level_count"])
    assert_state_matches(got.state, want.state)
    met = tserve.obsdev.metrics_dict(got.metrics)
    assert met["decisions_total"] == int(got.count.sum()) > 0
    assert met["wheel_pallas_fallbacks"] == 0
    if impl == "wheel":
        assert met["wheel_bucket_occupancy_hwm"] > 0
        assert met["wheel_reslots_total"] > 0
    # the epoch writes only the mutable fields
    st0 = to_torch(jstate)
    got2 = tfp.scan_calendar_epoch(st0, now, 1, **_epoch_kw(impl))
    for f in tfp._EPOCH_INVARIANT:
        assert getattr(got2.state, f) is getattr(st0, f), f


def test_wheel_epoch_matches_jax_pallas_interpret(monkeypatch):
    """The same wheel epoch against JAX's Pallas kernel in interpret
    mode: no fallback on either side, the same vector."""
    monkeypatch.setenv("DMCLOCK_WHEEL_INTERPRET", "1")
    jstate, now = zipf64_state(n=8, depth=16), 500 * S
    kw = _epoch_kw("wheel")
    want = _jax_fn(jfp.scan_calendar_epoch, jstate, m=2,
                   wheel_kernel="pallas", **kw)(jstate, jnp.int64(now))
    got = tfp.scan_calendar_epoch(to_torch(jstate), now, 2, **kw)
    assert_tuple_matches(got, want, fields=[
        "count", "resv_count", "progress_ok", "served", "metrics",
        "level_count"])
    assert_state_matches(got.state, want.state)
    assert jobs.metrics_dict(want.metrics)["wheel_pallas_fallbacks"] == 0
    assert int(got.count.sum()) > 0


def test_calendar_epoch_later_slices_raise():
    """The telemetry accumulators and ``tag_width=32`` are ported: an
    accumulator that is not one is refused, and so are other widths."""
    st = tserve._preloaded_state(8, 4, ring=4, device="cpu")
    for kw in (dict(hists=object()), dict(flight=object())):
        with pytest.raises(ValueError, match="telemetry accumulator"):
            tfp.scan_calendar_epoch(st, 0, 1, steps=2, **kw)
    with pytest.raises(ValueError):
        tfp.scan_calendar_epoch(st, 0, 1, steps=2, calendar_impl="radix")
    with pytest.raises(ValueError, match="tag_width"):
        tfp.scan_calendar_epoch(st, 0, 1, steps=2, tag_width=16)
    with pytest.raises(ValueError, match="steps"):
        tfp.calendar_batch(st, 0, steps=5)


@pytest.mark.parametrize("impl", ["wheel", "bucketed"])
def test_wheel_epoch_equals_port_serial_engine(impl):
    """The port against itself: the epoch's per-client counts and final
    state equal the serial engine run for ``count`` steps."""
    jstate, now = mixed_qos_state(n=8, depth=12)
    st = to_torch(jstate)
    ep = tfp.scan_calendar_epoch(st, now, 2, **_epoch_kw(impl))
    total = int(ep.count.sum())
    assert total > 0 and bool(ep.progress_ok.all())
    ser_st, _, ser = tk.engine_run(st, now, total, allow_limit_break=False,
                                   anticipation_ns=0)
    assert bool((ser.type == tk.RETURNING).all())
    counts = torch.bincount(ser.slot.to(torch.int64),
                            minlength=st.capacity).to(torch.int32)
    assert torch.equal(counts, ep.served)
    for f, a, b in zip(ep.state._fields, ep.state, ser_st):
        assert torch.equal(a, b), f


# ----------------------------------------------------------------------
# the whole slice: closed-loop rounds
# ----------------------------------------------------------------------

_ROUND = dict(m=2, steps=6, ladder_levels=2, waves=8,
              dt_round_ns=50_000_000)


def _jax_round(impl):
    """The JAX package's composition of one closed-loop round (the body
    of ``bench_sustained``'s ``round_fn``), jitted once."""
    key = ("round", impl)
    if key not in _JIT:
        from dmclock_tpu.engine.kernels import ingest_superwave

        c = _ROUND

        def round_fn(st, counts, t_base):
            headroom = jnp.maximum(st.ring_capacity - st.depth,
                                   0).astype(jnp.int32)
            counts, dropped = jobs.admission_clamp(counts, headroom)
            wave_times = t_base + jnp.arange(c["waves"], dtype=jnp.int64) \
                * (c["dt_round_ns"] // c["waves"])
            ones = jnp.ones((st.capacity,), jnp.int64)
            st = ingest_superwave(st, counts, wave_times, ones, ones, ones,
                                  anticipation_ns=0)
            ep = jfp.scan_calendar_epoch(
                st, t_base + c["dt_round_ns"], c["m"], steps=c["steps"],
                anticipation_ns=0, with_metrics=True, calendar_impl=impl,
                ladder_levels=c["ladder_levels"])
            return ep, jobs.metrics_combine(
                ep.metrics, jobs.metrics_delta(ingest_drops=dropped))

        _JIT[key] = jax.jit(round_fn)
    return _JIT[key]


def test_calendar_rounds_match_jax():
    """Four rounds at 64 clients, ring 16: Zipf weights, reservations,
    Poisson arrivals clamped to ring headroom (drops happen), superwave
    ingest and wheel epochs, against the same JAX composition."""
    n, ring, depth0 = 64, 16, 8
    weights = tserve._zipf_weights(n)
    rates = np.full(n, 1200.0)
    rates[::5] = 0.0            # a few weight-only clients
    import bench

    jstate = bench._sustained_setup(n, ring, depth0, rates, weights)
    st = tserve._sustained_setup(n, ring, depth0, rates, weights,
                                 device="cpu")
    assert_state_matches(st, jstate)
    rng = np.random.default_rng(5)
    run = _jax_round("wheel")
    drops = 0
    for r in range(4):
        counts = np.minimum(rng.poisson(6.0, n), _ROUND["waves"]) \
            .astype(np.int32)
        t_base = r * _ROUND["dt_round_ns"]
        want, want_met = run(jstate, jnp.asarray(counts), jnp.int64(t_base))
        got = tserve.calendar_round(st, torch.from_numpy(counts), t_base,
                                    calendar_impl="wheel", **_ROUND)
        assert_tuple_matches(got, want, fields=[
            "count", "resv_count", "progress_ok", "served", "level_count"])
        assert_np_equal("metrics", got.metrics.numpy(),
                        np.asarray(want_met))
        assert_state_matches(got.state, want.state)
        jstate, st = want.state, got.state
        drops += tserve.obsdev.metrics_dict(got.metrics)["ingest_drops"]
    assert drops > 0
