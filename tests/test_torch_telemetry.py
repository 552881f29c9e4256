"""The port's telemetry plane against the JAX package, exactly: the
histogram and ledger functions (bucket edges, masked and dead folds),
the flight ring (wraparound, one-batch overflow, masked and dead
batches), and the three epoch scans with all five accumulators riding
them (histograms, ledger, flight ring, SLO window block, provenance
block) under every knob the port takes; decisions, state and metrics
identical with telemetry on and off."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.obs import flight as jflight
from dmclock_tpu.obs import histograms as jhist
from dmclock_tpu.obs import provenance as jprov
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.obs import flight as tflight
from dmclock_tpu_torch.obs import histograms as thist
from dmclock_tpu_torch.obs import provenance as tprov
from dmclock_tpu_torch.obs import slo as tslo

from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                random_state, to_jax, to_torch)

I64_MAX = (1 << 63) - 1
RECORDS = 40


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


# ----------------------------------------------------------------------
# histograms and ledger
# ----------------------------------------------------------------------

def _edge_values():
    vals = [0, -1, -(1 << 62), I64_MAX, I64_MAX - 1, 1 << 62, 1 << 46,
            (1 << 46) - 1, (1 << 47) + 5]
    for i in range(1, 47):
        vals += [(1 << i) - 1, 1 << i, (1 << i) + 1]
    return np.asarray(vals, dtype=np.int64)


def test_bucket_index_edges_match_jax():
    """0, 2^i - 1, 2^i and 2^i + 1 for every i, negatives and values
    near int64 max: the same bucket on both sides, and the documented
    one."""
    v = _edge_values()
    got = _np(thist.bucket_index(torch.from_numpy(v)))
    want = _np(jhist.bucket_index(jnp.asarray(v)))
    assert_np_equal("bucket", got, want)
    for x, b in zip(v.tolist(), got.tolist()):
        assert b == (0 if x <= 0 else min(x.bit_length(), 47)), (x, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_observe_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([_edge_values(),
                           rng.integers(-(1 << 40), 1 << 50, 300)])
    mask = rng.random(vals.size) < 0.6
    th, jh = thist.hist_zero("cpu"), jhist.hist_zero()
    for fam in range(thist.NUM_HISTS):
        th = thist.hist_observe(th, fam, torch.from_numpy(vals),
                                torch.from_numpy(mask))
        jh = jhist.hist_observe(jh, fam, jnp.asarray(vals),
                                jnp.asarray(mask))
        mask = np.roll(mask, 7)
    for value, weight in ((0, 1), (5, 0), (1 << 20, 1), (-3, 1),
                          ((1 << 50) + 1, 1), (7, True), (9, False)):
        th = thist.hist_observe_scalar(th, 2, value, weight)
        jh = jhist.hist_observe_scalar(jh, 2, value, weight)
    assert_np_equal("hists", _np(th), _np(jh))
    for live in (True, False):
        assert_np_equal(
            f"hist_fold live={live}",
            _np(thist.hist_fold(th, th, torch.tensor(live))),
            _np(jhist.hist_fold(jh, jh, jnp.bool_(live))))
    assert_np_equal("hist_fold True", _np(thist.hist_fold(th, th, True)),
                    _np(jhist.hist_combine(jh, jh)))
    assert thist.hist_dict(th) == jhist.hist_dict(jh)
    for fam in range(thist.NUM_HISTS):
        assert thist.hist_mean(th, fam) == jhist.hist_mean(jh, fam)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert thist.hist_percentile(th, fam, q) == \
                jhist.hist_percentile(jh, fam, q)
    empty = thist.hist_zero("cpu")
    assert thist.hist_percentile(empty, 0, 0.5) == 0.0
    assert thist.hist_mean(empty, 1) == 0.0


def test_ledger_functions_match_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 30, (50, thist.LED_COLS)).astype(np.int64)
    b = rng.integers(0, 1 << 30, (50, thist.LED_COLS)).astype(np.int64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert_np_equal("combine", _np(thist.ledger_combine(ta, tb)),
                    _np(jhist.ledger_combine(jnp.asarray(a),
                                             jnp.asarray(b))))
    for live in (True, False):
        assert_np_equal(
            f"fold live={live}",
            _np(thist.ledger_fold(ta, tb, torch.tensor(live))),
            _np(jhist.ledger_fold(jnp.asarray(a), jnp.asarray(b),
                                  jnp.bool_(live))))
    # a dead fold is the identity; a live one equals the combine
    assert torch.equal(thist.ledger_fold(ta, tb, torch.tensor(False)), ta)
    assert torch.equal(thist.ledger_fold(ta, tb, True),
                       thist.ledger_combine(ta, tb))
    assert_np_equal("combine_np", thist.ledger_combine_np(a, b, a),
                    jhist.ledger_combine_np(a, b, a))
    assert thist.ledger_totals(ta) == jhist.ledger_totals(a)
    assert thist.ledger_rows(ta, limit=7) == jhist.ledger_rows(a, limit=7)
    assert thist.ledger_zero(3, "cpu").shape == (3, thist.LED_COLS)


# ----------------------------------------------------------------------
# the flight ring
# ----------------------------------------------------------------------

_JFLIGHT = jax.jit(jflight.flight_record)


def _record_both(seq_of_batches, records):
    tf, jf = tflight.flight_init(records, "cpu"), jflight.flight_init(records)
    for slot, live, margin, gate in seq_of_batches:
        k = slot.size
        cls = (np.arange(k) % 3).astype(np.int64)
        tag = (np.arange(k) * 1000 + 7).astype(np.int64)
        cost = (np.arange(k) % 5 + 1).astype(np.int32)
        kw_t = dict(live=live if live is True else torch.tensor(live))
        kw_j = dict(live=live)
        if margin is not None:
            kw_t["margin"] = torch.from_numpy(margin)
            kw_j["margin"] = jnp.asarray(margin)
        if gate is not None:
            kw_t["gate"] = torch.tensor(gate, dtype=torch.int64)
            kw_j["gate"] = jnp.int64(gate)
        tf = tflight.flight_record(
            tf, torch.from_numpy(slot), torch.from_numpy(cls),
            torch.from_numpy(tag), torch.from_numpy(cost), **kw_t)
        jf = _JFLIGHT(jf, jnp.asarray(slot), jnp.asarray(cls),
                      jnp.asarray(tag), jnp.asarray(cost), **kw_j)
    for f in ("buf", "seq", "batch"):
        assert_np_equal(f, _np(getattr(tf, f)), _np(getattr(jf, f)))
    assert tflight.flight_drain(tf) == jflight.flight_drain(jf)
    return tf


def test_flight_wraparound_keeps_newest():
    batches = [(np.arange(6, dtype=np.int32) + 10 * i, True, None, None)
               for i in range(5)]
    fl = _record_both(batches, 16)
    recs = tflight.flight_drain(fl)
    assert [r["seq"] for r in recs] == list(range(14, 30))
    assert int(fl.seq) == 30 and int(fl.batch) == 5


def test_flight_one_batch_overflow():
    rng = np.random.default_rng(3)
    slot = np.where(rng.random(50) < 0.7, np.arange(50), -1).astype(np.int32)
    margin = rng.integers(-1, 1 << 30, 50).astype(np.int64)
    fl = _record_both([(slot, True, margin, 9)], 8)
    recs = tflight.flight_drain(fl)
    assert len(recs) == 8 and int(fl.seq) == int((slot >= 0).sum())
    assert [r["client"] for r in recs] == \
        [int(c) for c in slot[slot >= 0][-8:]]
    assert all(r["gate"] == 9 for r in recs)


def test_flight_masked_and_dead_batches_write_nothing():
    rng = np.random.default_rng(5)
    scattered = np.where(rng.random(20) < 0.4, np.arange(20),
                         -1).astype(np.int32)
    fl = _record_both([
        (np.full(12, -1, np.int32), True, None, None),      # all masked
        (np.arange(12, dtype=np.int32), False, None, 3),    # dead batch
        (scattered, True, None, 2),                         # scattered
        (np.arange(5, dtype=np.int32), False, None, None),
    ], RECORDS)
    assert int(fl.batch) == 2 and int(fl.seq) == int((scattered >= 0).sum())


def test_flight_dump_and_from_arrays(tmp_path):
    fl = _record_both([(np.arange(7, dtype=np.int32), True, None, 1)], 5)
    path = tmp_path / "flight.jsonl"
    assert tflight.flight_dump(fl, str(path)) == 5
    assert len(path.read_text().splitlines()) == 5
    back = tflight.flight_from_arrays(_np(fl.buf), _np(fl.seq),
                                      _np(fl.batch), device="cpu")
    assert tflight.flight_drain(back) == tflight.flight_drain(fl)
    with pytest.raises(ValueError):
        tflight.flight_init(0, "cpu")


# ----------------------------------------------------------------------
# the epoch scans with all five accumulators
# ----------------------------------------------------------------------

_JIT: dict = {}


def _jax_epoch(name, **kw):
    """One jit per scan configuration, shared by every case."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(functools.partial(getattr(jfp, name), **kw))
    return _JIT[key]


def _kits(n, now0=0):
    """The five accumulators on both sides: ``(port kwargs, JAX
    kwargs)``."""
    t = dict(hists=thist.hist_zero("cpu"), ledger=thist.ledger_zero(n, "cpu"),
             flight=tflight.flight_init(RECORDS, "cpu"),
             slo=tslo.window_zero(n, "cpu"),
             prov=tprov.prov_init(n, now0, "cpu"))
    j = dict(hists=jhist.hist_zero(), ledger=jhist.ledger_zero(n),
             flight=jflight.flight_init(RECORDS),
             slo=jslo.window_zero(n), prov=jprov.prov_init(n, now0))
    return t, j


def assert_tele_matches(got, want):
    """The five accumulators of two epoch results, field by field."""
    for f in ("hists", "ledger", "slo"):
        assert_np_equal(f, _np(getattr(got, f)), _np(getattr(want, f)))
    for f in ("buf", "seq", "batch"):
        assert_np_equal(f"flight.{f}", _np(getattr(got.flight, f)),
                        _np(getattr(want.flight, f)))
    for f in ("margin_hist", "scal", "last_served"):
        assert_np_equal(f"prov.{f}", _np(getattr(got.prov, f)),
                        _np(getattr(want.prov, f)))


def _outputs_equal(a, b, fields):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f, x, y in zip(a.state._fields, a.state, b.state):
        assert torch.equal(x, y), f


_PREFIX_OUT = ("count", "guards_ok", "slot", "phase", "cost", "lb",
               "metrics")
_CHAIN_OUT = ("count", "unit_count", "guards_ok", "slot", "cls", "length",
              "metrics")
_CAL_OUT = ("count", "resv_count", "progress_ok", "served", "metrics",
            "level_count")


def _states():
    """name -> (numpy state, now): an arbitrary state where every class
    and the sentinels occur; the preloaded backlog at default rates,
    where the int32 carry trips in the first batches; the same backlog at
    1000x the rates, where it never does."""
    trip = bridge.state_to_numpy(
        tserve._preloaded_state(48, 8, ring=8, device="cpu"))
    hi = bridge.state_to_numpy(tserve.high_rate_state(48, 16, device="cpu"))
    return {"random": (random_state(11, 40, 8), 50 * S),
            "trip": (trip, 0),
            "high_rate": (hi, 20_000)}


STATES = _states()


@pytest.mark.parametrize("shape, select_impl, tag_width, allow", [
    ("random", "sort", 64, True), ("random", "radix", 64, False),
    ("high_rate", "sort", 32, False), ("high_rate", "radix", 32, False),
    ("trip", "sort", 32, False)])
def test_prefix_epoch_telemetry_matches_jax(shape, select_impl, tag_width,
                                            allow):
    arrays, now = STATES[shape]
    n = arrays["depth"].shape[0]
    kw = dict(m=4, k=16, anticipation_ns=0, allow_limit_break=allow,
              with_metrics=True, select_impl=select_impl,
              tag_width=tag_width, window_m=2)
    tk, jk = _kits(n)
    want = _jax_epoch("scan_prefix_epoch", **kw)(to_jax(arrays),
                                                 jnp.int64(now), **jk)
    st = to_torch(arrays)
    got = tfp.scan_prefix_epoch(st, now, **kw, **tk)
    assert_tele_matches(got, want)
    for f in _PREFIX_OUT:
        assert_np_equal(f, _np(getattr(got, f)), _np(getattr(want, f)))
    assert_state_matches(got.state, want.state)
    met = tserve.obsdev.metrics_dict(got.metrics)
    if shape == "trip":
        assert tag_width == 64 or met["rebase_fallbacks"] == 1
    else:
        assert met["rebase_fallbacks"] == 0
    assert int(got.ledger[:, thist.LED_OPS].sum()) == \
        met["decisions_total"] > 0
    # decisions, state and metrics do not move with telemetry off
    _outputs_equal(got, tfp.scan_prefix_epoch(st, now, **kw), _PREFIX_OUT)


def test_prefix_tag32_trip_folds_nothing_after_the_trip():
    """A trip in the first batch: every batch is dead, so every
    accumulator stays at its entry value on both sides."""
    arrays, now = STATES["trip"]
    n = arrays["depth"].shape[0]
    kw = dict(m=4, k=16, anticipation_ns=0, allow_limit_break=False,
              with_metrics=True, select_impl="sort", tag_width=32,
              window_m=2)
    tk, jk = _kits(n, now0=5)
    want = _jax_epoch("scan_prefix_epoch", **kw)(to_jax(arrays),
                                                 jnp.int64(now), **jk)
    got = tfp.scan_prefix_epoch(to_torch(arrays), now, **kw, **tk)
    assert_tele_matches(got, want)
    good = _np(got.guards_ok)
    assert not good.all()
    dead = int(np.argmin(good)) if not good[0] else None
    if dead == 0:
        assert int(got.hists.sum()) == 0 and int(got.flight.seq) == 0
        assert torch.equal(got.prov.last_served, tk["prov"].last_served)


@pytest.mark.parametrize("select_impl, tag_width, allow", [
    ("sort", 64, True), ("radix", 64, False), ("sort", 32, False)])
def test_chain_epoch_telemetry_matches_jax(select_impl, tag_width, allow):
    arrays, now = STATES["random" if tag_width == 64 else "high_rate"]
    n = arrays["depth"].shape[0]
    kw = dict(m=3, k=16, chain_depth=3, anticipation_ns=0,
              allow_limit_break=allow, with_metrics=True,
              select_impl=select_impl, tag_width=tag_width)
    tk, jk = _kits(n)
    want = _jax_epoch("scan_chain_epoch", **kw)(to_jax(arrays),
                                                jnp.int64(now), **jk)
    st = to_torch(arrays)
    got = tfp.scan_chain_epoch(st, now, **kw, **tk)
    assert_tele_matches(got, want)
    for f in _CHAIN_OUT:
        assert_np_equal(f, _np(getattr(got, f)), _np(getattr(want, f)))
    assert_state_matches(got.state, want.state)
    assert int(got.count.sum()) > 0
    _outputs_equal(got, tfp.scan_chain_epoch(st, now, **kw), _CHAIN_OUT)


def _cfg4_like(n=40, ring=12, depth0=6, seed=3):
    """A small cfg4-flavored state after one superwave ingest: Zipf
    weights, reservations (a fifth of the clients without one)."""
    rates = np.full(n, 1200.0)
    rates[::5] = 0.0
    st = tserve._sustained_setup(n, ring, depth0, rates,
                                 tserve._zipf_weights(n), device="cpu")
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.poisson(3.0, n), ring - depth0).astype(np.int32)
    ones = torch.ones((n,), dtype=torch.int64)
    st = tserve.ingest_superwave(
        st, torch.from_numpy(counts),
        torch.arange(6, dtype=torch.int64) * 8_000_000, ones, ones, ones,
        anticipation_ns=0)
    return bridge.state_to_numpy(st), 50_000_000


CAL_STATE = _cfg4_like()


@pytest.mark.parametrize("impl, tag_width, allow", [
    ("minstop", 64, False), ("bucketed", 64, True), ("wheel", 64, False),
    ("minstop", 32, False), ("wheel", 32, False)])
def test_calendar_epoch_telemetry_matches_jax(impl, tag_width, allow):
    if tag_width == 32:
        arrays, now = STATES["high_rate"]
    else:
        arrays, now = CAL_STATE
    n = arrays["depth"].shape[0]
    kw = dict(m=2, steps=4, anticipation_ns=0, allow_limit_break=allow,
              with_metrics=True, tag_width=tag_width, calendar_impl=impl,
              ladder_levels=3)
    tk, jk = _kits(n)
    want = _jax_epoch("scan_calendar_epoch", wheel_kernel="xla", **kw)(
        to_jax(arrays), jnp.int64(now), **jk)
    st = to_torch(arrays)
    got = tfp.scan_calendar_epoch(st, now, **kw, **tk)
    assert_tele_matches(got, want)
    for f in _CAL_OUT:
        assert_np_equal(f, _np(getattr(got, f)), _np(getattr(want, f)))
    assert_state_matches(got.state, want.state)
    assert int(got.count.sum()) > 0
    assert int(got.ledger[:, thist.LED_OPS].sum()) == int(got.count.sum())
    _outputs_equal(got, tfp.scan_calendar_epoch(st, now, **kw), _CAL_OUT)


def test_bucketed_telemetry_equals_the_minstop_composition():
    """A ladder level is one minstop batch: bucketed-L telemetry (hists,
    ledger, window, provenance) equals L minstop batches'; and the wheel
    equals bucketed on all five accumulators."""
    arrays, now = CAL_STATE
    n = arrays["depth"].shape[0]
    st = to_torch(arrays)
    kw = dict(steps=4, anticipation_ns=0, with_metrics=True)
    tk, _ = _kits(n)
    del tk["flight"]
    lad = tfp.scan_calendar_epoch(st, now, 1, calendar_impl="bucketed",
                                  ladder_levels=3, **kw, **tk)
    mins = tfp.scan_calendar_epoch(st, now, 3, calendar_impl="minstop",
                                   **kw, **tk)
    for f in ("hists", "ledger", "slo"):
        assert torch.equal(getattr(lad, f), getattr(mins, f)), f
    for f, a, b in zip(tprov.ProvBlock._fields, lad.prov, mins.prov):
        assert torch.equal(a, b), f
    tk, _ = _kits(n)
    a = tfp.scan_calendar_epoch(st, now, 2, calendar_impl="wheel",
                                ladder_levels=3, **kw, **tk)
    tk, _ = _kits(n)
    b = tfp.scan_calendar_epoch(st, now, 2, calendar_impl="bucketed",
                                ladder_levels=3, **kw, **tk)
    for f in ("hists", "ledger", "slo"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.flight + a.prov, b.flight + b.prov):
        assert torch.equal(x, y)


def test_scans_refuse_misshapen_accumulators():
    st = tserve._preloaded_state(8, 4, ring=4, device="cpu")
    for kw in (dict(ledger=thist.ledger_zero(9, "cpu")),
               dict(slo=tslo.window_zero(8, "cpu").to(torch.int32)),
               dict(prov=tprov.prov_init(7, 0, "cpu"))):
        with pytest.raises(ValueError):
            tfp.scan_prefix_epoch(st, 0, 1, 4, anticipation_ns=0, **kw)
