"""The port's stream chunk (``engine/stream.py``) and the sustained rows
(``serve.cfg3_*``, ``serve.cfg4_*``) against the JAX package, exactly:
``build_stream_chunk`` for the three engines with ingest and all five
telemetry accumulators, the ``with_pressure`` probe, the chunk against
the port's own round loop, and the cfg3 and cfg4 rounds at a reduced
width against the JAX scans composed the way ``bench.py`` composes
them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.engine import stream as jstream
from dmclock_tpu.obs import device as jobs
from dmclock_tpu.obs import flight as jflight
from dmclock_tpu.obs import histograms as jhist
from dmclock_tpu.obs import provenance as jprov
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import stream as tstream
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.obs import flight as tflight
from dmclock_tpu_torch.obs import histograms as thist
from dmclock_tpu_torch.obs import provenance as tprov
from dmclock_tpu_torch.obs import slo as tslo

from test_torch_support import (assert_np_equal, assert_state_matches,
                                to_jax, to_torch)

N, RING, DEPTH0, WAVES, DT = 40, 10, 5, 2, 20_000_000
EPOCHS = 3
RECORDS = 32

# engine -> (case name, kwargs of build_stream_chunk)
CASES = {
    "prefix": dict(engine="prefix", m=2, k=16),
    "chain": dict(engine="chain", m=2, k=8, chain_depth=3),
    "minstop": dict(engine="calendar", m=2, k=4),
    "bucketed": dict(engine="calendar", m=2, k=4, calendar_impl="bucketed",
                     ladder_levels=2),
    "wheel": dict(engine="calendar", m=2, k=4, calendar_impl="wheel",
                  ladder_levels=2),
}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


def _setup():
    rates = np.full(N, 100.0)
    rates[::4] = 0.0
    weights = np.asarray([1.0 + (i % 4) for i in range(N)])
    st = tserve._sustained_setup(N, RING, DEPTH0, rates, weights,
                                 device="cpu")
    rng = np.random.default_rng(9)
    counts = np.minimum(rng.poisson(1.2, (2 * EPOCHS, N)), WAVES) \
        .astype(np.int32)
    return bridge.state_to_numpy(st), counts


ARRAYS, COUNTS = _setup()


def _kits():
    t = (thist.hist_zero("cpu"), thist.ledger_zero(N, "cpu"),
         tflight.flight_init(RECORDS, "cpu"), tslo.window_zero(N, "cpu"),
         tprov.prov_init(N, 0, "cpu"))
    j = (jhist.hist_zero(), jhist.ledger_zero(N),
         jflight.flight_init(RECORDS), jslo.window_zero(N),
         jprov.prov_init(N, 0))
    return t, j


def _assert_tele(got, want):
    """(hists, ledger, flight, slo, prov) of the port against JAX."""
    names = ("hists", "ledger", "flight", "slo", "prov")
    for name, g, w in zip(names, got, want):
        if isinstance(g, tuple):
            for f, a, b in zip(g._fields, g, w):
                assert_np_equal(f"{name}.{f}", _np(a), _np(b))
        else:
            assert_np_equal(name, _np(g), _np(w))


def _chunk_kw(case):
    kw = dict(CASES[case])
    kw.setdefault("epochs", EPOCHS)
    return dict(kw, dt_epoch_ns=DT, waves=WAVES, with_metrics=True)


_JIT: dict = {}


def _jax_chunk(case):
    if case not in _JIT:
        _JIT[case] = jax.jit(jstream.build_stream_chunk(
            wheel_kernel="xla", **_chunk_kw(case)))
    return _JIT[case]


def _jax_pressure_step(case):
    """JAX ``make_epoch_step(with_pressure=True)`` for ``case``, jitted
    once (the JAX chunk has no probe; the port's chunk is held against
    this step run epoch by epoch)."""
    key = ("step", case)
    if key not in _JIT:
        kw = dict(CASES[case])
        engine, m = kw.pop("engine"), kw.pop("m")
        skw = jfp.epoch_scan_kwargs(engine, wheel_kernel="xla",
                                    with_metrics=True, **kw)
        _JIT[key] = jax.jit(jstream.make_epoch_step(
            engine=engine, m=m, kw=skw, dt_epoch_ns=DT, waves=WAVES,
            ingest=True, with_pressure=True))
    return _JIT[key]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_chunk_matches_jax(case):
    """One chunk of three epochs with ingest and all five accumulators,
    from epoch 1: the state, every stacked output and the accumulators
    equal the JAX chunk's."""
    tk, jkit = _kits()
    want = _jax_chunk(case)(to_jax(ARRAYS), jnp.int64(1),
                            jnp.asarray(COUNTS[:EPOCHS]), *jkit)
    chunk = tstream.build_stream_chunk(**_chunk_kw(case))
    got = chunk(to_torch(ARRAYS), 1, torch.from_numpy(COUNTS[:EPOCHS]),
                *tk)
    assert_state_matches(got.state, want.state)
    assert sorted(got.outs) == sorted(want.outs)
    for f in got.outs:
        assert_np_equal(f, _np(got.outs[f]), _np(want.outs[f]))
    _assert_tele(got[2:], want[2:])
    assert int(got.outs["count"].sum()) > 0
    assert tstream.epoch_decisions(CASES[case]["engine"], got.outs, 0) \
        == int(got.outs["count"][0].sum())


@pytest.mark.parametrize("case", ["prefix", "chain", "wheel"])
def test_stream_chunk_with_pressure_matches_jax(case):
    """The probe's chunk against JAX ``make_epoch_step(with_pressure=
    True)`` epoch by epoch; the probe moves nothing else."""
    tk, jkit = _kits()
    step = _jax_pressure_step(case)
    st, carry, press = to_jax(ARRAYS), jkit, []
    for i in range(EPOCHS):
        (st, *carry), outs = step(st, jnp.int64(i * DT),
                                  jnp.asarray(COUNTS[i]), *carry)
        press.append(np.asarray(outs["pressure"]))
    chunk = tstream.build_stream_chunk(with_pressure=True,
                                       **_chunk_kw(case))
    got = chunk(to_torch(ARRAYS), 0, torch.from_numpy(COUNTS[:EPOCHS]),
                *tk)
    assert_np_equal("pressure", _np(got.outs["pressure"]), np.stack(press))
    assert_state_matches(got.state, st)
    _assert_tele(got[2:], carry)
    plain = tstream.build_stream_chunk(**_chunk_kw(case))(
        to_torch(ARRAYS), 0, torch.from_numpy(COUNTS[:EPOCHS]))
    for f in plain.outs:
        assert torch.equal(plain.outs[f], got.outs[f]), f
    d = tprov.pressure_dict(got.outs["pressure"][0])
    assert d["backlog"] > 0 and d["eligible_live"] == d["eligible_peak"]


@pytest.mark.parametrize("case", ["prefix", "chain", "bucketed"])
def test_stream_chunk_equals_the_round_loop(case):
    """Two chunks (3 + 3 epochs) equal six rounds of the port's own
    round loop: ``ingest_step`` then the epoch scan, the accumulators
    carried."""
    kw = _chunk_kw(case)
    engine, m = kw.pop("engine"), kw.pop("m")
    chunk = tstream.build_stream_chunk(engine=engine, m=m, **kw)
    tk, _ = _kits()
    st, tele = to_torch(ARRAYS), tk
    outs = []
    for e0 in (0, EPOCHS):
        ch = chunk(st, e0, torch.from_numpy(COUNTS[e0:e0 + EPOCHS]),
                   *tele)
        st, tele = ch.state, tuple(ch[2:])
        outs.append(ch.outs)
    skw = tfp.epoch_scan_kwargs(
        engine, with_metrics=True,
        **{f: v for f, v in CASES[case].items()
           if f not in ("engine", "m")})
    fn = tfp.epoch_scan_fn(engine)
    rst, rtele = to_torch(ARRAYS), _kits()[0]
    for i in range(2 * EPOCHS):
        rst = tstream.ingest_step(rst, torch.from_numpy(COUNTS[i]), i * DT,
                                  dt_epoch_ns=DT, waves=WAVES)
        ep = fn(rst, (i + 1) * DT, m=m, **skw,
                **dict(zip(("hists", "ledger", "flight", "slo", "prov"),
                           rtele)))
        rst = ep.state
        rtele = (ep.hists, ep.ledger, ep.flight, ep.slo, ep.prov)
        view = tstream.epoch_view(engine, outs[i // EPOCHS], i % EPOCHS)
        assert type(view) is type(ep) and view.state is None
        for f in tstream.STREAM_OUT_FIELDS[engine] + ("metrics",):
            assert torch.equal(getattr(view, f), getattr(ep, f)), (i, f)
    for f, a, b in zip(st._fields, st, rst):
        assert torch.equal(a, b), f
    for a, b in zip(tele, rtele):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_ingest_step_and_no_ingest_chunk_match_jax():
    want = jstream.jit_ingest_step(dt_epoch_ns=DT, waves=WAVES)(
        to_jax(ARRAYS), jnp.asarray(COUNTS[0] * 3), jnp.int64(DT))
    got = tstream.ingest_step(to_torch(ARRAYS),
                              torch.from_numpy(COUNTS[0] * 3), DT,
                              dt_epoch_ns=DT, waves=WAVES)
    assert_state_matches(got, want)
    chunk = tstream.build_stream_chunk(ingest=False, **_chunk_kw("prefix"))
    got = chunk(to_torch(ARRAYS), 0)
    ep = tfp.scan_prefix_epoch(to_torch(ARRAYS), DT, 2, 16,
                               anticipation_ns=0, with_metrics=True)
    assert torch.equal(got.outs["slot"][0], ep.slot)
    with pytest.raises(ValueError, match="counts"):
        tstream.build_stream_chunk(**_chunk_kw("prefix"))(
            to_torch(ARRAYS), 0)
    with pytest.raises(ValueError):
        tstream.build_stream_chunk(epochs=0, engine="prefix", m=1,
                                   dt_epoch_ns=DT, waves=WAVES)


def test_chunk_bounds_and_fields_match_jax():
    for start, epochs, every in ((0, 5, 2), (3, 11, 4), (4, 4, 2),
                                 (0, 7, 1), (2, 9, 0)):
        assert list(tstream.chunk_bounds(start, epochs, every)) == \
            list(jstream.chunk_bounds(start, epochs, every))
    assert tstream.STREAM_OUT_FIELDS == jstream.STREAM_OUT_FIELDS
    assert tstream.STREAM_GUARD_FIELD == jstream.STREAM_GUARD_FIELD


# ----------------------------------------------------------------------
# the sustained rows at a reduced width against bench's composition
# ----------------------------------------------------------------------

def _bench_round(engine, **kw):
    """Bench's ``round_fn`` with telemetry, SLO and provenance on, as
    one JAX function: the admission clamp with its drop count, the
    superwave ingest, the epoch scan with the accumulators, the drop
    row added to the epoch's metrics."""
    key = ("bench", engine, tuple(sorted(kw.items())))
    if key in _JIT:
        return _JIT[key]
    waves, dt = kw.pop("waves"), kw.pop("dt_round_ns")
    m = kw.pop("m")

    def round_fn(st, counts, t_base, th, tl, ts, tp):
        headroom = jnp.maximum(st.ring_capacity - st.depth, 0) \
            .astype(jnp.int32)
        counts, dropped = jobs.admission_clamp(counts, headroom)
        wave_times = t_base + jnp.arange(waves, dtype=jnp.int64) \
            * (dt // waves)
        cost = jnp.ones((st.capacity,), dtype=jnp.int64)
        st = jk.ingest_superwave(st, counts, wave_times, cost, cost, cost,
                                 anticipation_ns=0)
        fn = jfp.scan_prefix_epoch if engine == "prefix" \
            else functools.partial(jfp.scan_calendar_epoch,
                                   wheel_kernel="xla")
        ep = fn(st, t_base + dt, m, anticipation_ns=0, with_metrics=True,
                hists=th, ledger=tl, slo=ts, prov=tp, **kw)
        return ep._replace(metrics=jobs.metrics_combine(
            ep.metrics, jobs.metrics_delta(ingest_drops=dropped)))

    _JIT[key] = jax.jit(round_fn)
    return _JIT[key]


def _jax_tele(n, plane, t0=0):
    return (jhist.hist_zero(), jhist.ledger_zero(n),
            jslo.window_zero(n).at[:, jslo.W_CEPOCH].set(
                jnp.asarray(plane.cepoch_vector())),
            jprov.prov_init(n, t0))


@pytest.mark.parametrize("workload", ["cfg3", "cfg4"])
def test_sustained_rounds_match_bench_composition(workload):
    """Two timed rounds of the row at a reduced width (cfg3: 96 clients
    at its ring, waves, k and m; cfg4 minstop: 64 clients), after bench's
    calibration, with telemetry, SLO and provenance on, against bench's
    round function on the JAX package from the same calibrated state and
    time; the stream loop (chunk 2) equals the rounds except the
    ingest_drops row the chunk does not count; telemetry off moves
    nothing; and bench's derived scalars come out."""
    n, rounds = (96, 2) if workload == "cfg3" else (64, 2)
    setup = tserve.cfg3_setup if workload == "cfg3" else tserve.cfg4_setup
    prep = setup(n, rounds, device="cpu")
    st0, draws, t0 = prep.state, prep.draws, prep.t0
    plane = tserve.slo_plane(workload, n, state=st0)
    tele = tserve.tele_zero(n, plane=plane, t0=t0, device="cpu")
    if workload == "cfg3":
        c = tserve.CFG3
        got = tserve.cfg3_rounds(st0, draws, t0=t0, tele=tele)
        stream = tserve.cfg3_stream(st0, draws, t0=t0, tele=tele, chunk=2)
        off = tserve.cfg3_rounds(st0, draws, t0=t0)
        run = _bench_round("prefix", m=c["m"], k=c["k"], waves=c["waves"],
                           dt_round_ns=c["dt_round_ns"])
        fields = ("count", "guards_ok", "slot", "phase", "cost", "lb")
    else:
        c = tserve.CFG4
        kw = dict(calendar_impl="minstop", t0=t0)
        got = tserve.cfg4_rounds(st0, draws, tele=tele, **kw)
        stream = tserve.cfg4_stream(st0, draws, tele=tele, chunk=2, **kw)
        off = tserve.cfg4_rounds(st0, draws, **kw)
        run = _bench_round("calendar", m=c["m"], steps=c["steps"],
                           waves=c["waves"], dt_round_ns=c["dt_round_ns"],
                           calendar_impl="minstop")
        fields = ("count", "resv_count", "progress_ok", "served",
                  "level_count")
    jst = to_jax(bridge.state_to_numpy(st0))
    jt = _jax_tele(n, plane, t0)
    met = jobs.metrics_zero()
    for r in range(rounds):
        ep = run(jst, jnp.asarray(_np(draws[r])),
                 jnp.int64(t0 + r * c["dt_round_ns"]), *jt)
        for f in fields:
            assert_np_equal(f, _np(getattr(got, f)[r]),
                            _np(getattr(ep, f)))
        jst, jt = ep.state, (ep.hists, ep.ledger, ep.slo, ep.prov)
        met = jobs.metrics_combine(met, ep.metrics)
    assert_state_matches(got.state, jst)
    assert_np_equal("metrics", _np(got.metrics), _np(met))
    for name, a, b in zip(("hists", "ledger", "slo"), got.tele, jt):
        assert_np_equal(name, _np(a), _np(b))
    for f, a, b in zip(tprov.ProvBlock._fields, got.tele.prov, jt[3]):
        assert_np_equal(f"prov.{f}", _np(a), _np(b))
    # the stream loop and telemetry off
    keep = torch.ones(tobs.NUM_METRICS, dtype=torch.bool)
    keep[tobs.MET_INGEST_DROPS] = False
    for res, what in ((stream, "stream"), (off, "telemetry off")):
        for f in fields:
            assert torch.equal(getattr(res, f), getattr(got, f)), (what, f)
        for f, a, b in zip(res.state._fields, res.state, got.state):
            assert torch.equal(a, b), (what, f)
        assert torch.equal(res.metrics[keep], got.metrics[keep]), what
    assert torch.equal(off.metrics, got.metrics)
    for a, b in zip(stream.tele[:3], got.tele[:3]):
        assert torch.equal(a, b)
    for a, b in zip(stream.tele.prov, got.tele.prov):
        assert torch.equal(a, b)
    sc = tserve.row_scalars(got.tele, got.state,
                            t0 + rounds * c["dt_round_ns"], c["dt_round_ns"])
    assert sc["ledger_totals"]["ops"] == int(got.count.sum()) > 0
    assert sc["slo_window_totals"]["ops"] == int(got.count.sum())
    for key in ("tardiness_p50_ns", "tardiness_p99_ns", "margin_p50_ns",
                "starvation_max_ns", "limit_gate_share"):
        assert key in sc
