"""The port's degradation ladder, host metric fold and guarded stream
chunk (``robust/guarded.py``, ``obs/device.py``) against the JAX
package's, exactly: the ladder on random fault sequences at every
threshold and rung with encode/load round trips, ``metrics_combine_np``,
``run_stream_chunk_guarded`` on the three engines (minstop, bucketed and
wheel calendars) with telemetry on, a chunk whose tag32 carry trips and
falls back to the round path, and a transient error retried."""

import numpy as np
import pytest
import torch

import dmclock_tpu.obs.device as jdev
import dmclock_tpu.robust.guarded as JG
import dmclock_tpu.robust.supervisor as JS
import dmclock_tpu_torch.engine.stream as tstream
import dmclock_tpu_torch.obs.device as tdev
import dmclock_tpu_torch.robust.guarded as TG
import dmclock_tpu_torch.robust.supervisor as TS
from dmclock_tpu_torch.obs.spans import SpanTracer

from test_torch_support import assert_np_equal, assert_state_matches
from test_torch_telemetry import _kits, _np, assert_tele_matches

# ----------------------------------------------------------------------
# the ladder
# ----------------------------------------------------------------------

FAST_CFGS = {
    "wheel": {"calendar_impl": "wheel", "select_impl": "sort",
              "tag_width": 64},
    "bucketed": {"calendar_impl": "bucketed", "select_impl": "sort",
                 "tag_width": 64},
    "radix": {"calendar_impl": "minstop", "select_impl": "radix",
              "tag_width": 64},
    "tag32": {"calendar_impl": "minstop", "select_impl": "sort",
              "tag_width": 32},
    "all": {"calendar_impl": "wheel", "select_impl": "radix",
            "tag_width": 32},
}


def test_rungs_equal_jax():
    assert TG.LADDER_RUNGS == JG.LADDER_RUNGS


def _ladder_state(lad):
    return (lad.steps_taken, lad.describe(), lad.encode().tolist())


@pytest.mark.parametrize("threshold", [1, 2, 3])
@pytest.mark.parametrize("cfg_name", sorted(FAST_CFGS))
def test_ladder_equals_jax_on_random_faults(threshold, cfg_name):
    """A seeded stream of clean epochs, guard trips and launch failures:
    every step, applied config, can_step answer, description and encoded
    vector equal the JAX ladder's; every few epochs both are encoded and
    loaded into fresh ladders, which then go on equal too."""
    rng = np.random.default_rng(100 * threshold + len(cfg_name))
    base = FAST_CFGS[cfg_name]
    tl = TG.DegradationLadder(threshold=threshold)
    jl = JG.DegradationLadder(threshold=threshold)
    for i in range(40):
        cfg_t, cfg_j = tl.apply(base), jl.apply(base)
        assert cfg_t == cfg_j
        assert tl.can_step(cfg_t) == jl.can_step(cfg_j)
        kind = rng.integers(0, 3)
        kw = {1: {"guard_trips": int(rng.integers(1, 3))},
              2: {"launch_failures": 1}}.get(int(kind), {})
        assert tl.note_epoch(cfg_t, **kw) == jl.note_epoch(cfg_j, **kw)
        assert _ladder_state(tl) == _ladder_state(jl)
        if i % 7 == 6:
            vec = tl.encode()
            tl = TG.DegradationLadder(threshold=threshold)
            tl.load(torch.from_numpy(vec))
            jl2 = JG.DegradationLadder(threshold=threshold)
            jl2.load(jl.encode())
            jl = jl2
            assert _ladder_state(tl) == _ladder_state(jl)
    assert tl.apply(base) == jl.apply(base)


def test_disabled_ladder_is_inert_like_jax():
    tl, jl = TG.DegradationLadder(enabled=False), \
        JG.DegradationLadder(enabled=False)
    cfg = FAST_CFGS["all"]
    for _ in range(5):
        assert tl.note_epoch(cfg, guard_trips=1) == 0 == \
            jl.note_epoch(cfg, guard_trips=1)
    assert tl.apply(cfg) == cfg == jl.apply(cfg)
    assert not tl.can_step(cfg) and not jl.can_step(cfg)
    assert tl.encode().tolist() == jl.encode().tolist()


def test_ladder_step_records_an_instant():
    tracer = SpanTracer()
    lad = TG.DegradationLadder(threshold=1, tracer=tracer)
    assert lad.note_epoch(FAST_CFGS["tag32"], guard_trips=1) == 1
    rows = [r for r in tracer.rows() if r["name"] == "ladder.step"]
    assert len(rows) == 1 and rows[0]["args"]["to"] == "64"


def test_ladder_load_rejects_a_bad_vector():
    with pytest.raises(ValueError):
        TG.DegradationLadder().load(np.zeros(3, dtype=np.int64))


@pytest.mark.parametrize("seed", range(4))
def test_metrics_combine_np_equals_jax(seed):
    rng = np.random.default_rng(seed)
    vecs = [rng.integers(-5, 1 << 40, tdev.NUM_METRICS, dtype=np.int64)
            for _ in range(4)]
    got = tdev.metrics_combine_np(vecs[0], *[torch.from_numpy(v)
                                             for v in vecs[1:]])
    want = jdev.metrics_combine_np(vecs[0], *vecs[1:])
    assert_np_equal("metrics", got, want)
    assert tdev.RESUME_ROWS == jdev.RESUME_ROWS


# ----------------------------------------------------------------------
# the guarded stream chunk
# ----------------------------------------------------------------------

OUT_FIELDS = {
    "prefix": ("count", "guards_ok", "slot", "phase", "cost", "lb",
               "metrics"),
    "chain": ("count", "unit_count", "guards_ok", "slot", "cls", "length",
              "metrics"),
    "calendar": ("count", "resv_count", "progress_ok", "served", "metrics",
                 "level_count"),
}
DECISION_FIELDS = ("type", "slot", "phase", "cost", "when", "limit_break")

CHUNKS = {
    "prefix": dict(engine="prefix", k=16),
    "prefix-radix": dict(engine="prefix", k=16, select_impl="radix"),
    "chain": dict(engine="chain", k=8, chain_depth=3),
    "calendar-minstop": dict(engine="calendar", k=4),
    "calendar-bucketed": dict(engine="calendar", k=4,
                              calendar_impl="bucketed", ladder_levels=2),
    "calendar-wheel": dict(engine="calendar", k=4, calendar_impl="wheel",
                           ladder_levels=2),
}
N, RING, EPOCHS, WAVES, DT = 96, 10, 3, 2, 10 ** 8


def _job(spread: int = 0):
    return dict(n=N, depth=6, ring=RING, tag_spread_ns=spread)


def _states(spread: int = 0):
    want = JS._job_state(JS.EpochJob(**_job(spread)))
    got = TS._job_state(TS.EpochJob(**_job(spread)), "cpu")
    assert_state_matches(got, want)
    return got, want


def _counts(seed: int):
    rng = np.random.default_rng(seed)
    return rng.poisson(1.5, (EPOCHS, N)).astype(np.int32)


def _chunk_kw(cfg: dict, tag_width: int = 64) -> dict:
    return dict(cfg, epochs=EPOCHS, m=2, dt_epoch_ns=DT, waves=WAVES,
                tag_width=tag_width)


def assert_chunk_equal(got, want, engine: str):
    assert got.counts == want.counts
    assert got.guard_trips == want.guard_trips
    assert (got.stream_fallback, got.retries) == \
        (want.stream_fallback, want.retries)
    assert len(got.epochs) == len(want.epochs)
    for ge, we in zip(got.epochs, want.epochs):
        assert len(ge) == len(we)
        for g, w in zip(ge, we):
            fields = DECISION_FIELDS if hasattr(w, "type") \
                else OUT_FIELDS[engine]
            for f in fields:
                assert_np_equal(f, _np(getattr(g, f)), _np(getattr(w, f)))
    assert_state_matches(got.state, want.state)
    assert_tele_matches(got, want)


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_stream_chunk_equals_jax(name):
    cfg = CHUNKS[name]
    st, jst = _states()
    counts = _counts(3)
    tk, jk = _kits(N)
    want = JG.run_stream_chunk_guarded(jst, 2, counts, **_chunk_kw(cfg),
                                       **jk)
    overlapped = []
    got = TG.run_stream_chunk_guarded(
        st, 2, counts, **_chunk_kw(cfg), **tk,
        overlap=lambda: overlapped.append(1))
    assert_chunk_equal(got, want, cfg["engine"])
    assert got.stream_fallback == 0 and overlapped == [1]
    assert sum(got.counts) > 0


@pytest.mark.parametrize("name", ["prefix", "chain", "calendar-minstop"])
def test_tripping_chunk_falls_back_like_jax(name):
    """Client 0's proportion tag 2^31 + 1 ns ahead trips the tag32 carry:
    the chunk is dropped and its epochs replay on the round path, equal
    to the JAX fallback and to the port's own round loop from the same
    entry state, telemetry included; the entry state is untouched."""
    cfg = CHUNKS[name]
    st, jst = _states(2 ** 31 + 1)
    entry = [t.clone() for t in st]
    counts = _counts(5)
    tk, jk = _kits(N)
    tracer = SpanTracer()
    want = JG.run_stream_chunk_guarded(jst, 0, counts,
                                       **_chunk_kw(cfg, 32), **jk)
    got = TG.run_stream_chunk_guarded(st, 0, counts,
                                      **_chunk_kw(cfg, 32), **tk,
                                      tracer=tracer)
    assert got.stream_fallback == 1 and sum(got.guard_trips) > 0
    assert_chunk_equal(got, want, cfg["engine"])
    for f, a, b in zip(st._fields, st, entry):
        assert torch.equal(a, b), f"the chunk wrote the entry {f}"
    names = {r["name"] for r in tracer.rows()}
    assert {"stream.dispatch", "stream.device_wait",
            "stream.fallback"} <= names

    # the port's own round loop from the entry state
    tk2, _ = _kits(N)
    cur, rows = st, []
    for i in range(EPOCHS):
        cur = tstream.ingest_step(cur, torch.from_numpy(counts[i]), i * DT,
                                  dt_epoch_ns=DT, waves=WAVES)
        run_kw = {k: v for k, v in _chunk_kw(cfg, 32).items()
                  if k not in ("epochs", "dt_epoch_ns", "waves")}
        ep = TG.run_epoch_guarded(cur, i * DT + DT, with_metrics=True,
                                  **run_kw, **tk2)
        cur = ep.state
        tk2 = {f: getattr(ep, f) for f in tk2}
        rows.append(ep.count)
    assert tuple(rows) == got.counts
    for f, a, b in zip(cur._fields, cur, got.state):
        assert torch.equal(a, b), f
    for f in ("hists", "ledger", "slo"):
        assert torch.equal(tk2[f], getattr(got, f)), f


def test_transient_error_is_retried_and_counted(monkeypatch):
    """An OSError from the chunk launch is retried (no sleep here) and
    counted; the result equals a clean chunk's and the JAX package's."""
    cfg = CHUNKS["prefix"]
    st, jst = _states()
    counts = _counts(7)
    want = JG.run_stream_chunk_guarded(jst, 0, counts, **_chunk_kw(cfg))
    real = tstream.build_stream_chunk
    fails = [1]

    def flaky(**kw):
        fn = real(**kw)

        def chunk(*a):
            if fails[0]:
                fails[0] -= 1
                raise OSError("transport hiccup")
            return fn(*a)
        return chunk

    monkeypatch.setattr(tstream, "build_stream_chunk", flaky)
    # the chunk programs are cached by configuration: start empty, so the
    # flaky chunk is the one the guarded runner captures
    monkeypatch.setattr(tstream, "_STREAM_JIT_CACHE", {})
    seen = []
    got = TG.run_stream_chunk_guarded(
        st, 0, counts, **_chunk_kw(cfg), sleep=seen.append,
        on_retry=lambda i, e: seen.append(type(e).__name__))
    assert got.retries == 1 and seen[0] == "OSError"
    assert got.counts == want.counts
    assert_state_matches(got.state, want.state)


def test_runtime_error_is_not_retried(monkeypatch):
    """A RuntimeError (the class a CUDA error is) propagates at once: it
    is never retried in process."""
    calls = [0]

    def broken(**kw):
        def chunk(*a):
            calls[0] += 1
            raise RuntimeError("CUDA error: an illegal memory access")
        return chunk

    monkeypatch.setattr(tstream, "build_stream_chunk", broken)
    monkeypatch.setattr(tstream, "_STREAM_JIT_CACHE", {})
    st, _ = _states()
    with pytest.raises(RuntimeError, match="CUDA error"):
        TG.run_stream_chunk_guarded(st, 0, _counts(1),
                                    **_chunk_kw(CHUNKS["prefix"]),
                                    sleep=lambda s: None)
    assert calls[0] == 1
