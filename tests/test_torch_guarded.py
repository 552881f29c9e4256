"""The port's guarded epoch runner (``robust/guarded.py``
``run_epoch_guarded``) against the JAX package's, exactly: the three
engines with and without the five telemetry accumulators, the tag32
window trip resumed on int64, a guard trip resumed on the serial engine,
transient errors retried with backoff, ``skew_ns`` and the spans.

The trips the scans never make at these shapes are forced the same way
on both sides: the JAX side through its epoch cache
(``guarded._jit_epoch``), the port's through ``fastpath.epoch_scan_fn``.
"""

import jax.numpy as jnp
import pytest
import torch

import dmclock_tpu.robust.guarded as JG
import dmclock_tpu_torch.engine.fastpath as tfp
import dmclock_tpu_torch.robust.guarded as TG
from dmclock_tpu.obs import spans as JS
from dmclock_tpu_torch.obs import spans as TS

from test_torch_support import (assert_np_equal, assert_state_matches,
                                to_jax, to_torch)
from test_torch_telemetry import (STATES, _kits, _np, assert_tele_matches)

OUT_FIELDS = {
    "prefix": ("count", "guards_ok", "slot", "phase", "cost", "lb",
               "metrics"),
    "chain": ("count", "unit_count", "guards_ok", "slot", "cls", "length",
              "metrics"),
    "calendar": ("count", "resv_count", "progress_ok", "served", "metrics",
                 "level_count"),
}
DECISION_FIELDS = ("type", "slot", "phase", "cost", "when", "limit_break")
KW = dict(m=4, k=8, with_metrics=True)   # k <= the states' ring (8)


def run_both(arrays, now, *, tele: bool, **kw):
    n = arrays["depth"].shape[0]
    tk, jk = _kits(n) if tele else ({}, {})
    want = JG.run_epoch_guarded(to_jax(arrays), jnp.int64(now), **kw, **jk)
    got = TG.run_epoch_guarded(to_torch(arrays), now, **kw, **tk)
    return got, want


def assert_guarded_equal(got, want, engine: str, tele: bool):
    assert (got.count, got.rebase_fallbacks, got.serial_fallbacks,
            got.retries) == (want.count, want.rebase_fallbacks,
                             want.serial_fallbacks, want.retries)
    assert len(got.results) == len(want.results)
    for g, w in zip(got.results, want.results):
        fields = DECISION_FIELDS if hasattr(w, "type") \
            else OUT_FIELDS[engine]
        for f in fields:
            assert_np_equal(f, _np(getattr(g, f)), _np(getattr(w, f)))
    assert_state_matches(got.state, want.state)
    if tele:
        assert_tele_matches(got, want)
    else:
        assert got.hists is None and got.prov is None


@pytest.mark.parametrize("engine", ["prefix", "chain", "calendar"])
@pytest.mark.parametrize("tele", [False, True], ids=["plain", "tele"])
def test_engines_equal_jax(engine, tele):
    arrays, now = STATES["random"]
    got, want = run_both(arrays, now, tele=tele, engine=engine, **KW)
    assert_guarded_equal(got, want, engine, tele)
    assert got.count > 0 and got.retries == 0
    assert got.rebase_fallbacks == got.serial_fallbacks == 0


@pytest.mark.parametrize("engine, k", [("prefix", 16), ("chain", 16),
                                       ("calendar", 8)])
def test_tag32_trip_resumes_on_int64_like_jax(engine, k):
    """The default-rate backlog trips the int32 carry within the epoch:
    the remaining batches resume at int64 from the last good state, the
    accumulators carrying on."""
    arrays, now = STATES["trip"]
    got, want = run_both(arrays, now, tele=True, engine=engine,
                         tag_width=32, **{**KW, "k": k})
    assert got.rebase_fallbacks == 1 and len(got.results) == 2
    assert_guarded_equal(got, want, engine, True)


def _tripping(ep, field: str, lib):
    """``ep`` with one more batch that committed nothing and tripped."""
    if lib is torch:
        cat, zero, bad = torch.cat, torch.zeros(1, dtype=ep.count.dtype), \
            torch.zeros(1, dtype=torch.bool)
    else:
        cat, zero, bad = jnp.concatenate, jnp.zeros(1, ep.count.dtype), \
            jnp.zeros(1, bool)
    return ep._replace(count=cat([ep.count, zero]),
                       **{field: cat([getattr(ep, field), bad])})


@pytest.mark.parametrize("engine", ["prefix", "calendar"])
def test_guard_trip_resumes_on_the_serial_engine_like_jax(engine,
                                                          monkeypatch):
    """The last batch of the first attempt reports a trip: the rest runs
    on the serial engine, max(remaining, 1) * max(k, 1) steps at the
    same now, accumulators passed through."""
    field = "progress_ok" if engine == "calendar" else "guards_ok"
    orig_j, orig_t = JG._jit_epoch, tfp.epoch_scan_fn

    def jit_epoch(eng, m_run, kw, tele_sig=()):
        real = orig_j(eng, m_run - 1, kw, tele_sig)
        return lambda *a: _tripping(real(*a), field, jnp)

    def scan_fn(eng):
        real = orig_t(eng)
        return lambda st, t, m, **kw: _tripping(real(st, t, m=m - 1, **kw),
                                                field, torch)

    monkeypatch.setattr(JG, "_jit_epoch", jit_epoch)
    monkeypatch.setattr(tfp, "epoch_scan_fn", scan_fn)
    arrays, now = STATES["random"]
    got, want = run_both(arrays, now, tele=True, engine=engine, **KW)
    assert got.serial_fallbacks == 1 and len(got.results) == 2
    assert got.results[1].type.shape == (KW["k"],)
    assert_guarded_equal(got, want, engine, True)


def test_transient_errors_retry_with_backoff_like_jax(monkeypatch):
    orig_j, orig_t = JG._jit_epoch, tfp.epoch_scan_fn
    fails = {"jax": 2, "port": 2}

    def flaky(side, fn):
        def call(*a, **kw):
            if fails[side]:
                fails[side] -= 1
                raise ConnectionError("transport hiccup")
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(JG, "_jit_epoch",
                        lambda *a: flaky("jax", orig_j(*a)))
    monkeypatch.setattr(tfp, "epoch_scan_fn",
                        lambda eng: flaky("port", orig_t(eng)))
    arrays, now = STATES["random"]
    sleeps = {"jax": [], "port": []}
    seen = {"jax": [], "port": []}
    n = arrays["depth"].shape[0]
    tk, jk = _kits(n)
    want = JG.run_epoch_guarded(
        to_jax(arrays), jnp.int64(now), engine="prefix", **KW, **jk,
        base_s=0.01, sleep=sleeps["jax"].append,
        on_retry=lambda i, e: seen["jax"].append((i, type(e).__name__)))
    got = TG.run_epoch_guarded(
        to_torch(arrays), now, engine="prefix", **KW, **tk, base_s=0.01,
        sleep=sleeps["port"].append,
        on_retry=lambda i, e: seen["port"].append((i, type(e).__name__)))
    assert got.retries == 2 and sleeps["port"] == sleeps["jax"] == \
        [0.01, 0.02]
    assert seen["port"] == seen["jax"]
    assert_guarded_equal(got, want, "prefix", True)


def test_exhaustion_and_caller_errors(monkeypatch):
    """Retries exhausted: the last OSError re-raises.  A RuntimeError (a
    caller bug, or a CUDA error) is never retried."""
    orig = tfp.epoch_scan_fn
    calls = []

    def failing(exc):
        def fn(*a, **kw):
            calls.append(exc)
            raise exc("boom")
        return lambda eng: fn

    arrays, now = STATES["random"]
    monkeypatch.setattr(tfp, "epoch_scan_fn", failing(OSError))
    with pytest.raises(OSError):
        TG.run_epoch_guarded(to_torch(arrays), now, retries=2,
                             sleep=lambda s: None, **KW)
    assert len(calls) == 3
    calls.clear()
    monkeypatch.setattr(tfp, "epoch_scan_fn", failing(RuntimeError))
    with pytest.raises(RuntimeError):
        TG.run_epoch_guarded(to_torch(arrays), now, sleep=lambda s: None,
                             **KW)
    assert len(calls) == 1
    monkeypatch.setattr(tfp, "epoch_scan_fn", orig)
    with pytest.raises(ValueError, match="unknown epoch engine"):
        TG.run_epoch_guarded(to_torch(arrays), now, engine="nope", **KW)
    assert TG.RECOVERABLE_ERRORS == (OSError, TimeoutError)


@pytest.mark.parametrize("engine", ["prefix", "chain"])
def test_skew_ns_like_jax(engine):
    """The fault-injection hook: the epoch sees now + skew."""
    arrays, now = STATES["random"]
    got, want = run_both(arrays, now, tele=False, engine=engine,
                         skew_ns=-3 * 10 ** 8, **KW)
    assert_guarded_equal(got, want, engine, False)
    plain, _ = run_both(arrays, now - 3 * 10 ** 8, tele=False,
                        engine=engine, **KW)
    assert plain.count == got.count


def test_spans_like_jax(monkeypatch):
    """One injected clock: the same span names, categories, args and
    order through a retry and a tag32 resume; decisions as untraced."""
    orig_j, orig_t = JG._jit_epoch, tfp.epoch_scan_fn
    fails = {"jax": 1, "port": 1}

    def flaky(side, fn):
        def call(*a, **kw):
            if fails[side]:
                fails[side] -= 1
                raise TimeoutError("late")
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(JG, "_jit_epoch",
                        lambda *a: flaky("jax", orig_j(*a)))
    monkeypatch.setattr(tfp, "epoch_scan_fn",
                        lambda eng: flaky("port", orig_t(eng)))
    arrays, now = STATES["trip"]
    rows = []
    for S, run, st, t in ((JS, JG.run_epoch_guarded, to_jax(arrays),
                           jnp.int64(now)),
                          (TS, TG.run_epoch_guarded, to_torch(arrays), now)):
        clock = iter(range(0, 10 ** 9, 10))
        tr = S.SpanTracer(clock_ns=lambda: next(clock))
        ge = run(st, t, tag_width=32, tracer=tr, sleep=lambda s: None,
                 **{**KW, "k": 16})
        rows.append(([(r["name"], r["cat"], r["depth"], r["args"], r["dur"])
                      for r in tr.rows()], ge.count))
    assert rows[0] == rows[1]
    names = [r[0] for r in rows[1][0]]
    assert names.count("guarded.retry") == 1
    assert "guarded.rebase_resume" in names
    plain = TG.run_epoch_guarded(to_torch(arrays), now, tag_width=32,
                                 **{**KW, "k": 16})
    assert plain.count == rows[1][1]
