"""The port's span tracer (``dmclock_tpu_torch/obs/spans.py``) against
the JAX package's (``dmclock_tpu/obs/spans.py``): the same calls with
one injected clock give equal rows, aggregates, summary and JSONL.

Each scenario takes a spans module and a scratch directory and returns
everything observable; the two packages' results must be equal.  Thread
idents are equal because both run on the test's thread (the threaded
scenario compares counts only).
"""

import threading

import pytest

from dmclock_tpu.obs import spans as JS
from dmclock_tpu_torch.obs import spans as TS


def make_clock(step=0):
    """A deterministic ns clock: each read returns the current time,
    then advances it by ``step``; ``advance(ns)`` moves it by hand."""
    st = {"t": 1000}

    def clock():
        t = st["t"]
        st["t"] += step
        return t

    def advance(ns):
        st["t"] += ns

    return clock, advance


def observe(tr) -> dict:
    return dict(rows=tr.rows(), summary=tr.summary(),
                cats=tr.category_totals(), counts=tr.category_counts(),
                names=tr.name_stats(), recorded=tr.spans_recorded,
                dropped=tr.spans_dropped, leaked=tr.spans_leaked)


def sc_nesting(S, tmp):
    clock, adv = make_clock()
    tr = S.SpanTracer(clock_ns=clock)
    with tr.span("outer", "host_prep", k=1):
        adv(10)
        with tr.span("inner", "dispatch"):
            adv(30)
            with tr.span("leaf", "device_compute", m=4):
                adv(3)
        adv(5)
        with tr.span("inner", "dispatch"):
            adv(2)
    return observe(tr)


def sc_instants_and_guards(S, tmp):
    clock, adv = make_clock(7)
    tr = S.SpanTracer(clock_ns=clock)
    S.instant(tr, "mark", "retry", error="Boom")
    with S.span(tr, "a", "fetch"):
        S.instant(tr, "inside", "retry")
    with S.span(None, "x", "dispatch"):
        pass
    S.instant(None, "x", "retry")
    return observe(tr)


def sc_ring_bound(S, tmp):
    clock, adv = make_clock()
    tr = S.SpanTracer(limit=4, clock_ns=clock)
    for i in range(10):
        with tr.span(f"s{i % 3}", "drain"):
            adv(7 + i)
    return observe(tr)


def sc_leaked_and_double_exit(S, tmp):
    clock, adv = make_clock()
    tr = S.SpanTracer(clock_ns=clock)
    outer = tr.span("outer", "host_prep")
    inner = tr.span("inner", "dispatch")
    outer.__enter__()
    inner.__enter__()
    adv(10)
    outer.__exit__(None, None, None)
    inner.__exit__(None, None, None)
    sp = tr.span("s", "drain")
    sp.__enter__()
    adv(5)
    sp.__exit__(None, None, None)
    sp.__exit__(None, None, None)
    with tr.span("next", "fetch"):
        adv(1)
    return observe(tr)


def sc_jsonl(S, tmp):
    clock, adv = make_clock(3)
    tr = S.SpanTracer(clock_ns=clock)
    path = str(tmp / f"{S.__name__}.drain.jsonl")
    with tr.span("a", "checkpoint", epoch=1):
        adv(5)
    n1 = tr.drain_jsonl(path)
    n0 = tr.drain_jsonl(path)          # nothing new: 0, file untouched
    with tr.span("b", "checkpoint"):
        adv(5)
    n2 = tr.drain_jsonl(path)
    with tr.span("c", "ingest"):
        adv(2)
    full = str(tmp / f"{S.__name__}.export.jsonl")
    n3 = tr.export_jsonl(full)
    with open(path) as f1, open(full) as f2:
        text = (f1.read(), f2.read())
    return dict(n=(n1, n0, n2, n3), text=text,
                loaded=(S.load_jsonl(path), S.load_jsonl(full)),
                obs=observe(tr))


def sc_open_spans(S, tmp):
    clock, adv = make_clock()
    tr = S.SpanTracer(clock_ns=clock)
    before = (tr.open_categories(), tr.oldest_open_ns(),
              tr.last_end_ns("dispatch"))
    with tr.span("launch", "dispatch"):
        adv(4)
        with tr.span("wait", "device_compute"):
            adv(6)
            during = (tr.open_categories(), tr.oldest_open_ns(),
                      tr.oldest_open_ns(("device_compute",)))
    after = (tr.open_categories(), tr.oldest_open_ns(),
             tr.last_end_ns("dispatch"), tr.last_end_ns("device_compute"))
    return dict(before=before, during=during, after=after,
                obs=observe(tr))


def sc_drain_keeps_aggregates(S, tmp):
    clock, adv = make_clock(1)
    tr = S.SpanTracer(clock_ns=clock)
    for name in ("x", "y", "x"):
        with tr.span(name, "dispatch"):
            adv(9)
    rows = tr.drain()
    return dict(rows=rows, obs=observe(tr))


SCENARIOS = [sc_nesting, sc_instants_and_guards, sc_ring_bound,
             sc_leaked_and_double_exit, sc_jsonl, sc_open_spans,
             sc_drain_keeps_aggregates]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_tracer_equals_jax(scenario, tmp_path):
    want = scenario(JS, tmp_path)
    got = scenario(TS, tmp_path)
    assert got == want


def test_taxonomy_and_schema_equal_jax():
    assert TS.CATEGORIES == JS.CATEGORIES
    assert TS.ROW_FIELDS == JS.ROW_FIELDS
    for S in (JS, TS):
        tr = S.SpanTracer()
        with pytest.raises(ValueError, match="taxonomy"):
            tr.span("x", "not-a-category")
        with pytest.raises(ValueError, match="taxonomy"):
            tr.instant("x", "also-wrong")


def test_load_jsonl_rejects_bad_rows_like_jax(tmp_path):
    bad = tmp_path / "bad.jsonl"
    for text in ("{not json}\n", '{"ts": 1}\n', "[1, 2]\n"):
        bad.write_text(text)
        msgs = []
        for S in (JS, TS):
            with pytest.raises(ValueError) as e:
                S.load_jsonl(str(bad))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_threads_keep_their_own_stacks():
    tr = TS.SpanTracer()

    def worker():
        for _ in range(100):
            with tr.span("w", "fetch"):
                with tr.span("w2", "drain"):
                    pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.spans_recorded == 800
    assert tr.category_counts()["fetch"] == 400
    assert all(r["depth"] == (1 if r["name"] == "w2" else 0)
               for r in tr.rows())
    # the workers are gone: nothing reads as open
    assert tr.open_categories() == {}
