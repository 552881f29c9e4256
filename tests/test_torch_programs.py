"""The port's captured programs (``obs/compile_plane.py``
``InstrumentedJit``, ``engine/stream.py`` ``jit_stream_chunk`` and
``jit_ingest_step``) against the JAX package's jit caches on the CPU.

On CPU tensors a program is its body run eagerly, with the signature
bookkeeping and the records of the card's captures, so what is held
here is what the card must also keep: the chunk and the ingest step
equal JAX's exactly, donated and not, chained call after call; one call
sequence gives both compile planes the same entries, compiles and
retraces (a Python int is an input, a new N a retrace whose diff names
the leaf); the watchdog's retrace-storm warning equals JAX's on one
event feed; and the donated write-back pairs each carried output with
its own input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from dmclock_tpu.engine import stream as jstream
from dmclock_tpu.obs import compile_plane as jcp
from dmclock_tpu.obs import histograms as jhist
from dmclock_tpu.obs import provenance as jprov
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu.obs import spans as jspans
from dmclock_tpu.obs.watchdog import Watchdog as JWatchdog
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import stream as tstream
from dmclock_tpu_torch.obs import compile_plane as tcp
from dmclock_tpu_torch.obs import histograms as thist
from dmclock_tpu_torch.obs import provenance as tprov
from dmclock_tpu_torch.obs import slo as tslo
from dmclock_tpu_torch.obs import spans as tspans
from dmclock_tpu_torch.obs.watchdog import Watchdog as TWatchdog

from test_torch_support import assert_np_equal, assert_state_matches, to_jax

N, RING, DEPTH0, WAVES, DT = 40, 10, 5, 2, 20_000_000
EPOCHS = 2

ENGINES = {
    "prefix": dict(engine="prefix", m=2, k=16),
    "chain": dict(engine="chain", m=2, k=8, chain_depth=3),
    "calendar": dict(engine="calendar", m=2, k=4),
}


def _setup(n: int):
    rates = np.full(n, 100.0)
    rates[::4] = 0.0
    weights = np.asarray([1.0 + (i % 4) for i in range(n)])
    st = tserve._sustained_setup(n, RING, DEPTH0, rates, weights,
                                 device="cpu")
    rng = np.random.default_rng(9)
    counts = np.minimum(rng.poisson(1.2, (3 * EPOCHS, n)), WAVES) \
        .astype(np.int32)
    return bridge.state_to_numpy(st), counts


ARRAYS, COUNTS = _setup(N)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


def _tele(n: int):
    """(hists, ledger, slo, prov) of both packages, zeroed."""
    return ((thist.hist_zero("cpu"), thist.ledger_zero(n, "cpu"),
             tslo.window_zero(n, "cpu"), tprov.prov_init(n, 0, "cpu")),
            (jhist.hist_zero(), jhist.ledger_zero(n), jslo.window_zero(n),
             jprov.prov_init(n, 0)))


def _cfg(engine: str, epochs: int = EPOCHS) -> dict:
    return dict(ENGINES[engine], epochs=epochs, dt_epoch_ns=DT,
                waves=WAVES, with_metrics=True)


def _assert_chunk(got, want):
    assert_state_matches(got.state, want.state)
    assert sorted(got.outs) == sorted(want.outs)
    for f in got.outs:
        assert_np_equal(f, _np(got.outs[f]), _np(want.outs[f]))
    for name in ("hists", "ledger", "slo"):
        assert_np_equal(name, _np(getattr(got, name)),
                        _np(getattr(want, name)))
    for f, a, b in zip(got.prov._fields, got.prov, want.prov):
        assert_np_equal(f"prov.{f}", _np(a), _np(b))


@pytest.fixture
def fresh_caches(monkeypatch):
    """Empty module caches and planes in both packages (records and
    programs of other tests kept out), the planes on."""
    for mod in (jstream, tstream):
        monkeypatch.setattr(mod, "_STREAM_JIT_CACHE", {})
        monkeypatch.setattr(mod, "_INGEST_STEP_CACHE", {})
    planes = (jcp.CompilePlane(), tcp.CompilePlane())
    monkeypatch.setattr(jcp, "_PLANE", planes[0])
    monkeypatch.setattr(tcp, "_PLANE", planes[1])
    return planes


@pytest.mark.parametrize("donate", [False, True], ids=["kept", "donated"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_jit_stream_chunk_matches_jax(engine, donate):
    """Three chained chunks (epoch0 = 1, 3, 5) with ingest and four
    accumulators: every chunk's state, stacked outputs and accumulators
    equal the JAX chunk's, field by field; a kept (not donated) chunk
    leaves its inputs as they were."""
    cfg = _cfg(engine)
    jfn = jstream.jit_stream_chunk(donate=donate, wheel_kernel="xla", **cfg)
    tfn = tstream.jit_stream_chunk(donate=donate, wheel_kernel="xla", **cfg)
    assert tfn.donate_argnums == ((0, 3, 4, 5, 6, 7) if donate else ())
    (th, tl, ts, tp), (jh, jl, js, jp) = _tele(N)
    tst, jst = bridge.state_from_numpy(ARRAYS, "cpu"), to_jax(ARRAYS)
    keep = bridge.state_to_numpy(tst)
    for c in range(3):
        e0 = 1 + c * EPOCHS
        counts = COUNTS[c * EPOCHS:(c + 1) * EPOCHS]
        want = jfn(jst, e0, jnp.asarray(counts), jh, jl, None, js, jp)
        got = tfn(tst, e0, torch.from_numpy(counts), th, tl, None, ts, tp)
        _assert_chunk(got, want)
        if not donate and c == 0:
            for f, a in bridge.state_to_numpy(tst).items():
                assert np.array_equal(a, keep[f]), f
        tst, th, tl, ts, tp = got.state, got.hists, got.ledger, got.slo, \
            got.prov
        jst, jh, jl, js, jp = want.state, want.hists, want.ledger, \
            want.slo, want.prov
    assert int(got.outs["count"].sum()) > 0
    assert tfn.fn is not None and callable(tfn.fn)


def test_jit_ingest_step_matches_jax():
    jfn = jstream.jit_ingest_step(dt_epoch_ns=DT, waves=WAVES)
    tfn = tstream.jit_ingest_step(dt_epoch_ns=DT, waves=WAVES)
    assert tstream.jit_ingest_step(dt_epoch_ns=DT, waves=WAVES) is tfn
    jst, tst = to_jax(ARRAYS), bridge.state_from_numpy(ARRAYS, "cpu")
    for i in range(3):
        counts = COUNTS[i] * 3
        jst = jfn(jst, jnp.asarray(counts), i * DT)
        tst = tfn(tst, torch.from_numpy(counts), i * DT)
        assert_state_matches(tst, jst)
    # the program is the chunk's ingest leg standing alone
    one = tstream.ingest_step(bridge.state_from_numpy(ARRAYS, "cpu"),
                              torch.from_numpy(COUNTS[0] * 3), 0,
                              dt_epoch_ns=DT, waves=WAVES)
    again = tfn(bridge.state_from_numpy(ARRAYS, "cpu"),
                torch.from_numpy(COUNTS[0] * 3), 0)
    for f, a, b in zip(one._fields, one, again):
        assert torch.equal(a, b), f


def _entries(pl, caches=("stream.chunk", "stream.ingest")):
    return sorted((e["cache"], e["entry"], e["compiles"], e["retraces"])
                  for e in pl.entries() if e["cache"] in caches)


def test_plane_entries_match_jax(fresh_caches):
    """One call sequence in both packages: two chunk lengths, three
    values of ``epoch0`` (a Python int is an input: no retrace), one
    change of N (a retrace, its diff naming the changed leaves), and the
    ingest step at both N.  Entries, compiles, retraces and the diffs'
    leaf paths are equal."""
    jpl, tpl = fresh_caches
    n2 = N + 8
    arrays2, counts2 = _setup(n2)
    for pkg in ("jax", "torch"):
        stream = jstream if pkg == "jax" else tstream
        for epochs in (EPOCHS, EPOCHS + 1):
            fn = stream.jit_stream_chunk(**_cfg("prefix", epochs))
            for e0 in (0, 5, 9):
                if pkg == "jax":
                    fn(to_jax(ARRAYS), e0, jnp.asarray(COUNTS[:epochs]))
                else:
                    fn(bridge.state_from_numpy(ARRAYS, "cpu"), e0,
                       torch.from_numpy(COUNTS[:epochs]))
        fn = stream.jit_stream_chunk(**_cfg("prefix"))
        ing = stream.jit_ingest_step(dt_epoch_ns=DT, waves=WAVES)
        for arrays, counts in ((ARRAYS, COUNTS), (arrays2, counts2)):
            if pkg == "jax":
                fn(to_jax(arrays), 2, jnp.asarray(counts[:EPOCHS]))
                ing(to_jax(arrays), jnp.asarray(counts[0]), 7)
            else:
                st = bridge.state_from_numpy(arrays, "cpu")
                fn(st, 2, torch.from_numpy(counts[:EPOCHS]))
                ing(st, torch.from_numpy(counts[0]), 7)
    got, want = _entries(tpl), _entries(jpl)
    assert got == want
    assert sorted((c, n, r) for c, _, n, r in got) == [
        ("stream.chunk", 1, 0), ("stream.chunk", 2, 1),
        ("stream.ingest", 2, 1)]
    assert tpl.totals()["retraces"] == jpl.totals()["retraces"] == 2
    assert len(tpl.retrace_events()) == len(jpl.retrace_events()) == 2

    def diff_paths(pl):
        return {e["cache"]: [d.split(":")[0] for d in e["last_retrace_diff"]]
                for e in pl.entries() if e["retraces"]}

    paths = diff_paths(tpl)
    assert paths == diff_paths(jpl)
    assert paths["stream.chunk"][0] == paths["stream.ingest"][0] == \
        "[0][0].active"
    # every record of a CPU program: no capture, no pool
    for e in tpl.entries():
        assert e["compile_ms"] == 0.0 and e["memory_analysis"] == {}
        assert e["dispatch_fallbacks"] == 0
    assert tpl.totals()["dispatch_fallbacks"] == 0


def test_record_compile_equals_jax():
    """The same capture records folded into both planes: equal entries
    (less the port's ``found``), totals, span payloads and retrace
    events."""
    clock = iter(range(10 ** 9, 2 * 10 ** 9, 10 ** 6)).__next__
    jpl, tpl = jcp.CompilePlane(clock_ns=clock), \
        tcp.CompilePlane(clock_ns=clock)
    specs = ({"[0][0]": ("arr", (4,), "int64", False)},
             {"[0][0]": ("arr", (8,), "int64", False)})
    recs = []
    for pl in (jpl, tpl):
        out = []
        for i, (entry, spec) in enumerate((("a", specs[0]), ("b", specs[0]),
                                           ("a", specs[1]))):
            out.append(pl.record_compile(
                "bench.round", entry, lower_ns=1000 * (i + 1),
                compile_ns=2000 * (i + 1), cost={},
                hbm={"total_bytes": 64 * (i + 1)}, path_specs=spec))
        recs.append(out)
    assert recs[0] == recs[1]
    assert recs[1][2]["sig_diff"] == [
        "[0][0]: ('arr', (4,), 'int64', False) -> "
        "('arr', (8,), 'int64', False)"]
    strip = [{k: v for k, v in e.items() if k != "found"}
             for e in tpl.entries()]
    assert strip == jpl.entries()
    assert tpl.totals() == jpl.totals()
    assert [e for _, e in tpl.retrace_events()] == \
        [e for _, e in jpl.retrace_events()] == ["bench.round:a"]


class _Clock:
    def __init__(self):
        self.t = 0

    def __call__(self) -> int:
        return self.t


def test_retrace_storm_matches_jax():
    """Both watchdogs over their planes on one clock and one feed: no
    warning for first compiles or below K retraces, one warning at K
    inside the window (once an episode), re-armed once the window has
    passed."""
    clock = _Clock()
    planes = (jcp.CompilePlane(clock_ns=clock),
              tcp.CompilePlane(clock_ns=clock))
    logs = ([], [])
    wds = tuple(cls(tr, compile_plane=pl, retrace_storm_k=3,
                    retrace_window_s=10.0, log=lg.append, clock_ns=clock)
                for cls, tr, pl, lg in (
                    (JWatchdog, jspans.SpanTracer(clock_ns=clock), planes[0],
                     logs[0]),
                    (TWatchdog, tspans.SpanTracer(clock_ns=clock),
                     planes[1], logs[1])))

    def compile_at(t_s: float, entry: str):
        clock.t = int(t_s * 1e9)
        for pl in planes:
            pl.record_compile("stream.chunk", entry, lower_ns=1,
                              compile_ns=1, cost={}, hbm={})

    def poll(t_s: float):
        clock.t = int(t_s * 1e9)
        got = [wd.poll_once() for wd in wds]
        assert got[0] == got[1]
        return got[1]

    for e in ("a", "b", "c"):
        compile_at(0.5, e)                 # first compiles: no retrace
    assert poll(1.0) == []
    compile_at(2.0, "a")
    compile_at(3.0, "a")
    assert poll(3.5) == []                 # 2 retraces < K
    compile_at(4.0, "a")
    (w,) = poll(4.5)
    assert (w["kind"], w["entry"], w["retraces"], w["window_s"]) == \
        ("retrace_storm", "stream.chunk:a", 3, 10.0)
    compile_at(5.0, "a")
    assert poll(5.5) == []                 # once an episode
    assert poll(30.0) == []                # the window passed: re-armed
    for t in (31.0, 32.0, 33.0):
        compile_at(t, "b")
    assert [w["entry"] for w in poll(33.5)] == ["stream.chunk:b"]
    assert logs[0] == logs[1] and len(logs[1]) == 2
    assert [w["kind"] for w in wds[1].warnings] == ["retrace_storm"] * 2


def test_program_on_the_cpu_is_its_eager_body(fresh_caches):
    """A CPU program runs its body eagerly on every call: Python scalars
    arrive as 0-d tensors, outputs are fresh, ``fn`` is the body, a new
    signature is a retrace and ``clear_compiled`` makes the next call a
    retrace too (the JAX wrapper's contract)."""
    _, tpl = fresh_caches
    seen = []

    def body(x, t, scale):
        seen.append((type(t), t.dtype, type(scale)))
        return x * scale + t, x.sum()

    prog = tcp.instrumented_jit(body, cache="test", entry=("k", 1))
    x = torch.arange(4, dtype=torch.int64)
    for t in (3, 7, 11):
        out, s = prog(x, t, 2)
        assert torch.equal(out, x * 2 + t) and int(s) == 6
    assert seen[0] == (torch.Tensor, torch.int64, torch.Tensor)
    assert prog.fn is body
    (e,) = tpl.entries()
    assert (e["cache"], e["entry"], e["compiles"], e["retraces"]) == \
        ("test", "('k', 1)", 1, 0)
    prog(torch.arange(5, dtype=torch.int64), 3, 2)
    (e,) = tpl.entries()
    assert e["last_retrace_diff"] == [
        "[0][0]: ('arr', (4,), 'int64', 'cpu', (1,)) -> "
        "('arr', (5,), 'int64', 'cpu', (1,))"]
    prog(x, 3, 2.5)                       # a float is another type
    tcp.clear_compiled()
    prog(x, 3, 2.5)
    (e,) = tpl.entries()
    assert (e["compiles"], e["retraces"]) == (4, 3)
    assert e["last_retrace_diff"] == []   # same signature, after a clear
    assert [d.split(":")[0] for d in tpl._entries[
        ("test", "('k', 1)")].path_specs] == ["[0][0]", "[0][1]", "[0][2]"]
    # aot_record: one capture now, the call's result dropped
    prog2 = tcp.aot_record("bench.serve", ("e",), body, x, 0, 1,
                           donate_argnums=(0,))
    assert prog2.donate_argnums == (0,)
    assert torch.equal(prog2(x, 1, 1)[0], x + 1)
    assert [(e["cache"], e["compiles"]) for e in tpl.entries()
            if e["cache"] == "bench.serve"] == [("bench.serve", 1)]


def test_donated_write_back_pairs_each_output_with_its_input():
    """The card's write-back, run on CPU tensors: the carried outputs are
    copied into their donated static inputs, paired by field name where
    shapes collide, and returned as those buffers; a chained call passes
    them back and its copy-in is skipped; an output that is its input
    unchanged is not copied."""
    from collections import namedtuple

    Carry = namedtuple("Carry", "a b")
    Out = namedtuple("Out", "b a same extra")

    def body(carry, other, inc):
        return Out(b=carry.b + inc, a=carry.a * 2, same=other,
                   extra=carry.a - carry.b)

    prog = tcp.InstrumentedJit(body, cache="t", entry="w",
                               donate_argnums=(0,))
    carry = Carry(torch.arange(3), torch.arange(3) + 10)
    other = torch.ones(3, dtype=torch.int64)
    args = (carry, other, torch.tensor(5))
    leaves, spec = pytree.tree_flatten((args, {}))
    paths = pytree.tree_flatten_with_path((args, {}))[0]
    g = tcp._Graph(body, "program t w", leaves, spec, torch.device("cpu"),
                   prog._donated_leaves(args),
                   [tcp._path_name(p, prog._argnames) for p, _ in paths])
    out = pytree.tree_unflatten(g.body(), g.out_spec)
    # paired by name although a and b have one shape and dtype
    assert sorted(g.alias) == [(0, 1), (1, 0)]
    assert out.a is g.static[0] and out.b is g.static[1]
    assert torch.equal(out.a, torch.arange(3) * 2)
    assert torch.equal(out.b, torch.arange(3) + 15)
    assert torch.equal(out.extra, torch.arange(3) - torch.arange(3) - 10)
    # the caller's carry was copied in, not written
    assert torch.equal(carry.a, torch.arange(3))
    # a second body run chains from the buffers it wrote
    out2 = pytree.tree_unflatten(g.body(), g.out_spec)
    assert torch.equal(out2.a, torch.arange(3) * 4)
    assert torch.equal(out2.b, torch.arange(3) + 20)
    # the kept output that is a static input is handed back as a clone
    own = g._own(g.body())
    assert own[2] is not g.static[2] and torch.equal(own[2], other)
