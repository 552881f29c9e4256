"""The guarded-run programs of the port (``robust/guarded.py``
``_jit_epoch``, ``_jit_serial`` and ``_pressure_probe``,
``engine/fastpath.py`` ``_runner_jit``, ``robust/supervisor.py``
``_jit_ingest``, ``parallel/mesh.py`` ``jit_mesh_chunk``) against the JAX
package's jit caches on the CPU.

On CPU tensors a program is its body run eagerly with the card's
signatures and records, so what is held here is what the card must keep:
every decision, state field, accumulator, metric row and digest equals
the JAX package's exactly, through the programs; the serial resume's
blocks give ``engine_run``'s stream for a block smaller than, equal to,
larger than and not dividing the steps; and one call sequence gives
both compile planes the same entries, compiles, retraces and retrace
diff paths for the five caches.  The one mapping: the JAX key of a
calendar epoch and of a guarded mesh chunk carries ``('wheel_kernel',
'xla')``, a knob the port has not got, so that item is removed from the
JAX key before the comparison.  Last, the two repairs of the compile
plane: a numpy leaf raises ``TypeError`` naming its path, and a
``parallel.groups.Grouped`` argument is flattened into its tensors."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmclock_tpu.engine.fastpath as jfp
import dmclock_tpu.robust.guarded as JG
import dmclock_tpu_torch.engine.fastpath as tfp
import dmclock_tpu_torch.engine.kernels as tk
import dmclock_tpu_torch.robust.guarded as TG
from dmclock_tpu.engine import stream as jstream
from dmclock_tpu.obs import compile_plane as jcp
from dmclock_tpu.parallel import mesh as JM
from dmclock_tpu.robust import faults as JF
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.engine import stream as tstream
from dmclock_tpu_torch.obs import compile_plane as tcp
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.parallel import groups
from dmclock_tpu_torch.parallel import mesh as TM
from dmclock_tpu_torch.robust import supervisor as TS
from dmclock_tpu_torch.robust.digest import digest_update

from test_torch_guarded import KW, _tripping, assert_guarded_equal, run_both
from test_torch_support import assert_np_equal, to_jax, to_torch
from test_torch_telemetry import STATES, _kits

ENGINES = {
    "prefix": dict(engine="prefix"),
    "chain": dict(engine="chain", chain_depth=3),
    "calendar-minstop": dict(engine="calendar", calendar_impl="minstop"),
    "calendar-wheel": dict(engine="calendar", calendar_impl="wheel",
                           ladder_levels=2),
}
CACHES = ("guarded.epoch", "guarded.serial", "fastpath.runner",
          "supervisor.ingest", "mesh.chunk")


def _np(x):
    if groups.is_grouped(x):
        x = groups.gather(x, "cpu")
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


def _without_wheel_kernel(key):
    """A JAX cache key with its ``('wheel_kernel', ...)`` items removed:
    the one item the port's keys lack."""
    if isinstance(key, tuple):
        return tuple(_without_wheel_kernel(k) for k in key
                     if not (isinstance(k, tuple) and len(k) == 2
                             and k[0] == "wheel_kernel"))
    return key


@pytest.fixture
def fresh(monkeypatch):
    """Empty module caches and compile planes in both packages."""
    for mod, names in ((JG, ("_EPOCH_JIT_CACHE",)),
                       (TG, ("_EPOCH_JIT_CACHE",)),
                       (jfp, ("_RUNNER_JIT_CACHE",)),
                       (tfp, ("_RUNNER_JIT_CACHE",)),
                       (JS, ("_INGEST_JIT_CACHE",)),
                       (TS, ("_INGEST_JIT_CACHE",)),
                       (JM, ("_MESH_CHUNK_JIT_CACHE",)),
                       (TM, ("_MESH_CHUNK_JIT_CACHE",)),
                       (jstream, ("_INGEST_STEP_CACHE",)),
                       (tstream, ("_INGEST_STEP_CACHE",))):
        for name in names:
            monkeypatch.setattr(mod, name, {})
    monkeypatch.setattr(JG, "_PRESSURE_PROBE_JIT", [])
    monkeypatch.setattr(TG, "_PRESSURE_PROBE_JIT", [])
    planes = (jcp.CompilePlane(), tcp.CompilePlane())
    monkeypatch.setattr(jcp, "_PLANE", planes[0])
    monkeypatch.setattr(tcp, "_PLANE", planes[1])
    return planes


def _port_entry(pl, cache: str, key) -> dict:
    (e,) = [e for e in pl.entries() if e["cache"] == cache and
            e["entry"] == tcp._entry_str(key)]
    return e


# ----------------------------------------------------------------------
# the guarded epoch and its resumes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tele", [False, True], ids=["plain", "tele"])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_guarded_epoch_program_equals_jax(fresh, name, tele):
    """``run_epoch_guarded`` through its ``guarded.epoch`` program: the
    epoch's results, state and accumulators equal JAX's; the program is
    the module cache's entry under the JAX key, recorded once."""
    arrays, now = STATES["random"]
    got, want = run_both(arrays, now, tele=tele, **ENGINES[name], **KW)
    assert_guarded_equal(got, want, ENGINES[name]["engine"], tele)
    assert got.count > 0
    (key,) = TG._EPOCH_JIT_CACHE
    (jkey,) = JG._EPOCH_JIT_CACHE
    assert key == _without_wheel_kernel(jkey)
    assert isinstance(TG._EPOCH_JIT_CACHE[key], tcp.InstrumentedJit)
    assert key[3] == (tuple(sorted(
        ("hists", "ledger", "flight", "slo", "prov"))) if tele else ())
    e = _port_entry(fresh[1], "guarded.epoch", key)
    assert (e["compiles"], e["retraces"]) == (1, 0)


@pytest.mark.parametrize("engine, k", [("prefix", 16), ("calendar", 8)])
def test_tag32_trip_resumes_through_a_new_entry(fresh, engine, k):
    """A tag32 trip and its int64 resume: the resume's ``m`` is a new
    entry of the cache, as in JAX, and the results equal JAX's."""
    arrays, now = STATES["trip"]
    got, want = run_both(arrays, now, tele=True, engine=engine,
                         tag_width=32, **{**KW, "k": k})
    assert got.rebase_fallbacks == 1 and len(got.results) == 2
    assert_guarded_equal(got, want, engine, True)
    keys = sorted(TG._EPOCH_JIT_CACHE, key=repr)
    assert keys == sorted(map(_without_wheel_kernel, JG._EPOCH_JIT_CACHE),
                          key=repr)
    assert {key[1] for key in keys} == {
        KW["m"], int(got.results[1].count.shape[0])}


_SERIAL_WANT = {}


def _force_serial_trip(monkeypatch, engine: str):
    """The last batch of each package's first attempt reports a trip
    (``test_torch_guarded``'s forcing): the rest runs serially."""
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


@pytest.mark.parametrize("block", [3, 4, 8, 16])
@pytest.mark.parametrize("engine", ["prefix", "calendar"])
def test_serial_resume_blocks_equal_jax(monkeypatch, engine, block):
    """A forced order/cost-guard trip resumes on ``guarded.serial``:
    ``max(remaining, 1) * max(k, 1)`` = 8 steps, replayed as blocks of
    3 (two and a remainder of 2), 4 (two), 8 (one) and 16 (one of 8:
    fewer steps than a block); the decisions and the state equal JAX's
    ``lax.scan`` of the step for each."""
    monkeypatch.setattr(TG, "_EPOCH_JIT_CACHE", {})
    monkeypatch.setattr(tk, "SERIAL_BLOCK", block)
    _force_serial_trip(monkeypatch, engine)
    arrays, now = STATES["random"]
    key = engine
    if key not in _SERIAL_WANT:
        _SERIAL_WANT[key] = run_both(arrays, now, tele=True, engine=engine,
                                     **KW)[1]
    tkit, _ = _kits(arrays["depth"].shape[0])
    got = TG.run_epoch_guarded(to_torch(arrays), now, engine=engine, **KW,
                               **tkit)
    want = _SERIAL_WANT[key]
    assert got.serial_fallbacks == 1 and len(got.results) == 2
    assert got.results[1].type.shape == (KW["k"],)
    assert_guarded_equal(got, want, engine, True)
    prog = TG._EPOCH_JIT_CACHE[("serial", KW["k"], False, 0)]
    assert isinstance(prog, tcp.SerialJit)
    steps, b = KW["k"], min(block, KW["k"])
    assert [(n_, p.fn.keywords["steps"]) for n_, p in prog._parts] == \
        [(n_, s) for n_, s in ((steps // b, b), (1, steps % b))
         if n_ and s]


@pytest.mark.parametrize("block", [3, 5, 7])
def test_serial_program_equals_engine_run(monkeypatch, block):
    """The program itself on a chain of calls: 7 steps as blocks of 3
    (2 + 1), 5 (1 + 2) and 7; state, ``t`` and decisions equal one
    ``engine_run`` of 7 steps, and a chained call continues it."""
    monkeypatch.setattr(tk, "SERIAL_BLOCK", block)
    arrays, now = STATES["random"]
    prog = tk.serial_program(7, allow_limit_break=False, anticipation_ns=0,
                             cache="t", entry=("serial", 7))
    st = to_torch(arrays)
    for _ in range(2):
        want = tk.engine_run(st, now, 7, allow_limit_break=False,
                             anticipation_ns=0, advance_now=False)
        got = prog(st, now)
        for f in want[0]._fields:
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
        assert int(got[1]) == now
        for f in want[2]._fields:
            assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
        st = got[0]
    assert int((got[2].type == tk.RETURNING).sum()) > 0


# ----------------------------------------------------------------------
# the prefix runner
# ----------------------------------------------------------------------

def test_prefix_runner_programs_equal_jax(fresh):
    """``make_prefix_runner`` through its "attempt" program, then through
    "exact" once a creation-order spread past 2^28 trips the guards: the
    same states, decisions and counts as JAX; the two entries under the
    JAX keys."""
    arrays, now = STATES["random"]
    jst, tst = to_jax(arrays), to_torch(arrays)
    k = 8
    for spread in (False, True):
        if spread:       # client 1 is active and queued
            jst = jst._replace(order=jst.order.at[1].set(jnp.int64(1) << 29))
            tst = tst._replace(order=tst.order.clone())
            tst.order[1] = 1 << 29
        jst, jdec, jn = jfp.make_prefix_runner(k)(jst, jnp.int64(now))
        tst, tdec, tn = tfp.make_prefix_runner(k)(tst, now)
        assert tn == jn > 0
        for f in tdec._fields:
            assert_np_equal(f, _np(getattr(tdec, f)), _np(getattr(jdec, f)))
        for f in tst._fields:
            assert_np_equal(f, _np(getattr(tst, f)), _np(getattr(jst, f)))
    assert sorted(tfp._RUNNER_JIT_CACHE, key=repr) == \
        sorted(jfp._RUNNER_JIT_CACHE, key=repr)
    assert isinstance(tfp._RUNNER_JIT_CACHE[("exact", k, 0, False)],
                      tcp.SerialJit)
    for key in tfp._RUNNER_JIT_CACHE:
        e = _port_entry(fresh[1], "fastpath.runner", key)
        assert (e["compiles"], e["retraces"]) == (1, 0)


# ----------------------------------------------------------------------
# the supervisor's round loop
# ----------------------------------------------------------------------

def test_supervisor_round_job_through_its_ingest_program(fresh):
    """A round-loop job with arrivals: every epoch's ingest is the
    ``supervisor.ingest`` program, every epoch ``guarded.epoch``; the
    result equals JAX's to its digest, and the two ingest entries have
    the same records."""
    kw = dict(n=48, depth=6, ring=12, epochs=3, m=2, k=16, seed=9,
              arrival_lam=1.5, waves=3, ckpt_every=2, engine="prefix",
              engine_loop="round", with_hists=True, with_slo=True)
    want = JS.run_job(JS.EpochJob(**kw))
    got = TS.run_job(TS.EpochJob(**kw), device="cpu")
    assert got.digest == want.digest and got.decisions == want.decisions
    assert got.decisions > 0
    assert_np_equal("metrics", np.asarray(got.metrics),
                    np.asarray(want.metrics))
    key = (48, 12, 3, TS.EpochJob(**kw).dt_epoch_ns)
    assert list(TS._INGEST_JIT_CACHE) == list(JS._INGEST_JIT_CACHE) == [key]
    jpl, tpl = fresh
    for cache in ("supervisor.ingest", "guarded.epoch"):
        assert _records(tpl, (cache,)) == _records(jpl, (cache,))


# ----------------------------------------------------------------------
# the mesh chunk
# ----------------------------------------------------------------------

MESH_JOB = dict(n=48, depth=6, ring=10, epochs=4, m=2, seed=5,
                arrival_lam=1.0, waves=2, ckpt_every=2, engine="prefix",
                k=8)
S, E = 4, 4
_MESH_WANT = {}


def _mesh_inputs(faults: bool):
    plan = JF.sample_plan(11, E, S, p_dropout=0.3, mean_outage_steps=2.0,
                          p_delay=0.2, p_dup=0.2, max_skew_ns=1000) \
        if faults else None
    rng = np.random.Generator(np.random.PCG64(9))
    counts = rng.poisson(1.0, (S, E, MESH_JOB["n"])).astype(np.int32)
    fc = None if plan is None else JF.plan_chunk(plan, 0, E)
    return counts, fc


def _mesh_kw(K: int, pressure: bool = False) -> dict:
    return dict(engine="prefix", epochs=E, m=MESH_JOB["m"],
                k=MESH_JOB["k"], dt_epoch_ns=10 ** 8,
                waves=MESH_JOB["waves"], with_metrics=True,
                counter_sync_every=K, with_pressure=pressure)


def _jax_mesh(faults: bool, K: int, replay: bool = False,
              pressure: bool = False):
    """JAX's guarded chunk (or host replay) and the mesh-chunk cache keys
    it made, each computed once in this module."""
    key = (faults, K, replay, pressure)
    if key not in _MESH_WANT:
        counts, fc = _mesh_inputs(faults)
        mesh = JM.make_mesh(S)
        state = JM.stack_shards(JS._job_state(JS.EpochJob(**MESH_JOB)), S,
                                mesh)
        ctrs = JM.counter_init(S, MESH_JOB["n"])
        run = JG.mesh_chunk_host_replay if replay else \
            lambda *a, **kw: JG.run_mesh_chunk_guarded(*a, mesh=mesh, **kw)
        held = set(JM._MESH_CHUNK_JIT_CACHE)
        out = run(state, *ctrs, 0, counts, faults=fc,
                  **_mesh_kw(K, pressure))
        _MESH_WANT[key] = out, [k[1:] for k in JM._MESH_CHUNK_JIT_CACHE
                                if k not in held]
    return _MESH_WANT[key]


def _digest(g) -> str:
    d = b"\x00" * 32
    for row in g.epochs:
        d = digest_update(d, tuple(r for grp in row for r in grp))
    return hashlib.sha256(d).hexdigest()


def _assert_mesh_equal(a, b, what: str) -> None:
    assert _digest(a) == _digest(b), f"{what}: row digest"
    assert tuple(a.counts) == tuple(b.counts), f"{what}: counts"
    met = [np.zeros(tobs.NUM_METRICS, dtype=np.int64) for _ in (a, b)]
    for i, g in enumerate((a, b)):
        for row in g.epochs:
            for grp in row:
                for r in grp:
                    met[i] = tobs.metrics_combine_np(met[i], _np(r.metrics))
    assert_np_equal(f"{what}: metrics", met[0], met[1])
    for f in ("cd", "cr", "view_d", "view_r", "slo", "slo_merged"):
        assert_np_equal(f"{what}: {f}", _np(getattr(a, f)),
                        _np(getattr(b, f)))
    sa = groups.gather(a.state, "cpu") if groups.is_grouped(a.state) \
        else a.state
    for f in sa._fields:
        assert_np_equal(f"{what}: state.{f}", _np(getattr(sa, f)),
                        _np(getattr(b.state, f)))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("faults", [False, True], ids=["clean", "chaos"])
@pytest.mark.parametrize("layout", ["stacked", "groups"])
def test_mesh_chunk_program_equals_jax(fresh, layout, faults, K):
    """``run_mesh_chunk_guarded`` through ``mesh.chunk`` on the stacked
    layout and over two groups (each a CPU group), clean and under a
    sampled fault plan, with ``counter_sync_every`` 1 and 4: the fused
    chunk equals JAX's field by field; the entry's key is JAX's less
    ``wheel_kernel``; the numpy draws and fault arrays became tensors
    before the call."""
    counts, fc = _mesh_inputs(faults)
    devs = ("cpu",) if layout == "stacked" else ("cpu", "cpu")
    mesh = TM.make_mesh(S, devices=devs)
    state = TM.stack_shards(TS._job_state(TS.EpochJob(**MESH_JOB), "cpu"),
                            S, mesh)
    ctrs = TM.counter_init(S, MESH_JOB["n"], mesh=mesh)
    got = TG.run_mesh_chunk_guarded(state, *ctrs, 0, counts, mesh=mesh,
                                    faults=fc, **_mesh_kw(K))
    assert got.mesh_fallback == 0 and sum(got.counts) > 0
    assert groups.is_grouped(got.cd) == (layout == "groups")
    want, jkeys = _jax_mesh(faults, K)
    _assert_mesh_equal(got, want, f"{layout} K={K}")
    (full_key,) = TM._MESH_CHUNK_JIT_CACHE
    assert full_key[0] == mesh
    prog = TM._MESH_CHUNK_JIT_CACHE[full_key]
    assert prog.cache == "mesh.chunk"
    assert [full_key[1:]] == [_without_wheel_kernel(k) for k in jkeys]
    if layout == "stacked":
        assert isinstance(prog, tcp.InstrumentedJit)
        sigs = list(prog._programs)
    else:
        # one leg a group, one signature each for every segment
        assert isinstance(prog, tcp.StagedJit) and len(prog.legs) == 2
        sigs = list(prog._seen)
        for leg in prog.legs:
            (leg_sig,) = leg.program._programs
            sigs.append(leg_sig)
    assert len(sigs) == (1 if layout == "stacked" else 3)
    for sig in sigs:
        assert not any(s_ == ("obj",) or (isinstance(s_, tuple) and
                                          s_[:1] == ("obj",))
                       for s_ in sig[1])


def test_host_replay_with_its_pressure_probe_equals_jax(fresh):
    """The host loop under faults with the pressure probe: its chunk
    peaks, rows and counters equal JAX's replay; the probe is a captured
    program outside the plane's records; every shard's view ``x[s]``
    shares one signature, so one program serves every shard."""
    counts, fc = _mesh_inputs(True)
    mesh = TM.make_mesh(S, "cpu")
    state = TM.stack_shards(TS._job_state(TS.EpochJob(**MESH_JOB), "cpu"),
                            S)
    ctrs = TM.counter_init(S, MESH_JOB["n"], device="cpu")
    del mesh
    got = TG.mesh_chunk_host_replay(state, *ctrs, 0, counts, faults=fc,
                                    **_mesh_kw(2, pressure=True))
    want, _ = _jax_mesh(True, 2, replay=True, pressure=True)
    assert got.mesh_fallback == 1 and got.press.any()
    assert_np_equal("press", got.press, _np(want.press))
    _assert_mesh_equal(got, want, "host replay")
    (probe,) = TG._PRESSURE_PROBE_JIT
    assert not probe.record and len(probe._programs) == 1
    tpl = fresh[1]
    assert not [e for e in tpl.entries()
                if e["cache"] == "guarded.pressure_probe"]
    (e,) = [e for e in tpl.entries() if e["cache"] == "guarded.epoch"]
    assert (e["compiles"], e["retraces"]) == (1, 0)


def test_grouped_layout_plans_one_leg_a_group_by_its_layout():
    """The choice between one graph and one graph a group is read from
    the layout's group count before any capture: one group is one
    program, two groups (on one card or on two) a staged program with
    one segment leg a group on the group's device, under the same entry
    (nothing here touches a card)."""
    cfg = _mesh_kw(1)
    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    single = TM.MeshLayout(4, c0, (c0,))
    one = TM.MeshLayout(4, c0, (c0,) * 2)
    two = TM.MeshLayout(4, c0, (c0, c1))
    assert isinstance(TM.jit_mesh_chunk(single, **cfg), tcp.InstrumentedJit)
    for mesh in (one, two):
        prog = TM.jit_mesh_chunk(mesh, **cfg)
        assert isinstance(prog, tcp.StagedJit)
        assert [(leg.name, leg.group, leg.device, leg.program.device)
                for leg in prog.legs] == [("segment", g, d, d)
                                          for g, d in enumerate(
                                              mesh.devices)]
        assert not prog.captures()
    assert TM.jit_mesh_chunk(one, **cfg).entry == \
        TM.jit_mesh_chunk(two, **cfg).entry == \
        TM.jit_mesh_chunk(single, **cfg).entry
    assert TM.mesh_shape(two) == (4,)


# ----------------------------------------------------------------------
# the plane's records against JAX's
# ----------------------------------------------------------------------

def _records(pl, caches=CACHES) -> list:
    return sorted((e["cache"], e["compiles"], e["retraces"],
                   tuple(d.split(":")[0] for d in e["last_retrace_diff"]))
                  for e in pl.entries() if e["cache"] in caches)


def _entry_map(jkeys, cache):
    """JAX entry string -> the port's entry string of the same key."""
    return {jcp._entry_str(k): tcp._entry_str(_without_wheel_kernel(k))
            for k in jkeys}


def test_plane_records_equal_jax(fresh, monkeypatch):
    """One call sequence in both packages: guarded epochs on the prefix
    engine (a tag32 trip and its int64 resume) and on the wheel, each at
    two populations (a retrace whose diff names ``active`` first); the
    serial resume program at two populations; the prefix runner on both
    branches; the supervisor's ingest at one key called twice; the mesh
    chunk at two values of ``epoch0`` (an input: no retrace) and at a
    second population.  Per cache the entries, compiles, retraces and
    diff paths are equal, each JAX entry mapped to the port's by its key
    less ``wheel_kernel``."""
    jpl, tpl = fresh
    (_, trip_now), (random, r_now) = STATES["trip"], STATES["random"]
    small = {f: a[:24] for f, a in random.items()}
    trip, _ = STATES["trip"]
    for pkg in ("jax", "port"):
        G = JG if pkg == "jax" else TG
        conv = to_jax if pkg == "jax" else to_torch

        def t_of(now):
            return jnp.int64(now) if pkg == "jax" else now

        for arrays in (trip, {f: a[:32] for f, a in trip.items()}):
            G.run_epoch_guarded(conv(arrays), t_of(trip_now),
                                engine="prefix", m=4, k=16, tag_width=32)
        for arrays in (random, small):
            G.run_epoch_guarded(conv(arrays), t_of(r_now),
                                engine="calendar", m=2, k=4,
                                calendar_impl="wheel", ladder_levels=2)
            serial = G._jit_serial(5, False, 0)
            serial(conv(arrays), t_of(r_now))
        fp = jfp if pkg == "jax" else tfp
        st = conv(random)
        st, _, _ = fp.make_prefix_runner(8)(st, t_of(r_now))
        if pkg == "jax":
            st = st._replace(order=st.order.at[1].set(jnp.int64(1) << 29))
        else:
            st = st._replace(order=st.order.clone())
            st.order[1] = 1 << 29
        fp.make_prefix_runner(8)(st, t_of(r_now))
        Sup = JS if pkg == "jax" else TS
        job = Sup.EpochJob(n=40, depth=4, ring=8, waves=2, epochs=1)
        ing = Sup._jit_ingest(job)
        counts = np.ones(40, dtype=np.int32)
        for t_base in (0, 10 ** 8):
            ing(conv(random), jnp.asarray(counts) if pkg == "jax"
                else torch.from_numpy(counts),
                jnp.int64(t_base) if pkg == "jax" else t_base)
        for n in (48, 32):
            job = dict(MESH_JOB, n=n)
            c = np.random.default_rng(3).poisson(
                1.0, (S, E, n)).astype(np.int32)
            if pkg == "jax":
                mesh = JM.make_mesh(S)
                state = JM.stack_shards(JS._job_state(JS.EpochJob(**job)), S,
                                        mesh)
                ctrs = JM.counter_init(S, n)
            else:
                mesh = TM.make_mesh(S, "cpu")
                state = TM.stack_shards(
                    TS._job_state(TS.EpochJob(**job), "cpu"), S)
                ctrs = TM.counter_init(S, n, device="cpu")
            for e0 in ((0, 4) if n == 48 else (0,)):
                G.run_mesh_chunk_guarded(state, *ctrs, e0, c, mesh=mesh,
                                         **_mesh_kw(1))
    # the entries, key for key, less wheel_kernel
    for cache, jkeys, tkeys in (
            ("guarded", JG._EPOCH_JIT_CACHE, TG._EPOCH_JIT_CACHE),
            ("fastpath.runner", jfp._RUNNER_JIT_CACHE,
             tfp._RUNNER_JIT_CACHE),
            ("supervisor.ingest", JS._INGEST_JIT_CACHE,
             TS._INGEST_JIT_CACHE)):
        assert sorted(map(_without_wheel_kernel, jkeys), key=repr) == \
            sorted(tkeys, key=repr), cache
    assert sorted(_without_wheel_kernel(k[1:]) for k in
                  JM._MESH_CHUNK_JIT_CACHE) == \
        sorted(k[1:] for k in TM._MESH_CHUNK_JIT_CACHE)
    emap = {}
    for jkeys in (JG._EPOCH_JIT_CACHE, jfp._RUNNER_JIT_CACHE,
                  JS._INGEST_JIT_CACHE):
        emap.update(_entry_map(jkeys, None))
    emap.update(_entry_map([k[1:] for k in JM._MESH_CHUNK_JIT_CACHE], None))
    jrec = {(e["cache"], emap[e["entry"]]): (
        e["compiles"], e["retraces"],
        [d.split(":")[0] for d in e["last_retrace_diff"]])
        for e in jpl.entries() if e["cache"] in CACHES}
    trec = {(e["cache"], e["entry"]): (
        e["compiles"], e["retraces"],
        [d.split(":")[0] for d in e["last_retrace_diff"]])
        for e in tpl.entries() if e["cache"] in CACHES}
    assert trec == jrec
    assert {c for c, _ in trec} == set(CACHES)
    by_cache = {}
    for (c, _), (n, r, paths) in trec.items():
        by_cache.setdefault(c, []).append((n, r))
        if r:
            assert paths[0] == "[0][0].active", (c, paths)
    assert sorted(by_cache["guarded.serial"]) == [(2, 1)]
    assert sorted(by_cache["supervisor.ingest"]) == [(1, 0)]
    assert sorted(by_cache["mesh.chunk"]) == [(2, 1)]
    assert sorted(by_cache["fastpath.runner"]) == [(1, 0), (1, 0)]
    assert tpl.totals()["retraces"] == jpl.totals()["retraces"]
    assert tpl.totals()["dispatch_fallbacks"] == 0


# ----------------------------------------------------------------------
# the compile plane's repairs
# ----------------------------------------------------------------------

def test_numpy_leaf_raises_type_error_naming_its_path():
    """A numpy array cannot be a program's input, nor its constant (its
    repr elides a large array): the call raises ``TypeError`` naming the
    leaf's path, before anything runs; the mesh chunk's numpy draws
    likewise."""
    ran = []

    def body(x, extra):
        ran.append(1)
        return x + 1

    prog = tcp.instrumented_jit(body, cache="t", entry=("np",))
    x = torch.arange(4)
    with pytest.raises(TypeError, match=r"\[0\]\[1\]\['draws'\].*numpy"):
        prog(x, {"draws": np.arange(3), "n": 1})
    with pytest.raises(TypeError, match=r"\[0\]\[1\]"):
        prog(x, np.int64(3) * np.ones(2))
    assert not ran
    assert torch.equal(prog(x, {"draws": torch.arange(3), "n": 1}), x + 1)
    assert torch.equal(prog(x, "a string constant"), x + 1)
    serial = tk.serial_program(2, allow_limit_break=False,
                               anticipation_ns=0, cache="t", entry="s")
    arrays, now = STATES["random"]
    with pytest.raises(TypeError, match=r"\[0\]\[1\]"):
        serial(to_torch(arrays), np.asarray([now]))
    mesh = TM.make_mesh(S, "cpu")
    fn = TM.jit_mesh_chunk(mesh, **{k: v for k, v in _mesh_kw(1).items()},
                           ingest=True)
    state = TM.stack_shards(TS._job_state(TS.EpochJob(**MESH_JOB), "cpu"),
                            S)
    ctrs = TM.counter_init(S, MESH_JOB["n"], device="cpu")
    counts, _ = _mesh_inputs(False)
    with pytest.raises(TypeError, match=r"\[0\]\[6\]"):
        fn(state, *ctrs, 0, counts, None, None, TG._zero_window_stack(
            ctrs[0]), None, None, None)


def test_grouped_argument_is_flattened_into_its_tensors():
    """A ``Grouped`` argument is a pytree node: its parts are the
    program's tensor inputs (none a constant), its devices part of the
    structure, a changed value changes the result (nothing frozen), and
    the output comes back grouped."""
    def body(g, k):
        return groups.tree_map(lambda a: a * k, g)

    prog = tcp.instrumented_jit(body, cache="t", entry=("grouped",))
    g = groups.place(torch.arange(8).reshape(4, 2), ("cpu", "cpu"))
    out = prog(g, 3)
    assert groups.is_grouped(out) and out.devices == g.devices
    assert torch.equal(groups.gather(out), torch.arange(8).reshape(4, 2) * 3)
    g2 = groups.place(torch.arange(8).reshape(4, 2) + 100, ("cpu", "cpu"))
    out2 = prog(g2, 3)
    assert torch.equal(groups.gather(out2),
                       (torch.arange(8).reshape(4, 2) + 100) * 3)
    (sig,) = prog._programs
    specs = sig[1]
    assert len(specs) == 3 and all(isinstance(s_, tuple) and
                                   s_[1] == torch.int64 for s_ in specs[:2])
    assert specs[2] is int
