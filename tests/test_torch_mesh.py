"""The port's mesh chunk (``parallel/mesh.py``) against the JAX
package's ``jit_mesh_chunk`` on its CPU mesh, exactly: S=4 chunks of the
prefix (sort), chain, calendar-minstop and calendar-wheel engines at
``tests/test_mesh.py``'s ``BASE`` size; ``counter_sync_every`` 1 and 2,
the grouped (collective-skipping) chunk equal to the flat one; the fault
model inside the chunk with every telemetry accumulator (histograms,
ledger, flight ring, SLO block, provenance) and the pressure probe; the
shard helpers of the telemetry planes; S=1 equal to the port's own
stream chunk; and ``serve.mesh_row`` against ``bench.bench_mesh`` on
the CPU, clean and chaos.  Every field of every state, output, counter,
view and merged block is compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from dmclock_tpu.obs import capacity as JC
from dmclock_tpu.obs import device as jobs
from dmclock_tpu.obs import flight as jflight
from dmclock_tpu.obs import histograms as jhist
from dmclock_tpu.obs import provenance as jprov
from dmclock_tpu.obs import registry as jreg
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu.parallel import mesh as JM
from dmclock_tpu.robust import faults as JF
from dmclock_tpu.robust import supervisor as JSV
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import stream as tstream
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.obs import flight as tflight
from dmclock_tpu_torch.obs import histograms as thist
from dmclock_tpu_torch.obs import provenance as tprov
from dmclock_tpu_torch.obs import registry as treg
from dmclock_tpu_torch.obs import slo as tslo
from dmclock_tpu_torch.parallel import mesh as TM
from dmclock_tpu_torch.robust import faults as TF

from test_torch_support import assert_np_equal

# tests/test_mesh.py's BASE job size
BASE = dict(n=96, depth=6, ring=10, epochs=5, m=2, seed=5,
            arrival_lam=1.0, waves=2, ckpt_every=2)
ENGINES = {
    "prefix-sort": dict(engine="prefix", k=16, select_impl="sort"),
    "chain": dict(engine="chain", chain_depth=3, k=8),
    "calendar-minstop": dict(engine="calendar", k=4,
                             calendar_impl="minstop"),
    "calendar-wheel": dict(engine="calendar", k=4, calendar_impl="wheel",
                           ladder_levels=2),
}
S, E, RECORDS = 4, 2, 24
N = BASE["n"]

_REFS: dict = {}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def assert_tree_equal(name, got, want):
    if got is None or want is None:
        assert got is None and want is None, name
        return
    if isinstance(got, dict):
        assert got.keys() == want.keys(), name
        for key in got:
            assert_tree_equal(f"{name}.{key}", got[key], want[key])
        return
    if isinstance(got, tuple):
        fields = getattr(got, "_fields", range(len(got)))
        for f, a, b in zip(fields, got, want):
            assert_tree_equal(f"{name}.{f}", a, b)
        return
    assert_np_equal(name, _np(got), _np(want))


def assert_chunk_equal(got, want):
    for f in JM.MeshChunk._fields:
        assert_tree_equal(f, getattr(got, f), getattr(want, f))


def _job(name):
    return JSV.EpochJob(engine_loop="stream", **BASE,
                        **{k: v for k, v in ENGINES[name].items()})


def _state_np(name) -> dict:
    """The job's preloaded single-engine state, from the JAX package."""
    key = ("state", name)
    if key not in _REFS:
        st = JSV._job_state(_job(name))
        _REFS[key] = {f: _np(v) for f, v in zip(st._fields, st)}
    return _REFS[key]


def _cfg(name, **over):
    job = _job(name)
    cfg = dict(engine=job.engine, epochs=E, m=job.m, k=job.k,
               chain_depth=job.chain_depth, dt_epoch_ns=job.dt_epoch_ns,
               waves=job.waves, with_metrics=True,
               select_impl=job.select_impl,
               calendar_impl=job.calendar_impl,
               ladder_levels=job.ladder_levels, counter_sync_every=1,
               ingest=True)
    cfg.update(over)
    return cfg


def _counts(seed, s=S, e=E):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.poisson(1.0, (s, e, N)).astype(np.int32)


def _tele(pkg, s, *, full: bool):
    """Stacked (hists, ledger, slo, prov, flight) of one package; the
    SLO block always, the rest with ``full``."""
    if pkg == "jax":
        mesh = JM.make_mesh(s)

        def st(x):
            return JM.stack_shards(x, s, mesh)

        slo = st(jslo.window_zero(N))
        if not full:
            return None, None, slo, None, None
        return (st(jhist.hist_zero()), st(jhist.ledger_zero(N)), slo,
                st(jprov.prov_init(N, 0)), st(jflight.flight_init(RECORDS)))

    def st(x):
        return TM.stack_shards(x, s)

    slo = st(tslo.window_zero(N, "cpu"))
    if not full:
        return None, None, slo, None, None
    return (st(thist.hist_zero("cpu")), st(thist.ledger_zero(N, "cpu")),
            slo, st(tprov.prov_init(N, 0, "cpu")),
            st(tflight.flight_init(RECORDS, "cpu")))


def _run_jax(name, cfg, e0, counts, *, s=S, full=False, faults=None):
    mesh = JM.make_mesh(s)
    fn = JM.jit_mesh_chunk(mesh, **cfg)
    state = JM.stack_shards(jax.tree.map(jnp.asarray, _job_state_jax(
        name)), s, mesh)
    cd, cr, vd, vr = JM.counter_init(s, N)
    h, l, w, p, f = _tele("jax", s, full=full)
    return fn(state, cd, cr, vd, vr, jnp.int64(e0), jnp.asarray(counts),
              h, l, w, p, f,
              None if faults is None else tuple(map(jnp.asarray, faults)))


def _job_state_jax(name):
    from dmclock_tpu.engine.state import EngineState

    return EngineState(**{k: jnp.asarray(v)
                          for k, v in _state_np(name).items()})


def _run_torch(name, cfg, e0, counts, *, s=S, full=False, faults=None):
    mesh = TM.make_mesh(s, "cpu")
    fn = TM.build_mesh_chunk(mesh, **cfg)
    state = TM.stack_shards(bridge.state_from_numpy(_state_np(name),
                                                    "cpu"), s)
    cd, cr, vd, vr = TM.counter_init(s, N, device="cpu")
    h, l, w, p, f = _tele("torch", s, full=full)
    return fn(state, cd, cr, vd, vr, e0, counts, h, l, w, p, f, faults)


def _ref(key, thunk):
    if key not in _REFS:
        _REFS[key] = thunk()
    return _REFS[key]


# ----------------------------------------------------------------------
# the chunk, per engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ENGINES))
def test_mesh_chunk_engines(name):
    cfg = _cfg(name)
    counts = _counts(13)
    want = _ref(("k1", name), lambda: _run_jax(name, cfg, 0, counts))
    got = _run_torch(name, cfg, 0, counts)
    assert_chunk_equal(got, want)
    assert int(_np(got.outs["count"]).sum()) > 0
    # the result views and decision counts, per shard and epoch
    outs_np = {k: _np(v) for k, v in got.outs.items()}
    jouts = {k: _np(v) for k, v in want.outs.items()}
    for i in range(E):
        assert TM.mesh_epoch_decisions(cfg["engine"], got.outs, i) == \
            JM.mesh_epoch_decisions(cfg["engine"], jouts, i)
        rows_t = TM.mesh_epoch_results(cfg["engine"], outs_np, i)
        rows_j = JM.mesh_epoch_results(cfg["engine"], jouts, i)
        assert len(rows_t) == len(rows_j) == S
        for (a,), (b,) in zip(rows_t, rows_j):
            assert type(a).__name__ == type(b).__name__
            for f in a._fields:
                if f != "state":
                    assert_tree_equal(f, getattr(a, f), getattr(b, f))


def test_counter_sync_every_two_grouped_equals_flat():
    """K=2 over 2 epochs from epoch 2: the port's grouped and flat
    chunks both equal the JAX grouped chunk (which the JAX package pins
    to its flat one), and the views refresh on the grid only."""
    name = "prefix-sort"
    counts = _counts(17)
    grouped = _cfg(name, counter_sync_every=2, collective_skipping=True)
    flat = _cfg(name, counter_sync_every=2, collective_skipping=False)
    want = _run_jax(name, grouped, 2, counts)
    assert_chunk_equal(_run_torch(name, grouped, 2, counts), want)
    assert_chunk_equal(_run_torch(name, flat, 2, counts), want)
    # off the grid (epoch 1) the flat chunk refreshes at epoch 2 only
    off = _run_torch(name, flat, 1, counts)
    assert off.view_d.min() >= 1
    with pytest.raises(ValueError):
        TM.build_mesh_chunk(TM.make_mesh(S, "cpu"), **_cfg(
            name, counter_sync_every=2, collective_skipping=True,
            with_faults=True))


def _fault_chunk(pkg, seed=7):
    spec = "seed=%d,p_dropout=0.3,mean_outage_steps=2,p_delay=0.3," \
        "p_dup=0.3,max_skew_ns=20000000" % seed
    mod = JF if pkg == "jax" else TF
    plan = mod.plan_from_spec(mod.parse_fault_spec(spec), E + 1, S)
    return plan, mod.plan_chunk(plan, 1, E + 1)


def test_faults_with_every_accumulator_and_pressure(tmp_path):
    """The fault model in the chunk with histograms, ledger, flight
    ring, SLO block, provenance and the pressure probe riding it."""
    name = "prefix-sort"
    cfg = _cfg(name, with_faults=True, with_pressure=True)
    counts = _counts(19)
    jplan, jfc = _fault_chunk("jax")
    tplan, tfc = _fault_chunk("torch")
    assert not np.asarray(jfc.up).all(), "the plan should drop a shard"
    want = _run_jax(name, cfg, 1, counts, full=True, faults=jfc)
    got = _run_torch(name, cfg, 1, counts, full=True, faults=tfc)
    assert_chunk_equal(got, want)
    # the fault rows equal the plan oracle's events in the window
    mets = _np(got.outs["metrics"])
    win = TF.FaultPlan(*(np.asarray(a)[1:] for a in tplan))
    prev = np.asarray(tplan.up)[0]
    ups = np.vstack([prev[None], np.asarray(win.up)])
    dropouts = (ups[:-1] & ~ups[1:]).sum(axis=0)
    assert np.array_equal(mets[:, :, tobs.MET_SERVER_DROPOUTS].sum(1),
                          dropouts)
    # the shard helpers of the telemetry planes, against the JAX host
    # merges of the same stacked blocks
    led = jhist.ledger_combine_np(np.zeros((N, jhist.LED_COLS), np.int64),
                                  *_np(got.ledger))
    assert_np_equal("ledger_mesh_reduce",
                    _np(thist.ledger_mesh_reduce(got.ledger)), led)
    assert_np_equal("hist_mesh_reduce",
                    _np(thist.hist_mesh_reduce(got.hists)),
                    _np(got.hists).sum(axis=0))
    assert_np_equal("window_mesh_reduce",
                    _np(tslo.window_mesh_reduce(got.slo)),
                    jslo.window_combine_np(
                        np.zeros((N, jslo.W_FIELDS), np.int64),
                        *_np(got.slo)))
    met = jobs.metrics_combine_np(np.zeros(jobs.NUM_METRICS, np.int64),
                                  *mets.reshape(-1, jobs.NUM_METRICS))
    assert_np_equal("metrics_mesh_reduce", _np(tobs.metrics_mesh_reduce(
        got.outs["metrics"].reshape(-1, tobs.NUM_METRICS))), met)
    prov = tprov.prov_mesh_reduce(got.prov)
    ps = _np(got.prov.scal)
    mask = np.zeros(tprov.PS_FIELDS, bool)
    mask[list(tprov._PS_MAX_ROWS)] = True
    assert_np_equal("prov scal", _np(prov.scal),
                    np.where(mask, ps.max(0), ps.sum(0)))
    assert_np_equal("prov last", _np(prov.last_served),
                    _np(got.prov.last_served).max(0))
    press = _np(got.outs["pressure"]).reshape(-1, tprov.PRESS_FIELDS)
    pm = np.zeros(tprov.PRESS_FIELDS, bool)
    pm[[tprov.PRESS_ELIG_PEAK, tprov.PRESS_WAIT_WM]] = True
    assert_np_equal("pressure_mesh_reduce",
                    _np(tprov.pressure_mesh_reduce(
                        torch.from_numpy(press))),
                    np.where(pm, press.max(0), press.sum(0)))
    # flight: shard-order merge and drain equal the JAX readers
    jfl = jflight.FlightState(*(jnp.asarray(_np(x)) for x in got.flight))
    rows_t, seq_t = tflight.flight_merge_stacked(got.flight)
    rows_j, seq_j = jflight.flight_merge_stacked(jfl)
    assert_np_equal("flight rows", rows_t, rows_j)
    assert seq_t == seq_j
    assert tflight.flight_drain_stacked(got.flight) == \
        jflight.flight_drain_stacked(jfl)
    paths = [tmp_path / "t.jsonl", tmp_path / "j.jsonl"]
    assert tflight.flight_dump_any(got.flight, str(paths[0])) == \
        jflight.flight_dump_any(jfl, str(paths[1])) > 0
    assert paths[0].read_text() == paths[1].read_text()


def test_zero_faults_equal_no_faults_and_publishers():
    name = "prefix-sort"
    counts = _counts(23)
    clean = _run_torch(name, _cfg(name), 3, counts)
    zero = TF.plan_chunk(TF.zero_plan(E + 3, S), 3, E + 3)
    faulty = _run_torch(name, _cfg(name, with_faults=True), 3, counts,
                        faults=zero)
    assert_chunk_equal(faulty, clean)
    # the publishers write what the JAX ones write
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    blocks = _np(clean.slo)
    jslo.publish_shard_windows(jr, blocks, merged=_np(clean.slo_merged))
    tslo.publish_shard_windows(tr, blocks, merged=_np(clean.slo_merged))
    mets = _np(clean.outs["metrics"])[:, 0]
    jobs.publish_shard_faults(jr, mets)
    tobs.publish_shard_faults(tr, mets)
    press = np.arange(S * 4, dtype=np.int64).reshape(S, 4)
    jprov.publish_shard_pressure(jr, press, merged=press.sum(0))
    tprov.publish_shard_pressure(tr, press, merged=press.sum(0))
    assert tr.prometheus() == jr.prometheus()


def test_s1_equals_stream_chunk():
    """A one-shard mesh chunk is the stream chunk, field by field."""
    name = "prefix-sort"
    cfg = _cfg(name)
    counts = _counts(29, s=1)
    got = _run_torch(name, cfg, 0, counts, s=1, full=True)
    st = bridge.state_from_numpy(_state_np(name), "cpu")
    kw = {k: v for k, v in cfg.items()
          if k not in ("counter_sync_every",)}
    ref = tstream.build_stream_chunk(**kw)(
        st, 0, torch.from_numpy(counts[0]), thist.hist_zero("cpu"),
        thist.ledger_zero(N, "cpu"), tflight.flight_init(RECORDS, "cpu"),
        tslo.window_zero(N, "cpu"), tprov.prov_init(N, 0, "cpu"))
    one = TM.unstack_shard(got)
    assert_tree_equal("state", one.state, ref.state)
    assert_tree_equal("outs", {k: v[0] for k, v in got.outs.items()},
                      ref.outs)
    for f in ("hists", "ledger", "flight", "slo", "prov"):
        assert_tree_equal(f, getattr(one, f), getattr(ref, f))
    assert_tree_equal("slo_merged", got.slo_merged, ref.slo)


# ----------------------------------------------------------------------
# bench's mesh row
# ----------------------------------------------------------------------

# the keys that measure wall time (and the projected bytes, whose epoch
# block the JAX ledger takes from its closed form when the accumulators
# are on: test_torch_capacity.py holds both)
NOT_COMPARED = {"dps", "dps_per_shard", "dps_per_shard_mean",
                "dps_per_shard_min", "dps_per_shard_max", "wall_s",
                "projected_hbm_bytes_per_shard", "n_shards",
                "clients_per_shard"}


@pytest.mark.parametrize("chaos", [False, True])
def test_mesh_row_equals_bench(chaos):
    kw = dict(n_shards=4, epochs=8, warmup_epochs=4, chunk=4,
              counter_sync_every=1 if chaos else 2)
    spec = None
    if chaos:
        spec = "seed=7,p_dropout=0.05,mean_outage_steps=2,p_dup=0.1"
    want = bench.bench_mesh(
        512, fault_spec=JF.parse_fault_spec(spec), **kw)
    got = tserve.mesh_row(512, fault_spec=TF.parse_fault_spec(spec),
                          registry=treg.MetricsRegistry(), device="cpu",
                          **kw)
    assert set(got) == set(want)
    for key in sorted(want):
        if key not in NOT_COMPARED:
            assert got[key] == want[key], key
    for key in ("n_shards", "clients_per_shard"):
        assert got[key] == want[key] == {"n_shards": 4,
                                         "clients_per_shard": 128}[key]
    assert got["decisions"] > 0
    # the projected bytes: the JAX ledger's but for its closed-form
    # epoch block (see tests/test_torch_capacity.py)
    cap = dict(ring=16, engine="prefix", m=4, k=256, telemetry=True,
               slo=True, stream_chunk=4)
    assert got["projected_hbm_bytes_per_shard"] == \
        want["projected_hbm_bytes_per_shard"] \
        - JC.hbm_ledger(128, **cap)["epoch_outputs"] \
        + JC.hbm_ledger(128, **dict(cap, telemetry=False,
                                    slo=False))["epoch_outputs"]
    if chaos:
        plan = TF.plan_from_spec(TF.parse_fault_spec(spec), 12, 4)
        ev = TF.plan_shard_events(plan)
        assert got["fault_dropouts_per_shard"] == \
            ev["server_dropouts"].tolist()
        assert got["fault_resyncs_per_shard"] == \
            ev["tracker_resyncs"].tolist()
    else:
        assert got["collective_skipping"] is True


def test_mesh_row_cli_on_the_cpu():
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run(
        [sys.executable, "-m", "dmclock_tpu_torch.serve", "--workload",
         "mesh", "--n-shards", "2", "--clients", "256", "--fault-plan",
         "seed=3,p_dropout=0.2", "--device", "cpu"],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["workload"] == "mesh" and row["device"] == "cpu"
    assert row["n_shards"] == 2 and row["decisions"] > 0
    assert row["fault_plan"].startswith("T32xS2:")
