"""The port's guarded mesh chunk (``robust/guarded.py``:
``run_mesh_chunk_guarded``, ``mesh_chunk_host_replay``,
``neutral_epoch_view``) against the JAX package's on its CPU mesh,
exactly.

One chunk of 4 shards x 6 epochs at ``tests/test_mesh.py``'s job size,
from the same stacked state, counters and raw draws, on the prefix
(sort), chain and calendar-minstop engines: the fused leg equals the
host replay (the chain digest of every epoch's rows, the per-epoch
decisions, the metric fold, the counters, views, state and merged SLO
block), clean and under a sampled fault plan (dropouts, restarts,
delays, duplicated completions, clock skew), and each leg equals its
JAX counterpart field for field.  A tag32 trip discards the fused chunk
and replays it on the host loop, equal to the JAX fallback.  The
host-built neutral epoch of a down shard has the dtype, shape and
values of a masked real epoch."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from dmclock_tpu.parallel import mesh as JM
from dmclock_tpu.robust import faults as JF
from dmclock_tpu.robust import guarded as JG
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import stream as tstream
from dmclock_tpu_torch.obs import device as tobs
from dmclock_tpu_torch.parallel import mesh as TM
from dmclock_tpu_torch.robust import guarded as TG
from dmclock_tpu_torch.robust import supervisor as TS
from dmclock_tpu_torch.robust.digest import digest_update

from test_torch_support import assert_np_equal

BASE = dict(n=96, depth=6, ring=10, epochs=5, m=2, seed=5,
            arrival_lam=1.0, waves=2, ckpt_every=2)
ENGINES = {
    "prefix-sort": dict(engine="prefix", k=16, select_impl="sort"),
    "chain": dict(engine="chain", chain_depth=3, k=8),
    "calendar-minstop": dict(engine="calendar", k=4,
                             calendar_impl="minstop"),
}
S, E = 4, 6


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


def _inputs(name, K, *, faults, tag=None, pressure=False):
    """The job, the chunk kwargs, the raw draws and the fault chunk."""
    over = dict(tag or {})
    job = dict(BASE, **ENGINES[name], **over)
    plan = JF.sample_plan(11, E, S, p_dropout=0.3, mean_outage_steps=2.0,
                          p_delay=0.2, p_dup=0.2, max_skew_ns=1000) \
        if faults else None
    rng = np.random.Generator(np.random.PCG64(9))
    counts = rng.poisson(1.0, (S, E, job["n"])).astype(np.int32)
    kw = dict(engine=job["engine"], epochs=E, m=job["m"], k=job["k"],
              chain_depth=job.get("chain_depth", 4),
              dt_epoch_ns=10 ** 8, waves=job["waves"], with_metrics=True,
              select_impl=job.get("select_impl", "sort"),
              calendar_impl=job.get("calendar_impl", "minstop"),
              ladder_levels=job.get("ladder_levels", 4),
              tag_width=job.get("tag_width", 64), counter_sync_every=K,
              with_pressure=pressure)
    return job, kw, counts, plan


def _port(name, K, *, faults, tag=None, pressure=False):
    job, kw, counts, plan = _inputs(name, K, faults=faults, tag=tag,
                                    pressure=pressure)
    tjob = TS.EpochJob(**job)
    state = TM.stack_shards(TS._job_state(tjob, "cpu"), S)
    ctrs = TM.counter_init(S, job["n"], device="cpu")
    fc = None if plan is None else JF.plan_chunk(plan, 0, E)
    mesh = TM.make_mesh(S, "cpu")
    fused = TG.run_mesh_chunk_guarded(state, *ctrs, 0, counts, mesh=mesh,
                                      faults=fc, **kw)
    host = TG.mesh_chunk_host_replay(state, *ctrs, 0, counts, faults=fc,
                                     **kw)
    return fused, host, plan


def _jax(name, K, *, faults, tag=None, pressure=False):
    job, kw, counts, plan = _inputs(name, K, faults=faults, tag=tag,
                                    pressure=pressure)
    jjob = JS.EpochJob(**job)
    mesh = JM.make_mesh(S)
    state = JM.stack_shards(JS._job_state(jjob), S, mesh)
    ctrs = JM.counter_init(S, job["n"])
    fc = None if plan is None else JF.plan_chunk(plan, 0, E)
    fused = JG.run_mesh_chunk_guarded(state, *ctrs, 0, counts, mesh=mesh,
                                      faults=fc, **kw)
    host = JG.mesh_chunk_host_replay(state, *ctrs, 0, counts, faults=fc,
                                     **kw)
    return fused, host


def _digest(g) -> str:
    d = b"\x00" * 32
    for row in g.epochs:
        d = digest_update(d, tuple(r for grp in row for r in grp))
    return hashlib.sha256(d).hexdigest()


def _metrics(g) -> np.ndarray:
    met = np.zeros(tobs.NUM_METRICS, dtype=np.int64)
    for row in g.epochs:
        for grp in row:
            for r in grp:
                met = tobs.metrics_combine_np(met, _np(r.metrics))
    return met


def _assert_legs_equal(a, b, what):
    """Two MeshGuarded results (either package) on every compared
    field."""
    assert _digest(a) == _digest(b), f"{what}: row digest"
    assert tuple(a.counts) == tuple(b.counts), f"{what}: counts"
    assert_np_equal(f"{what}: metrics", _metrics(a), _metrics(b))
    for f in ("cd", "cr", "view_d", "view_r", "slo", "slo_merged"):
        assert_np_equal(f"{what}: {f}", _np(getattr(a, f)),
                        _np(getattr(b, f)))
    for f in a.state._fields:
        assert_np_equal(f"{what}: state.{f}", _np(getattr(a.state, f)),
                        _np(getattr(b.state, f)))


CASES = [("prefix-sort", 2, True), ("chain", 1, True),
         ("calendar-minstop", 4, True), ("prefix-sort", 1, False),
         ("chain", 2, False), ("calendar-minstop", 2, False)]


@pytest.mark.parametrize("name, K, faults", CASES)
def test_fused_equals_host_replay_and_jax(name, K, faults):
    fused, host, plan = _port(name, K, faults=faults)
    assert fused.mesh_fallback == 0 and host.mesh_fallback == 1
    _assert_legs_equal(fused, host, "port fused vs host")
    assert sum(fused.counts) > 0
    if faults:
        ev = JF.plan_events(plan)
        md = tobs.metrics_dict(_metrics(fused))
        for key in ("server_dropouts", "tracker_resyncs",
                    "faults_injected"):
            assert md[key] == ev[key], key
    jfused, jhost = _jax(name, K, faults=faults)
    _assert_legs_equal(fused, jfused, "fused vs JAX fused")
    _assert_legs_equal(host, jhost, "host replay vs JAX host replay")


def test_pressure_peaks_are_exact_on_both_legs():
    """The mid-epoch pressure probe's per-shard chunk peaks (down epochs
    read zeros): the fused leg, the host replay and both JAX legs agree,
    under faults."""
    fused, host, _ = _port("prefix-sort", 2, faults=True, pressure=True)
    jfused, jhost = _jax("prefix-sort", 2, faults=True, pressure=True)
    assert fused.press.shape == (S, fused.press.shape[1]) and \
        fused.press.any()
    for what, other in (("host", host), ("JAX fused", jfused),
                        ("JAX host", jhost)):
        assert_np_equal(f"press vs {what}", fused.press, _np(other.press))
    _assert_legs_equal(fused, host, "fused vs host with the probe")


def test_tag32_trip_replays_on_the_host_loop():
    """Client 0's tag 2^31 + 1 ns ahead trips the tag32 window: the fused
    chunk is discarded and the host loop's replay (its rebase resumes
    counted per epoch) is what comes back, equal to the JAX fallback."""
    tag = dict(tag_width=32, tag_spread_ns=2 ** 31 + 1)
    fused, host, _ = _port("prefix-sort", 1, faults=True, tag=tag)
    assert fused.mesh_fallback == 1
    assert sum(fused.guard_trips) > 0
    _assert_legs_equal(fused, host, "trip vs host replay")
    jfused, _ = _jax("prefix-sort", 1, faults=True, tag=tag)
    assert jfused.mesh_fallback == 1
    _assert_legs_equal(fused, jfused, "trip vs JAX")
    assert tuple(fused.guard_trips) == tuple(jfused.guard_trips)


@pytest.mark.parametrize("name, over", [
    ("prefix-sort", {}), ("chain", {}), ("calendar-minstop", {}),
    ("calendar-minstop", dict(calendar_impl="bucketed", ladder_levels=2)),
])
def test_neutral_epoch_view_matches_a_masked_epoch(name, over):
    """The host-built neutral epoch of a down shard equals a real epoch's
    outputs through ``mask_epoch_outs`` with ``up`` False, in dtype,
    shape and value, the metrics being the fault delta."""
    job = TS.EpochJob(**{**BASE, **ENGINES[name], **over})
    st = TS._job_state(job, "cpu")
    kw = tfp.epoch_scan_kwargs(job.engine, k=job.k,
                               chain_depth=job.chain_depth,
                               calendar_impl=job.calendar_impl,
                               ladder_levels=job.ladder_levels,
                               with_metrics=True)
    ep = tfp.epoch_scan_fn(job.engine)(st, 10 ** 8, m=job.m, **kw)
    outs = {f: getattr(ep, f)
            for f in tstream.STREAM_OUT_FIELDS[job.engine]}
    outs["metrics"] = ep.metrics
    fv = TG._fault_met_vec(True, False, 0)
    masked = TM.mask_epoch_outs(outs, torch.tensor(False),
                                torch.from_numpy(fv))
    view = TG.neutral_epoch_view(job.engine, st, job.m, kw, fv)
    for f, arr in masked.items():
        assert_np_equal(f, _np(getattr(view, f)), _np(arr))
