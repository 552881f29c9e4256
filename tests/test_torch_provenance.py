"""The port's provenance plane against the JAX package, exactly: the
block's init, observe, liveness select, combine and round trip; the
host views (margin percentiles, ``prov_dict``, stale clients); the
starvation monitor over the same sequence of blocks; and the pressure
vector the stream chunk's probe reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.obs import provenance as jprov
from dmclock_tpu_torch.obs import provenance as tprov

from test_torch_support import (S, assert_np_equal, random_state, to_jax,
                                to_torch)

N = 60


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


def _assert_block(t, j):
    for f in tprov.ProvBlock._fields:
        assert_np_equal(f, _np(getattr(t, f)), _np(getattr(j, f)))


def _observations(seed):
    """Seeded batch observations: entry masks, the min class, served
    counts and margins (-1 = none), at an advancing now."""
    rng = np.random.default_rng(seed)
    for b in range(6):
        elig = rng.random(N) < 0.5
        gated = ~elig & (rng.random(N) < 0.3)
        cls = rng.integers(0, 3, N).astype(np.int32)
        win = np.int32(cls[elig].min() if elig.any() else 3)
        served = np.where(elig & (rng.random(N) < 0.4),
                          rng.integers(1, 4, N), 0).astype(np.int32)
        margins = np.where(rng.random(N) < 0.5,
                           rng.integers(0, 1 << 40, N), -1)
        margins[:3] = [0, 1, (1 << 46) + 3]
        yield (1000 + b * 7_000_000, elig, gated, win, served,
               margins.astype(np.int64), b == 4)


def _run_both(seed):
    tp, jp = tprov.prov_init(N, 500, "cpu"), jprov.prov_init(N, 500)
    for now, elig, gated, win, served, margins, dead in \
            _observations(seed):
        nt = tprov.prov_observe(
            tp, now=torch.tensor(now), elig=torch.from_numpy(elig),
            gated=torch.from_numpy(gated), win_cls=torch.tensor(win),
            served_pc=torch.from_numpy(served),
            margins=torch.from_numpy(margins))
        nj = jprov.prov_observe(
            jp, now=jnp.int64(now), elig=jnp.asarray(elig),
            gated=jnp.asarray(gated), win_cls=jnp.int32(win),
            served_pc=jnp.asarray(served), margins=jnp.asarray(margins))
        tp = tprov.prov_select(torch.tensor(not dead), nt, tp)
        jp = jprov.prov_select(jnp.bool_(not dead), nj, jp)
        _assert_block(tp, jp)
    return tp, jp


@pytest.mark.parametrize("seed", [0, 1])
def test_prov_observe_select_combine_match_jax(seed):
    tp, jp = _run_both(seed)
    assert int(tp.scal[tprov.PS_BATCHES]) == 5      # one dead batch
    tq, jq = _run_both(seed + 10)
    _assert_block(tprov.prov_combine(tp, tq), jprov.prov_combine(jp, jq))
    assert tprov.prov_select(True, tq, tp) is tq
    nomargin = tprov.prov_observe(
        tp, now=torch.tensor(9), elig=torch.ones(N, dtype=torch.bool),
        gated=torch.zeros(N, dtype=torch.bool), win_cls=torch.tensor(1),
        served_pc=torch.zeros(N, dtype=torch.int32))
    assert torch.equal(nomargin.margin_hist, tp.margin_hist)
    back = tprov.prov_from_arrays(*(_np(x) for x in tp), device="cpu")
    _assert_block(back, jp)


def test_prov_host_views_match_jax():
    tp, jp = _run_both(3)
    assert tprov.prov_dict(tp) == jprov.prov_dict(jp)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert tprov.margin_percentile(tp, q) == \
            jprov.margin_percentile(jp, q)
    backlog = np.arange(N) % 3
    for now, thr in ((50_000_000, 10_000_000), (9 * S, 0)):
        assert tprov.stale_clients(tp, now, thr) == \
            jprov.stale_clients(jp, now, thr)
        assert tprov.stale_clients(tp, now, thr,
                                   backlog=torch.from_numpy(backlog)) == \
            jprov.stale_clients(jp, now, thr, backlog=backlog)


def test_starvation_monitor_matches_jax():
    """The same blocks at the same drain points: the same episodes fire
    on both sides, once each, and re-arm when a client is served."""
    tlog, jlog = [], []
    tm = tprov.StarvationMonitor(20_000_000, log=tlog.append)
    jm = jprov.StarvationMonitor(20_000_000, log=jlog.append)
    tp, jp = tprov.prov_init(N, 0, "cpu"), jprov.prov_init(N, 0)
    rng = np.random.default_rng(8)
    backlog = (rng.random(N) < 0.7).astype(np.int32)
    for step in range(6):
        now = (step + 1) * 15_000_000
        served = (rng.random(N) < 0.3).astype(np.int32)
        tp = tprov.prov_observe(
            tp, now=torch.tensor(now), elig=torch.from_numpy(backlog > 0),
            gated=torch.zeros(N, dtype=torch.bool), win_cls=torch.tensor(0),
            served_pc=torch.from_numpy(served))
        jp = jprov.prov_observe(
            jp, now=jnp.int64(now), elig=jnp.asarray(backlog > 0),
            gated=jnp.zeros(N, bool), win_cls=jnp.int32(0),
            served_pc=jnp.asarray(served))
        assert tm.observe(tp, now + 10_000_000,
                          backlog=torch.from_numpy(backlog)) == \
            jm.observe(jp, now + 10_000_000, backlog=backlog)
    assert tm.fired == jm.fired and tm.episodes_total == jm.episodes_total
    assert tm.active == jm.active and tlog == jlog
    assert tm.episodes_total > 0


@pytest.mark.parametrize("seed", [2, 7])
def test_pressure_vec_matches_jax(seed):
    arrays = random_state(seed, 50, 6)
    for now in (50 * S, 49 * S, 52 * S):
        got = tprov.pressure_vec(to_torch(arrays), torch.tensor(now))
        want = jprov.pressure_vec(to_jax(arrays), jnp.int64(now))
        assert_np_equal("pressure", _np(got), _np(want))
        assert tprov.pressure_dict(got) == jprov.pressure_dict(want)
    assert tprov.pressure_dict(got)["backlog"] > 0
