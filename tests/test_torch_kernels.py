"""Tag algebra, the serial engine and the metrics vector of the port
against the JAX package, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.core import ClientInfo
from dmclock_tpu.core import timebase as jtb
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.obs import device as jobs
from dmclock_tpu_torch.core import timebase as ttb
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.obs import device as tobs

from engine_helpers import build_state
from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                assert_tuple_matches, random_state,
                                to_jax, to_torch)


def test_timebase_copy_matches_jax():
    for name in ("NS_PER_SEC", "MAX_TAG", "MIN_TAG", "TIME_MAX",
                 "MAX_CHARGE_UNITS", "ORGANIC_TAG_CAP",
                 "LOWEST_PROP_TAG_TRIGGER", "MAX_INV_NS"):
        assert getattr(ttb, name) == getattr(jtb, name), name
    for rate in (0.0, 1e-9, 0.5, 1.0, 3.0, 100.0, 12345.6):
        assert ttb.rate_to_inv_ns(rate) == jtb.rate_to_inv_ns(rate)
    assert (tk.KEY_INF, tk.RETURNING, tk.FUTURE, tk.NONE) == \
        (jk.KEY_INF, jk.RETURNING, jk.FUTURE, jk.NONE)


@pytest.mark.parametrize("anticipation_ns", [0, 5 * S])
def test_make_tag_matches_jax(anticipation_ns):
    """Random int64 inputs, with ``inv == 0`` sentinels on every axis
    and arrivals both inside and outside the anticipation window."""
    rng = np.random.default_rng(17 + anticipation_ns)
    n = 4096
    now = 100 * S

    def t(size=n):
        return (now + rng.integers(-20 * S, 20 * S, size)).astype(np.int64)

    def inv():
        return np.where(rng.random(n) < 0.25, 0,
                        rng.integers(1, 10**10, n)).astype(np.int64)

    args = [t(), t(), t(), t(), inv(), inv(), inv(),
            rng.integers(0, 8, n).astype(np.int64),
            rng.integers(0, 8, n).astype(np.int64),
            t(), rng.integers(0, 1 << 21, n).astype(np.int64)]
    want = jk._make_tag(*map(jnp.asarray, args),
                        anticipation_ns=anticipation_ns)
    got = tk._make_tag(*map(torch.from_numpy, args),
                       anticipation_ns=anticipation_ns)
    for name, g, w in zip("rpl", got, want):
        assert_np_equal(name, g.numpy(), np.asarray(w))
    # every branch was taken: sentinels, capped charges, backdating
    assert (args[4] == 0).any() and (args[10] > ttb.MAX_CHARGE_UNITS).any()
    if anticipation_ns:
        assert ((args[9] - anticipation_ns) < args[3]).any()
    fold_w = jk._fold_prev(jnp.asarray(args[0]), want[0])
    fold_g = tk._fold_prev(torch.from_numpy(args[0]), got[0])
    assert_np_equal("fold", fold_g.numpy(), np.asarray(fold_w))
    possible = np.where(rng.random(n) < 0.3, 0, args[2])
    mn_w = jk._min_not_0(jnp.asarray(args[1]), jnp.asarray(possible))
    mn_g = tk._min_not_0(torch.from_numpy(args[1]),
                         torch.from_numpy(possible))
    assert_np_equal("min_not_0", mn_g.numpy(), np.asarray(mn_w))


def _mixed_queue_state():
    """A reachable state from the JAX queue's own ingest: reservation,
    weight and limit clients with staggered arrivals."""
    infos = {0: ClientInfo(2, 1, 0), 1: ClientInfo(0, 2, 0),
             2: ClientInfo(1, 1, 3), 3: ClientInfo(0, 1, 2),
             4: ClientInfo(0.5, 3, 0), 5: ClientInfo(0, 1, 0)}
    adds = [(c, (1 + i) * S // 3, 1 + (c + i) % 2, 1, 1)
            for i in range(5) for c in infos]
    return build_state(infos, adds, capacity=16, ring=8)


@pytest.mark.parametrize(
    "allow, advance_now, with_metrics",
    [(False, False, True), (False, True, False), (True, False, False),
     (True, True, True)])
def test_engine_run_matches_jax(allow, advance_now, with_metrics):
    steps = 24
    cases = [(_mixed_queue_state(), 2 * S),
             (to_jax(random_state(5, 40, 6)), 50 * S)]
    for jstate, now in cases:
        want = jk.engine_run(jstate, jnp.int64(now), steps,
                             allow_limit_break=allow, anticipation_ns=0,
                             advance_now=advance_now,
                             with_metrics=with_metrics)
        got = tk.engine_run(to_torch(jstate), now, steps,
                            allow_limit_break=allow, anticipation_ns=0,
                            advance_now=advance_now,
                            with_metrics=with_metrics)
        assert len(got) == len(want) == (4 if with_metrics else 3)
        assert_state_matches(got[0], want[0])
        assert int(got[1]) == int(want[1])
        assert_tuple_matches(got[2], want[2])
        if with_metrics:
            assert_np_equal("metrics", got[3].numpy(), np.asarray(want[3]))
        served = (got[2].type == tk.RETURNING).sum()
        assert 0 < int(served)


def test_engine_run_with_anticipation_matches_jax():
    jstate = to_jax(random_state(8, 24, 5))
    want = jk.engine_run(jstate, jnp.int64(50 * S), 12,
                         allow_limit_break=False,
                         anticipation_ns=S // 2, advance_now=True)
    got = tk.engine_run(to_torch(jstate), 50 * S, 12,
                        allow_limit_break=False, anticipation_ns=S // 2,
                        advance_now=True)
    assert_state_matches(got[0], want[0])
    assert_tuple_matches(got[2], want[2])


def test_metrics_vector_matches_jax():
    assert tobs.METRIC_NAMES == jobs.METRIC_NAMES
    assert tobs.NUM_METRICS == jobs.NUM_METRICS == 20
    assert np.array_equal(tobs._HWM_MASK, jobs._HWM_MASK)
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1000, 20).astype(np.int64)
    b = rng.integers(0, 1000, 20).astype(np.int64)
    got = tobs.metrics_combine(torch.from_numpy(a), torch.from_numpy(b))
    assert_np_equal("combine", got.numpy(), np.asarray(
        jobs.metrics_combine(jnp.asarray(a), jnp.asarray(b))))
    rows = dict(decisions=7, resv=3, prop=4, ring_hwm=9, guard_trips=1,
                pallas_fallbacks=2)
    got = tobs.metrics_delta(device="cpu", **{
        k: torch.tensor(v) for k, v in rows.items()})
    assert_np_equal("delta", got.numpy(),
                    np.asarray(jobs.metrics_delta(**rows)))
    assert tobs.metrics_dict(got) == jobs.metrics_dict(
        jobs.metrics_delta(**rows))
    assert_np_equal("zero", tobs.metrics_zero("cpu").numpy(),
                    np.asarray(jobs.metrics_zero()))
    with pytest.raises(TypeError):
        tobs.metrics_delta(device="cpu", bogus=1)
