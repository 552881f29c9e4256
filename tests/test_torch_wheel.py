"""The timer wheel of the port against the JAX package, exactly: the
wheel primitives and the plain version of kernel K2 against both
``kernels.wheel_scan`` and the Pallas kernel in interpret mode, and the
wheel index (build, origins, in-place adjust, stop-key boundary)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.engine.kernels_pallas import wheel_scan_pallas
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk

from test_calendar_bucketed import zipf64_state
from test_prefix import mixed_qos_state
from test_torch_cases import WHEEL_CASES, plain_wheel_scan, wheel_case
from test_torch_support import (S, assert_np_equal, random_state, to_jax,
                                to_torch)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_scan_equal(got, want, what):
    for name, g, w in zip(("cnt", "bmin", "val", "found"), got, want):
        assert_np_equal(f"{what} {name}", _np(g), _np(w))


@pytest.mark.parametrize("name, n, nb", WHEEL_CASES,
                         ids=[c[0] for c in WHEEL_CASES])
def test_wheel_scan_matches_jax_and_pallas_interpret(name, n, nb):
    """The port's wheel_scan on CPU tensors (K2's plain version) equals
    the XLA reference, the Pallas kernel run in interpret mode, and a
    numpy statement of the function."""
    keys, slot = wheel_case(name, n, nb)
    got = tk.wheel_scan(torch.from_numpy(keys), torch.from_numpy(slot), nb)
    jk_, js = jnp.asarray(keys), jnp.asarray(slot)
    _assert_scan_equal(got, jk.wheel_scan(jk_, js, nb), "xla")
    _assert_scan_equal(got, wheel_scan_pallas(jk_, js, nb, interpret=True),
                       "pallas")
    cnt, bmin, val, found = plain_wheel_scan(keys, slot, nb)
    _assert_scan_equal(got, (cnt, bmin, np.int64(val), np.bool_(found)),
                       "numpy")
    if name == "all_masked":
        assert not bool(got[3]) and int(got[2]) == tk.KEY_INF
    if name in ("key_inf", "one_bucket"):
        assert bool(got[3])


def test_wheel_nearest_matches_jax():
    rng = np.random.default_rng(3)
    for nb in (256, 768):
        for occupancy in (0.0, 0.01, 0.5):
            cnt = np.where(rng.random(nb) < occupancy,
                           rng.integers(1, 9, nb), 0).astype(np.int32)
            bmin = np.where(cnt > 0, rng.integers(-(1 << 50), 1 << 50, nb),
                            tk.KEY_INF).astype(np.int64)
            got = tk.wheel_nearest(torch.from_numpy(cnt),
                                   torch.from_numpy(bmin))
            want = jk.wheel_nearest(jnp.asarray(cnt), jnp.asarray(bmin))
            for nm, g, w in zip(("val", "b0", "found"), got, want):
                assert_np_equal(nm, g.numpy(), np.asarray(w))
    # the batched form the wheel origins use: one row per class wheel
    cnt = np.zeros((3, 256), np.int32)
    cnt[1, 200] = 2
    cnt[2, 3] = 1
    bmin = np.full((3, 256), tk.KEY_INF, np.int64)
    bmin[1, 200], bmin[2, 3] = -5, 7
    val, b0, found = tk.wheel_nearest(torch.from_numpy(cnt),
                                      torch.from_numpy(bmin))
    assert val.tolist() == [tk.KEY_INF, -5, 7]
    assert b0.tolist() == [256, 200, 3]
    assert found.tolist() == [False, True, True]


def test_wheel_slot_matches_jax():
    rng = np.random.default_rng(4)
    keys = rng.integers(-(1 << 61), 1 << 61, 2048).astype(np.int64)
    for origin, shift, nb in ((0, 52, 256), (50 * S, 20, 256),
                              (-(1 << 40), 30, 768), (7, 0, 5)):
        got = tk.wheel_slot(torch.from_numpy(keys), origin, shift, nb)
        want = jk.wheel_slot(jnp.asarray(keys), jnp.int64(origin), shift,
                             nb)
        assert_np_equal("slot", got.numpy(), np.asarray(want))
        assert got.min() >= 0 and got.max() < nb


def test_wheel_scan_wrapper_checks():
    keys = torch.zeros(8, dtype=torch.int64)
    slot = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.wheel_scan(keys.to(torch.int32), slot, 4)
    with pytest.raises(TypeError):
        tk.wheel_scan(keys, slot.to(torch.int64), 4)
    with pytest.raises(ValueError, match="shapes"):
        tk.wheel_scan(keys, slot[:4], 4)
    for nb in (0, tk.WHEEL_MAX_BUCKETS + 1):
        with pytest.raises(ValueError, match="buckets"):
            tk.wheel_scan(keys, slot, nb)


def _wheel_states():
    """(JAX state, now, allow) cases: the cfg4 cutter shape, a mixed-QoS
    stream, and an arbitrary state with every class present."""
    state_m, now_m = mixed_qos_state(n=8, depth=10)
    arrays = random_state(21, 96, 8, spread=S // 5)
    return [(zipf64_state(n=12, depth=16), 500 * S, False),
            (state_m, now_m, False), (state_m, now_m, True),
            (to_jax(arrays), 50 * S, True)]


def _assert_index_equal(got: tfp.WheelIndex, want, fields=None):
    for f in fields or tfp.WheelIndex._fields:
        assert_np_equal(f, _np(getattr(got, f)),
                        np.asarray(getattr(want, f)))


def test_wheel_build_origins_and_stop_min_match_jax():
    for jstate, now, allow in _wheel_states():
        st = to_torch(jstate)
        got = tfp.wheel_build(st, now, allow)
        want = jfp.wheel_build(jstate, jnp.int64(now), allow)
        _assert_index_equal(got, want)
        for g, w in zip(tfp.wheel_origins(got), jfp.wheel_origins(want)):
            assert_np_equal("origin", _np(g), np.asarray(w))
    rng = np.random.default_rng(23)
    for frac_inf in (0.0, 0.3, 1.0):
        stops = rng.integers(0, 1 << 60, 300).astype(np.int64)
        stops[rng.random(300) < frac_inf] = tk.KEY_INF
        got = tfp._wheel_stop_min(torch.from_numpy(stops))
        want = jfp._wheel_stop_min(jnp.asarray(stops), jk.wheel_scan)
        assert_np_equal("stop_min", got.numpy(), np.asarray(want))
        assert int(got) == int(stops.min())


def test_wheel_adjust_matches_jax_and_rebuild():
    """Re-slot exactly the clients a wheel batch served: equal to the
    JAX adjust on every field (re-slot count and high-water mark too)
    and to a rebuild of the committed state."""
    for jstate, now, allow in _wheel_states()[:3]:
        st = to_torch(jstate)
        b = tfp.calendar_batch_wheel(st, now, steps=6, levels=2,
                                     allow_limit_break=allow)
        assert int(b.count) > 0
        moved = b.served > 0
        got = tfp.wheel_adjust(tfp.wheel_build(st, now, allow), b.state,
                               now, allow, moved)
        want = jfp.wheel_adjust(
            jfp.wheel_build(jstate, jnp.int64(now), allow),
            to_jax(bridge.state_to_numpy(b.state)),
            jnp.int64(now), allow, jnp.asarray(moved.numpy()))
        _assert_index_equal(got, want)
        _assert_index_equal(got, tfp.wheel_build(b.state, now, allow),
                            fields=("origin", "cnt", "bmin", "slot",
                                    "key"))
        assert int(got.reslots) > 0
