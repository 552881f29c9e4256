"""The ring window (kernel K1) against the JAX package's ring rotations.

On the CPU the wrapper runs K1's plain version (a gather on floor-mod
indices); it is held here against the XLA barrel shift and the Pallas
kernel in interpret mode.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu_torch.engine import _ext
from dmclock_tpu_torch.engine import fastpath as tfp

from test_torch_cases import RING_SHAPES, ring_case
from test_torch_support import (assert_np_equal, random_state, to_jax,
                                to_torch)


@pytest.mark.parametrize("n, q, w", RING_SHAPES)
def test_plain_window_matches_xla_rotate(n, q, w):
    ring, q0 = ring_case(n, q, n + q + w)
    got = tfp._ring_window_torch(torch.from_numpy(ring),
                                 torch.from_numpy(q0), w)
    want = jfp._rotate_rows_xla(jnp.asarray(ring), jnp.asarray(q0), w)
    assert tuple(got.shape) == (w, n)
    assert_np_equal("window", got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n, q, w", [(700, 16, 5), (100, 64, 64),
                                     (300, 320, 32), (64, 48, 48)])
def test_plain_window_matches_pallas_interpret(n, q, w):
    ring, q0 = ring_case(n, q, 7 * n + w)
    got = tfp._ring_window_torch(torch.from_numpy(ring),
                                 torch.from_numpy(q0), w)
    want = jfp._rotate_rows_pallas(jnp.asarray(ring), jnp.asarray(q0), w,
                                   interpret=True)
    assert_np_equal("window", got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [1, 4, 9, 100])
def test_ring_window_on_state_matches_jax(m):
    """``ring_window(state, m)``: both rings, ``w = min(m, Q)``."""
    arrays = random_state(21, 90, 9)
    got = tfp.ring_window(to_torch(arrays), m)
    want = jfp.ring_window(to_jax(arrays), m, use_pallas=False)
    for f in ("arr", "cost", "q0"):
        assert_np_equal(f, getattr(got, f).numpy(),
                        np.asarray(getattr(want, f)))


@pytest.mark.parametrize("depth", [1, 3])
def test_window_rows_match_jax(depth):
    """The rows a batch reads after some clients consumed part of the
    window, including offsets past its end."""
    arrays = random_state(22, 60, 11)
    jst, tst = to_jax(arrays), to_torch(arrays)
    jwin = jfp.ring_window(jst, 5, use_pallas=False)
    twin = tfp.ring_window(tst, 5)
    adv = np.random.default_rng(3).integers(0, 11, 60).astype(np.int32)
    q1 = ((arrays["q_head"] + adv) % 11).astype(np.int32)
    jst = jst._replace(q_head=jnp.asarray(q1))
    tst = tst._replace(q_head=torch.from_numpy(q1))
    ja, jc = jfp._window_rows(jst, jwin, depth)
    ta, tc = tfp._window_rows(tst, twin, depth)
    for d in range(depth):
        assert_np_equal(f"arr{d}", ta[d].numpy(), np.asarray(ja[d]))
        assert_np_equal(f"cost{d}", tc[d].numpy(), np.asarray(jc[d]))


def test_wrapper_rejects_bad_inputs():
    ring = torch.zeros((4, 8), dtype=torch.int64)
    q0 = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError):
        tfp.ring_window_rows(ring.to(torch.int32), ring, q0, 2)
    with pytest.raises(TypeError):
        tfp.ring_window_rows(ring, ring, q0.to(torch.int64), 2)
    with pytest.raises(ValueError):
        tfp.ring_window_rows(ring, ring[:3], q0, 2)
    with pytest.raises(ValueError):
        tfp.ring_window_rows(ring, ring, q0, 9)


def test_cpu_window_does_not_count_a_launch():
    before = dict(_ext.LAUNCHES)
    ring = torch.arange(24, dtype=torch.int64).reshape(3, 8)
    tfp.ring_window_rows(ring, ring, torch.tensor([0, 3, 7],
                                                  dtype=torch.int32), 4)
    assert _ext.LAUNCHES == before
