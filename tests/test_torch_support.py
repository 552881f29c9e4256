"""Shared inputs for the PyTorch port's differential tests (no tests of
its own).

Every comparison hands the same numpy arrays to the JAX package and to
``dmclock_tpu_torch`` on the CPU and demands exact equality: all the
arithmetic is int64 nanoseconds, so there is no tolerance to state.
"""

import jax
import numpy as np

from dmclock_tpu.engine.state import EngineState as JaxState
from dmclock_tpu_torch.core.timebase import MAX_TAG, MIN_TAG
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine.state import EngineState

S = 1_000_000_000


def jax_to_np(state) -> dict:
    """A JAX ``EngineState`` (or any NamedTuple of arrays) as numpy."""
    return {f: np.asarray(jax.device_get(v))
            for f, v in zip(state._fields, state)}


def to_torch(state_or_arrays):
    """A JAX state or a dict of numpy arrays as the port's CPU state."""
    arrays = state_or_arrays
    if isinstance(arrays, JaxState):
        arrays = jax_to_np(arrays)
    return bridge.state_from_numpy(arrays, device="cpu")


def to_jax(arrays: dict) -> JaxState:
    import jax.numpy as jnp

    return JaxState(**{f: jnp.asarray(arrays[f])
                       for f in JaxState._fields})


def assert_np_equal(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{name} differs:\n{a}\nvs\n{b}"


def assert_state_matches(torch_state: EngineState, jax_state):
    """Field by field, dtype and value, through the bridge."""
    got = bridge.state_to_numpy(torch_state)
    want = jax_to_np(jax_state)
    for f in EngineState._fields:
        assert_np_equal(f, got[f], want[f])


def assert_tuple_matches(torch_tuple, jax_tuple, fields=None):
    """Equal NamedTuples (e.g. ``Decision``), field by field; torch
    tensors are compared as numpy."""
    for f in fields or torch_tuple._fields:
        t = getattr(torch_tuple, f)
        assert_np_equal(f, t.detach().cpu().numpy(),
                        jax.device_get(getattr(jax_tuple, f)))


def random_state(seed: int, n: int, q: int, *, now: int = 50 * S,
                 max_depth: int = 6, spread: int = S) -> dict:
    """An arbitrary (not necessarily reachable) engine state as numpy:
    tags scattered around ``now`` so every class, the sentinels
    (disabled axes) and the ring wrap all occur.  Creation orders are a
    permutation, so packed sort keys stay unique among candidates."""
    rng = np.random.default_rng(seed)
    i64 = np.int64

    def around(size):
        return (now + rng.integers(-spread, spread, size)).astype(i64)

    resv_inv = np.where(rng.random(n) < 0.3, 0,
                        rng.integers(10**6, 10**9, n)).astype(i64)
    weight_inv = rng.integers(10**6, 10**9, n).astype(i64)
    limit_inv = np.where(rng.random(n) < 0.5, 0,
                         rng.integers(10**6, 10**9, n)).astype(i64)
    head_limit = np.where(limit_inv == 0, MIN_TAG, around(n)).astype(i64)
    return dict(
        active=rng.random(n) < 0.9,
        idle=rng.random(n) < 0.1,
        order=(rng.permutation(n) + 1000).astype(i64),
        resv_inv=resv_inv, weight_inv=weight_inv, limit_inv=limit_inv,
        prop_delta=rng.integers(0, spread // 4, n).astype(i64),
        prev_resv=around(n), prev_prop=around(n), prev_limit=around(n),
        prev_arrival=around(n),
        cur_rho=rng.integers(1, 4, n).astype(i64),
        cur_delta=rng.integers(1, 5, n).astype(i64),
        head_resv=np.where(resv_inv == 0, MAX_TAG, around(n)).astype(i64),
        head_prop=around(n),
        head_limit=head_limit,
        head_arrival=around(n),
        head_cost=rng.integers(1, 4, n).astype(i64),
        head_rho=rng.integers(1, 4, n).astype(i64),
        head_ready=rng.random(n) < 0.3,
        depth=rng.integers(0, max_depth + 1, n).astype(np.int32),
        q_head=rng.integers(0, q, n).astype(np.int32),
        q_arrival=around((n, q)),
        q_cost=rng.integers(1, 4, (n, q)).astype(i64),
    )
