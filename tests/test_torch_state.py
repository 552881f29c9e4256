"""The port's engine state and numpy bridge against the JAX package."""

import numpy as np
import pytest

from dmclock_tpu.engine import state as jstate
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import state as tstate

from test_torch_support import (assert_state_matches, random_state,
                                to_jax)


@pytest.mark.parametrize("n, q", [(1, 1), (7, 16), (64, 320)])
def test_init_state_matches_jax(n, q):
    st = tstate.init_state(n, q, device="cpu")
    assert st.capacity == n and st.ring_capacity == q
    assert_state_matches(st, jstate.init_state(n, q))


def test_state_tables_match_jax():
    assert tstate.EngineState._fields == jstate.EngineState._fields
    assert len(tstate.EngineState._fields) == 24
    assert tstate.TAG_I64_FIELDS == jstate.TAG_I64_FIELDS
    assert tstate._FRESH_FILLS == jstate._FRESH_FILLS


@pytest.mark.parametrize("old, new", [(5, 5), (5, 13), (32, 64)])
def test_grow_state_matches_jax(old, new):
    arrays = random_state(11 + old, old, 8)
    grown = tstate.grow_state(bridge.state_from_numpy(arrays, "cpu"), new)
    assert grown.capacity == new
    assert_state_matches(grown, jstate.grow_state(to_jax(arrays), new))


def test_grow_state_refuses_to_shrink():
    st = tstate.init_state(8, 4, device="cpu")
    with pytest.raises(ValueError, match="cannot shrink"):
        tstate.grow_state(st, 7)


def test_bridge_round_trip_keeps_dtypes():
    arrays = random_state(3, 40, 12)
    st = bridge.state_from_numpy(arrays, device="cpu")
    for f in tstate.EngineState._fields:
        assert getattr(st, f).dtype == tstate.FIELD_DTYPES[f], f
    back = bridge.state_to_numpy(st)
    for f, a in arrays.items():
        assert back[f].dtype == a.dtype, f
        assert np.array_equal(back[f], a), f
    assert_state_matches(st, to_jax(arrays))


def test_bridge_rejects_wrong_fields_and_dtypes():
    arrays = random_state(4, 8, 4)
    bad = dict(arrays, depth=arrays["depth"].astype(np.int64))
    with pytest.raises(ValueError, match="depth"):
        bridge.state_from_numpy(bad, device="cpu")
    missing = {f: a for f, a in arrays.items() if f != "q_cost"}
    with pytest.raises(ValueError, match="q_cost"):
        bridge.state_from_numpy(missing, device="cpu")
