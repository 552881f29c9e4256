"""The port's ``ingest`` (one fixed-shape dense pass), ``ingest_wave``,
``mark_idle`` and ``deactivate`` against the JAX package's, exactly:
the same numpy state and op rows go to both, and the whole
``EngineState`` is compared field by field through the bridge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import kernels as jk
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.engine.state import init_state
from dmclock_tpu_torch.engine import bridge

from test_torch_support import (S, assert_state_matches, random_state,
                                to_jax, to_torch)


def _batch(rng, arrays, b, *, p_create=0.1, p_nop=0.1, recreate=False,
           t0=50 * S):
    """``b`` op rows against ``arrays``: creates on inactive slots (some
    recycled: deactivated with stale fields), adds -- repeated slots,
    adds to idle slots anywhere in the batch, adds right after a create
    -- and NOP rows; with ``recreate``, creates of slots that already
    have rows in the batch.  No queue grows past the ring."""
    n, q = arrays["q_arrival"].shape
    depth = arrays["depth"].astype(np.int64).copy()
    active = arrays["active"].copy()
    seen = set()
    rows = []
    t = t0
    for i in range(b):
        t += int(rng.integers(0, S // 20))
        u = rng.random()
        inactive = np.flatnonzero(~active)
        if u < p_nop:
            rows.append((tk.OP_NOP, 0, 0, 0, 0, 0, 0, 0, 0, 0))
            continue
        if u < p_nop + p_create and (inactive.size or recreate):
            pool = inactive if inactive.size and not (
                recreate and seen and rng.random() < 0.5) \
                else np.asarray(sorted(seen))
            s = int(rng.choice(pool))
            winv = 0 if rng.random() < 0.15 else int(
                rng.integers(10**6, 10**9))
            rows.append((tk.OP_CREATE, s, 0, 0, 0, 0,
                         int(rng.integers(0, 10**9)) * (rng.random() < 0.7),
                         winv if winv or rng.random() < 0.5 else 10**8,
                         int(rng.integers(0, 10**9)) * (rng.random() < 0.4),
                         1000 + n + i))
            active[s] = True
            depth[s] = 0
            seen.add(s)
            continue
        room = np.flatnonzero(depth < q)
        s = int(rng.choice(room))
        delta = int(rng.integers(1, 5))
        rows.append((tk.OP_ADD, s, t, int(rng.integers(1, 4)),
                     int(rng.integers(1, delta + 1)), delta, 0, 0, 0, 0))
        depth[s] += 1
        seen.add(s)
    return np.asarray(rows, dtype=np.int64).T


def _jax_ops(rows):
    return jk.IngestOps(
        kind=jnp.asarray(rows[0], jnp.int32),
        slot=jnp.asarray(rows[1], jnp.int32),
        **{f: jnp.asarray(rows[i]) for i, f in enumerate(
            jk.IngestOps._fields[2:], start=2)})


def _both_ingest(arrays, rows, ant):
    want = jk.ingest(to_jax(arrays), _jax_ops(rows), anticipation_ns=ant)
    got = tk.ingest(to_torch(arrays), tk.IngestOps(*rows),
                    anticipation_ns=ant)
    return got, want


@pytest.mark.parametrize("seed, n, q, b, ant", [
    (1, 24, 8, 60, 0), (2, 40, 8, 120, 0), (3, 16, 16, 80, S // 50),
    (4, 64, 8, 200, 0), (5, 12, 32, 150, S // 10)])
def test_ingest_matches_jax(seed, n, q, b, ant):
    rng = np.random.default_rng(seed)
    arrays = random_state(seed, n, q, max_depth=q // 2)
    arrays["idle"][rng.random(n) < 0.3] = True
    arrays["depth"][rng.random(n) < 0.3] = 0
    rows = _batch(rng, arrays, b)
    kinds = rows[0]
    assert (kinds == tk.OP_CREATE).any() and (kinds == tk.OP_NOP).any()
    adds = rows[1][kinds == tk.OP_ADD]
    assert len(set(adds.tolist())) < adds.size, "no repeated slot"
    got, want = _both_ingest(arrays, rows, ant)
    assert_state_matches(got, want)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_ingest_recreated_slots_split_segments(seed):
    """A slot re-created after rows of its own in the same batch starts a
    new segment of the host's count (``ingest_segments``); the one
    device pass still equals the scan."""
    rng = np.random.default_rng(seed)
    arrays = random_state(seed, 20, 8, max_depth=3)
    rows = _batch(rng, arrays, 120, p_create=0.2, recreate=True)
    segs = tk.ingest_segments(rows[0], rows[1])
    assert len(segs) > 1
    assert segs[0][0] == 0 and segs[-1][1] == rows.shape[1]
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    got, want = _both_ingest(arrays, rows, 0)
    assert_state_matches(got, want)


@pytest.mark.parametrize("seed, weightless", [(21, False), (22, True),
                                              (23, False)])
def test_ingest_bulk_load_of_new_clients(seed, weightless):
    """The queue's bulk load: a fresh state, creates interleaved with
    adds, every first add a reactivation that reads the clients created
    before it (one long recurrence in one segment).  ``weightless``
    gives some clients no weight, so ``lowest`` can sit past the
    trigger and the shift is skipped."""
    rng = np.random.default_rng(seed)
    n, q = 48, 8
    arrays = bridge.state_to_numpy(init_state(n, q, device="cpu"))
    rows, t, nxt = [], S, 0
    for i in range(300):
        t += int(rng.integers(0, S // 50))
        if nxt < 40 and (nxt == 0 or rng.random() < 0.3):
            w = 0 if weightless and rng.random() < 0.6 else int(
                rng.integers(10**6, 10**9))
            rows.append((tk.OP_CREATE, nxt, 0, 0, 0, 0,
                         int(rng.integers(10**6, 10**9)), w, 0, nxt))
            nxt += 1
            continue
        s = int(rng.integers(0, nxt))
        if sum(1 for r in rows if r[0] == tk.OP_ADD and r[1] == s) >= q:
            continue
        rows.append((tk.OP_ADD, s, t, 1, 1, 1, 0, 0, 0, 0))
    rows = np.asarray(rows, dtype=np.int64).T
    assert tk.ingest_segments(rows[0], rows[1]) == [(0, rows.shape[1])]
    got, want = _both_ingest(arrays, rows, 0)
    assert_state_matches(got, want)


def test_ingest_leaves_its_input_state_untouched():
    rng = np.random.default_rng(31)
    arrays = random_state(31, 16, 8, max_depth=4)
    rows = _batch(rng, arrays, 40)
    st = to_torch(arrays)
    keep = [t.clone() for t in st]
    tk.ingest(st, tk.IngestOps(*rows), anticipation_ns=0)
    for f, a, b in zip(st._fields, st, keep):
        assert torch.equal(a, b), f"ingest wrote {f} in place"


def test_ingest_of_nothing_returns_the_state():
    st = to_torch(random_state(32, 8, 4))
    nops = np.zeros((10, 5), dtype=np.int64)
    assert tk.ingest_segments(nops[0], nops[1]) == []
    assert tk.ingest(st, tk.IngestOps(*nops), anticipation_ns=0) is st


@pytest.mark.parametrize("seed, per_client_time", [(41, False),
                                                   (42, True), (43, False)])
def test_ingest_wave_matches_jax(seed, per_client_time):
    rng = np.random.default_rng(seed)
    n, q = 40, 8
    arrays = random_state(seed, n, q, max_depth=q - 1)
    arrays["idle"][rng.random(n) < 0.3] = True
    arrays["depth"][rng.random(n) < 0.3] = 0
    arrays["q_head"][:5] = q - 1
    req = rng.random(n) < 0.6
    t = (50 * S + rng.integers(0, S, n)).astype(np.int64) \
        if per_client_time else np.int64(50 * S)
    cost = rng.integers(1, 4, n).astype(np.int64)
    delta = rng.integers(1, 5, n).astype(np.int64)
    rho = np.minimum(rng.integers(1, 5, n), delta).astype(np.int64)
    want = jk.ingest_wave(to_jax(arrays), jnp.asarray(req), jnp.asarray(t),
                          jnp.asarray(cost), jnp.asarray(rho),
                          jnp.asarray(delta), anticipation_ns=S // 100)
    got = tk.ingest_wave(to_torch(arrays), torch.from_numpy(req),
                         torch.from_numpy(np.asarray(t))
                         if per_client_time else int(t),
                         *map(torch.from_numpy, (cost, rho, delta)),
                         anticipation_ns=S // 100)
    assert_state_matches(got, want)


@pytest.mark.parametrize("slots", [[3, 0, 7], [], [5, 5, 1]])
def test_mark_idle_and_deactivate_match_jax(slots):
    arrays = random_state(51, 12, 4)
    js = jnp.asarray(slots, dtype=jnp.int32)
    for jf, tf in ((jk.mark_idle, tk.mark_idle),
                   (jk.deactivate, tk.deactivate)):
        st = to_torch(arrays)
        got = tf(st, np.asarray(slots, dtype=np.int64))
        assert_state_matches(got, jf(to_jax(arrays), js))
        assert_state_matches(st, to_jax(arrays))     # out of place
