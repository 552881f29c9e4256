"""The lifecycle plane's three programs against the JAX package's jit
caches, with the same seeded numpy inputs: ``apply_op_vector`` as
``_OPS_JIT[(capacity, ring capacity, rows)]`` (register, update, evict
and idle rows in one boundary, NOP padding), ``compact_tree`` as
``_COMPACT_JIT["take"]`` (one capture a tree structure and shape, as
JAX traces one), the serial churn runner's leg as ``_RUN_JIT[steps]``
(``kernels.serial_leg``), ``run_serial_churn``'s digest, decisions and
plane counters, and ``inplace=True`` pinned as eager.  Then ROADMAP
§3's check of cfg4 at m = 2: one closed-loop cfg4 round at m = 2 and
one at m = 3 in both packages (minstop, cfg4's 64 steps) from the same
state and draws, the decisions and committed counts equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmclock_tpu.lifecycle as JL
import dmclock_tpu.lifecycle.plane as JPL
import dmclock_tpu.lifecycle.runner as JRN
import dmclock_tpu.lifecycle.slots as JSL
import dmclock_tpu_torch.lifecycle as TL
import dmclock_tpu_torch.lifecycle.plane as TPL
import dmclock_tpu_torch.lifecycle.slots as TSL
from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.obs import device as jobs
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import kernels as tk

from test_torch_support import (assert_np_equal, assert_state_matches,
                                assert_tuple_matches, random_state, to_jax,
                                to_torch)

# one boundary's rows: register then update of slot 2, an evict of slot
# 5, an idle mark of slot 7, an update of slot 1, a register of the
# evicted slot 5, and NOP padding to 8 (kind, slot, r, w, l, order)
ROWS = [(1, 2, 11, 12, 13, 40), (2, 2, 21, 22, 23, 0), (3, 5, 0, 0, 0, 0),
        (4, 7, 0, 0, 0, 0), (2, 1, 31, 32, 33, 0), (1, 5, 41, 42, 43, 41),
        (0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0)]


def _cols(rows):
    a = np.asarray(rows, dtype=np.int64)
    return (a[:, 0].astype(np.int32), a[:, 1].astype(np.int32), a[:, 2],
            a[:, 3], a[:, 4], a[:, 5])


def test_ops_program_equals_the_jax_ops_jit():
    """Every kind in one boundary and the NOP padding, then another
    boundary of the same length: equal to the JAX scan, one program
    under the JAX key that traced once."""
    arrays = random_state(21, 12, 6)
    key = (12, 6, len(ROWS))
    jstate, tstate = to_jax(arrays), to_torch(arrays)
    rng = np.random.default_rng(3)
    for rows in (ROWS, [(int(rng.integers(1, 5)), int(rng.integers(12)),
                         *rng.integers(1, 10 ** 6, 3).tolist(), 7)
                        for _ in range(len(ROWS))]):
        jstate = JPL.apply_op_vector(jstate, *_cols(rows))
        tstate = TPL.apply_op_vector(tstate, *_cols(rows))
        assert_state_matches(tstate, jstate)
    assert key in JPL._OPS_JIT and key in TPL._OPS_JIT
    prog = TPL._OPS_JIT[key]
    assert prog.cache == "lifecycle.ops" and prog.record is False
    assert len(prog._programs) == 1 == JPL._OPS_JIT[key]._cache_size()


def test_inplace_op_vector_stays_eager():
    """``inplace=True`` (the migration's write into a stacked mesh
    state's shard views) writes the state's own tensors, builds no
    program, and equals the JAX scan."""
    arrays = random_state(22, 12, 6)
    tstate = to_torch(arrays)
    held = dict(TPL._OPS_JIT)
    ptrs = [t.data_ptr() for t in tstate]
    got = TPL.apply_op_vector(tstate, *_cols(ROWS[:6]), inplace=True)
    assert TPL._OPS_JIT == held
    assert all(a is b for a, b in zip(got, tstate))
    assert [t.data_ptr() for t in got] == ptrs
    assert_state_matches(got, JPL.apply_op_vector(to_jax(arrays),
                                                  *_cols(ROWS[:6])))


def test_compact_program_equals_the_jax_take():
    """Two tree structures (the state alone; the state with a ledger and
    an int32 extra): each equal to the JAX ``take``, each one capture of
    the ``take`` program as each is one JAX trace."""
    arrays = random_state(23, 10, 4)
    rng = np.random.default_rng(4)
    led = rng.integers(0, 99, (10, 5)).astype(np.int64)
    extra = rng.integers(0, 99, (10, 3)).astype(np.int32)
    perm = rng.permutation(10)
    trees = [((to_jax(arrays),), (to_torch(arrays),)),
             ((to_jax(arrays), jnp.asarray(led), jnp.asarray(extra)),
              (to_torch(arrays), torch.from_numpy(led),
               torch.from_numpy(extra)))]
    JSL.compact_tree(trees[0][0], perm)     # the JAX cache exists
    j0 = JSL._COMPACT_JIT["take"]._cache_size()
    t0 = len(TSL._COMPACT_JIT["take"]._programs) \
        if "take" in TSL._COMPACT_JIT else 0
    for jt, tt in trees:
        want = JSL.compact_tree(jt, perm)
        got = TSL.compact_tree(tt, perm)
        assert_state_matches(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            assert_np_equal("leaf", g.numpy(), np.asarray(w))
    prog = TSL._COMPACT_JIT["take"]
    assert prog.cache == "lifecycle.compact" and prog.record is False
    grown = len(prog._programs) - t0
    assert grown == 2 and JSL._COMPACT_JIT["take"]._cache_size() - j0 in \
        (1, 2)


def test_run_leg_equals_the_jax_run_jit():
    """The runner's serial leg (``kernels.serial_leg(steps)``) equals
    the JAX runner's ``_RUN_JIT[steps]`` on a seeded state: the state,
    the clock and every decision."""
    arrays = random_state(24, 16, 8)
    now = 60 * 10 ** 9
    want = JRN._jit_run(16)(to_jax(arrays), np.int64(now))
    got = tk.serial_leg(16, allow_limit_break=False,
                        anticipation_ns=0)(to_torch(arrays), now)
    assert_state_matches(got[0], want[0])
    assert int(got[1]) == int(want[1])
    assert_tuple_matches(got[2], want[2])
    assert int((got[2].type == tk.RETURNING).sum()) > 0
    assert 16 in JRN._RUN_JIT
    assert (16, False, 0, False, False, False) in tk._SERIAL_LEGS


def test_serial_churn_equals_the_jax_runner():
    """``run_serial_churn`` through the serial leg: the digest (the
    decision stream in client-id space), the decisions and the plane's
    counters equal the JAX runner's."""
    spec = JL.make_spec("churn_storm", total_ids=12, base_lam=1.5,
                        compact_every=2)
    d_jax, jplane, n_jax = JL.run_serial_churn(spec, epochs=10, every=2)
    d_port, plane, n_port = TL.run_serial_churn(spec, epochs=10, every=2,
                                                device="cpu")
    assert d_port == d_jax and n_port == n_jax > 0
    assert plane.counters == jplane.counters


def _bench_round(*, m, steps, ladder_levels, waves, dt_round_ns):
    """The body of ``bench.bench_sustained``'s ``round_fn`` on its
    calendar branch (admission clamp, superwave ingest of unit costs,
    ``m`` calendar batches, the drops folded into the metrics), jitted
    as bench jits it."""
    def round_fn(st, counts, t_base):
        headroom = jnp.maximum(st.ring_capacity - st.depth,
                               0).astype(jnp.int32)
        counts, dropped = jobs.admission_clamp(counts, headroom)
        wave_times = t_base + jnp.arange(waves, dtype=jnp.int64) \
            * (dt_round_ns // waves)
        ones = jnp.ones((st.capacity,), jnp.int64)
        st = jk.ingest_superwave(st, counts, wave_times, ones, ones, ones,
                                 anticipation_ns=0)
        ep = jfp.scan_calendar_epoch(
            st, t_base + dt_round_ns, m, steps=steps, anticipation_ns=0,
            with_metrics=True, calendar_impl="minstop",
            ladder_levels=ladder_levels)
        return ep, jobs.metrics_combine(
            ep.metrics, jobs.metrics_delta(ingest_drops=dropped))

    return jax.jit(functools.partial(round_fn))


@pytest.mark.parametrize("m", [2, 3])
def test_cfg4_round_at_m_equals_bench(m):
    """ROADMAP §3's check: one cfg4 round (minstop, cfg4's 64 steps and
    64 waves, ring 128 preloaded 64, Zipf weights, reservations) at m =
    2 and at m = 3 from the same state and draws in both packages: the
    committed counts a batch, the per-client decisions, the metrics and
    the state equal.  At m = 2 the round commits fewer decisions than
    at m = 3 in both alike: the engine's, not the port's."""
    c = tserve.CFG4
    n = 256
    weights = tserve._zipf_weights(n)
    rates = np.full(n, c["resv_rate"])
    import bench

    jstate = bench._sustained_setup(n, c["ring"], c["depth0"], rates,
                                    weights)
    st = tserve._sustained_setup(n, c["ring"], c["depth0"], rates, weights,
                                 device="cpu")
    assert_state_matches(st, jstate)
    counts = np.minimum(np.random.default_rng(11).poisson(40.0, n),
                        c["waves"] - 1).astype(np.int32)
    kw = dict(m=m, steps=c["steps"], ladder_levels=c["ladder_levels"],
              waves=c["waves"], dt_round_ns=c["dt_round_ns"])
    want, want_met = _bench_round(**kw)(
        jstate, jnp.asarray(counts), jnp.int64(0))
    got = tserve.calendar_round(st, torch.from_numpy(counts), 0,
                                calendar_impl="minstop", **kw)
    assert_tuple_matches(got, want, fields=[
        "count", "resv_count", "progress_ok", "served"])
    assert_np_equal("metrics", got.metrics.numpy(), np.asarray(want_met))
    assert_state_matches(got.state, want.state)
    committed = int(got.count.sum())
    assert committed == int(np.asarray(want.count).sum()) > 0
    _COMMITTED[m] = committed
    if len(_COMMITTED) == 2:
        assert _COMMITTED[2] < _COMMITTED[3]


_COMMITTED: dict = {}
