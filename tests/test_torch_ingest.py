"""The port's superwave ingest, admission clamp and cfg4 set-up against
the JAX package and ``bench.py``, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from dmclock_tpu.engine import kernels as jk
from dmclock_tpu.obs import device as jobs
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.obs import device as tobs

from test_torch_support import (S, assert_np_equal, assert_state_matches,
                                random_state, to_jax, to_torch)


def _superwave_inputs(arrays, seed, waves, t0):
    """Arrival counts within ring headroom (the caller contract), with
    some clients receiving nothing, and per-client cost/rho/delta."""
    rng = np.random.default_rng(seed)
    n, q = arrays["q_arrival"].shape
    headroom = np.maximum(q - arrays["depth"], 0)
    counts = np.minimum(rng.integers(0, waves + 1, n), headroom)
    counts[rng.random(n) < 0.3] = 0
    wave_times = t0 + np.arange(waves, dtype=np.int64) * (S // 100)
    return (counts.astype(np.int32), wave_times,
            rng.integers(1, 4, n).astype(np.int64),
            rng.integers(1, 3, n).astype(np.int64),
            rng.integers(1, 3, n).astype(np.int64))


def _arrays_with_edge_clients(seed, n, q):
    """random_state plus the edge cases: empty non-requesting clients
    (base = -1 before the floor-mod), idle clients, rings read from the
    last slot (writes wrap), and one full ring."""
    a = random_state(seed, n, q, max_depth=q - 2)
    a["depth"][:6] = 0
    a["idle"][2:10] = True
    a["active"][2:10] = True
    a["q_head"][10:20] = q - 1
    a["depth"][20] = q
    return a


@pytest.mark.parametrize("seed, n, q, waves, anticipation_ns", [
    (1, 64, 16, 8, 0), (2, 100, 16, 16, 0), (3, 48, 32, 8, S // 50),
    (4, 130, 8, 8, 0)])
def test_ingest_superwave_matches_jax(seed, n, q, waves, anticipation_ns):
    arrays = _arrays_with_edge_clients(seed, n, q)
    counts, wt, cost, rho, delta = _superwave_inputs(arrays, seed, waves,
                                                     50 * S)
    assert (counts > 0).any() and ((arrays["depth"] == 0)
                                   & (counts == 0)).any()
    want = jk.ingest_superwave(to_jax(arrays), *map(jnp.asarray, (
        counts, wt, cost, rho, delta)), anticipation_ns=anticipation_ns)
    got = tk.ingest_superwave(to_torch(arrays), *map(torch.from_numpy, (
        counts, wt, cost, rho, delta)), anticipation_ns=anticipation_ns)
    assert_state_matches(got, want)


def test_ingest_superwave_reactivation_matches_jax():
    """Idle clients that receive arrivals while others are busy shift
    their proportion tags (idle reactivation at wave 0); and with every
    client idle, nobody shifts."""
    arrays = random_state(9, 40, 16, max_depth=4)
    arrays["active"][:] = True
    arrays["idle"][:] = False
    arrays["idle"][::4] = True
    for all_idle in (False, True):
        if all_idle:
            arrays["idle"][:] = True
        counts, wt, cost, rho, delta = _superwave_inputs(arrays, 9, 8,
                                                         60 * S)
        counts[::4] = 3
        want = jk.ingest_superwave(to_jax(arrays), *map(jnp.asarray, (
            counts, wt, cost, rho, delta)), anticipation_ns=0)
        got = tk.ingest_superwave(to_torch(arrays), *map(torch.from_numpy, (
            counts, wt, cost, rho, delta)), anticipation_ns=0)
        assert_state_matches(got, want)
        shifted = got.prop_delta.numpy() != arrays["prop_delta"]
        assert shifted.any() != all_idle


def test_admission_clamp_matches_jax():
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 65, 1000).astype(np.int32)
    headroom = rng.integers(0, 80, 1000).astype(np.int32)
    got = tobs.admission_clamp(torch.from_numpy(counts),
                               torch.from_numpy(headroom))
    want = jobs.admission_clamp(jnp.asarray(counts), jnp.asarray(headroom))
    for name, g, w in zip(("clamped", "dropped"), got, want):
        assert_np_equal(name, g.numpy(), np.asarray(w))
    assert int(got[1]) > 0


@pytest.mark.parametrize("n", [1, 10, 1000, 100_000])
def test_zipf_weights_match_bench(n):
    assert_np_equal("weights", tserve._zipf_weights(n),
                    bench._zipf_weights(n))


@pytest.mark.parametrize("n, ring, depth0", [(50, 16, 8), (129, 32, 31)])
def test_sustained_setup_matches_bench(n, ring, depth0):
    weights = bench._zipf_weights(n)
    rates = np.full(n, 1200.0)
    rates[::7] = 0.0
    weights[3::11] = 0.0
    got = tserve._sustained_setup(n, ring, depth0, rates, weights,
                                  device="cpu")
    want = bench._sustained_setup(n, ring, depth0, rates, weights)
    assert_state_matches(got, want)


def test_cfg4_setup_shape():
    """The cfg4 set-up at a small width: bench's state at the cfg4 ring
    and depth before calibration, and after it one int32 draw per timed
    round, clipped to the waves, from the 11 calibration rounds' end."""
    n, rounds = 128, 3
    c = tserve.CFG4
    want = bench._sustained_setup(n, c["ring"], c["depth0"],
                                  np.full(n, c["resv_rate"]),
                                  bench._zipf_weights(n))
    assert_state_matches(tserve.sustained_start("cfg4", n, device="cpu"),
                         want)
    prep = tserve.cfg4_setup(n, rounds, device="cpu")
    draws = prep.draws
    assert prep.cal_rounds == 11 and prep.t0 == 11 * c["dt_round_ns"]
    assert draws.shape == (rounds, n) and draws.dtype == torch.int32
    assert 0 <= int(draws.min()) and int(draws.max()) <= c["waves"]
    assert not torch.equal(draws[0], draws[1])
