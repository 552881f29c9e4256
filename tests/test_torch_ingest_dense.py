"""The port's fixed-shape device ingest (``kernels.ingest`` through
``_ingest_dense``) and kernel K3's plain version (``ingest_scan``)
against the JAX package's ``ingest`` scan, exactly.

The same numpy state and op rows go to both packages and the whole
``EngineState`` is compared field by field: several adds to one slot,
slots re-created in the batch (stale ring cells left behind, a
reactivation before and after the re-create), reactivations with the
lowest tag on both sides of ``LOWEST_PROP_TAG_TRIGGER``, tags at the
int64 edge, ring wraparound, all-NOP and NOP-padded batches, and a
cluster wave in which every one of 10,000 clients reactivates; then a
hypothesis property over all of it.  K3's plain version is held to the
host loop the ingest ran before it (copied here) and to a direct
simulation of the scheduling set, and the pass is checked to hold no
data-dependent operation (nothing that would read the card back).
K3 itself runs in ``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from dmclock_tpu.engine import kernels as jk
from dmclock_tpu_torch.core.timebase import (LOWEST_PROP_TAG_TRIGGER,
                                             MAX_TAG)
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.engine.state import init_state

from test_torch_support import (S, assert_state_matches, random_state,
                                to_jax, to_torch)

OPS = (tk.OP_NOP, tk.OP_ADD, tk.OP_CREATE)


def _rows(rng, arrays, b, *, p_nop=0.1, p_create=0.1, t0=50 * S,
          slots=None):
    """``b`` op rows against ``arrays``: adds (repeated slots, idle
    slots, adds right after a create), creates of any slot -- inactive,
    active, or one with rows earlier in the batch (a re-create) -- and
    NOP rows.  No queue grows past the ring.  ``slots`` limits the
    slots the rows touch."""
    n, q = arrays["q_arrival"].shape
    depth = arrays["depth"].astype(np.int64).copy()
    pool = np.arange(n) if slots is None else np.asarray(slots)
    rows, t = [], t0
    for i in range(b):
        t += int(rng.integers(0, S // 20))
        u = rng.random()
        if u < p_nop:
            rows.append((tk.OP_NOP, int(rng.integers(0, n)), 0, 0, 0, 0, 0,
                         0, 0, 0))
            continue
        s = int(rng.choice(pool))
        if u < p_nop + p_create or depth[s] >= q:
            winv = 0 if rng.random() < 0.15 else int(
                rng.integers(10**6, 10**9))
            rows.append((tk.OP_CREATE, s, 0, 0, 0, 0,
                         int(rng.integers(0, 10**9)) * (rng.random() < 0.7),
                         winv,
                         int(rng.integers(0, 10**9)) * (rng.random() < 0.4),
                         1000 + n + i))
            depth[s] = 0
            continue
        delta = int(rng.integers(1, 5))
        rows.append((tk.OP_ADD, s, t, int(rng.integers(1, 4)),
                     int(rng.integers(1, delta + 1)), delta, 0, 0, 0, 0))
        depth[s] += 1
    return np.asarray(rows, dtype=np.int64).reshape(-1, 10).T.copy()


def _jax_ops(rows):
    return jk.IngestOps(
        kind=jnp.asarray(rows[0], jnp.int32),
        slot=jnp.asarray(rows[1], jnp.int32),
        **{f: jnp.asarray(rows[i]) for i, f in enumerate(
            jk.IngestOps._fields[2:], start=2)})


def _check(arrays, rows, ant=0, packed=True):
    """The port's ingest (of the packed tensor, or of the numpy rows)
    equals JAX's scan on every field."""
    want = jk.ingest(to_jax(arrays), _jax_ops(rows), anticipation_ns=ant)
    ops = torch.from_numpy(rows) if packed else tk.IngestOps(*rows)
    got = tk.ingest(to_torch(arrays), ops, anticipation_ns=ant)
    assert_state_matches(got, want)
    return got


def _state(seed, n, q, *, p_idle=0.3, p_empty=0.3, max_depth=None):
    rng = np.random.default_rng(seed + 7)
    arrays = random_state(seed, n, q, max_depth=max_depth or q // 2)
    arrays["idle"][rng.random(n) < p_idle] = True
    arrays["depth"][rng.random(n) < p_empty] = 0
    return arrays


# ----------------------------------------------------------------------
# the device ingest against the JAX scan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed, n, q, b, ant, p_create", [
    (1, 24, 8, 64, 0, 0.1), (2, 40, 8, 128, 0, 0.2),
    (3, 16, 16, 80, S // 50, 0.1), (4, 64, 8, 200, 0, 0.05),
    (5, 12, 32, 150, S // 10, 0.25), (6, 8, 4, 96, 0, 0.3)])
def test_dense_ingest_matches_jax(seed, n, q, b, ant, p_create):
    rng = np.random.default_rng(seed)
    arrays = _state(seed, n, q)
    rows = _rows(rng, arrays, b, p_create=p_create)
    assert len(tk.ingest_segments(rows[0], rows[1])) > 1 or p_create < 0.1
    _check(arrays, rows, ant)


@pytest.mark.parametrize("empty", [True, False], ids=["empty", "queued"])
def test_several_adds_to_one_slot(empty):
    """Eight adds to one slot: the first tags the head of an empty queue
    (or appends behind a queued one), the rest fill the ring in order."""
    arrays = _state(8, 6, 16)
    arrays["depth"][2] = 0 if empty else 3
    arrays["idle"][2] = False
    rows = np.asarray([(tk.OP_ADD, 2, 50 * S + i, 1 + i % 3, 1, 2, 0, 0, 0,
                        0) for i in range(8)], dtype=np.int64).T.copy()
    got = _check(arrays, rows)
    assert int(got.depth[2]) == arrays["depth"][2] + 8


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_recreated_slots_leave_stale_ring_cells(seed):
    """Slots created again after rows of their own in one batch, as the
    host's ``ingest_segments`` would split it: one pass equals the scan,
    the ring cells an earlier epoch wrote and a later one did not are
    left as the scan leaves them."""
    rng = np.random.default_rng(seed)
    arrays = _state(seed, 10, 8, max_depth=3)
    rows = _rows(rng, arrays, 120, p_create=0.25, slots=range(6))
    assert len(tk.ingest_segments(rows[0], rows[1])) > 2
    _check(arrays, rows)


def test_reactivation_before_and_after_a_recreate():
    """An idle client reactivates, joins the scheduling set, is created
    again (it leaves the set) and reactivates once more; a client
    reactivating in between sees it, one after the re-create does not."""
    arrays = _state(21, 6, 8, p_idle=0.0, p_empty=0.0)
    arrays["idle"][:] = [False, True, True, True, False, True]
    arrays["active"][:] = True
    arrays["prop_delta"][:] = 0
    arrays["head_prop"][:] = 60 * S
    arrays["head_prop"][0] = 70 * S
    t = 80 * S
    rows = np.asarray([
        (tk.OP_ADD, 1, t, 1, 1, 1, 0, 0, 0, 0),          # reactivates
        (tk.OP_ADD, 2, t + 1, 1, 1, 1, 0, 0, 0, 0),      # sees 1
        (tk.OP_CREATE, 1, 0, 0, 0, 0, 0, S, 0, 99),      # 1 leaves
        (tk.OP_ADD, 3, t + 2, 1, 1, 1, 0, 0, 0, 0),      # does not see 1
        (tk.OP_ADD, 1, t + 3, 1, 1, 1, 0, 0, 0, 0),      # reactivates again
        (tk.OP_ADD, 5, t + 4, 1, 1, 1, 0, 0, 0, 0),      # sees the new 1
    ], dtype=np.int64).T.copy()
    _check(arrays, rows)


@pytest.mark.parametrize("weightless", [False, True],
                         ids=["below_trigger", "above_trigger"])
def test_reactivation_on_both_sides_of_the_trigger(weightless):
    """Every scheduling client weightless (its proportion tag the
    MAX_TAG sentinel) puts ``lowest`` above ``LOWEST_PROP_TAG_TRIGGER``,
    so no shift; with weights it lies below and the idle clients shift."""
    n = 16
    arrays = _state(31, n, 8, p_idle=0.5, p_empty=0.5)
    if weightless:
        arrays["head_prop"][:] = MAX_TAG
        arrays["prev_prop"][:] = MAX_TAG
        arrays["prop_delta"][:] = 0
    rng = np.random.default_rng(31)
    rows = _rows(rng, arrays, 48, p_create=0.0, p_nop=0.0)
    got = _check(arrays, rows)
    eff = np.where(arrays["depth"] > 0, arrays["head_prop"],
                   arrays["prev_prop"]) + arrays["prop_delta"]
    sched = arrays["active"] & ~arrays["idle"]
    assert (eff[sched].min() >= LOWEST_PROP_TAG_TRIGGER) == weightless
    idle_hit = arrays["idle"] & np.isin(np.arange(n), rows[1])
    moved = bridge.state_to_numpy(got)["prop_delta"] != arrays["prop_delta"]
    assert moved[idle_hit].any() != weightless


@pytest.mark.parametrize("seed", [41, 42])
def test_tags_at_the_int64_edge_wrap(seed):
    """Effective tags near -2^63: ``lowest - t`` wraps past the bottom of
    int64, and the reactivated client's ``base + prop_delta`` wraps
    back; both packages wrap the same way."""
    rng = np.random.default_rng(seed)
    arrays = _state(seed, 12, 8, p_idle=0.5, p_empty=0.4)
    arrays["prop_delta"][:] = -(1 << 63) + 10**9 + \
        rng.integers(0, 10**6, 12)
    rows = _rows(rng, arrays, 40, p_create=0.05)
    got = bridge.state_to_numpy(_check(arrays, rows))
    react = arrays["idle"] & np.isin(np.arange(12), rows[1][rows[0] == 1])
    assert (got["prop_delta"][react] > 0).any()     # wrapped


def test_ring_wraparound():
    """Heads at the last ring cells: appends wrap to cell 0 on."""
    q = 8
    arrays = _state(51, 10, q, p_idle=0.1, p_empty=0.0, max_depth=3)
    arrays["q_head"][:] = q - 1
    arrays["depth"][:] = 2
    rng = np.random.default_rng(51)
    rows = _rows(rng, arrays, 40, p_create=0.0, p_nop=0.2)
    _check(arrays, rows)


@pytest.mark.parametrize("packed", [False, True], ids=["host", "tensor"])
def test_all_nop_batch(packed):
    """A batch of NOP rows changes nothing: a host batch returns the
    state itself, a device batch (whose content the host never reads)
    runs the pass and leaves every field as it was."""
    arrays = _state(61, 8, 4)
    nops = np.zeros((10, 8), dtype=np.int64)
    nops[1] = np.arange(8)
    st0 = to_torch(arrays)
    got = tk.ingest(st0, torch.from_numpy(nops) if packed
                    else tk.IngestOps(*nops), anticipation_ns=0)
    assert (got is st0) != packed
    assert_state_matches(got, to_jax(arrays))


def test_nop_padded_batch_equals_the_unpadded_one():
    """The queue pads its batches with NOP rows to a power of two: the
    padded batch equals the unpadded one and the scan."""
    rng = np.random.default_rng(71)
    arrays = _state(71, 20, 8)
    rows = _rows(rng, arrays, 37, p_nop=0.0)
    padded = np.zeros((10, 64), dtype=np.int64)
    padded[:, :37] = rows
    a = _check(arrays, padded)
    b = tk.ingest(to_torch(arrays), torch.from_numpy(rows),
                  anticipation_ns=0)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_tensor_columns_equal_the_packed_batch():
    rng = np.random.default_rng(72)
    arrays = _state(72, 20, 8)
    rows = _rows(rng, arrays, 50)
    a = tk.ingest(to_torch(arrays), tk.IngestOps(
        *(torch.from_numpy(r) for r in rows)), anticipation_ns=0)
    b = _check(arrays, rows)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_cluster_wave_of_10000_reactivations():
    """A cluster server's first wave: 10,000 clients installed and idle,
    every one sends a request at the same instant (one add a slot, in
    slot order), so every row reactivates and each one's ``lowest``
    reads the ones before it."""
    c = 10_000
    st0 = bridge.state_to_numpy(init_state(c, 4, device="cpu"))
    st0["active"][:] = True
    rng = np.random.default_rng(81)
    st0["weight_inv"][:] = rng.integers(10**6, 10**9, c)
    st0["resv_inv"][:] = np.where(rng.random(c) < 0.5, 0, 10**9)
    st0["order"][:] = np.arange(c)
    st0["prev_prop"][:] = 5 * S + rng.integers(0, S, c)
    delta = rng.integers(1, 4, c)
    rows = np.zeros((10, c), dtype=np.int64)
    rows[0], rows[1], rows[2] = tk.OP_ADD, np.arange(c), 5 * S
    rows[3], rows[4], rows[5] = 1 + np.arange(c) % 2, 1, delta
    got = bridge.state_to_numpy(_check(st0, rows))
    assert not got["idle"].any() and (got["depth"] == 1).all()
    assert (got["prop_delta"][1:] > 0).all()


class _Ops(TorchDispatchMode):
    """Records the aten ops a body runs."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        dev = kwargs.get("device")
        if name == "_to_copy" and dev is not None and \
                torch.device(dev) != args[0].device:
            name = "copy_between_devices"
        self.names.add(name)
        return func(*args, **kwargs)


def test_pass_holds_no_data_dependent_op():
    """The pass on a device batch: no op whose output size or control
    flow depends on the data, and no read of a value to the host (the
    plain K3, the CPU's stand-in for the kernel, excluded)."""
    rng = np.random.default_rng(91)
    arrays = _state(91, 16, 8)
    rows = torch.from_numpy(_rows(rng, arrays, 64, p_create=0.2))
    st0 = to_torch(arrays)
    seen = _Ops()
    orig = tk.ingest_scan
    try:
        tk.ingest_scan = lambda r, c: torch.zeros_like(r[0])
        with seen:
            tk.ingest(st0, rows, anticipation_ns=0)
    finally:
        tk.ingest_scan = orig
    banned = {"nonzero", "unique", "_unique2", "unique_consecutive",
              "masked_select", "_local_scalar_dense", "item", "argwhere",
              "copy_between_devices", "repeat_interleave"}
    assert seen.names and not seen.names & banned, seen.names & banned


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 12),
       q=st.sampled_from([1, 2, 4, 8]), b=st.integers(1, 60),
       p_create=st.sampled_from([0.0, 0.1, 0.4]),
       p_idle=st.sampled_from([0.0, 0.5, 1.0]),
       edge=st.booleans(), ant=st.sampled_from([0, S // 20]))
def test_property_dense_ingest_equals_the_scan(seed, n, q, b, p_create,
                                               p_idle, edge, ant):
    rng = np.random.default_rng(seed)
    arrays = _state(seed % 1000, n, q, p_idle=p_idle, max_depth=q - 1)
    if edge:
        arrays["prop_delta"][:] = -(1 << 63) + rng.integers(0, 10**9, n)
    rows = _rows(rng, arrays, b, p_create=p_create)
    _check(arrays, rows, ant)


# ----------------------------------------------------------------------
# the cover-min table and K3's plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed, b", [(101, 1), (102, 37), (103, 256)])
def test_cover_min_equals_brute_force(seed, b):
    rng = np.random.default_rng(seed)
    m = 3 * b + 5
    lo = rng.integers(-1, b + 1, m)
    hi = lo + rng.integers(-2, b + 1, m)
    val = rng.integers(-10**12, 10**12, m)
    ok = (rng.random(m) < 0.8) & (lo <= hi) & (lo >= 0) & (hi < b)
    mins, counts = tk._cover_min(*(torch.from_numpy(x) for x in
                                   (lo, hi, val, ok)), b)
    x = np.arange(b)[:, None]
    cover = ok[None, :] & (lo[None, :] <= x) & (x <= hi[None, :])
    want = np.where(cover, val[None, :], tk.KEY_INF).min(1)
    assert np.array_equal(mins.numpy(), want)
    assert np.array_equal(counts.numpy(), cover.sum(1))


def _old_host_loop(vals, r_time):
    """The recurrence as the ingest ran it on the host before K3
    (``_reactivation_shifts``): rows ``(m, any0, base, pd, act)`` with
    their arrival times, no client leaving the set."""
    low_p, any_r, out = tk.KEY_INF, False, []
    for (mk, a0, b, pd, act), t in zip(vals, r_time):
        low = min(mk, low_p)
        if (a0 or any_r) and low < LOWEST_PROP_TAG_TRIGGER:
            pd = tk._wrap64(low - t)
        out.append(pd)
        if act:
            low_p = min(low_p, tk._wrap64(b + pd))
            any_r = True
    return out


def _scan_rows(rng, r, b, *, leaving=False, edge=False):
    base = (50 * S + rng.integers(-S, S, r)).astype(np.int64)
    m = np.where(rng.random(r) < 0.3, tk.KEY_INF,
                 50 * S + rng.integers(-S, S, r))
    m = np.where(rng.random(r) < 0.1, MAX_TAG, m)
    if edge:
        m = np.where(rng.random(r) < 0.5, -(1 << 63) + 10**6, m)
        base = np.where(rng.random(r) < 0.5, (1 << 62) + base, base)
    end = np.full(r, r) if not leaving else np.where(
        rng.random(r) < 0.5, r, np.arange(r) + rng.integers(0, 6, r))
    rows = np.zeros((7, b), dtype=np.int64)
    rows[:, :r] = np.stack([m, rng.random(r) < 0.7, base,
                            rng.integers(0, S, r), rng.random(r) < 0.8,
                            60 * S + rng.integers(0, S, r),
                            np.minimum(end, r)])
    return rows


@pytest.mark.parametrize("seed, r, edge", [(111, 1, False),
                                           (112, 200, False),
                                           (113, 500, True)])
def test_k3_plain_equals_the_old_host_loop(seed, r, edge):
    rng = np.random.default_rng(seed)
    rows = _scan_rows(rng, r, r + 13, edge=edge)
    got = tk.ingest_scan(torch.from_numpy(rows), torch.tensor(r))
    want = _old_host_loop(rows[:5, :r].T.tolist(), rows[5, :r].tolist())
    assert got[:r].tolist() == want


def test_k3_plain_with_clients_leaving_equals_a_direct_simulation():
    """Joined tags with an end (a re-create later in the batch) leave the
    set: a direct simulation of the set gives the same shifts."""
    rng = np.random.default_rng(121)
    r = 300
    rows = _scan_rows(rng, r, r, leaving=True)
    got = tk.ingest_scan(torch.from_numpy(rows), torch.tensor(r)).tolist()
    joined, want = [], []
    for k in range(r):
        m, a0, base, pd, act, t, end = (int(x) for x in rows[:, k])
        live = [v for j, v, e in joined if j < k < e]
        low = min([m] + live)
        if (a0 or live) and low < LOWEST_PROP_TAG_TRIGGER:
            pd = tk._wrap64(low - t)
        want.append(pd)
        if act:
            joined.append((k, tk._wrap64(base + pd), end))
    assert got == want


def test_k3_wrapper_checks_its_inputs():
    rows = torch.zeros((7, 4), dtype=torch.int64)
    with pytest.raises(TypeError):
        tk.ingest_scan(rows.to(torch.int32), torch.tensor(1))
    with pytest.raises(ValueError):
        tk.ingest_scan(rows[:6], torch.tensor(1))
    with pytest.raises(ValueError):
        tk.ingest_scan(rows, torch.tensor([1]))
    assert tk.ingest_scan(rows, torch.tensor(0)).shape == (4,)
    assert tk.ingest_scan_cost(10)["bytes_accessed"] == 648
