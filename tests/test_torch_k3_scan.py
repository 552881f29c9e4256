"""A CPU model of kernel K3's algorithm (``engine/csrc/ingest_scan.cu``),
held against K3's plain version (``kernels._ingest_scan_torch``).

No kernel runs on the CPU, so the decomposition the kernel makes is
proved here, step for step in plain Python integers: the liveness of
each tile (the first row whose tag joins for good, ``j0``, and ``L``,
the first row at which a tag that leaves again is live), the tile loop of the
block-parallel scan of min-plus maps ``x -> min(x + a, b)`` (each
thread's rows composed, a Hillis-Steele scan across each warp's lanes,
the warps' totals scanned by the first warp), the two regimes of the
trigger (before and after the running minimum crosses it, the tile that
crosses scanned twice), the local check of every row in the kernel's
int64 wrap-around arithmetic, ``F`` (the first row that fails it), and
the serial walk from ``min(F, L)``.  The model runs at the kernel's own
block (512 threads of 4 rows, warps of 32) and at a small one (warps of
4, tiles of 16 rows), so tile and warp edges are crossed.  Its exits
``(min(F, L), L, the crossing row)`` do not depend on the tiling, and
are asserted on the two real inputs of ``chip_smoke.py`` phase 4b."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import kernels as tk

from test_torch_cases import K3_DOOR_CASES, K3_TILE, K3_TRIGGER, k3_rows

KEY_INF = tk.KEY_INF
T = tk.LOWEST_PROP_TAG_TRIGGER
S = 10 ** 9
# the identity map's b: past any value the scan reaches
NO_B = 1 << 120
IDENT = (0, NO_B)
# the kernel's block: threads, rows a thread of a tile, warp width
KERNEL = dict(threads=512, per=4, warp=32)
SMALL = dict(threads=16, per=1, warp=4)
SMALL2 = dict(threads=8, per=3, warp=4)


def _wrap(x: int) -> int:
    return tk._wrap64(x)


def _compose(f, g):
    """``f`` then ``g``."""
    return f[0] + g[0], min(f[1] + g[0], g[1])


def _apply(f, x):
    return min(x + f[0], f[1])


def _row_map(rows, k, n, j0, kt):
    """Row ``k``'s step of the running minimum P of the tags that joined
    for good, as a map: the identity unless its tag joins for good; a
    shift where the row shifts (any, and its own m or, from the crossing
    row ``kt`` on, P below the trigger) without wrapping; else its tag
    ``base + pd0`` as the device forms it."""
    m, a0, base, pd0, act, t, end = (col[k] for col in rows)
    if not (act and end >= n):
        return IDENT
    if (a0 or k > j0) and (m < T or k >= kt):
        c = base - t
        return min(0, c), m + c
    return 0, _wrap(base + pd0)


def _real_step(rows, k, n, j0, p):
    """Row ``k`` in the kernel's int64 from P = ``p``: ``(pd, P after)``."""
    m, a0, base, pd0, act, t, end = (col[k] for col in rows)
    low = min(m, p)
    pd = _wrap(low - t) if (a0 or k > j0) and low < T else pd0
    if act and end >= n:
        return pd, min(p, _wrap(base + pd))
    return pd, p


def _warp_scan(vals, warp):
    """Inclusive scan across each warp's lanes, as ``__shfl_up_sync``
    does it: a lane below the distance keeps its own value."""
    inc, d = list(vals), 1
    while d < warp:
        inc = [_compose(inc[i - d], v) if i % warp >= d else v
               for i, v in enumerate(inc)]
        d *= 2
    return inc


def _block_scan(loc, warp):
    """Each thread's exclusive prefix map and the block's total."""
    nw = len(loc) // warp
    inc = _warp_scan(loc, warp)
    ex = [IDENT if i % warp == 0 else inc[i - 1] for i in range(len(loc))]
    tot = _warp_scan([inc[w * warp + warp - 1] for w in range(nw)]
                     + [IDENT] * (warp - nw), warp)[:nw]
    pre = [IDENT] + tot[:-1]
    return [_compose(pre[i // warp], e) for i, e in enumerate(ex)], tot[-1]


def k3_model(rows, count, *, threads, per, warp):
    """K3's algorithm on ``rows`` (int64 ``[7, B]``) for ``count`` rows:
    ``(pd list of the first count rows, (min(F, L), L, crossing))``,
    ``L`` reported where the scan stopped there and the crossing row
    where it is at most ``min(F, L)`` (else ``count``): what the kernel
    knows whatever its tiling."""
    rows = [list(map(int, col)) for col in np.asarray(rows)]
    b = len(rows[0])
    n = max(0, min(int(count), b))
    m, a0, base, pd0, act, t, end = rows
    out = [0] * n
    # j0: the first row whose tag joins for good; jl: the first whose tag
    # leaves again, lim = L (both n until a tile holds them); kt: the
    # first row at which P is below the trigger, n + 1 until the scan
    # finds it
    j0, jl, lim, kt, s = n, n, n, n + 1, n
    carry, t0 = KEY_INF, 0
    while t0 < lim:
        tile = range(t0, min(t0 + threads * per, n))
        j0 = min([j0] + [k for k in tile if act[k] and end[k] >= n])
        pl = [k for k in tile if act[k] and k + 1 < end[k] < n]
        if pl:
            jl = min(pl)
            lim = jl + 1
        own = [[k for k in range(t0 + i * per, t0 + (i + 1) * per)
                if k < lim] for i in range(threads)]
        t0 += threads * per
        for _ in range(2):
            loc = []
            for ks in own:
                f = IDENT
                for k in ks:
                    f = _compose(f, _row_map(rows, k, n, j0, kt))
                loc.append(f)
            ex, tot = _block_scan(loc, warp)
            if kt <= n or _apply(tot, carry) >= T:
                break
            # the running minimum crosses the trigger in this tile
            cand = [n]
            for e, ks in zip(ex, own):
                x = _apply(e, carry)
                for k in ks:
                    x = _apply(_row_map(rows, k, n, j0, kt), x)
                    if x < T:
                        cand.append(k + 1)
                        break
            kt = min(cand)
        fails = []
        for e, ks in zip(ex, own):
            x = _apply(e, carry)
            for k in ks:
                xn = _apply(_row_map(rows, k, n, j0, kt), x)
                out[k], p1 = _real_step(rows, k, n, j0, _wrap(x))
                if p1 != xn:
                    fails.append((k, x))
                    break
                x = xn
        if fails:
            s, carry = min(fails)
            break
        carry = _apply(tot, carry)
    s = min(s, lim)
    # the serial remainder, from the exact carry
    assert _wrap(carry) == carry
    low_p, any_p = carry, j0 < s
    leaving = [(_wrap(base[jl] + out[jl]), end[jl])] if s == lim < n \
        else []
    for k in range(s, n):
        leaving = [(v, e) for v, e in leaving if e > k]
        low = min([m[k], low_p] + [v for v, _ in leaving])
        pd = pd0[k]
        if (a0[k] or any_p or leaving) and low < T:
            pd = _wrap(low - t[k])
        out[k] = pd
        if act[k]:
            v = _wrap(base[k] + pd)
            if end[k] >= n:
                low_p, any_p = min(low_p, v), True
            elif end[k] > k + 1:
                leaving.append((v, end[k]))
    return out, (s, lim if s == lim else n, kt if kt <= s else n)


def _plain(rows, count):
    r = max(0, min(int(count), rows.shape[1]))
    return tk._ingest_scan_torch(torch.from_numpy(np.asarray(rows)),
                                 torch.tensor(count))[:r].tolist()


def _check(rows, count, blocks=(KERNEL, SMALL, SMALL2)):
    """The model at every block equals the plain version, with the same
    exits; returns them."""
    want = _plain(rows, count)
    exits = set()
    for blk in blocks:
        got, ex = k3_model(rows, count, **blk)
        assert got == want, blk
        exits.add(ex)
    assert len(exits) == 1, exits
    return exits.pop()


def _rows(seed, r, b, *, m_inf=0.3, leave=0.0, wrap=0.0, high=0.0):
    """Random K3 rows: tags around 50 s; a ``high`` share of tags above
    the trigger; a ``wrap`` share of rows at the int64 edges (``low - t``
    and ``base + pd`` wrapping); a ``leave`` share of tags leaving the
    set again."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random(r) < m_inf, KEY_INF,
                 50 * S + rng.integers(-S, S, r))
    base = 50 * S + rng.integers(-S, S, r)
    base = np.where(rng.random(r) < high, base + T, base)
    t = 60 * S + rng.integers(0, S, r)
    e = rng.random(r)
    m = np.where(e < wrap / 2, -(1 << 63) + rng.integers(0, S, r), m)
    t = np.where((e >= wrap / 2) & (e < wrap), -(1 << 62), t)
    base = np.where((e >= wrap / 2) & (e < wrap), (1 << 62) + base, base)
    end = np.where(rng.random(r) < leave,
                   np.arange(r) + rng.integers(0, 6, r), r)
    rows = np.zeros((7, b), dtype=np.int64)
    rows[:, :r] = np.stack([m, rng.random(r) < 0.5, base,
                            rng.integers(0, S, r), rng.random(r) < 0.8, t,
                            np.minimum(end, r)])
    return rows


# ----------------------------------------------------------------------
# the counts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("r, b", [(0, 8), (1, 1), (16, 16), (37, 37),
                                  (37, 64), (200, 200)])
def test_model_equals_plain_at_each_count(r, b):
    """Count 0, 1, B, and counts that are no multiple of a tile."""
    s, lim, _ = _check(_rows(r + b, r, b), r)
    assert s == lim == r


def test_model_count_past_b_and_negative():
    rows = _rows(5, 20, 20)
    assert _check(rows, 50)[0] == 20
    assert _check(rows, -3) == (0, 0, 0)


# ----------------------------------------------------------------------
# the trigger
# ----------------------------------------------------------------------

def test_model_every_m_at_key_inf():
    """As in the cluster wave: no client scheduling outside the batch,
    so the first row that joins takes P below the trigger at row 1."""
    rows = _rows(11, 300, 300, m_inf=1.0)
    rows[4, 0] = 1
    assert _check(rows, 300) == (300, 300, 1)


def test_model_tags_on_both_sides_of_the_trigger():
    s, lim, kt = _check(_rows(12, 400, 400, high=0.5), 400)
    assert s == lim == 400 and kt < 400


@pytest.mark.parametrize("cross_at", [0, 1, 15, 16, 17, 47, 100])
def test_model_p_crosses_the_trigger_in_mid_batch(cross_at):
    """The tile that crosses is scanned again from the crossing row."""
    rows = k3_rows(120, 128, cross_at, cross_at=cross_at)
    assert _check(rows, 120) == (120, 120, cross_at + 1)


def test_model_p_never_crosses():
    rows = k3_rows(60, 60, 1, cross_at=59)
    rows[4, 59] = 0
    assert _check(rows, 60) == (60, 60, 60)


# ----------------------------------------------------------------------
# wrap-around and leaving tags
# ----------------------------------------------------------------------

@pytest.mark.parametrize("wrap_at", [0, 3, 16, 50])
def test_model_low_minus_t_wraps_in_mid_batch(wrap_at):
    """The row whose shift wraps fails the local check: the scan is
    left there, and the walk gives the plain version's values."""
    rows = k3_rows(80, 80, wrap_at, wrap_at=wrap_at)
    s, lim, kt = _check(rows, 80)
    assert (s, lim) == (wrap_at, 80)


def test_model_base_plus_pd_wraps_in_mid_batch():
    """``low - t`` in range, ``base + pd`` past int64's top: the joined
    tag is negative on the device, and the check sends the row to the
    walk."""
    rows = k3_rows(60, 60, 3)
    rows[:, 30] = [50 * S, 1, (1 << 62) + 10 ** 13, 0, 1, -(1 << 62), 60]
    s, lim, _ = _check(rows, 60)
    assert (s, lim) == (30, 60)


def test_model_wrap_that_the_minimum_hides_passes_the_check():
    """A non-shifting tag that wraps (the batch's last row) enters as
    the device forms it: the check passes it."""
    rows = k3_rows(21, 21, 4)
    rows[:, 20] = [KEY_INF, 0, KEY_INF, 5, 1, 60 * S, 21]
    rows[1, :21] = 0
    rows[4, :20] = 0
    assert _check(rows, 21) == (21, 21, 21)


@pytest.mark.parametrize("leave_at, r", [(0, 40), (1, 40), (20, 40),
                                         (36, 40)])
def test_model_leaving_tag_early_and_late(leave_at, r):
    """L = the leaving row + 1: the walk starts there with its tag in
    the list."""
    rows = k3_rows(r, r, leave_at, leave_at=leave_at)
    assert _check(rows, r)[:2] == (leave_at + 1, leave_at + 1)


def test_model_tag_whose_end_is_its_next_row_never_leaves():
    """``end == k + 1``: the tag is never live, the map the identity."""
    rows = k3_rows(40, 40, 9)
    rows[4, 10], rows[6, 10] = 1, 11
    assert _check(rows, 40)[:2] == (40, 40)


def test_model_wrap_before_a_leaving_tag():
    """The check stops the scan first: L is not reached."""
    rows = k3_rows(90, 90, 5, wrap_at=30, leave_at=60)
    assert _check(rows, 90)[:2] == (30, 90)


@pytest.mark.parametrize("seed", range(6))
def test_model_random_edges_and_leaving(seed):
    _check(_rows(100 + seed, 150, 160, leave=0.2, wrap=0.1, high=0.2), 150)


# ----------------------------------------------------------------------
# the door cases of phase 4b and the two real inputs
# ----------------------------------------------------------------------

_DOORS = {"none": lambda s, lim, n: s == lim == n,
          "check": lambda s, lim, n: s < lim,
          "leaving": lambda s, lim, n: s == lim < n}


@pytest.mark.parametrize("label, r, b, opts, door", K3_DOOR_CASES,
                         ids=[c[0] for c in K3_DOOR_CASES])
def test_model_on_the_door_cases(label, r, b, opts, door):
    """Each of phase 4b's door cases leaves the scan by its door (the
    kernel's block only: the small ones are slow at these sizes)."""
    rows = k3_rows(r, b, 24, **opts)
    s, lim, kt = _check(rows, r, blocks=(KERNEL,))
    assert _DOORS[door](s, lim, r), (s, lim)
    if "cross_at" in opts:
        assert kt == opts["cross_at"] + 1 > K3_TILE
    assert K3_TILE == KERNEL["threads"] * KERNEL["per"]


def _load_chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_k3_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_model_on_the_real_inputs():
    """Phase 4b's two real inputs, as the CPU's ingest hands them to K3:
    the cluster wave never leaves the scan (P crosses the trigger at row
    1); the queue flush leaves it at its first leaving tag."""
    seen, real = [], tk.ingest_scan

    def record(rows, count):
        seen.append((rows.numpy().copy(), int(count)))
        return real(rows, count)

    exits = {}
    for label, arrays, ops in _load_chip_smoke().k3_real_batches():
        tk.ingest_scan = record
        try:
            tk.ingest(bridge.state_from_numpy(arrays, "cpu"),
                      torch.from_numpy(ops), anticipation_ns=0)
        finally:
            tk.ingest_scan = real
        rows, count = seen.pop()
        exits[label] = (count, _check(rows, count, blocks=(KERNEL,)))
    assert exits["cluster wave"] == (10_000, (10_000, 10_000, 1))
    assert exits["queue flush"] == (124, (11, 11, 1))


# ----------------------------------------------------------------------
# a property over all of it
# ----------------------------------------------------------------------

_EDGE = st.sampled_from([KEY_INF, -(1 << 63), T - 1, T, 0, -1,
                         (1 << 62), -(1 << 62), 50 * S])
_VAL = st.one_of(_EDGE, st.integers(-(1 << 63), (1 << 63) - 1),
                 st.integers(40 * S, 70 * S))


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 24).flatmap(lambda r: st.tuples(
    st.just(r), st.integers(0, 3),
    st.lists(st.tuples(_VAL, st.booleans(), _VAL, _VAL, st.booleans(),
                       _VAL, st.integers(0, r + 1)),
             min_size=r, max_size=r))))
def test_model_property(case):
    r, pad, cols = case
    rows = np.zeros((7, r + pad), dtype=np.int64)
    if r:
        rows[:, :r] = np.array(cols, dtype=object).T.astype(np.int64)
    rows[6, :r] = np.minimum(rows[6, :r], r)
    _check(rows, r, blocks=(SMALL, SMALL2))
