"""Shapes and inputs for the ring-window (kernel K1) and timer-wheel scan
(kernel K2) tests, made with numpy from a seed (no tests of its own).

This module imports neither ``jax`` nor ``torch``: the card-only tests
(``test_torch_cuda.py``) use it on a machine without JAX, and the CPU
tests hand the same arrays to the JAX package and to the port.
"""

import numpy as np

KEY_INF = (1 << 63) - 1

# (n, q, w) for the ring window: tests/test_prefix.py's rotate cases,
# Q = 320 (the serve ring, not a power of two) and Q = 48, each with
# w < Q and w == Q; and the edges of K1's tiling (32 clients a block, 64
# window rows a chunk): a part tile (N = 31), one past a tile (33, 97),
# one client, w = 1, one past a chunk (65, 129), and five chunks (320);
# and the chain engine's window at the serve ring (w = chain_depth = 4)
RING_SHAPES = [
    (700, 16, 5), (2500, 128, 32), (100, 64, 64), (300, 320, 32),
    (50, 320, 320), (200, 48, 7), (64, 48, 48),
    (31, 64, 1), (33, 128, 65), (97, 256, 129), (33, 320, 320), (1, 8, 8),
    (1000, 320, 4),
    # the churn row's ring and window at capacities that are not a
    # multiple of K1's 32-client tile (a spec's capacity0 doubled)
    (250, 32, 4), (1000, 32, 4),
]

# K1 at every main-path shape: serve and serve_radix (N=100000, Q=320,
# w=32), cfg4 and the stop ladder (N=100000, Q=128, w=64), the chain
# paths (Q=320, w=chain_depth=4), tag32 on the high-rate state
# (Q=128, w=32), cfg3 (N=10000, Q=256, w=32), the churn row (ring 32,
# w=m=4) at the capacities flash_crowd grows through, and the
# supervised prefix jobs (Q=128, w=m=8), and the device sim's headline
# (8 servers of N=100000, Q=64): the prefix batches' head read (w=1) and
# the minstop calendar batches (w=calendar_steps=8), and the mesh row
# (ring 16, w=m=4) per shard at 8 x 12,500 clients and at 1 x 100,000,
# and its wheel chunk (10,000 clients a shard, w=calendar_steps=4), and
# the supervised churn mesh (ring 32, w=m=4) at 1,024 slots a shard
RING_MAIN_SHAPES = [(100_000, 320, 32), (100_000, 128, 64),
                    (100_000, 320, 4), (100_000, 128, 32),
                    (10_000, 256, 32), (2048, 32, 4), (4096, 32, 4),
                    (100_000, 128, 8), (100_000, 64, 1), (100_000, 64, 8),
                    (12_500, 16, 4), (100_000, 16, 4), (10_000, 16, 4),
                    (1024, 32, 4)]


def ring_case(n: int, q: int, seed: int, lo: int = 0, hi=None):
    """``(ring int64[n, q], q_head int32[n])`` with ``q_head`` in
    ``[lo, hi)`` (default ``[0, q)``, whose wrap edges 0 and q - 1 lead
    the vector)."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(-(1 << 50), 1 << 50, (n, q)).astype(np.int64)
    q0 = rng.integers(lo, q if hi is None else hi, n).astype(np.int32)
    if hi is None:
        q0[:4] = [0, q - 1, q - 1, 0][:min(4, n)]
    return ring, q0

# (name, n, nb): both calendar bucket counts, n = 1, and lane counts
# that are not multiples of 128
WHEEL_CASES = [
    ("random", 1000, 256), ("entry_keys", 1000, 768),
    ("stop_packs", 700, 256), ("key_inf", 300, 256),
    ("all_masked", 200, 768), ("one_bucket", 333, 256),
    ("single_lane", 1, 768), ("lanes_129", 129, 256),
]


def wheel_case(name: str, n: int, nb: int, seed: int = 0):
    """``(keys int64[n], slot int32[n])`` with ``slot`` in ``[0, nb]``
    (``nb`` masks a lane out)."""
    rng = np.random.default_rng(seed + n + nb)
    slot = rng.integers(0, nb + 1, n).astype(np.int32)
    if name == "random":
        # both signs, full range
        keys = rng.integers(-(1 << 62), 1 << 62, n)
    elif name == "entry_keys":
        # the wheel build's shape: keys near now, some below it (negative
        # after the weight-phase debt), bucketed as wheel_build does
        now = 50_000_000_000
        keys = now + rng.integers(-(1 << 28), 1 << 28, n)
        keys[: n // 4] = -rng.integers(1, 1 << 40, n // 4)
        cls = rng.integers(0, 4, n)
        b = np.clip((keys - (now - (128 << 20))) >> 20, 0, 255)
        slot = np.where(cls == 3, nb, cls * 256 + b).astype(np.int32)
    elif name == "stop_packs":
        # _wheel_stop_min's shape: class bits at 58, most packs in a few
        # buckets of 2^52, some KEY_INF (masked)
        cls = rng.integers(0, 3, n)
        keys = (cls << 58) | ((1 << 57) + rng.integers(0, 1 << 30, n))
        keys[rng.random(n) < 0.2] = KEY_INF
        slot = np.where(keys < KEY_INF, np.clip(keys >> 52, 0, nb - 1),
                        nb).astype(np.int32)
    elif name == "key_inf":
        # KEY_INF keys inside real buckets count and min as themselves
        keys = np.full(n, KEY_INF)
        keys[::3] = rng.integers(0, 1 << 40, len(keys[::3]))
    elif name == "all_masked":
        keys = rng.integers(-(1 << 40), 1 << 40, n)
        slot[:] = nb
    elif name == "one_bucket":
        keys = -rng.integers(1, 1 << 62, n)
        slot[:] = 17
    else:
        keys = rng.integers(-(1 << 40), 1 << 40, n)
    return keys.astype(np.int64), slot


def plain_wheel_scan(keys, slot, nb):
    """A straight numpy statement of the function K2 computes."""
    cnt = np.zeros(nb, np.int32)
    bmin = np.full(nb, KEY_INF, np.int64)
    live = slot < nb
    np.add.at(cnt, slot[live], 1)
    np.minimum.at(bmin, slot[live], keys[live])
    occ = np.flatnonzero(cnt)
    found = occ.size > 0
    return cnt, bmin, (bmin[occ[0]] if found else KEY_INF), found
