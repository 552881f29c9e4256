"""The port's CUDA kernels (K1 ring window, K2 wheel scan) against their
plain PyTorch versions, and a cfg4 round on the card against the CPU.
Marked ``cuda``: every test skips where CUDA is unavailable.

This file imports neither ``jax`` nor the JAX package, so it also runs
on a machine with the card and no JAX, without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from dmclock_tpu_torch.engine import _ext
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk

from test_torch_cases import (RING_MAIN_SHAPES, RING_SHAPES, WHEEL_CASES,
                              plain_wheel_scan, ring_case, wheel_case)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel: needs an NVIDIA GPU")
    return torch.device("cuda")


def _ring_window_matches_plain(cuda, n, q, w, ring, q0):
    ta, tc, tq = (torch.from_numpy(x).to(cuda)
                  for x in (ring, np.roll(ring, 1, axis=1), q0))
    before = _ext.LAUNCHES["ring_window"]
    ga, gc = tfp.ring_window_rows(ta, tc, tq, w)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] == before + 1
    assert ga.shape == gc.shape == (w, n)
    assert torch.equal(ga, tfp._ring_window_torch(ta, tq, w))
    assert torch.equal(gc, tfp._ring_window_torch(tc, tq, w))


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, w", RING_SHAPES + RING_MAIN_SHAPES)
def test_ring_window_kernel_matches_plain(cuda, n, q, w):
    _ring_window_matches_plain(cuda, n, q, w, *ring_case(n, q, n + q + w))


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, w", RING_SHAPES)
def test_ring_window_kernel_floor_mod_of_any_head(cuda, n, q, w):
    """``q_head`` from [-2Q, 2Q): the kernel's 32-bit floored modulo
    equals the plain version's ``torch.remainder``."""
    _ring_window_matches_plain(cuda, n, q, w,
                               *ring_case(n, q, 3 * n + w, -2 * q, 2 * q))


@pytest.mark.cuda
def test_ring_window_kernel_rejects_strided_input(cuda):
    ring = torch.zeros((8, 16), dtype=torch.int64, device=cuda)
    q0 = torch.zeros((8,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfp.ring_window_rows(ring[:, ::2], ring[:, ::2], q0, 4)


# the wheel-scan cases of tests/test_torch_wheel.py and the two cfg4
# shapes: the wheel build (N=100000, nb=768) and the stop wheel
# (N=100000, nb=256)
K2_CASES = WHEEL_CASES + [("entry_keys", 100_000, 768),
                          ("stop_packs", 100_000, 256)]


def _assert_scan_matches_plain(got, keys, slot, nb):
    want = tk._wheel_scan_torch(keys, slot, nb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name, n, nb", K2_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in K2_CASES])
def test_wheel_scan_kernel_matches_plain(cuda, name, n, nb):
    keys, slot = wheel_case(name, n, nb)
    tkeys, tslot = torch.from_numpy(keys).to(cuda), \
        torch.from_numpy(slot).to(cuda)
    before = _ext.LAUNCHES["wheel_scan"]
    got = tk.wheel_scan(tkeys, tslot, nb)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["wheel_scan"] == before + 1
    _assert_scan_matches_plain(got, tkeys, tslot, nb)
    cnt, bmin, val, found = plain_wheel_scan(keys, slot, nb)
    assert np.array_equal(got[0].cpu().numpy(), cnt)
    assert np.array_equal(got[1].cpu().numpy(), bmin)
    assert int(got[2]) == val and bool(got[3]) == found


@pytest.mark.cuda
def test_wheel_scan_kernel_leaves_its_workspace_clean(cuda):
    """Calls in sequence at both bucket counts, one with every lane
    masked: each equals the plain version, so no call sees what the one
    before it merged."""
    seq = [("entry_keys", 100_000, 768), ("all_masked", 100_000, 256),
           ("stop_packs", 100_000, 256), ("entry_keys", 100_000, 768)]
    for k, (name, n, nb) in enumerate(seq):
        keys, slot = (torch.from_numpy(x).to(cuda)
                      for x in wheel_case(name, n, nb, seed=k))
        before = _ext.LAUNCHES["wheel_scan"]
        got = tk.wheel_scan(keys, slot, nb)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["wheel_scan"] == before + 1
        _assert_scan_matches_plain(got, keys, slot, nb)
        assert bool(got[3]) == (name != "all_masked")


@pytest.mark.cuda
def test_wheel_scan_kernel_replays_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph, replayed with the inputs
    changed in place between replays: each replay equals the plain
    version on the inputs it read."""
    n, nb = 1000, 256
    keys, slot = (torch.from_numpy(x).to(cuda)
                  for x in wheel_case("random", n, nb))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.wheel_scan(keys, slot, nb)           # workspace, build, warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tk.wheel_scan(keys, slot, nb)
    for name in ("stop_packs", "one_bucket", "all_masked"):
        k2, s2 = wheel_case(name, n, nb, seed=5)
        keys.copy_(torch.from_numpy(k2))
        slot.copy_(torch.from_numpy(s2))
        graph.replay()
        torch.cuda.synchronize()
        _assert_scan_matches_plain(got, keys, slot, nb)
        cnt, bmin, val, found = plain_wheel_scan(k2, s2, nb)
        assert np.array_equal(got[0].cpu().numpy(), cnt)
        assert int(got[2]) == val and bool(got[3]) == found


@pytest.mark.cuda
def test_wheel_scan_first_call_under_capture_raises(cuda, monkeypatch):
    """The workspace must not come from a graph's private pool: a first
    call on a device inside a capture raises, and allocates nothing."""
    keys, slot = (torch.from_numpy(x).to(cuda)
                  for x in wheel_case("random", 64, 8))
    tk.wheel_scan(keys, slot, 8)                # builds the kernel
    monkeypatch.setattr(tk, "_WHEEL_WORKSPACE", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            tk.wheel_scan(keys, slot, 8)
    assert tk._WHEEL_WORKSPACE == {}


@pytest.mark.cuda
def test_wheel_scan_kernel_rejects_bad_input(cuda):
    keys = torch.zeros((64,), dtype=torch.int64, device=cuda)
    slot = torch.zeros((64,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tk.wheel_scan(keys[::2], slot[::2], 8)
    with pytest.raises(TypeError):
        tk.wheel_scan(keys.to(torch.int32), slot, 8)
    with pytest.raises(TypeError):
        tk.wheel_scan(keys, slot.to(torch.int64), 8)


@pytest.mark.cuda
def test_wheel_round_on_the_card_equals_cpu(cuda):
    """One cfg4 round at 512 clients: on the card (K1 and K2 launched)
    equal to the same round on the CPU, every output and the state."""
    from dmclock_tpu_torch import serve

    st, draws = serve.cfg4_setup(512, 1, device="cpu")
    want = serve.cfg4_rounds(st, draws)
    before = dict(_ext.LAUNCHES)
    got = serve.cfg4_rounds(
        st._replace(**{f: getattr(st, f).to(cuda) for f in st._fields}),
        draws.to(cuda))
    torch.cuda.synchronize()
    c = serve.CFG4
    assert _ext.LAUNCHES["ring_window"] - before["ring_window"] \
        == c["m"] * c["ladder_levels"]
    assert _ext.LAUNCHES["wheel_scan"] - before["wheel_scan"] \
        == c["m"] * (1 + c["ladder_levels"])
    for f in ("count", "resv_count", "progress_ok", "served",
              "level_count", "metrics"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f, a, b in zip(want.state._fields, got.state, want.state):
        assert torch.equal(a.cpu(), b), f
    assert int(want.count.sum()) > 0
