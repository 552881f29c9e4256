"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: every test skips where CUDA is unavailable.

This file imports neither ``jax`` nor the JAX package, so it also runs
on a machine with the card and no JAX, without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from dmclock_tpu_torch.engine import _ext
from dmclock_tpu_torch.engine import fastpath as tfp

# the ring-window shapes of tests/test_torch_ring_window.py and the
# serve shape (N=100000, Q=320, w=32)
SHAPES = [(700, 16, 5), (2500, 128, 32), (100, 64, 64), (300, 320, 32),
          (50, 320, 320), (200, 48, 7), (64, 48, 48), (100_000, 320, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel: needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, w", SHAPES)
def test_ring_window_kernel_matches_plain(cuda, n, q, w):
    rng = np.random.default_rng(n + q + w)
    ring = rng.integers(-(1 << 50), 1 << 50, (n, q)).astype(np.int64)
    q0 = rng.integers(0, q, n).astype(np.int32)
    q0[:4] = [0, q - 1, q - 1, 0][:min(4, n)]       # the wrap edges
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
def test_ring_window_kernel_rejects_strided_input(cuda):
    ring = torch.zeros((8, 16), dtype=torch.int64, device=cuda)
    q0 = torch.zeros((8,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfp.ring_window_rows(ring[:, ::2], ring[:, ::2], q0, 4)
