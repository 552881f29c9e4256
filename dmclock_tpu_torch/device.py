"""Device resolution: CUDA unless the caller asks for the CPU.

There is no silent fallback: asking for ``cuda`` where PyTorch sees no
CUDA device raises, so a run can never report CPU work as the card's.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError when it
    names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
