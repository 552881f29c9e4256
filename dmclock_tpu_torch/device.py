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


def resolve_devices(devices=None) -> tuple:
    """A layout's devices as a tuple of ``torch.device``.  ``None`` is
    every visible CUDA device by index (``cuda:0`` .. ``cuda:{D-1}``)
    and raises where there is none, as :func:`resolve_device` does for
    ``"cuda"``; an int ``D`` is the first ``D`` of them.  Otherwise each
    entry resolves as :func:`resolve_device`, and an indexed CUDA device
    past the visible count raises: no device stands in for a missing
    one.  A device may repeat (several groups on one device)."""
    if devices is None or isinstance(devices, int):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "devices=None means every visible CUDA device, but "
                "torch.cuda.is_available() is False; pass "
                "devices=('cpu',) * D to lay the groups out on the CPU")
        count = torch.cuda.device_count()
        want = count if devices is None else int(devices)
        if not 0 < want <= count:
            raise RuntimeError(f"{want} CUDA devices requested, "
                               f"{count} visible")
        return tuple(torch.device("cuda", i) for i in range(want))
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    out = tuple(resolve_device(d) for d in devices)
    # an unindexed "cuda" resolves at op time to whatever device is
    # current; a layout pins it to an index
    out = tuple(torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in out)
    if not out:
        raise ValueError("a layout needs at least one device")
    for d in out:
        if d.type == "cuda" and d.index is not None and \
                d.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(d)!r} requested, "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "visible")
    return out


def parse_devices(text: str):
    """A CLI ``--devices`` value: ``"cuda:0,cuda:1"`` (a list, repeats
    allowed) or ``"4"`` (the first four cards)."""
    text = text.strip()
    if text.isdigit():
        return int(text)
    return tuple(p.strip() for p in text.split(",") if p.strip())
