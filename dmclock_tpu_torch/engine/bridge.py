"""Numpy bridge: carry an ``EngineState`` across frameworks.

A scheduler has no weights; its "weights carried across" are the SoA
state.  ``state_from_numpy`` takes a dict of numpy arrays (e.g. the
JAX package's ``EngineState`` fetched field by field) and builds the
port's state on ``device``; ``state_to_numpy`` is the inverse.  Dtypes
are kept exactly and checked against the field table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .state import FIELD_DTYPES, EngineState


def state_from_numpy(arrays, device: str | torch.device = DEFAULT_DEVICE
                     ) -> EngineState:
    """``arrays``: a mapping with one numpy-convertible array per
    ``EngineState`` field.  Raises ValueError on a missing or extra
    field or a dtype that differs from the field's."""
    names = set(arrays)
    want = set(EngineState._fields)
    if names != want:
        raise ValueError(f"state fields differ: missing "
                         f"{sorted(want - names)}, extra "
                         f"{sorted(names - want)}")
    dev = resolve_device(device)
    out = {}
    for f in EngineState._fields:
        # a private, writable copy: fetched JAX arrays are read-only
        a = np.array(arrays[f], copy=True, order="C")
        t = torch.from_numpy(a)
        if t.dtype != FIELD_DTYPES[f]:
            raise ValueError(f"field {f}: dtype {a.dtype} != "
                             f"{FIELD_DTYPES[f]}")
        out[f] = t.to(dev)
    return EngineState(**out)


def state_to_numpy(state: EngineState) -> dict:
    """Every field as a host numpy array, dtypes kept."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in EngineState._fields}
