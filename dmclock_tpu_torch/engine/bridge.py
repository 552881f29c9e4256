"""Numpy bridge: carry an ``EngineState`` across frameworks.

A scheduler has no weights; its "weights carried across" are the SoA
state.  ``state_from_numpy`` takes a dict of numpy arrays (e.g. the
JAX package's ``EngineState`` fetched field by field) and builds the
port's state on ``device``; ``state_to_numpy`` is the inverse.  Both
take a stacked ``[S, ...]`` state (a mesh's shards) as well.
``cluster_from_numpy`` / ``cluster_to_numpy`` carry a whole
``parallel.cluster.ClusterState`` (stacked engine, ``[S, C]`` tracker of
either policy, ``[S]`` clocks).  Dtypes
are kept exactly and checked against the field table (the device sim's
``sim.device_sim.device_sim_from_numpy`` reuses the checks).
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
    dev = resolve_device(device)
    _check_fields(arrays, EngineState._fields, "state")
    return EngineState(**{
        f: _tensor_from_numpy(arrays[f], FIELD_DTYPES[f], dev,
                              f"field {f}")
        for f in EngineState._fields})


def state_to_numpy(state: EngineState) -> dict:
    """Every field as a host numpy array, dtypes kept."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in EngineState._fields}


def _check_fields(arrays, fields, what: str) -> None:
    names = set(arrays)
    want = set(fields)
    if names != want:
        raise ValueError(f"{what} fields differ: missing "
                         f"{sorted(want - names)}, extra "
                         f"{sorted(names - want)}")


def _tensor_from_numpy(a, dtype: torch.dtype, dev: torch.device,
                       what: str) -> torch.Tensor:
    # a private, writable copy: fetched JAX arrays are read-only
    a = np.array(a, copy=True, order="C")
    t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {a.dtype} != {dtype}")
    return t.to(dev)


def cluster_from_numpy(arrays, device: str | torch.device = DEFAULT_DEVICE):
    """A ``ClusterState`` from ``{"engine": {field: array}, "tracker":
    {field: array}, "now": array}``; the tracker's fields pick its
    policy (``TrackerState`` or ``BorrowTrackerState``)."""
    from ..parallel.cluster import ClusterState
    from ..parallel.tracker import (TRACKER_DTYPES, BorrowTrackerState,
                                    TrackerState)

    dev = resolve_device(device)
    trk = arrays["tracker"]
    cls = BorrowTrackerState if "borrow_delta" in trk else TrackerState
    _check_fields(trk, cls._fields, "tracker")
    tracker = cls(**{f: _tensor_from_numpy(
        trk[f], TRACKER_DTYPES.get(f, torch.int64), dev, f"tracker {f}")
        for f in cls._fields})
    return ClusterState(
        engine=state_from_numpy(arrays["engine"], dev), tracker=tracker,
        now=_tensor_from_numpy(arrays["now"], torch.int64, dev, "now"))


def cluster_to_numpy(cluster) -> dict:
    """A ``ClusterState`` as ``{"engine": ..., "tracker": ..., "now":
    ...}`` of host numpy arrays."""
    return {"engine": state_to_numpy(cluster.engine),
            "tracker": {f: getattr(cluster.tracker, f).detach().cpu()
                        .numpy() for f in cluster.tracker._fields},
            "now": cluster.now.detach().cpu().numpy()}
