"""The chain digest of a decision stream (the port's copy of
``_DIGEST_FIELDS`` and ``_digest_update`` from
``dmclock_tpu/robust/supervisor.py``).

One step is ``sha256(previous digest || this epoch's decision arrays)``:
for each result and each field of :data:`DIGEST_FIELDS` it has, the
numpy dtype string, the shape and the bytes.  The port's decision
dtypes equal the JAX package's, so the same run gives the same digest
in both packages.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

DIGEST_FIELDS = ("count", "unit_count", "resv_count", "slot", "cls",
                 "length", "phase", "cost", "lb", "served", "type")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def digest_update(digest: bytes, results) -> bytes:
    """One chain-digest step over ``results`` (objects with any of
    :data:`DIGEST_FIELDS` as tensors or arrays)."""
    h = hashlib.sha256(digest)
    for r in results:
        for name in DIGEST_FIELDS:
            if hasattr(r, name):
                a = _np(getattr(r, name))
                h.update(str(a.dtype).encode())
                h.update(str(a.shape).encode())
                h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()
