"""Device-resident scheduler state: the ClientState SoA, as tensors.

Counterpart of ``dmclock_tpu/engine/state.py``: the same 24 fields with
the same dtypes and shapes.  Per-client state is a struct of
``[capacity]`` tensors so tag updates vectorize and selection is a
masked argmin; only the queue-head request of each client carries a
real tag (DelayedTagCalc, dmclock_server.h:878-893), the queued tail is
(arrival, cost) in a fixed-capacity ``[N, Q]`` ring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device


class EngineState(NamedTuple):
    """SoA over client slots.  ``capacity`` = length of every [N]
    tensor; ``ring_capacity`` = Q of the [N, Q] tail rings."""

    # slot bookkeeping
    active: torch.Tensor       # bool[N]  slot holds a live client
    idle: torch.Tensor         # bool[N]  ClientRec::idle
    order: torch.Tensor        # int64[N] creation index = tie-break

    # QoS parameters (ClientInfo inverses, ns per unit cost)
    resv_inv: torch.Tensor     # int64[N]
    weight_inv: torch.Tensor   # int64[N]
    limit_inv: torch.Tensor    # int64[N]

    # ClientRec scheduling state
    prop_delta: torch.Tensor   # int64[N] idle-reactivation shift
    prev_resv: torch.Tensor    # int64[N] prev_tag.reservation
    prev_prop: torch.Tensor    # int64[N] prev_tag.proportion
    prev_limit: torch.Tensor   # int64[N] prev_tag.limit
    prev_arrival: torch.Tensor  # int64[N] prev_tag.arrival
    cur_rho: torch.Tensor      # int64[N] latest ReqParams.rho
    cur_delta: torch.Tensor    # int64[N] latest ReqParams.delta

    # head request tag (the only fully-tagged request per client)
    head_resv: torch.Tensor    # int64[N]
    head_prop: torch.Tensor    # int64[N]
    head_limit: torch.Tensor   # int64[N]
    head_arrival: torch.Tensor  # int64[N]
    head_cost: torch.Tensor    # int64[N]
    head_rho: torch.Tensor     # int64[N] rho the head was tagged with
    head_ready: torch.Tensor   # bool[N]  RequestTag::ready

    # queued-tail ring (beyond the head)
    depth: torch.Tensor        # int32[N] request count INCLUDING head
    q_head: torch.Tensor       # int32[N] ring read index of oldest tail
    q_arrival: torch.Tensor    # int64[N, Q]
    q_cost: torch.Tensor       # int64[N, Q]

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def ring_capacity(self) -> int:
        return self.q_arrival.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.active.device


# The int64 per-client fields the epoch scans mutate batch to batch
# (the fields the ``tag_width=32`` carry narrows to int32 offsets).
TAG_I64_FIELDS = (
    "head_resv", "head_prop", "head_limit", "head_arrival",
    "head_cost", "head_rho",
    "prev_resv", "prev_prop", "prev_limit", "prev_arrival",
)

# Field dtypes; every field not listed here is int64.
FIELD_DTYPES = {f: torch.int64 for f in EngineState._fields}
FIELD_DTYPES.update(active=torch.bool, idle=torch.bool,
                    head_ready=torch.bool, depth=torch.int32,
                    q_head=torch.int32)

# Per-field fill values for slots that hold no client yet: exactly what
# ``init_state`` writes, so a grown slot is indistinguishable from an
# init-time one.
_FRESH_FILLS = {
    "active": False, "idle": True, "order": 0,
    "resv_inv": 0, "weight_inv": 0, "limit_inv": 0,
    "prop_delta": 0,
    "prev_resv": 0, "prev_prop": 0, "prev_limit": 0, "prev_arrival": 0,
    "cur_rho": 1, "cur_delta": 1,
    "head_resv": 0, "head_prop": 0, "head_limit": 0, "head_arrival": 0,
    "head_cost": 1, "head_rho": 0, "head_ready": False,
    "depth": 0, "q_head": 0, "q_arrival": 0, "q_cost": 0,
}


def init_state(capacity: int, ring_capacity: int = 64, *,
               device: str | torch.device = DEFAULT_DEVICE
               ) -> EngineState:
    """Fresh state: every slot free."""
    dev = resolve_device(device)
    ring_fields = ("q_arrival", "q_cost")
    return EngineState(**{
        f: torch.full((capacity, ring_capacity) if f in ring_fields
                      else (capacity,), _FRESH_FILLS[f],
                      dtype=FIELD_DTYPES[f], device=dev)
        for f in EngineState._fields})


def grow_state(state: EngineState, new_capacity: int) -> EngineState:
    """Exact migration to a larger slot capacity: every [N, ...] field
    is extended along axis 0 with its ``init_state`` fill, so slots
    ``old_n .. new_n-1`` equal freshly initialized ones and existing
    slots are untouched."""
    old_n = state.capacity
    if new_capacity < old_n:
        raise ValueError(
            f"grow_state cannot shrink: {new_capacity} < {old_n}")
    if new_capacity == old_n:
        return state

    def pad(arr, fill):
        ext = torch.full((new_capacity - old_n,) + tuple(arr.shape[1:]),
                         fill, dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, ext], dim=0)

    return EngineState(**{
        f: pad(getattr(state, f), _FRESH_FILLS[f])
        for f in EngineState._fields})
