"""Slot management: client id <-> dense slot index over growing state.

Counterpart of ``dmclock_tpu/lifecycle/slots.py``.  The epoch engines
run dense passes over ``[capacity]`` tensors, so an open client
population (clients register, idle out and are erased:
``dmclock_server.h:913-932``, ``:1206-1255``) needs three mechanisms:

- **allocation**: a host-side map from client id to slot index, with a
  lowest-slot-first free list, so the free order is a pure function of
  the occupied-slot set and a resume can rebuild the allocator from the
  encoded ``cid_of_slot`` array alone;
- **growth**: geometric doubling through ``engine.state.grow_state``,
  whose new slots equal init-time ones, so growing mid-run cannot
  change a decision;
- **compaction**: churn fragments the live set across the slot space,
  and every launch pays a dense pass over all of it.  A compaction
  repacks live clients into a dense prefix by one gather per tensor
  (:func:`compact_tree`).  Every selection in the engines is
  permutation-invariant (mins, sums, sorts and argmin ties keyed on the
  per-client ``order`` field, which moves with its row), so a compacted
  run serves the same client-id decision stream as an uncompacted one.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np
import torch


def owner_shard(cids, n_shards: int):
    """Client->shard ownership: id ``c`` lives on shard ``c %
    n_shards``.  Deterministic and spec-independent, so a dynamic run,
    its static variant and a resumed run route an id alike."""
    return np.asarray(cids) % int(n_shards)


def owned_ids(total: int, shard: int, n_shards: int) -> np.ndarray:
    """Ascending client ids shard ``shard`` owns out of ``total``."""
    ids = np.arange(int(total), dtype=np.int64)
    return ids[ids % int(n_shards) == int(shard)]


class SlotMap:
    """Host-side client-id <-> slot-index map with slot recycling.

    Client ids are non-negative ints (the lifecycle plane's id space;
    the pull queue keeps its own hashable-id map).  ``cid_of_slot`` is
    the canonical state: everything else (the reverse map, the free
    heap) is derived, which is what makes the map checkpointable as a
    single int64 array plus three scalars."""

    def __init__(self, capacity: int):
        self.cid_of_slot = np.full(capacity, -1, dtype=np.int64)
        self.ever_used = np.zeros(capacity, dtype=bool)
        self.slot_of: Dict[int, int] = {}
        self._free: List[int] = list(range(capacity))
        heapq.heapify(self._free)
        self.next_order = 0

    @property
    def capacity(self) -> int:
        return int(self.cid_of_slot.shape[0])

    @property
    def live_count(self) -> int:
        return len(self.slot_of)

    def allocate(self, cid: int) -> int:
        """Bind ``cid`` to the lowest free slot; returns the slot and
        the creation order it should carry (via ``take_order``), or -1
        when full (caller grows and retries).  ``cid`` must not be
        registered."""
        cid = int(cid)
        assert cid >= 0 and cid not in self.slot_of, cid
        if not self._free:
            return -1
        slot = heapq.heappop(self._free)
        self.cid_of_slot[slot] = cid
        self.slot_of[cid] = slot
        return slot

    def take_order(self) -> int:
        order = self.next_order
        self.next_order += 1
        return order

    def was_used(self, slot: int) -> bool:
        """True when ``slot`` held an earlier tenant (a recycle); marks
        it used either way."""
        prior = bool(self.ever_used[slot])
        self.ever_used[slot] = True
        return prior

    def release(self, cid: int) -> int:
        slot = self.slot_of.pop(int(cid))
        self.cid_of_slot[slot] = -1
        heapq.heappush(self._free, slot)
        return slot

    def grow(self, new_capacity: int) -> None:
        old = self.capacity
        assert new_capacity > old
        self.cid_of_slot = np.concatenate(
            [self.cid_of_slot,
             np.full(new_capacity - old, -1, dtype=np.int64)])
        self.ever_used = np.concatenate(
            [self.ever_used, np.zeros(new_capacity - old, dtype=bool)])
        for s in range(old, new_capacity):
            heapq.heappush(self._free, s)

    # -- compaction ----------------------------------------------------
    def compaction_perm(self) -> Optional[np.ndarray]:
        """Permutation packing live slots into a dense prefix (stable:
        live slots keep their relative order), or None when the live
        set is already dense -- the caller skips the launch."""
        live = np.flatnonzero(self.cid_of_slot >= 0)
        if live.size == 0 or int(live[-1]) == live.size - 1:
            return None
        free = np.flatnonzero(self.cid_of_slot < 0)
        return np.concatenate([live, free]).astype(np.int32)

    def apply_perm(self, perm: np.ndarray) -> None:
        """Re-map after the device state was gathered by ``perm``."""
        self.cid_of_slot = self.cid_of_slot[perm]
        self.ever_used = self.ever_used[perm]
        self.slot_of = {int(c): s
                        for s, c in enumerate(self.cid_of_slot)
                        if c >= 0}
        self._free = [int(s) for s in
                      np.flatnonzero(self.cid_of_slot < 0)]
        heapq.heapify(self._free)

    # -- client-id-space views -----------------------------------------
    def translate(self, slot_arr) -> np.ndarray:
        """Map an int slot array into client-id space (-1 and other
        negative pads pass through) -- the canonicalization that makes
        decision streams comparable across slot layouts (compaction,
        recycling, growth all shuffle slots but never client ids)."""
        a = np.asarray(slot_arr)
        out = np.full(a.shape, -1, dtype=np.int64)
        valid = (a >= 0) & (a < self.capacity)
        out[valid] = self.cid_of_slot[a[valid]]
        return out

    def scatter_by_cid(self, arr, total: int) -> np.ndarray:
        """Re-index a per-slot array (last axis = capacity) into a
        per-client-id array of width ``total`` (unregistered ids keep
        zero) -- the calendar engine's per-client ``served`` counts
        canonicalize this way."""
        a = np.asarray(arr)
        assert a.shape[-1] == self.capacity, (a.shape, self.capacity)
        out = np.zeros(a.shape[:-1] + (total,), dtype=a.dtype)
        live = self.cid_of_slot >= 0
        out[..., self.cid_of_slot[live]] = a[..., live]
        return out

    # -- checkpoint round-trip -----------------------------------------
    def encode(self) -> dict:
        return {"lc_cids": self.cid_of_slot.copy(),
                "lc_ever": self.ever_used.copy(),
                "lc_next_order": np.int64(self.next_order)}

    @classmethod
    def load(cls, payload: dict) -> "SlotMap":
        cids = np.asarray(payload["lc_cids"], dtype=np.int64)
        m = cls(int(cids.shape[0]))
        m.cid_of_slot = cids.copy()
        m.ever_used = np.asarray(payload["lc_ever"],
                                 dtype=bool).copy()
        m.next_order = int(payload["lc_next_order"])
        m.slot_of = {int(c): s for s, c in enumerate(cids) if c >= 0}
        m._free = [int(s) for s in np.flatnonzero(cids < 0)]
        heapq.heapify(m._free)
        return m


# ----------------------------------------------------------------------
# device-side compaction
# ----------------------------------------------------------------------

def _gather_tree(tree, idx_of):
    if isinstance(tree, torch.Tensor):
        return torch.index_select(tree, 0, idx_of(tree.device))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_gather_tree(x, idx_of) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather_tree(x, idx_of) for x in tree)
    raise TypeError(f"compact_tree: unsupported leaf {type(tree)!r}")


def _devices(tree, out: set) -> set:
    """The devices of a tree's tensors (raises on any other leaf)."""
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _devices(x, out)
    else:
        raise TypeError(f"compact_tree: unsupported leaf {type(tree)!r}")
    return out


def _take(tree, perm):
    """Every tensor of ``tree`` gathered by ``perm`` along axis 0."""
    return _gather_tree(tree, lambda dev: perm)


# the JAX package's ``_COMPACT_JIT["take"]``: one program outside the
# compile plane's records, a capture for each tree structure and shape
_COMPACT_JIT: dict = {}


def compact_program():
    """The program of :func:`_take`: ``(tree, perm int64) -> tree``
    (cache ``lifecycle.compact``, entry ``take``, unrecorded)."""
    if "take" not in _COMPACT_JIT:
        from ..obs import compile_plane

        _COMPACT_JIT["take"] = compile_plane.InstrumentedJit(
            _take, cache="lifecycle.compact", entry="take", record=False)
    return _COMPACT_JIT["take"]


def compact_tree(tree, perm):
    """Gather every leaf of a tree (tensors, tuples, lists and
    NamedTuples such as ``EngineState``) of ``[capacity, ...]`` tensors
    by ``perm`` along axis 0: one ``index_select`` per leaf.  Covers the
    state's ``[N, Q]`` rings, the ledger, the SLO block and any extras
    alike.  A tree on one device runs as the program
    ``_COMPACT_JIT["take"]`` (``perm`` an int64 tensor input, a capture
    for each tree structure and shape, as JAX retraces for each); a tree
    over several devices (one CUDA graph holds one device) gathers on
    each with the index uploaded once per device."""
    perm = np.asarray(perm, dtype=np.int64)
    devs = _devices(tree, set())
    if len(devs) == 1:
        return compact_program()(tree,
                                 torch.from_numpy(perm).to(devs.pop()))
    idx: Dict[torch.device, torch.Tensor] = {}

    def idx_of(dev):
        if dev not in idx:
            idx[dev] = torch.from_numpy(perm).to(dev)
        return idx[dev]

    return _gather_tree(tree, idx_of)
