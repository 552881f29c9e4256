"""Crash-safe checkpoint and resume of device-resident state.

Counterpart of ``dmclock_tpu/utils/checkpoint.py``, in its file format:
a snapshot is one ``.npz`` of the flattened leaves (``leaf_00000``,
``leaf_00001``, ...) plus a sha256 sidecar (``<path>.sha256``) over every
leaf's dtype, shape and bytes.  Either package restores the other's
snapshots, and the same tree gives the same sidecar in both.

Leaf order is the JAX package's tree order, which this module computes
itself (:func:`tree_flatten`): a dict's values in sorted key order, a
NamedTuple's, tuple's or list's in field order, ``None`` no leaf at all,
anything else (a tensor, a numpy array or scalar, a Python number) one
leaf.  ``torch.utils._pytree`` keeps a dict's insertion order, so it is
not used.

Crash safety:

- :func:`save_pytree` is atomic: data and sidecar go to temp files, are
  fsynced and ``os.replace``d into place (data first, then sidecar; the
  directory fsynced after each rename).  An existing pair is hard-linked
  to ``<path>.prev`` first, so a crash at any point leaves the previous
  snapshot intact under one name or the other.  ``_crash_hook`` (called
  with each of :data:`SAVE_STAGES`) and ``_post_commit_hook`` (called
  with the committed path) are the seams the tests and
  ``robust.host_faults`` inject kills and media rot through.
- :func:`restore_pytree` verifies the sidecar against the loaded leaves
  and raises :class:`CheckpointCorruptError` on a truncated file, a
  flipped byte or a missing sidecar.
- :func:`save_pytree_rotating` / :func:`restore_pytree_rotating` keep a
  rotation directory of ``ckpt-<seq>`` snapshots; restore walks newest
  to oldest to the first intact one.

Tensors go to the host with a blocking ``.cpu()``, so a save never reads
a tensor the card is still writing; on restore a leaf whose template is a
tensor comes back as a tensor (on ``device``, else the template's) and a
numpy template leaf comes back as numpy, with the template's dtype
either way.  The pull queue's host bookkeeping rides beside the device
state through :func:`queue_state_dict` / :func:`restore_queue_state`.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """The snapshot at a path is unreadable, torn, or fails its digest:
    restore must not hand it out."""


# kill seam: called with a stage label at every point a crash could
# interrupt a save
_crash_hook: Optional[Callable[[str], None]] = None

# media-rot seam: called with the committed path once a save has fully
# committed (data and sidecar durable, .prev pruned)
_post_commit_hook: Optional[Callable[[str], None]] = None

SAVE_STAGES = ("data_written", "data_synced", "data_renamed",
               "sidecar_written", "done")


def _crash(stage: str) -> None:
    if _crash_hook is not None:
        _crash_hook(stage)


# ----------------------------------------------------------------------
# the tree order
# ----------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[list, Any]:
    """``(leaves, treedef)`` in the JAX package's leaf order."""
    leaves: list = []

    def walk(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if _is_namedtuple(x):
            return ("namedtuple", type(x), [walk(v) for v in x])
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, None, [walk(v) for v in x])
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        children = [build(c) for c in node[2]]
        if kind == "dict":
            return dict(zip(node[1], children))
        if kind == "namedtuple":
            return node[1](*children)
        return tuple(children) if kind == "tuple" else list(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _template(ref) -> Tuple[np.dtype, tuple]:
    """The numpy dtype and shape a template leaf demands."""
    if torch.is_tensor(ref):
        return (torch.empty(0, dtype=ref.dtype).numpy().dtype,
                tuple(ref.shape))
    ref = np.asarray(ref)
    return ref.dtype, ref.shape


def _leaf_digest(arrays) -> str:
    """sha256 over every leaf's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def tree_digest(tree) -> str:
    """:func:`_leaf_digest` of a tree's leaves, read to the host."""
    return _leaf_digest([_to_numpy(x) for x in tree_flatten(tree)[0]])


# ----------------------------------------------------------------------
# one snapshot
# ----------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                 os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sidecar(path: str) -> str:
    return path + ".sha256"


def _prev(path: str) -> str:
    return path + ".prev"


def _pair_verifies(path: str) -> bool:
    """True when the (data, sidecar) pair at ``path`` loads and matches
    its digest (structure unchecked): the is-it-torn probe of a save
    that finds a leftover ``.prev``."""
    side = _sidecar(path)
    if not (os.path.exists(path) and os.path.exists(side)):
        return False
    try:
        with open(side) as fh:
            want = fh.read().strip()
        with np.load(path) as z:
            arrays = [z[n] for n in sorted(z.files)]
        return _leaf_digest(arrays) == want
    except Exception:
        return False


def save_pytree(path, tree: Any) -> None:
    """Atomically write ``tree``'s leaves (tmp + fsync + rename, digest
    sidecar).  Overwriting an existing snapshot first hard-links the old
    pair to ``<path>.prev`` (a pair cannot swap in one rename), so every
    crash point leaves the previous snapshot intact; the links go once
    the new pair has committed.  A ``.prev`` left by a crashed save is
    refreshed from the primary only if the primary verifies."""
    path = os.fspath(path)
    arrays = [_to_numpy(leaf) for leaf in tree_flatten(tree)[0]]
    digest = _leaf_digest(arrays)
    tmp_data = f"{path}.tmp.{os.getpid()}"
    tmp_side = f"{_sidecar(path)}.tmp.{os.getpid()}"
    if os.path.exists(path) and os.path.exists(_sidecar(path)):
        have_prev = os.path.exists(_prev(path)) and \
            os.path.exists(_sidecar(_prev(path)))
        if not have_prev or _pair_verifies(path):
            for src, dst in ((path, _prev(path)),
                             (_sidecar(path), _sidecar(_prev(path)))):
                if os.path.exists(dst):
                    os.unlink(dst)
                os.link(src, dst)
            _fsync_dir(path)
    try:
        with open(tmp_data, "wb") as fh:
            np.savez(fh, **{f"leaf_{i:05d}": a
                            for i, a in enumerate(arrays)})
            _crash("data_written")
            fh.flush()
            os.fsync(fh.fileno())
        _crash("data_synced")
        os.replace(tmp_data, path)
        _fsync_dir(path)
        _crash("data_renamed")
        with open(tmp_side, "w") as fh:
            fh.write(digest + "\n")
            _crash("sidecar_written")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp_side, _sidecar(path))
        _fsync_dir(path)
        _crash("done")
        for old in (_prev(path), _sidecar(_prev(path))):
            if os.path.exists(old):
                os.unlink(old)
        if _post_commit_hook is not None:
            _post_commit_hook(path)
    finally:
        for tmp in (tmp_data, tmp_side):
            if os.path.exists(tmp):
                os.unlink(tmp)


def restore_pytree(path, like: Any, *, strict_shapes: bool = True,
                   device=None) -> Any:
    """Restore a snapshot written by :func:`save_pytree` (by either
    package) into ``like``'s structure, dtypes and shapes.  Raises
    :class:`CheckpointCorruptError` unless the data loads, matches its
    sidecar and fits ``like``; an intact ``.prev`` pair (an interrupted
    in-place overwrite) is returned in place of a primary that fails.

    ``strict_shapes=False`` relaxes the shape check along axis 0 only
    (dtype, rank and trailing dimensions still gate): grow-on-demand
    leaves vary exactly there.  ``device`` places the leaves whose
    template is a tensor (default: the template leaf's device)."""
    path = os.fspath(path)
    try:
        return _restore_exact(path, like, strict_shapes=strict_shapes,
                              device=device)
    except CheckpointCorruptError:
        prev = _prev(path)
        if os.path.exists(prev) and os.path.exists(_sidecar(prev)):
            return _restore_exact(prev, like,
                                  strict_shapes=strict_shapes,
                                  device=device)
        raise


def _restore_exact(path: str, like: Any, *, strict_shapes: bool,
                   device) -> Any:
    side = _sidecar(path)
    if not os.path.exists(path):
        raise CheckpointCorruptError(f"no checkpoint at {path}")
    if not os.path.exists(side):
        raise CheckpointCorruptError(
            f"{path}: missing digest sidecar {side} -- save was "
            "interrupted or the sidecar was lost; refusing to restore")
    with open(side) as fh:
        want = fh.read().strip()
    like_leaves, treedef = tree_flatten(like)
    try:
        with np.load(path) as z:
            arrays = [z[n] for n in sorted(z.files)]
    except Exception as e:
        raise CheckpointCorruptError(f"{path}: unreadable ({e})")
    if len(arrays) != len(like_leaves):
        raise CheckpointCorruptError(
            f"{path}: {len(arrays)} leaves saved, structure needs "
            f"{len(like_leaves)}")
    got = _leaf_digest(arrays)
    if got != want:
        raise CheckpointCorruptError(
            f"{path}: digest mismatch (sidecar {want[:16]}..., "
            f"content {got[:16]}...) -- torn or corrupted snapshot")
    out = []
    for arr, ref in zip(arrays, like_leaves):
        dtype, shape = _template(ref)
        if arr.dtype != dtype or \
                (strict_shapes and arr.shape != shape) or \
                (not strict_shapes and
                 (arr.ndim != len(shape) or arr.shape[1:] != shape[1:])):
            raise CheckpointCorruptError(
                f"{path}: leaf shape/dtype {arr.shape}/{arr.dtype} != "
                f"expected {shape}/{dtype}")
        if torch.is_tensor(ref):
            out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
                ref.device if device is None else device))
        else:
            out.append(arr)
    return tree_unflatten(treedef, out)


# ----------------------------------------------------------------------
# rotation directory
# ----------------------------------------------------------------------

_ROT_RE = re.compile(r"^ckpt-(\d{8})$")


def _rotation_entries(dirpath: str) -> List[Tuple[int, str]]:
    out = []
    if not os.path.isdir(dirpath):
        return out
    for name in os.listdir(dirpath):
        m = _ROT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dirpath, name)))
    return sorted(out)


def rotation_paths(dirpath) -> List[str]:
    """Snapshot paths in a rotation directory, oldest to newest."""
    return [p for _, p in _rotation_entries(os.fspath(dirpath))]


def save_pytree_rotating(dirpath, tree: Any, keep: int = 4) -> str:
    """Write the next ``ckpt-<seq>`` snapshot into a rotation directory
    (created on demand), then prune to the newest ``keep``.  Returns the
    written path.  Each entry is an independent atomic save, so a crash
    mid-save never harms the older entries."""
    dirpath = os.fspath(dirpath)
    os.makedirs(dirpath, exist_ok=True)
    entries = _rotation_entries(dirpath)
    seq = entries[-1][0] + 1 if entries else 1
    path = os.path.join(dirpath, f"ckpt-{seq:08d}")
    save_pytree(path, tree)
    for _, old in _rotation_entries(dirpath)[:-keep]:
        for p in (old, _sidecar(old)):
            if os.path.exists(p):
                os.unlink(p)
    return path


def restore_pytree_rotating(dirpath, like: Any, *,
                            strict_shapes: bool = True, device=None
                            ) -> Tuple[Any, str]:
    """Restore the newest intact snapshot of a rotation directory,
    walking newest to oldest past torn or corrupt entries.  Returns
    ``(tree, path)``; raises :class:`CheckpointCorruptError` when no
    entry verifies."""
    dirpath = os.fspath(dirpath)
    errors = []
    for _, path in reversed(_rotation_entries(dirpath)):
        try:
            return restore_pytree(path, like, strict_shapes=strict_shapes,
                                  device=device), path
        except CheckpointCorruptError as e:
            errors.append(str(e))
    raise CheckpointCorruptError(
        f"{dirpath}: no intact snapshot in rotation"
        + (f" ({'; '.join(errors)})" if errors else " (empty)"))


# ----------------------------------------------------------------------
# the pull queue's host bookkeeping
# ----------------------------------------------------------------------

def queue_state_dict(q) -> dict:
    """Host bookkeeping of a ``TpuPullPriorityQueue`` as plain data.

    Call it BEFORE ``save_pytree(path, q.state)``: it settles any
    speculative prefetch and flushes buffered ops into the device state,
    so the state saved after it is the one the payload FIFOs match."""
    with q.data_mtx:
        q._settle_spec()
        q._flush()
        return {
            "slot_of": dict(q._slot_of),
            "payloads": {s: list(d) for s, d in q._payloads.items()},
            "free": list(q._free),
            "next_order": q._next_order,
            "last_tick": dict(q._last_tick),
            "tick": q.tick,
            "counters": (q.reserv_sched_count, q.prop_sched_count,
                         q.limit_break_sched_count),
        }


def restore_queue_state(q, st: dict) -> None:
    """Restore host bookkeeping saved by :func:`queue_state_dict`.

    Restore the device state FIRST (``q.state = restore_pytree(...)``),
    then call this: the checks against the restored device state catch a
    mismatched pair of snapshots (payload FIFOs out of step with the
    device queue depths would hand out wrong payloads).  The queue's
    host mirror of ``state.idle`` is re-read from the restored state."""
    from collections import deque

    capacity = int(q.state.capacity)
    depth = q.state.depth.cpu().numpy()
    active = q.state.active.cpu().numpy()
    for c, s in st["slot_of"].items():
        if not 0 <= s < capacity:
            raise ValueError(
                f"restore mismatch: client {c!r} maps to slot {s}, "
                f"device capacity {capacity}")
    for s, d in st["payloads"].items():
        if not 0 <= s < capacity:
            raise ValueError(
                f"restore mismatch: payload FIFO for slot {s} is "
                f"outside device capacity {capacity}")
        if len(d) != int(depth[s]):
            raise ValueError(
                f"restore mismatch: slot {s} has {len(d)} payloads but "
                f"device depth {int(depth[s])} -- device and host "
                "snapshots are from different moments")
    occupied = np.flatnonzero(active & (depth > 0))
    missing = [int(s) for s in occupied if s not in st["payloads"]]
    if missing:
        raise ValueError(
            f"restore mismatch: device slots {missing} hold queued "
            "requests but have no host payload FIFO -- device and host "
            "snapshots are from different moments")

    with q.data_mtx:
        q._pending = []      # ops buffered against the old state
        # drop any speculative prefetch computed against the old state
        # without settling it (a settle would replay pre-restore
        # decisions over the restored state)
        q._buf.clear()
        q._buf_slots.clear()
        q._buf_horizon = 0
        q._spec_pre = None
        q._spec_consumed = 0
        q._host_idle.clear()
        if q._spec:
            q._spec_size = 1
        q._clean_mark_points.clear()
        q._last_erase_point = 0
        q._slot_of = dict(st["slot_of"])
        q._client_of = {s: c for c, s in q._slot_of.items()}
        q._payloads = {s: deque(d) for s, d in st["payloads"].items()}
        q._free = list(st["free"])
        q._next_order = st["next_order"]
        q._last_tick = dict(st["last_tick"])
        q.tick = st["tick"]
        (q.reserv_sched_count, q.prop_sched_count,
         q.limit_break_sched_count) = st["counters"]
