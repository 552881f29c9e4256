"""Shard groups: a mesh's stacked ``[S, ...]`` trees over several devices.

Counterpart of the JAX package's ``NamedSharding(mesh, P("servers"))``
over a ``servers`` mesh of devices.  One process places the shards in D
contiguous blocks of ``S // D``: shard ``s`` lives on group ``s // (S //
D)``, and each group's shards stay stacked on a leading axis of every
tensor on that group's device, as the whole port stacks them on one
card.  D = S is the JAX mesh's one shard a device.

A layout may name one device more than once (``("cpu",) * 4`` in the
tests, ``("cuda:0",) * 8`` on one card): that runs the grouped code on
one device.  It is a layout the caller asks for, never a stand-in that
the code picks for a missing device.

The reductions between groups are exact: each group reduces its own
block on its own device, and the partials fold on ``devices[0]`` in
group order through plain device-to-device copies, which PyTorch orders
with both devices' current streams.  int64 sums and maxima are exact in
any order, so every reduction equals the same reduction over the one
stacked tensor bit for bit.

A one-group layout keeps the plain stacked tree: :func:`place` moves it
to its device and nothing else changes, so the single-device mesh runs
as it always has.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


class Grouped:
    """A stacked ``[S, ...]`` tree cut into ``len(devices)`` contiguous
    blocks of shards: ``parts[g]`` is the stacked tree of group ``g``'s
    shards, on ``devices[g]``.  Not a tuple, so tree walkers never take
    it for a node of the tree it holds.  It is a ``torch.utils._pytree``
    node (its parts the children, its devices the context), so a
    captured program (``obs/compile_plane.py``) takes a grouped argument
    as its tensors, never as a constant."""

    __slots__ = ("parts", "devices")

    def __init__(self, parts, devices):
        self.parts = tuple(parts)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.parts) != len(self.devices) or not self.parts:
            raise ValueError(f"{len(self.parts)} parts on "
                             f"{len(self.devices)} devices")

    @property
    def n_groups(self) -> int:
        return len(self.parts)

    @property
    def n_shards(self) -> int:
        return sum(leading(p) for p in self.parts)

    @property
    def per_group(self) -> int:
        return leading(self.parts[0])

    def __getattr__(self, name: str):
        """A field of the parts (``tracker.completed_delta``), grouped
        the same way."""
        if name.startswith("_"):
            raise AttributeError(name)
        return Grouped([getattr(p, name) for p in self.parts],
                       self.devices)

    def _replace(self, **fields) -> "Grouped":
        """Replace fields of every part with grouped values of the same
        layout."""
        for k, v in fields.items():
            if not isinstance(v, Grouped) or v.devices != self.devices:
                raise ValueError(f"field {k!r}: not grouped like the "
                                 "tree it replaces into")
        return Grouped([p._replace(**{k: v.parts[g]
                                      for k, v in fields.items()})
                        for g, p in enumerate(self.parts)], self.devices)

    def __repr__(self) -> str:
        return (f"Grouped({self.n_shards} shards over "
                f"{[str(d) for d in self.devices]})")


pytree.register_pytree_node(
    Grouped, lambda g: (list(g.parts), g.devices),
    lambda parts, devices: Grouped(parts, devices),
    flatten_with_keys_fn=lambda g: (
        [(pytree.SequenceKey(i), p) for i, p in enumerate(g.parts)],
        g.devices))


def is_grouped(tree) -> bool:
    return isinstance(tree, Grouped)


# ----------------------------------------------------------------------
# trees (NamedTuples, tuples and dicts of tensors; None leaves kept)
# ----------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a NamedTuple/tuple/dict tree
    (and parallel trees of the same structure); None stays None.  A
    :class:`Grouped` tree maps part by part, its layout kept."""
    if tree is None:
        return None
    if isinstance(tree, Grouped):
        return Grouped([tree_map(fn, p, *(r.parts[g] for r in rest))
                        for g, p in enumerate(tree.parts)], tree.devices)
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    raise TypeError(f"not a tensor tree leaf: {type(tree)!r}")


def _join(trees: list, fn):
    first = trees[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return fn(trees)
    if isinstance(first, dict):
        return {k: _join([t[k] for t in trees], fn) for k in first}
    items = [_join(list(col), fn) for col in zip(*trees)]
    return type(first)(*items) if hasattr(first, "_fields") \
        else tuple(items)


def stack_trees(trees: list):
    """Stack per-shard trees on a new leading axis (None stays None)."""
    return _join(trees, torch.stack)


def cat_trees(trees: list):
    """Concatenate stacked trees along their leading axis."""
    return _join(trees, torch.cat)


def _children(tree):
    return tree.values() if isinstance(tree, dict) else tree


def first_leaf(tree):
    """The first tensor leaf of a tree (None for a tree of Nones); for
    a grouped tree, one of its first group's."""
    node = first_node(tree)
    return first_leaf(node.parts[0]) if isinstance(node, Grouped) else node


def first_node(tree):
    """The first leaf (a tensor or array) or :class:`Grouped` node of a
    tree."""
    if not isinstance(tree, (tuple, dict)):
        return tree
    for v in _children(tree):
        node = first_node(v)
        if node is not None:
            return node
    return None


def leading(tree) -> int:
    """The shard count of a stacked tree, a grouped one, or a tree whose
    leaves are grouped."""
    node = first_node(tree)
    if isinstance(node, Grouped):
        return sum(leading(p) for p in node.parts)
    return int(node.shape[0])


def _rebuild(tree, items):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), items))
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else tuple(items)


# ----------------------------------------------------------------------
# the shard -> (group, local index) map
# ----------------------------------------------------------------------

def check_split(n_shards: int, n_groups: int) -> int:
    """Shards a group (``S // D``); raises unless ``D`` divides ``S``."""
    if n_groups < 1:
        raise ValueError("a layout needs at least one device")
    if n_shards % n_groups:
        raise ValueError(f"{n_shards} shards do not split over "
                         f"{n_groups} devices (S % D must be 0)")
    return n_shards // n_groups


def group_of(n_shards: int, n_groups: int) -> list:
    """The group of every shard of an ``n_shards`` layout over
    ``n_groups`` groups: shard ``s`` is in group ``s // (S // D)``."""
    per = check_split(n_shards, n_groups)
    return [s // per for s in range(n_shards)]


def locate(tree, s: int) -> tuple:
    """``(group, index in the group)`` of shard ``s`` of a grouped tree
    (group 0 and ``s`` for a stacked one)."""
    node = first_node(tree)
    if not isinstance(node, Grouped):
        return 0, s
    return divmod(s, node.per_group)


def group_devices(tree) -> tuple:
    """The devices of a tree's groups (one for a stacked tree)."""
    node = first_node(tree)
    if isinstance(node, Grouped):
        return node.devices
    return (first_leaf(tree).device,)


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------

def place(tree, devices: Sequence):
    """A stacked ``[S, ...]`` tree (on any device, or already grouped)
    laid out over ``devices``: shard ``s`` on group ``s // (S // D)``.
    One device gives the stacked tree on it; several give a
    :class:`Grouped` whose parts are copies, so no part shares storage
    with the input or with another part."""
    if tree is None:
        return None
    devices = tuple(torch.device(d) for d in devices)
    if isinstance(tree, Grouped) and tree.devices == devices:
        return tree
    if isinstance(first_node(tree), Grouped):
        tree = gather(tree)
    if len(devices) == 1:
        return tree_map(lambda a: a.to(devices[0]), tree)
    per = check_split(leading(tree), len(devices))
    return Grouped([tree_map(lambda a, g=g, d=d: a[g * per:(g + 1) * per]
                             .to(d, copy=True), tree)
                    for g, d in enumerate(devices)], devices)


def gather(tree, device=None):
    """A grouped tree (or a tree with grouped leaves) back as stacked
    tensors on ``device`` (default each grouped node's first device); a
    stacked leaf is moved to ``device`` if one is named, else kept."""
    if tree is None:
        return None
    if isinstance(tree, Grouped):
        dev = tree.devices[0] if device is None else torch.device(device)
        return cat_trees([tree_map(lambda a: a.to(dev), p)
                          for p in tree.parts])
    if isinstance(tree, (tuple, dict)):
        return _rebuild(tree, [gather(v, device) for v in _children(tree)])
    return tree if device is None else tree.to(torch.device(device))


def view(tree, s: int):
    """Shard ``s`` of a stacked or grouped tree: leading-index views on
    the shard's own device (contiguous for a contiguous stack)."""
    if tree is None:
        return None
    if isinstance(tree, Grouped):
        g, j = divmod(s, tree.per_group)
        return tree_map(lambda a: a[j], tree.parts[g])
    if isinstance(tree, (tuple, dict)):
        return _rebuild(tree, [view(v, s) for v in _children(tree)])
    return tree[s]


def host(x) -> np.ndarray:
    """A stacked or grouped tensor as one ``[S, ...]`` host array: one
    copy to the host a group, joined in shard order (no stack is
    gathered on a device)."""
    if isinstance(x, Grouped):
        return np.concatenate([p.cpu().numpy() for p in x.parts])
    return x.cpu().numpy()


def read_rows(x, s: int, rows) -> torch.Tensor:
    """Rows ``rows`` of shard ``s`` of a stacked or grouped tensor, on
    the shard's device."""
    v = view(x, s)
    return v.index_select(0, torch.as_tensor(rows, dtype=torch.int64,
                                             device=v.device))


def fill_rows(x, s: int, rows, value) -> None:
    """Fill rows ``rows`` of shard ``s`` with ``value``, in place on the
    shard's device."""
    v = view(x, s)
    v.index_fill_(0, torch.as_tensor(rows, dtype=torch.int64,
                                     device=v.device), value)


def write_rows(x, s: int, rows, values) -> None:
    """Write ``values`` (host or device, one a row) at rows ``rows`` of
    shard ``s``, in place on the shard's device."""
    v = view(x, s)
    v.index_put_((torch.as_tensor(rows, dtype=torch.int64,
                                  device=v.device),),
                 torch.as_tensor(values, dtype=v.dtype, device=v.device))


def rebuild(fn: Callable, trees: Sequence) -> tuple:
    """Every shard of ``trees`` (stacked or grouped alike, None entries
    kept) through ``fn(s, *views) -> tuple of per-shard trees``, the
    results stacked again by the layout of ``trees[0]``.  A grow of
    every shard to one capacity this way keeps one rectangle across all
    groups, as the JAX package's unstack and restack does."""
    devices = group_devices(trees[0])
    outs = [fn(s, *(view(t, s) for t in trees))
            for s in range(leading(trees[0]))]
    return tuple(restack([o[j] for o in outs], devices)
                 for j in range(len(outs[0])))


def restack(per_shard: list, devices: Sequence):
    """Per-shard trees (each on its group's device) stacked by the
    layout of ``devices``: one stacked tree, or a :class:`Grouped` of
    one stack a group."""
    if per_shard[0] is None:
        return None
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) == 1:
        return stack_trees(per_shard)
    per = check_split(len(per_shard), len(devices))
    return Grouped([stack_trees(per_shard[g * per:(g + 1) * per])
                    for g in range(len(devices))], devices)


# ----------------------------------------------------------------------
# reductions between groups
# ----------------------------------------------------------------------

def reduce(x, axis_fn: Callable, combine_fn: Callable) -> torch.Tensor:
    """Reduce a stacked or grouped tree over its shard axis: ``axis_fn``
    reduces each group's block on its device, and the partials fold on
    the first group's device in group order with ``combine_fn``.  A
    stacked tree is ``axis_fn`` alone."""
    if not isinstance(x, Grouped):
        return axis_fn(x)
    dev = x.devices[0]
    acc = axis_fn(x.parts[0])
    for p in x.parts[1:]:
        part = tree_map(lambda a: a.to(dev), axis_fn(p))
        acc = combine_fn(acc, part)
    return acc


def sum_parts(partials: list, devices: Sequence) -> list:
    """Per-group partials (group ``g``'s a tensor tree on ``devices[g]``)
    summed over the groups on the first device in group order, and one
    copy of the sum handed to each group on its device: the ``psum``
    between the legs of a grouped program.  One group keeps its own."""
    if len(partials) == 1:
        return list(partials)
    return list(replicate(reduce(Grouped(partials, devices), lambda a: a,
                                 lambda a, b: tree_map(torch.add, a, b)),
                          devices))


class Replicated(tuple):
    """One copy of a value a group, copy ``g`` on group ``g``'s device:
    what a collective (the JAX package's ``psum``) hands every shard.
    A ``torch.utils._pytree`` node (its copies the children), so a
    captured program takes a replicated argument as its tensors."""


pytree.register_pytree_node(
    Replicated, lambda r: (list(r), None),
    lambda copies, _: Replicated(copies),
    flatten_with_keys_fn=lambda r: (
        [(pytree.SequenceKey(i), x) for i, x in enumerate(r)], None))


def replicate(value, devices: Sequence) -> Replicated:
    """One copy of ``value`` (a tensor tree) on each of ``devices``; a
    device the value already lies on shares it."""
    leaf = first_leaf(value)
    out = []
    for d in devices:
        d = torch.device(d)
        out.append(value if leaf is None or leaf.device == d
                   else tree_map(lambda a, d=d: a.to(d), value))
    return Replicated(out)


def pick(value, g: int):
    """Group ``g``'s share of a value: its copy of a :class:`Replicated`
    value, its block of a :class:`Grouped` tree; any other value (a
    stacked tree among them) is the same for every group."""
    if isinstance(value, Replicated):
        return value[g]
    return value.parts[g] if isinstance(value, Grouped) else value
