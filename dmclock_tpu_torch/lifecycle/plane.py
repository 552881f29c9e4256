"""The client lifecycle plane: open-population control over the engines.

Counterpart of ``dmclock_tpu/lifecycle/plane.py``.  The reference
serves an open population: clients register
(``dmclock_server.h:913-932``), idle out and are erased (:1206-1255),
and have their QoS triple replaced in flight (``update_client_info``).
This module is a host-side control plane over the epoch engines, on
one discipline: lifecycle ops apply only at epoch boundaries, batched
into one application per boundary, so the epoch loops never change and
the hot path takes no lock.

Pieces:

- :class:`LifecyclePlane` -- owns the :class:`~.slots.SlotMap`, the
  pending-op journal (accepted control ops waiting for their boundary),
  per-client zero-arrival streaks (idle eviction), the lifecycle
  counters and the departed-clients report.
- :func:`apply_op_vector` -- the device half: an ordered vector of
  (register | qos-update | evict | idle) rows.  The JAX package runs it
  as a ``lax.scan`` over rows; here the rows are folded on the host
  into one final record per slot (the last reset, then the QoS and idle
  writes after it) and applied by one captured program of masked
  writes under the JAX key (every index list padded to the rows with a
  dropped row).  Register and
  evict both reset the row to ``engine.state._FRESH_FILLS``, so a
  recycled slot equals a fresh one.
- an admin **WAL** (``admin.wal`` in ``workdir``): every op accepted
  through the control API is fsynced before it is acknowledged, and the
  encoded ``wal_seen`` cursor applies each line exactly once.
- canonical **client-id-space views** (:meth:`LifecyclePlane.
  canon_results`): decision streams hash with slots translated to
  client ids and per-slot arrays scattered to the id space, so
  registration timing, slot recycling, growth and compaction leave the
  digest unchanged.

- per-shard routing: ``shard=(s, n_shards)`` makes a plane one shard's
  of a mesh job (the supervisor's mesh loop builds one per shard); it
  sees only the scripted events and control ops of the client ids its
  shard owns (the attached ``placement.PlacementMap``, else
  ``slots.owner_shard``) and refuses a control op for another shard's id.
- live-migration halves (:meth:`LifecyclePlane.migrate_out` /
  :meth:`LifecyclePlane.migrate_in`): the EVICT and REGISTER ops folded
  on the host, which the supervisor's ``_mesh_migrate`` drives as one
  two-sided move when the closed-loop controller fires ``migrate``.
"""

from __future__ import annotations

import json
import os
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.qos import validate_client_info
from ..core.timebase import rate_to_inv_ns
from ..engine.state import _FRESH_FILLS, EngineState, grow_state
from ..obs.histograms import LED_COLS
from . import churn as churn_mod
from .slots import SlotMap, compact_tree

# op codes of the update vector (0 = padding NOP).  LC_IDLE sets the
# slot's idle flag and nothing else: the static reference population
# applies it at exactly the boundaries the dynamic run EVICTS, so a
# departed client leaves the engines' idle-reactivation min identically
# in both runs.
LC_NOP, LC_REGISTER, LC_UPDATE, LC_EVICT, LC_IDLE = 0, 1, 2, 3, 4

WAL_FILE = "admin.wal"

# test seam: called between the compaction gather and the host-side
# slot-map re-map
_compact_hook = None


# ----------------------------------------------------------------------
# device half: one application of a boundary's op vector
# ----------------------------------------------------------------------

def _pad_len(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _fold_ops(kind, slot, resv_inv, weight_inv, limit_inv, order):
    """The ordered rows' net effect per slot, as index/value arrays:
    ``reset`` slots whose last REGISTER/EVICT resets the row to the
    fills; ``reg`` (slots, orders) whose last reset is a REGISTER;
    ``qos`` (slots, r, w, l) with the last QoS write after the last
    reset; ``idle`` slots marked idle with no reset.  A row of any other
    kind (LC_NOP, padding) touches nothing."""
    rec: Dict[int, list] = {}
    for k, s, ri, wi, li, o in zip(*(np.asarray(a, dtype=np.int64)
                                     .tolist() for a in
                                     (kind, slot, resv_inv, weight_inv,
                                      limit_inv, order))):
        if k not in (LC_REGISTER, LC_UPDATE, LC_EVICT, LC_IDLE):
            continue
        # [reset, order or None, qos or None, idle]
        e = rec.setdefault(s, [False, None, None, False])
        if k == LC_REGISTER:
            rec[s] = [True, o, (ri, wi, li), False]
        elif k == LC_EVICT:
            rec[s] = [True, None, None, False]
        elif k == LC_UPDATE:
            e[2] = (ri, wi, li)
        else:
            e[3] = True
    reset = [s for s, e in rec.items() if e[0]]
    reg = [(s, e[1]) for s, e in rec.items() if e[1] is not None]
    qos = [(s,) + e[2] for s, e in rec.items() if e[2] is not None]
    idle = [s for s, e in rec.items() if e[3] and not e[0]]
    return reset, reg, qos, idle


def _ops_body(state: EngineState, r_idx, g_idx, g_ord, q_idx, q_r, q_w,
              q_l, i_idx) -> EngineState:
    """The folded rows applied to ``state`` out of place, as masks: the
    resets to the fills first, then the registers' active flag and
    order, the QoS inverses and the idle marks.  Every index list is
    padded to the op vector's length with the dropped row
    ``capacity``, so one shape serves every boundary."""
    n, dev = state.capacity, state.device

    def rows(idx):
        return torch.zeros((n + 1,), dtype=torch.bool, device=dev) \
            .index_fill_(0, idx, True)[:n]

    def values(idx, v):
        return torch.zeros((n + 1,), dtype=torch.int64, device=dev) \
            .index_copy_(0, idx, v)[:n]

    reset, reg, qos, idle = rows(r_idx), rows(g_idx), rows(q_idx), \
        rows(i_idx)
    new = {}
    for f in EngineState._fields:
        t = getattr(state, f)
        new[f] = t.masked_fill(reset.view((n,) + (1,) * (t.dim() - 1)),
                               _FRESH_FILLS[f])
    new["active"] = new["active"].masked_fill(reg, True)
    new["order"] = torch.where(reg, values(g_idx, g_ord), new["order"])
    for f, idx, v in (("resv_inv", q_idx, q_r), ("weight_inv", q_idx, q_w),
                      ("limit_inv", q_idx, q_l)):
        new[f] = torch.where(qos, values(idx, v), new[f])
    new["idle"] = new["idle"].masked_fill(idle, True)
    return EngineState(**new)


# the JAX package's ``_OPS_JIT``: one program outside the compile
# plane's records a ``(capacity, ring capacity, rows)``
_OPS_JIT: dict = {}


def ops_program(capacity: int, ring_capacity: int, rows: int):
    """The program of :func:`_ops_body` under the JAX key ``(capacity,
    ring_capacity, rows)`` (cache ``lifecycle.ops``, unrecorded, as the
    JAX package's bare ``jax.jit`` is)."""
    key = (int(capacity), int(ring_capacity), int(rows))
    if key not in _OPS_JIT:
        from ..obs import compile_plane

        _OPS_JIT[key] = compile_plane.InstrumentedJit(
            _ops_body, cache="lifecycle.ops", entry=key, record=False)
    return _OPS_JIT[key]


def _fold_checked(state: EngineState, kind, slot, resv_inv, weight_inv,
                  limit_inv, order):
    """:func:`_fold_ops`'s lists, or None when the rows touch nothing;
    raises on a slot outside the state."""
    reset, reg, qos, idle = _fold_ops(kind, slot, resv_inv, weight_inv,
                                      limit_inv, order)
    n = state.capacity
    for s in set(reset) | {s for s, _ in reg} | {q[0] for q in qos} \
            | set(idle):
        if not 0 <= s < n:
            raise ValueError(f"op slot {s} outside [0, {n})")
    if not (reset or qos or idle):
        return None
    return reset, reg, qos, idle


def op_vector_inputs(state: EngineState, kind, slot, resv_inv,
                     weight_inv, limit_inv, order):
    """An op vector's rows folded on the host (:func:`_fold_ops`) and
    uploaded in one copy as :func:`_ops_body`'s eight index and value
    tensors, each padded to the rows with the dropped row; None when the
    rows touch nothing.  Raises on a slot outside the state."""
    folded = _fold_checked(state, kind, slot, resv_inv, weight_inv,
                           limit_inv, order)
    if folded is None:
        return None
    reset, reg, qos, idle = folded
    n = state.capacity
    b = int(np.asarray(kind).shape[0])

    def pad(xs, fill):
        return np.concatenate([np.asarray(xs, dtype=np.int64),
                               np.full((b - len(xs),), fill, np.int64)])

    reg_a = np.asarray(reg, dtype=np.int64).reshape(-1, 2)
    qos_a = np.asarray(qos, dtype=np.int64).reshape(-1, 4)
    flat = np.concatenate(
        [pad(reset, n), pad(reg_a[:, 0], n), pad(reg_a[:, 1], 0)]
        + [pad(qos_a[:, 0], n)] + [pad(qos_a[:, i], 0) for i in (1, 2, 3)]
        + [pad(idle, n)])
    return torch.from_numpy(flat).to(state.device).view(8, b).unbind(0)


def apply_op_vector(state: EngineState, kind, slot, resv_inv,
                    weight_inv, limit_inv, order, *,
                    inplace: bool = False) -> EngineState:
    """Apply an ordered batch of lifecycle ops; equal to the JAX
    package's ordered scan over the rows.

    ``kind`` int32[B] of LC_* codes; rows compose in order (a register
    and an update of one slot in one boundary act like separate
    boundaries).  REGISTER resets the row to the ``init_state`` fills
    then installs active/order/QoS inverses -- ``kernels.ingest``'s
    OP_CREATE; UPDATE replaces the three QoS inverses and nothing else;
    EVICT resets the row to the fills (active False), tail-ring rows
    included, so the slot's next tenant equals a fresh one; IDLE sets
    the slot's idle flag and nothing else.  The rows are folded on the
    host (:func:`_fold_ops`), each index list padded to ``B`` with a
    dropped row and uploaded in one copy, and applied by the program
    ``_OPS_JIT[(capacity, ring_capacity, B)]`` (:func:`_ops_body`, the
    JAX key).  ``inplace=True`` scatters into ``state``'s own tensors
    instead, eagerly (a stacked mesh state's shard views ``x[s]``,
    whose rows a live migration rewrites; JAX has no such write)."""
    if inplace:
        return _apply_inplace(state, kind, slot, resv_inv, weight_inv,
                              limit_inv, order)
    inputs = op_vector_inputs(state, kind, slot, resv_inv, weight_inv,
                              limit_inv, order)
    if inputs is None:
        return state
    return ops_program(state.capacity, state.ring_capacity,
                       inputs[0].shape[0])(state, *inputs)


def _apply_inplace(state: EngineState, kind, slot, resv_inv, weight_inv,
                   limit_inv, order) -> EngineState:
    """The folded rows scattered into ``state``'s own tensors, one
    in-place scatter per touched field."""
    folded = _fold_checked(state, kind, slot, resv_inv, weight_inv,
                           limit_inv, order)
    if folded is None:
        return state
    reset, reg, qos, idle = folded
    flat = np.concatenate([
        np.asarray(reset, dtype=np.int64),
        np.asarray(reg, dtype=np.int64).reshape(-1, 2).T.reshape(-1),
        np.asarray(qos, dtype=np.int64).reshape(-1, 4).T.reshape(-1),
        np.asarray(idle, dtype=np.int64)])
    dev = torch.from_numpy(flat).to(state.device)
    parts, at = [], 0
    for size in (len(reset), len(reg), len(reg), len(qos), len(qos),
                 len(qos), len(qos), len(idle)):
        parts.append(dev[at:at + size])
        at += size
    r_idx, g_idx, g_ord, q_idx, q_r, q_w, q_l, i_idx = parts
    if reset:
        for f in EngineState._fields:
            getattr(state, f).index_fill_(0, r_idx, _FRESH_FILLS[f])
    if reg:
        state.active.index_fill_(0, g_idx, True)
        state.order.index_copy_(0, g_idx, g_ord)
    if qos:
        for f, v in (("resv_inv", q_r), ("weight_inv", q_w),
                     ("limit_inv", q_l)):
            getattr(state, f).index_copy_(0, q_idx, v)
    if idle:
        state.idle.index_fill_(0, i_idx, True)
    return state


# ----------------------------------------------------------------------
# the plane
# ----------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def canon_results(results, slots: SlotMap, total: int) -> tuple:
    """Decision-stream results re-expressed in client-id space under
    ``slots``: slot-indexed fields translate through the map (-1 pads
    pass through), per-slot capacity arrays scatter to the id space of
    width ``total``.  What the chain digest hashes for a churn run --
    invariant under registration timing, recycling, growth and
    compaction (``engine.fastpath.DECISION_SLOT_FIELDS``).  Slot and
    served tensors are copied to the host; the rest stay as they are."""
    out = []
    for r in results:
        ns = SimpleNamespace()
        for name in ("count", "unit_count", "resv_count", "cls",
                     "length", "phase", "cost", "lb", "type"):
            if hasattr(r, name) and getattr(r, name) is not None:
                setattr(ns, name, getattr(r, name))
        if hasattr(r, "slot") and r.slot is not None:
            ns.slot = slots.translate(_host(r.slot))
        if hasattr(r, "served") and r.served is not None:
            ns.served = slots.scatter_by_cid(_host(r.served), total)
        out.append(ns)
    return tuple(out)


COUNTER_KEYS = ("registrations", "evictions", "compactions",
                "qos_updates", "slot_recycles", "grows", "idle_marks",
                "migrations_in", "migrations_out")


class LifecyclePlane:
    """Host-side lifecycle controller for one churn-spec run.

    Drives registration / QoS update / idle eviction / compaction at
    epoch boundaries over a (state, ledger) pair, keeps the
    client-id <-> slot map, journals control-API ops through the admin
    WAL, and provides the canonical client-id-space decision views the
    digest gates hash.  ``spec`` is a ``lifecycle.churn`` spec dict
    (``static=True`` = the pre-registered reference population: all
    ids register at boundary 0, eviction/growth/compaction off).
    Tensors stay on the state's device; a boundary reads back only
    ``depth`` when it has eviction candidates, and the evicted clients'
    ledger rows, in one copy for all of them.

    Thread contract: :meth:`accept` (the HTTP control plane) and
    :meth:`boundary` (the epoch loop) synchronize on ``self.lock``;
    ``accept`` touches no tensor, and everything else is
    loop-thread-only.
    """

    def __init__(self, spec: dict, *, workdir: Optional[str] = None,
                 tracer=None, shard: Optional[Tuple[int, int]] = None):
        """``shard=(s, n_shards)`` makes this shard ``s``'s plane of a
        mesh job: scripted events and control ops are filtered to the
        client ids shard ``s`` owns (:meth:`_owner_of`), so its slot map
        covers only that partition.  ``shard=None`` is the single-shard
        plane of the round and stream loops."""
        self.spec = dict(spec)
        self.static = bool(spec["static"])
        self.total = int(spec["total_ids"])
        self.shard = None if shard is None \
            else (int(shard[0]), int(shard[1]))
        self.slots = SlotMap(int(spec["capacity0"]))
        self.streak = np.zeros(self.total, dtype=np.int64)
        self.qos: Dict[int, Tuple[float, float, float]] = {}
        self.pending: List[dict] = []   # accepted, awaiting a boundary
        self.wal_seen = 0               # WAL lines already ingested
        self._wal_lines = None          # cached WAL line count (lazy)
        self.counters = {k: 0 for k in COUNTER_KEYS}
        self.departed: List[Tuple[int, np.ndarray]] = []
        self.peak_live = 0
        self.lock = threading.RLock()
        self.workdir = workdir
        self.tracer = tracer
        # optional obs.slo.SloPlane: every applied REGISTER/UPDATE/
        # EVICT bumps the client's contract-epoch counter there, so
        # closed conformance windows attribute to exactly one
        # (client, contract_version) pair
        self._slo = None
        # optional placement.PlacementMap, shared by every shard of a
        # mesh job: when attached it is the routing contract
        # (``_owner_of``) and registration ``order`` becomes the client
        # id
        self.placement = None

    def attach_placement(self, pm) -> None:
        self.placement = pm

    def attach_slo(self, slo) -> None:
        self._slo = slo

    # -- control-plane ingress (HTTP thread) ---------------------------
    @property
    def wal_path(self) -> Optional[str]:
        return os.path.join(self.workdir, WAL_FILE) \
            if self.workdir else None

    def accept(self, op: dict) -> int:
        """Accept one control op (``{"op": "register"|"update"|
        "evict", "cid", "r", "w", "l", "apply_at": boundary|None}``)
        into the pending journal; returns its sequence number.
        Validation happens HERE -- an accepted op cannot fail at its
        boundary -- with the same client-naming ValueErrors as
        init-time construction (``core.qos.validate_client_info``).
        With a workdir the op is fsynced to the admin WAL before it is
        acknowledged: accepted-but-unapplied ops survive a crash, and
        the encoded ``wal_seen`` cursor makes their application
        exactly-once across a resume.  Host-only (no tensor is touched),
        so it runs on a server thread."""
        kind = op["op"]
        assert kind in ("register", "update", "evict"), kind
        cid = int(op["cid"])
        if cid < 0:
            raise ValueError(f"client id must be >= 0, got {cid}")
        if cid >= self.total:
            # the id space is spec-bounded: arrival draws, the streak
            # array, and the canonical digest views are all
            # [total_ids]-wide, so an out-of-space registration could
            # never receive arrivals and would crash the id-space
            # scatter -- reject it at accept time instead
            raise ValueError(
                f"client id {cid} outside the churn spec's id space "
                f"[0, {self.total})")
        if not self._owns(cid):
            raise ValueError(
                f"client id {cid} is owned by shard "
                f"{self._owner_of(cid)}, not this plane's shard "
                f"{self.shard[0]} (route by the placement map when "
                f"attached, else slots.owner_shard)")
        if kind in ("register", "update"):
            validate_client_info(
                (op["r"], op["w"], op["l"]), name=cid)
        with self.lock:
            rec = {"op": kind, "cid": cid,
                   "r": float(op.get("r", 0.0)),
                   "w": float(op.get("w", 1.0)),
                   "l": float(op.get("l", 0.0)),
                   "apply_at": op.get("apply_at")}
            if self.wal_path is not None:
                rec["seq"] = self._wal_append(rec)
            else:
                rec["seq"] = self.wal_seen + len(self.pending)
                self.pending.append(rec)
            return rec["seq"]

    def _wal_count(self) -> int:
        """Total WAL lines, counted from the file once then cached --
        sequence numbering must not re-scan the whole journal per
        accepted op (acceptance holds ``self.lock``, which the epoch
        loop's boundary also takes)."""
        if self._wal_lines is None:
            self._wal_lines = 0
            if self.wal_path is not None and \
                    os.path.exists(self.wal_path):
                with open(self.wal_path) as fh:
                    self._wal_lines = sum(1 for ln in fh
                                          if ln.strip())
        return self._wal_lines

    def _wal_append(self, rec: dict) -> int:
        seq = self._wal_count()
        with open(self.wal_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._wal_lines = seq + 1
        return seq

    def _wal_ingest(self) -> None:
        """Pull WAL lines past the ``wal_seen`` cursor into pending --
        the resume-safe half of acceptance (the cursor is encoded with
        the plane, so a replayed boundary ingests exactly the lines the
        first run had)."""
        if self.wal_path is None or not os.path.exists(self.wal_path):
            return
        with open(self.wal_path) as fh:
            lines = [ln for ln in fh if ln.strip()]
        for i in range(self.wal_seen, len(lines)):
            rec = json.loads(lines[i])
            rec["seq"] = i
            if not 0 <= int(rec["cid"]) < self.total:
                # a hand-written WAL bypasses accept()'s bound check;
                # an out-of-space id can never receive arrivals and
                # would crash the id-space scatter at every resume --
                # drop it (deterministically: every resume drops
                # the same line) instead of poisoning the run
                import sys
                print(f"# lifecycle: dropping WAL line {i}: client "
                      f"id {rec['cid']} outside [0, {self.total})",
                      file=sys.stderr)
                continue
            self.pending.append(rec)
        self.wal_seen = len(lines)
        self._wal_lines = len(lines)

    def pending_view(self) -> List[dict]:
        """Read-only view of every accepted-but-unapplied op: the
        in-memory pending journal PLUS WAL lines past the ``wal_seen``
        cursor that no boundary has ingested yet.  The control API's
        existence/duplicate checks consult THIS -- in WAL mode an
        accepted op lives only in the file until the next boundary,
        and a 202'd registration must be visible to the PUT (and 409
        a duplicate POST) that follows it."""
        with self.lock:
            out = list(self.pending)
            if self.wal_path is not None and \
                    os.path.exists(self.wal_path):
                with open(self.wal_path) as fh:
                    lines = [ln for ln in fh if ln.strip()]
                for i in range(self.wal_seen, len(lines)):
                    out.append(json.loads(lines[i]))
            return out

    # -- scripted + pending op resolution ------------------------------
    def _owner_of(self, cid: int) -> int:
        """The routing contract in one place: the shared placement map
        when one is attached, else the static ``slots.owner_shard``."""
        if self.placement is not None:
            return int(self.placement.shard_of(cid))
        from .slots import owner_shard

        return int(owner_shard(cid, self.shard[1]))

    def _owns(self, cid: int) -> bool:
        return self.shard is None or \
            self._owner_of(cid) == self.shard[0]

    def _due_scripted(self, b: int, every: int) -> List[dict]:
        if self.static:
            out = []
            if b == 0:
                for cid in range(self.total):
                    if not self._owns(cid):
                        continue
                    r, w, l = churn_mod.init_qos(self.spec, cid)
                    out.append({"op": "register", "cid": cid,
                                "r": r, "w": w, "l": l})
            out += [e for e in churn_mod.events(self.spec, b, every)
                    if e["op"] == "update" and self._owns(e["cid"])]
            return out
        return [e for e in churn_mod.events(self.spec, b, every)
                if self._owns(e["cid"])]

    # -- the boundary --------------------------------------------------
    def boundary(self, state: EngineState, b: int, every: int, *,
                 ledger=None, slo_block=None, extras=None):
        """Apply everything due at boundary ``b`` (the epoch index the
        next window starts at): WAL ingest, scripted registrations and
        QoS updates, pending control ops with ``apply_at <= b`` (None
        = first boundary after acceptance), idle evictions, then the
        compaction epoch when due.  Returns the possibly grown /
        compacted ``(state, ledger)``; ``ledger=None`` passes through.
        Deterministic: a resumed run replaying this boundary from the
        same encoded plane applies the identical ops.

        ``slo_block`` (the obs.slo window block; pass only with an
        attached SloPlane) makes the return a 3-tuple: the block grows
        with capacity, permutes with compaction, zeroes with eviction,
        and leaves re-stamped with the post-boundary contract epochs.
        Boundaries sit exactly on the window-roll grid, so the block's
        counters are zero here and only the contract-epoch column is
        live -- a lifecycle op can never smear into a closed window.

        ``extras`` (list of ``(array, fill)`` pairs; axis 0 = slot)
        rides additional per-slot tensors through the same transforms:
        grown capacity pads with ``fill``, eviction resets the
        departing slot's row to ``fill`` (a recycled slot must look
        fresh), compaction gathers by the same permutation.  When
        given, the transformed list is appended to the return tuple.
        New rows are made on each tensor's own device."""
        from ..obs import spans as _spans

        slo_wanted = slo_block is not None
        extras_wanted = extras is not None
        extras = list(extras) if extras is not None else None

        with self.lock:
            self._wal_ingest()
            due = self._due_scripted(b, every)
            still: List[dict] = []
            for rec in self.pending:
                at = rec.get("apply_at")
                if at is None or int(at) <= b:
                    due.append(rec)
                else:
                    still.append(rec)
            self.pending = still

            rows: List[Tuple[int, int, int, int, int, int]] = []
            evict_api: List[dict] = []
            for op in due:
                if op["op"] == "register":
                    rows += self._register_row(op)
                    # growth may be needed before the row's slot exists
                elif op["op"] == "update":
                    rows += self._update_row(op)
                else:
                    evict_api.append(op)

            # growth happens inside _register_row via self._grow_to;
            # the grown state is staged on the instance
            state, ledger, slo_block, extras = self._take_growth(
                state, ledger, slo_block, extras)

            # idle evictions: scripted policy (zero-arrival streak,
            # drained queue) + control-plane DELETEs (drained only;
            # an undrained DELETE stays pending for the next boundary).
            # A STATIC plane runs the identical policy but IDLE-MARKS
            # instead of erasing (LC_IDLE): departure must leave the
            # engines' idle-reactivation min the same way in both
            # runs, or the dynamic-vs-static digest gate cannot hold.
            # The JAX package reads each evicted client's ledger row
            # inside the loop; here the loop first decides, then one
            # copy fetches every evicted row before they retire in order.
            evict_slots: List[int] = []
            retiring: List[Tuple[int, int]] = []
            cand = self._evict_candidates(b, evict_api)
            if cand:
                depth = state.depth.cpu().numpy().astype(np.int64)
                gone = set()
                for op in cand:
                    cid = op["cid"]
                    slot = None if cid in gone \
                        else self.slots.slot_of.get(cid)
                    if slot is None:
                        continue          # already gone
                    if depth[slot] != 0:
                        if op.get("seq") is not None:
                            still.append(op)   # DELETE waits for drain
                        continue
                    if self.static:
                        rows.append((LC_IDLE, slot, 0, 0, 0, 0))
                        if cid < self.total:
                            self.streak[cid] = 0
                        self.counters["idle_marks"] += 1
                    else:
                        rows.append((LC_EVICT, slot, 0, 0, 0, 0))
                        evict_slots.append(slot)
                        retiring.append((cid, slot))
                        gone.add(cid)
                if retiring:
                    led_rows = self._ledger_rows(ledger, evict_slots)
                    for (cid, slot), row in zip(retiring, led_rows):
                        self._retire(cid, slot, row)
                self.pending = still

            if rows:
                pad = _pad_len(len(rows))
                rows += [(LC_NOP, 0, 0, 0, 0, 0)] * (pad - len(rows))
                arr = np.asarray(rows, dtype=np.int64)
                state = apply_op_vector(
                    state, arr[:, 0], arr[:, 1], arr[:, 2],
                    arr[:, 3], arr[:, 4], arr[:, 5])
            if evict_slots:
                ev = np.asarray(evict_slots, dtype=np.int64)

                def zero_rows(arr, fill=0):
                    idx = torch.from_numpy(ev).to(arr.device)
                    return arr.index_fill(0, idx, fill)

                if ledger is not None:
                    ledger = zero_rows(ledger)
                if slo_block is not None:
                    slo_block = zero_rows(slo_block)
                if extras is not None:
                    extras = [(zero_rows(arr, fill), fill)
                              for arr, fill in extras]

            # streaks for the upcoming window [b, b+every): counted
            # BEFORE serving it, so boundary b+every evicts on
            # completed-window information only.  Only REGISTERED
            # clients accrue quiet windows -- a cohort's rate is zero
            # before its start, and counting those windows would evict
            # a flash crowd at the very boundary it registers.  Runs
            # in BOTH modes: the static reference shares the policy
            # (it idle-marks where the dynamic run evicts).
            if self.spec["evict_after"] > 0:
                lam = np.zeros(self.total)
                for e in range(b, b + every):
                    lam += churn_mod.lam_vector(self.spec, e)
                quiet = lam == 0.0
                reg = np.zeros(self.total, dtype=bool)
                for cid in self.slots.slot_of:
                    if cid < self.total:
                        reg[cid] = True
                self.streak = np.where(reg & quiet, self.streak + 1, 0)

            state, ledger, slo_block, extras = self._maybe_compact(
                state, ledger, slo_block, extras, b, every, _spans)
            self.peak_live = max(self.peak_live, self.slots.live_count)
            if slo_wanted and self._slo is not None:
                slo_block = self._slo.stamp(
                    slo_block, self.slots.cid_of_slot)
            out = (state, ledger)
            if slo_wanted:
                out += (slo_block,)
            if extras_wanted:
                out += (extras,)
            return out

    # -- boundary internals --------------------------------------------
    def _register_row(self, op: dict):
        cid = op["cid"]
        if cid in self.slots.slot_of:
            return []                     # replayed / duplicate accept
        slot = self.slots.allocate(cid)
        while slot < 0:
            self._grow_pending = max(
                getattr(self, "_grow_pending", 0),
                self.slots.capacity * 2)
            self.slots.grow(self.slots.capacity * 2)
            slot = self.slots.allocate(cid)
        if self.slots.was_used(slot):
            self.counters["slot_recycles"] += 1
        if self.placement is not None:
            # placement-path-independent tie-break rank: a client
            # must carry the SAME order whether it registered here
            # at its cohort boundary or arrived by migration -- the
            # client id is the one rank every path agrees on (the
            # churn generators register cohorts in ascending-id =
            # start order, so at S=1 this matches take_order exactly)
            order = cid
        else:
            order = self.slots.take_order()
        self.qos[cid] = (op["r"], op["w"], op["l"])
        if cid < self.total:
            self.streak[cid] = 0
        self.counters["registrations"] += 1
        if self._slo is not None:
            self._slo.register(cid, op["r"], op["w"], op["l"])
        return [(LC_REGISTER, slot,
                 rate_to_inv_ns(op["r"]), rate_to_inv_ns(op["w"]),
                 rate_to_inv_ns(op["l"]), order)]

    def _update_row(self, op: dict):
        cid = op["cid"]
        slot = self.slots.slot_of.get(cid)
        if slot is None:
            return []                     # departed before its boundary
        self.qos[cid] = (op["r"], op["w"], op["l"])
        self.counters["qos_updates"] += 1
        if self._slo is not None:
            self._slo.update(cid, op["r"], op["w"], op["l"])
        return [(LC_UPDATE, slot,
                 rate_to_inv_ns(op["r"]), rate_to_inv_ns(op["w"]),
                 rate_to_inv_ns(op["l"]), 0)]

    def _take_growth(self, state, ledger, slo_block=None,
                     extras=None):
        new_n = getattr(self, "_grow_pending", 0)
        if new_n > state.capacity:
            def pad(arr, fill=0):
                ext = torch.full((new_n - arr.shape[0],)
                                 + tuple(arr.shape[1:]), fill,
                                 dtype=arr.dtype, device=arr.device)
                return torch.cat([arr, ext], dim=0)

            state = grow_state(state, new_n)
            if ledger is not None:
                ledger = pad(ledger)
            if slo_block is not None:
                slo_block = pad(slo_block)
            if extras is not None:
                extras = [(pad(arr, fill), fill) for arr, fill in extras]
            self.counters["grows"] += 1
        self._grow_pending = 0
        return state, ledger, slo_block, extras

    def ensure_capacity(self, cap: int, state, ledger=None,
                        slo_block=None, extras=None):
        """Grow this plane's slot space and state tensors to at least
        ``cap`` (no-op below current capacity), e.g. to keep several
        shards' layouts the same size.  Same return shape as
        :meth:`boundary`: ``(state, ledger[, slo_block][, extras])``."""
        with self.lock:
            cap = int(cap)
            if cap > self.slots.capacity:
                self.slots.grow(cap)
            if cap > state.capacity:
                self._grow_pending = max(
                    getattr(self, "_grow_pending", 0), cap)
            state, ledger, slo_block, extras = self._take_growth(
                state, ledger, slo_block, extras)
            out = (state, ledger)
            if slo_block is not None:
                out += (slo_block,)
            if extras is not None:
                out += (extras,)
            return out

    def _evict_candidates(self, b: int, evict_api: List[dict]):
        out = list(evict_api)
        if self.spec["evict_after"] > 0 and b > 0:
            for cid in sorted(self.slots.slot_of):
                if cid < self.total and \
                        self.streak[cid] >= self.spec["evict_after"]:
                    out.append({"op": "evict", "cid": cid})
        return out

    @staticmethod
    def _ledger_rows(ledger, slots: List[int]) -> np.ndarray:
        """The ledger rows of ``slots`` in one copy to the host (zeros
        without a ledger)."""
        if ledger is None:
            return np.zeros((len(slots), LED_COLS), dtype=np.int64)
        idx = torch.from_numpy(np.asarray(slots, dtype=np.int64))
        return ledger.index_select(0, idx.to(ledger.device)).cpu() \
            .numpy().astype(np.int64)

    def _retire(self, cid: int, slot: int, row: np.ndarray) -> None:
        """Fold the departing client's final conformance-ledger row
        (``row``, read before its slot is recycled) into the departed
        report -- a silently zeroed row would erase QoS history with no
        trace (the pull queue's host ledger keeps the same contract)."""
        self.departed.append((cid, np.array(row, dtype=np.int64)))
        self.slots.release(cid)
        self.qos.pop(cid, None)
        if cid < self.total:
            self.streak[cid] = 0
        self.counters["evictions"] += 1
        if self._slo is not None:
            self._slo.evict(cid)

    # -- live migration halves: the supervisor's ``_mesh_migrate`` drives
    # them as one move, EVICT on the source plane and REGISTER on the
    # destination, and installs the carried per-slot riders (counter
    # views, provenance watermark) itself
    def migrate_out(self, cid: int, ledger):
        """Source half of a live move: fold the client's final ledger row
        into the departed report (as an idle eviction does), release its
        slot and return ``(slot, qos_triple)`` for the destination's
        REGISTER; None when the client is not resident here (a replayed
        boundary).  Counted as ``migrations_out``, not an eviction."""
        with self.lock:
            slot = self.slots.slot_of.get(cid)
            if slot is None:
                return None
            qos = self.qos.get(cid, (0.0, 1.0, 0.0))
            row = self._ledger_rows(ledger, [slot])[0]
            self.departed.append((cid, row))
            self.slots.release(cid)
            self.qos.pop(cid, None)
            if cid < self.total:
                self.streak[cid] = 0
            self.counters["migrations_out"] += 1
            if self._slo is not None:
                self._slo.evict(cid)
            return slot, qos

    def migrate_in(self, cid: int, qos) -> list:
        """Destination half: a plain registration (growth staged on
        demand, the order rank the client id under a placement map, the
        SLO contract epoch bumped) with the source's QoS triple.  Returns
        the ``LC_REGISTER`` rows for the destination's
        :func:`apply_op_vector`; counted as ``migrations_in`` besides
        ``registrations``."""
        with self.lock:
            r, w, l = (float(qos[0]), float(qos[1]), float(qos[2]))
            rows = self._register_row({"op": "register", "cid": cid,
                                       "r": r, "w": w, "l": l})
            if rows:
                self.counters["migrations_in"] += 1
            return rows

    def _maybe_compact(self, state, ledger, slo_block, extras,
                       b: int, every: int, _spans):
        ce = self.spec["compact_every"]
        if self.static or not ce or b == 0 or (b // every) % ce != 0:
            return state, ledger, slo_block, extras
        perm = self.slots.compaction_perm()
        if perm is None:
            return state, ledger, slo_block, extras
        with _spans.span(self.tracer, "lifecycle.compact", "dispatch",
                         boundary=b, live=self.slots.live_count):
            more = tuple(x for x in (ledger, slo_block)
                         if x is not None)
            xarrs = tuple(arr for arr, _fill in extras) \
                if extras is not None else ()
            out = compact_tree((state,) + more + xarrs, perm)
            state = out[0]
            it = iter(out[1:])
            if ledger is not None:
                ledger = next(it)
            if slo_block is not None:
                slo_block = next(it)
            if extras is not None:
                extras = [(next(it), fill) for _arr, fill in extras]
        if _compact_hook is not None:
            _compact_hook()      # seam: device gather done, host map
        #                          not yet re-mapped
        self.slots.apply_perm(perm)
        self.counters["compactions"] += 1
        return state, ledger, slo_block, extras

    def force_compact(self, state, ledger=None, slo_block=None,
                      extras=None, *, b: int = 0):
        """Compaction off the ``compact_every`` grid (a controller's
        trigger): the same gather, permutation and digest neutrality as
        the scheduled one.  A no-op when the layout is already dense or
        the plane is static; deterministic either way.  Same
        return-shape discipline as :meth:`boundary`:
        ``(state, ledger[, slo_block][, extras])``."""
        from ..obs import spans as _spans

        slo_wanted = slo_block is not None
        extras_wanted = extras is not None
        extras = list(extras) if extras is not None else None
        with self.lock:
            perm = None if self.static else self.slots.compaction_perm()
            if perm is not None:
                with _spans.span(self.tracer, "lifecycle.compact",
                                 "dispatch", boundary=b,
                                 live=self.slots.live_count):
                    more = tuple(x for x in (ledger, slo_block)
                                 if x is not None)
                    xarrs = tuple(arr for arr, _fill in extras) \
                        if extras is not None else ()
                    out = compact_tree((state,) + more + xarrs, perm)
                    state = out[0]
                    it = iter(out[1:])
                    if ledger is not None:
                        ledger = next(it)
                    if slo_block is not None:
                        slo_block = next(it)
                    if extras is not None:
                        extras = [(next(it), fill)
                                  for _arr, fill in extras]
                if _compact_hook is not None:
                    _compact_hook()
                self.slots.apply_perm(perm)
                self.counters["compactions"] += 1
                if slo_wanted and self._slo is not None:
                    slo_block = self._slo.stamp(
                        slo_block, self.slots.cid_of_slot)
            out = (state, ledger)
            if slo_wanted:
                out += (slo_block,)
            if extras_wanted:
                out += (extras,)
            return out

    # -- arrival-count mapping -----------------------------------------
    def map_counts(self, raw) -> np.ndarray:
        """Map RAW per-client-id Poisson draws (``[..., total_ids]``)
        onto the current slot layout (``[..., capacity]``,
        unregistered ids dropped -- the churn generators keep their
        rates zero, so nothing real is ever dropped).  The RNG draw
        itself stays in id space: identical consumption in the dynamic
        run and its static reference is what makes the digest gate
        meaningful."""
        raw = np.asarray(raw)
        out = np.zeros(raw.shape[:-1] + (self.slots.capacity,),
                       dtype=np.int32)
        live = self.slots.cid_of_slot >= 0
        cids = self.slots.cid_of_slot[live]
        out[..., live] = raw[..., cids]
        return out

    # -- canonical digest views ----------------------------------------
    def canon_results(self, results) -> tuple:
        """Decision-stream results re-expressed in client-id space under
        the current slot map (:func:`canon_results`)."""
        return canon_results(results, self.slots, self.total)

    # -- reports / observability ---------------------------------------
    def departed_report(self, drain: bool = True):
        """``(cid, int64[5] final ledger row)`` per departed client in
        eviction order (LED_* columns); ``drain=False`` peeks."""
        with self.lock:
            out = list(self.departed)
            if drain:
                self.departed.clear()
            return out

    def snapshot(self) -> dict:
        """Control-plane summary (the admin API's ``GET /clients`` and
        the bench/result JSON block)."""
        with self.lock:
            return {"live_clients": self.slots.live_count,
                    "peak_clients": self.peak_live,
                    "capacity": self.slots.capacity,
                    "pending_ops": len(self.pending),
                    **{k: int(v) for k, v in self.counters.items()}}

    def publish(self, registry, labels=None) -> None:
        """Register the lifecycle counters as scrape gauges."""
        rows = (
            ("dmclock_lc_registrations_total", "registrations",
             "clients registered through the lifecycle plane"),
            ("dmclock_lc_evictions_total", "evictions",
             "idle clients evicted (slot recycled; final ledger row "
             "folded into the departed-clients report first)"),
            ("dmclock_lc_compactions_total", "compactions",
             "compaction epochs launched (live clients repacked into "
             "a dense prefix)"),
            ("dmclock_lc_qos_updates_total", "qos_updates",
             "live ClientInfo updates applied at epoch boundaries"),
            ("dmclock_lc_slot_recycles_total", "slot_recycles",
             "registrations that re-used a previously-owned slot"),
            ("dmclock_lc_grows_total", "grows",
             "geometric state-array doublings"),
        )
        for name, key, help_text in rows:
            registry.gauge(name, help_text, labels=labels)\
                .set_function(lambda k=key: float(self.counters[k]))
        registry.gauge("dmclock_lc_live_clients",
                       "currently registered clients", labels=labels)\
            .set_function(lambda: float(self.slots.live_count))
        registry.gauge("dmclock_lc_peak_clients",
                       "peak simultaneously-registered clients",
                       labels=labels)\
            .set_function(lambda: float(self.peak_live))

    # -- encode / load --------------------------------------------------
    def encode(self) -> dict:
        """The plane as flat ``lc_*`` numpy leaves, key for key the
        JAX package's (so either package loads the other's)."""
        with self.lock:
            pend = np.asarray(
                [[{"register": 1, "update": 2, "evict": 3}[p["op"]],
                  p["cid"], p["r"], p["w"], p["l"],
                  -1.0 if p.get("apply_at") is None
                  else float(p["apply_at"]),
                  float(p.get("seq", -1))]
                 for p in self.pending],
                dtype=np.float64).reshape(len(self.pending), 7)
            qos = np.asarray(
                [[cid, r, w, l]
                 for cid, (r, w, l) in sorted(self.qos.items())],
                dtype=np.float64).reshape(len(self.qos), 4)
            dep = np.asarray(
                [[cid] + row.tolist() for cid, row in self.departed],
                dtype=np.int64).reshape(len(self.departed), 6)
            return {**self.slots.encode(),
                    "lc_streak": self.streak.copy(),
                    "lc_wal_seen": np.int64(self.wal_seen),
                    "lc_pending": pend,
                    "lc_qos": qos,
                    "lc_departed": dep,
                    "lc_counters": np.asarray(
                        [self.counters[k] for k in COUNTER_KEYS],
                        dtype=np.int64),
                    "lc_peak": np.int64(self.peak_live)}

    @classmethod
    def load(cls, payload: dict, spec: dict, *,
             workdir: Optional[str] = None,
             tracer=None,
             shard: Optional[Tuple[int, int]] = None
             ) -> "LifecyclePlane":
        p = cls(spec, workdir=workdir, tracer=tracer, shard=shard)
        p.slots = SlotMap.load(payload)
        p.streak = np.asarray(payload["lc_streak"],
                              dtype=np.int64).copy()
        p.wal_seen = int(payload["lc_wal_seen"])
        opname = {1: "register", 2: "update", 3: "evict"}
        p.pending = [
            {"op": opname[int(row[0])], "cid": int(row[1]),
             "r": float(row[2]), "w": float(row[3]),
             "l": float(row[4]),
             "apply_at": None if row[5] < 0 else int(row[5]),
             "seq": None if row[6] < 0 else int(row[6])}
            for row in np.asarray(payload["lc_pending"],
                                  dtype=np.float64)]
        p.qos = {int(row[0]): (float(row[1]), float(row[2]),
                               float(row[3]))
                 for row in np.asarray(payload["lc_qos"],
                                       dtype=np.float64)}
        p.departed = [
            (int(row[0]), np.asarray(row[1:], dtype=np.int64))
            for row in np.asarray(payload["lc_departed"],
                                  dtype=np.int64)]
        ctr = np.asarray(payload["lc_counters"], dtype=np.int64)
        p.counters = {k: int(v) for k, v in zip(COUNTER_KEYS, ctr)}
        p.peak_live = int(payload["lc_peak"])
        return p

    @classmethod
    def empty_leaves(cls) -> dict:
        """Zero-size ``lc_*`` leaves for runs without a churn spec, so
        a payload's structure depends only on the run's config."""
        return {"lc_cids": np.zeros(0, dtype=np.int64),
                "lc_ever": np.zeros(0, dtype=bool),
                "lc_next_order": np.int64(0),
                "lc_streak": np.zeros(0, dtype=np.int64),
                "lc_wal_seen": np.int64(0),
                "lc_pending": np.zeros((0, 7), dtype=np.float64),
                "lc_qos": np.zeros((0, 4), dtype=np.float64),
                "lc_departed": np.zeros((0, 6), dtype=np.int64),
                "lc_counters": np.zeros(len(COUNTER_KEYS),
                                        dtype=np.int64),
                "lc_peak": np.int64(0)}


def wal_append(workdir, op: dict) -> int:
    """Append one control op to a workdir's admin WAL without a live
    plane -- how a test (or an operator) pre-seeds accepted ops that a
    run must apply exactly once (validated with the same client-naming
    errors as the live path)."""
    total = max(int(op.get("cid", 0)) + 1, 1)
    plane = LifecyclePlane({"scenario": "flash_crowd",
                            "total_ids": total,
                            "static": False, "capacity0": 1,
                            "base_lam": 0.0, "evict_after": 0,
                            "compact_every": 0, "qos_r": 0.0,
                            "qos_l": 0.0, "qos_wmod": 1},
                           workdir=os.fspath(workdir))
    return plane.accept(op)
