"""The SLO plane: device-resident windowed conformance.

Counterpart of ``dmclock_tpu/obs/slo.py`` (its module docstring gives
the design).  Two halves:

1. **Device window block** (``int64[N, W_FIELDS]``): per-client
   delivered ops, delivered cost, reservation-phase ops, tardy ops,
   limit-break ops, reservation-tardiness sum, and the window's
   contract-epoch id.  The counter columns accumulate inside the three
   epoch loops like the histograms and the ledger (folded per batch,
   gated on tag32 liveness); the contract-epoch column maxes.
2. **Host plane** (:class:`SloPlane`): per-client contract-epoch
   counters bumped by register/update, a bounded ring of closed windows
   per client, each attributed to one ``(client, contract_version)``
   pair, and per-window delivered-vs-contract conformance rows.  Plain
   data, encoded into flat ``slo_*`` leaves and loaded back.

The burn-rate evaluator, with its registry counters and its watchdog
routing, is ``obs/alerts.py``'s ``SloEvaluator``.  The mesh merges
(``window_mesh_reduce``, ``window_combine_axis``, ``window_combine_np``,
``publish_shard_windows``) serve the mesh chunk, its host replay and the
supervised mesh.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.timebase import NS_PER_SEC
from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel import groups as _groups
from .histograms import _np64, col_mask

# -- window block columns ----------------------------------------------
W_OPS = 0          # decisions delivered in the window
W_COST = 1         # delivered cost (sum of served request costs)
W_RESV_OPS = 2     # constraint-phase (reservation-eligible) decisions
W_TARDY_OPS = 3    # reservation entries served past their deadline
W_LB_OPS = 4       # AtLimit::Allow limit-break entries
W_TARD_SUM = 5     # reservation tardiness sum, ns (entry-head obs)
W_CEPOCH = 6       # contract-epoch id (host-stamped at window open)
W_FIELDS = 7

WINDOW_COL_NAMES = ("ops", "cost", "resv_ops", "tardy_ops", "lb_ops",
                    "tardiness_sum_ns", "contract_epoch")

# the contract-epoch column is metadata, not a counter: deltas carry 0
# there and merges keep the max
_W_MAX_MASK = np.zeros((W_FIELDS,), dtype=bool)
_W_MAX_MASK[W_CEPOCH] = True


def window_zero(n: int, device: str | torch.device = DEFAULT_DEVICE
                ) -> torch.Tensor:
    return torch.zeros((n, W_FIELDS), dtype=torch.int64,
                       device=resolve_device(device))


def window_delta(served_pc, cost_pc, resv_pc, tardy_pc, lb_pc,
                 tard_pc) -> torch.Tensor:
    """One batch/level's window contribution (``int64[N, W_FIELDS]``):
    a stack of per-client reductions the telemetry fold already holds;
    the contract-epoch column rides as zeros (max-merged, so the
    stamped value survives every fold)."""
    cols = [c.to(torch.int64) for c in (served_pc, cost_pc, resv_pc,
                                        tardy_pc, lb_pc, tard_pc)]
    cols.append(torch.zeros_like(cols[0]))
    return torch.stack(cols, dim=1)


def window_combine(a, b):
    """Merge two window blocks over the same client set: counter columns
    add, the contract-epoch column maxes."""
    mask = col_mask(W_FIELDS, (W_CEPOCH,), a.device)
    return torch.where(mask, torch.maximum(a, b), a + b)


def window_fold(w, delta, live):
    """Fold a batch delta gated on liveness (the tag32 dead-batch rule).
    ``live`` is a 0-d bool tensor or the constant True."""
    if live is not True:
        delta = torch.where(live, delta, 0)
    return window_combine(w, delta)


def window_combine_axis(mat: torch.Tensor) -> torch.Tensor:
    """Reduce a stacked ``[S, N, W_FIELDS]`` block along its leading
    shard axis (counter columns sum, the contract-epoch column max)."""
    mask = col_mask(W_FIELDS, (W_CEPOCH,), mat.device)
    return torch.where(mask, mat.max(dim=0).values, mat.sum(dim=0))


def window_mesh_reduce(mat) -> torch.Tensor:
    """The JAX package's mesh merge of per-shard window blocks (counter
    columns ``psum``, the contract-epoch column ``pmax``; every shard
    stamps the same epochs).  On one device the shards are the leading
    axis of one stacked block, so it is :func:`window_combine_axis`; a
    grouped block merges its groups' partials on the first group's
    device."""
    return _groups.reduce(mat, window_combine_axis, window_combine)


def window_combine_np(acc, *blocks):
    """Host-side mirror of :func:`window_combine` over numpy blocks."""
    acc = _np64(acc)
    for b in blocks:
        b = _np64(b)
        acc = np.where(_W_MAX_MASK, np.maximum(acc, b), acc + b)
    return acc


def publish_shard_windows(registry, blocks, merged=None,
                          workload: Optional[str] = None) -> None:
    """Publish per-shard window-block totals as ``dmclock_slo_window_*``
    gauges labelled by ``shard``, plus the merged cluster total under
    ``shard="all"``.  ``blocks`` is ``[S, N, W_FIELDS]`` (stacked) or an
    iterable of per-shard blocks; ``merged`` defaults to the host
    combine of the shards."""
    blocks = [_np64(b) for b in blocks]
    if merged is None and blocks:
        merged = window_combine_np(np.zeros_like(blocks[0]), *blocks)

    def emit(block, shard: str) -> None:
        labels = {"shard": shard}
        if workload is not None:
            labels["workload"] = workload
        for name, val in window_totals(block).items():
            registry.gauge(
                f"dmclock_slo_window_{name}",
                "cluster-wide windowed conformance column, per shard "
                "(docs/OBSERVABILITY.md SLO plane; shard=all is the "
                "window_mesh_reduce merge)",
                labels=labels).set(float(val))

    for s, block in enumerate(blocks):
        emit(block, str(s))
    if merged is not None:
        emit(_np64(merged), "all")


def stamp_cepoch(block: torch.Tensor, cepochs) -> torch.Tensor:
    """Write the per-slot contract-epoch ids into the block's
    :data:`W_CEPOCH` column (one copy from the host per window
    boundary, outside any epoch)."""
    out = block.clone()
    out[:, W_CEPOCH] = torch.as_tensor(np.asarray(cepochs, np.int64)) \
        .to(block.device)
    return out


def window_totals(block) -> dict:
    """Counter-column totals of a fetched block (host side)."""
    a = _np64(block)
    return {name: int(a[:, i].sum())
            for i, name in enumerate(WINDOW_COL_NAMES) if i != W_CEPOCH}


# ----------------------------------------------------------------------
# host plane: contract epochs + closed-window ring + conformance
# ----------------------------------------------------------------------

RING_COLS = 12  # seq, cid, cepoch, e0, e1, ops, cost, resv_ops,
#                 tardy_ops, lb_ops, tard_sum_ns, backlog


@dataclasses.dataclass(frozen=True)
class ClosedWindow:
    """One client's closed window, attributed to exactly one ``(client,
    contract_epoch)`` pair.  ``backlog`` is the client's queue depth at
    close: what separates a starved client from an idle one."""

    seq: int          # global roll sequence number
    cid: int          # client id
    cepoch: int       # contract-epoch id (device-stamped)
    e0: int           # first epoch of the window
    e1: int           # one past the last epoch
    ops: int
    cost: int
    resv_ops: int
    tardy_ops: int
    lb_ops: int
    tard_sum_ns: int
    backlog: int

    def row(self) -> list:
        return [self.seq, self.cid, self.cepoch, self.e0, self.e1,
                self.ops, self.cost, self.resv_ops, self.tardy_ops,
                self.lb_ops, self.tard_sum_ns, self.backlog]

    @classmethod
    def from_row(cls, r) -> "ClosedWindow":
        return cls(*[int(x) for x in r])

    def to_json(self) -> dict:
        return {"seq": self.seq, "client": self.cid,
                "contract_epoch": self.cepoch,
                "e0": self.e0, "e1": self.e1, "ops": self.ops,
                "cost": self.cost, "resv_ops": self.resv_ops,
                "tardy_ops": self.tardy_ops, "lb_ops": self.lb_ops,
                "tardiness_sum_ns": self.tard_sum_ns,
                "backlog": self.backlog}


class SloPlane:
    """Host half of the windowed conformance plane for one run (the JAX
    package's ``SloPlane``): per-client contract-epoch counters (a
    re-registered client continues its own monotone counter), the
    current and per-epoch contract log (reservation, weight, limit as
    rates), and a bounded per-client ring of closed windows.  Plain
    data; :meth:`encode` / :meth:`load` round-trip it."""

    def __init__(self, capacity: int, *, dt_epoch_ns: int,
                 ring_depth: int = 64):
        self.capacity = int(capacity)
        self.dt_epoch_ns = int(dt_epoch_ns)
        self.ring_depth = max(int(ring_depth), 1)
        self.cepoch: Dict[int, int] = {}
        self.contracts: Dict[int, Tuple[float, float, float]] = {}
        self.contract_log: Dict[Tuple[int, int],
                                Tuple[float, float, float]] = {}
        self.rings: Dict[int, deque] = {}
        self.window_seq = 0
        self.windows_closed = 0

    # -- contract-epoch bumps ------------------------------------------
    def register(self, cid: int, r: float, w: float, l: float) -> int:
        """Bump the client's contract epoch and record the contract."""
        cid = int(cid)
        ce = self.cepoch.get(cid, 0) + 1
        self.cepoch[cid] = ce
        self.contracts[cid] = (float(r), float(w), float(l))
        self.contract_log[(cid, ce)] = self.contracts[cid]
        return ce

    def update(self, cid: int, r: float, w: float, l: float) -> int:
        """A live contract update: the same bump."""
        return self.register(cid, r, w, l)

    def evict(self, cid: int) -> None:
        """End the tenancy: the contract goes, the counter stays."""
        self.contracts.pop(int(cid), None)

    def contract_of(self, cid: int, cepoch: int
                    ) -> Optional[Tuple[float, float, float]]:
        return self.contract_log.get((int(cid), int(cepoch)))

    # -- device-column stamping ----------------------------------------
    def cepoch_vector(self, cid_of_slot=None) -> np.ndarray:
        """Per-slot contract-epoch ids (0 for free slots);
        ``cid_of_slot=None`` = identity (slot == client id)."""
        if cid_of_slot is None:
            return np.asarray([self.cepoch.get(c, 0)
                               for c in range(self.capacity)],
                              dtype=np.int64)
        return np.asarray(
            [self.cepoch.get(int(c), 0) if c >= 0 else 0
             for c in np.asarray(cid_of_slot)], dtype=np.int64)

    def stamp(self, block, cid_of_slot=None):
        """Stamp the block's contract-epoch column from the counters."""
        self.capacity = int(block.shape[0])
        return stamp_cepoch(block, self.cepoch_vector(cid_of_slot))

    # -- the roll ------------------------------------------------------
    def roll(self, block, e0: int, e1: int, *, cid_of_slot=None,
             depth=None, skip_idle: bool = False
             ) -> Tuple[torch.Tensor, List[ClosedWindow]]:
        """Close the window ``[e0, e1)``: read the ``block`` tensor back,
        append one
        :class:`ClosedWindow` per client with activity (or a live
        contract), and return a fresh zeroed block on the block's device
        with the contract-epoch column re-stamped.  ``depth`` (optional
        ``[N]``) records per-client backlog at close; ``skip_idle`` drops
        zero-activity windows even for live contracts."""
        a = _np64(block)
        self.capacity = a.shape[0]
        d = None if depth is None else _np64(depth)
        closed: List[ClosedWindow] = []
        seq = self.window_seq
        for slot in range(a.shape[0]):
            if cid_of_slot is None:
                cid = slot
            else:
                cid = int(cid_of_slot[slot])
                if cid < 0:
                    continue
            row = a[slot]
            active = bool(row[:W_CEPOCH].any())
            if not active and (skip_idle or cid not in self.contracts):
                continue
            if not active and row[W_CEPOCH] == 0:
                continue     # never registered on the device yet
            w = ClosedWindow(
                seq=seq, cid=cid, cepoch=int(row[W_CEPOCH]),
                e0=int(e0), e1=int(e1),
                ops=int(row[W_OPS]), cost=int(row[W_COST]),
                resv_ops=int(row[W_RESV_OPS]),
                tardy_ops=int(row[W_TARDY_OPS]),
                lb_ops=int(row[W_LB_OPS]),
                tard_sum_ns=int(row[W_TARD_SUM]),
                backlog=0 if d is None else int(d[slot]))
            closed.append(w)
            self.rings.setdefault(cid, deque(maxlen=self.ring_depth)) \
                .append(w)
        self.window_seq += 1
        self.windows_closed += len(closed)
        fresh = self.stamp(window_zero(a.shape[0], block.device),
                           cid_of_slot)
        return fresh, closed

    # -- conformance ---------------------------------------------------
    def conformance_rows(self, closed: List[ClosedWindow]
                         ) -> List[dict]:
        """Delivered-vs-contract judgment of one roll's closed windows:
        per client the delivered rate against the reservation floor, the
        delivered cost share against the weight entitlement among
        clients with demand, and the limit excess -- each against the
        window's own contract version."""
        if not closed:
            return []
        win_s = max((closed[0].e1 - closed[0].e0)
                    * self.dt_epoch_ns / 1e9, 1e-12)
        demand = [w for w in closed if w.ops > 0 or w.backlog > 0]
        total_cost = sum(w.cost for w in demand)
        wsum = 0.0
        for w in demand:
            c = self.contract_of(w.cid, w.cepoch)
            wsum += c[1] if c else 0.0
        rows = []
        for w in closed:
            r, wt, lim = self.contract_of(w.cid, w.cepoch) \
                or (0.0, 0.0, 0.0)
            rate = w.ops / win_s
            share = w.cost / total_cost if total_cost else 0.0
            entitled = (wt / wsum) if (wsum > 0 and
                                       (w.ops > 0 or w.backlog > 0)) \
                else 0.0
            share_err = (share - entitled) / max(entitled, 1e-9) \
                if entitled > 0 else 0.0
            resv_deficit = max(r - rate, 0.0) if r > 0 else 0.0
            # a reservation miss needs backlog or tardiness: an idle
            # client under its floor is not a starved one
            resv_miss = bool(r > 0 and resv_deficit > 0.05 * r
                             and (w.backlog > 0 or w.tardy_ops > 0))
            limit_excess = max(rate - lim, 0.0) if lim > 0 else 0.0
            rows.append({
                **w.to_json(),
                "window_s": win_s, "rate": rate,
                "reservation": r, "weight": wt, "limit": lim,
                "share": share, "entitled_share": entitled,
                "share_err": share_err,
                "resv_deficit": resv_deficit, "resv_miss": resv_miss,
                "limit_excess": limit_excess,
                "tardiness_mean_ns": w.tard_sum_ns
                / max(w.resv_ops, 1),
            })
        return rows

    # -- views / reports -----------------------------------------------
    def ring_rows(self, cid: Optional[int] = None) -> List[ClosedWindow]:
        """Closed windows, oldest first (one client's ring or all,
        interleaved in close order)."""
        if cid is not None:
            return list(self.rings.get(int(cid), ()))
        out = [w for ring in list(self.rings.values())
               for w in list(ring)]
        out.sort(key=lambda w: (w.seq, w.cid))
        return out

    def client_view(self, cid: int) -> dict:
        """One client's conformance view over the surviving ring, each
        roll group judged once."""
        cid = int(cid)
        want = {w.seq for w in list(self.rings.get(cid, ()))}
        grouped: Dict[int, List[ClosedWindow]] = {}
        for w in self.ring_rows():
            if w.seq in want:
                grouped.setdefault(w.seq, []).append(w)
        rows = []
        for seq in sorted(grouped):
            rows += [r for r in self.conformance_rows(grouped[seq])
                     if r["client"] == cid]
        return {"id": cid, "contract_epoch": self.cepoch.get(cid, 0),
                "contract": self.contracts.get(cid), "windows": rows}

    def summary(self) -> dict:
        return {"windows_closed": int(self.windows_closed),
                "rolls": int(self.window_seq),
                "clients_tracked": len(self.rings),
                "live_contracts": len(self.contracts),
                "ring_depth": self.ring_depth}

    def export_jsonl(self, path: str, closed: List[ClosedWindow],
                     judged: bool = True) -> int:
        """Append one roll's closed windows (judged rows when ``judged``)
        as JSONL."""
        rows = self.conformance_rows(closed) if judged \
            else [w.to_json() for w in closed]
        with open(path, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
        return len(rows)

    # -- checkpoint round-trip -----------------------------------------
    def encode(self) -> dict:
        """Flat ``slo_*`` numpy leaves."""
        ce = np.asarray(sorted(self.cepoch.items()),
                        dtype=np.int64).reshape(len(self.cepoch), 2)
        con = np.asarray(
            [[c, e, r, w, l]
             for (c, e), (r, w, l) in sorted(self.contract_log.items())],
            dtype=np.float64).reshape(len(self.contract_log), 5)
        live = np.asarray(sorted(self.contracts), dtype=np.int64)
        ring = np.asarray([w.row() for w in self.ring_rows()],
                          dtype=np.int64).reshape(-1, RING_COLS)
        return {"slo_cepoch": ce, "slo_contracts": con,
                "slo_live": live, "slo_ring": ring,
                "slo_scalars": np.asarray(
                    [self.window_seq, self.windows_closed,
                     self.ring_depth], dtype=np.int64)}

    @classmethod
    def load(cls, payload: dict, *, capacity: int, dt_epoch_ns: int,
             ring_depth: Optional[int] = None) -> "SloPlane":
        """Rebuild from :meth:`encode`'s leaves; ``ring_depth`` overrides
        the encoded depth before the rings are rebuilt."""
        sc = np.asarray(payload["slo_scalars"], dtype=np.int64)
        p = cls(capacity, dt_epoch_ns=dt_epoch_ns,
                ring_depth=int(sc[2]) if ring_depth is None
                else ring_depth)
        p.window_seq = int(sc[0])
        p.windows_closed = int(sc[1])
        for c, e in np.asarray(payload["slo_cepoch"],
                               dtype=np.int64).reshape(-1, 2):
            p.cepoch[int(c)] = int(e)
        for row in np.asarray(payload["slo_contracts"],
                              dtype=np.float64).reshape(-1, 5):
            p.contract_log[(int(row[0]), int(row[1]))] = \
                (float(row[2]), float(row[3]), float(row[4]))
        for c in np.asarray(payload["slo_live"],
                            dtype=np.int64).reshape(-1):
            con = p.contract_log.get((int(c), p.cepoch.get(int(c), 0)))
            if con is not None:
                p.contracts[int(c)] = con
        for row in np.asarray(payload["slo_ring"],
                              dtype=np.int64).reshape(-1, RING_COLS):
            w = ClosedWindow.from_row(row)
            p.rings.setdefault(w.cid, deque(maxlen=p.ring_depth)) \
                .append(w)
        return p

    @staticmethod
    def empty_leaves() -> dict:
        """Zero-size ``slo_*`` leaves for runs with the plane off."""
        return {"slo_cepoch": np.zeros((0, 2), dtype=np.int64),
                "slo_contracts": np.zeros((0, 5), dtype=np.float64),
                "slo_live": np.zeros((0,), dtype=np.int64),
                "slo_ring": np.zeros((0, RING_COLS), dtype=np.int64),
                "slo_scalars": np.zeros((3,), dtype=np.int64)}

    def register_from_inv(self, resv_inv, weight_inv, limit_inv) -> None:
        """Register every slot from the engine state's inverse-rate
        arrays (slot == client id), rates re-derived as ``1e9 / inv``."""
        def to_rate(inv):
            inv = _np64(inv)
            with np.errstate(divide="ignore"):
                return np.where(inv > 0,
                                NS_PER_SEC / np.maximum(inv, 1), 0.0)

        r, w, l = (to_rate(x) for x in (resv_inv, weight_inv, limit_inv))
        for c in range(len(r)):
            self.register(c, float(r[c]), float(w[c]), float(l[c]))


def load_windows_jsonl(path: str) -> List[dict]:
    """Read an :meth:`SloPlane.export_jsonl` file back; malformed lines
    are skipped and counted in row 0's ``_skipped``."""
    rows: List[dict] = []
    skipped = 0
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(obj, dict):
                rows.append(obj)
            else:
                skipped += 1
    if skipped and rows:
        rows[0] = dict(rows[0], _skipped=skipped)
    return rows
