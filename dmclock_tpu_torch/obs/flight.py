"""Flight recorder: the last R decision records, written on the device.

Counterpart of ``dmclock_tpu/obs/flight.py`` (its module docstring
gives the record granularity of each engine): a fixed ring of the most
recent R commit records in device memory, written by the epoch loops
with one scatter per batch and read back only at epoch or checkpoint
boundaries.

Columns (int64): ``seq`` (monotone global record number; wraparound
shows as a seq gap), ``batch`` (the recording batch's index), ``client``
(slot), ``cls`` (0 reservation / 1 weight / 2 limit-break), ``tag``
(unified entry key), ``cost``, ``margin`` (winner margin over the
runner-up, ns; -1 = none) and ``gate`` (clients queued but limit-blocked
at the batch's entry).  Unwritten rows carry seq -1.  A mesh chunk
stacks one ring per shard (``buf`` ``[S, R, COLS]``);
:func:`flight_merge_stacked` and :func:`flight_drain_stacked` read such
a stack back in shard order.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .histograms import _np64

FLIGHT_FIELDS = ("seq", "batch", "client", "cls", "tag", "cost",
                 "margin", "gate")
FLIGHT_COLS = len(FLIGHT_FIELDS)


class FlightState(NamedTuple):
    """The device ring and its cursors: ``seq`` counts records ever
    written, ``batch`` counts live batches recorded.  Record ``s`` lives
    in ring row ``s % R``."""

    buf: torch.Tensor    # int64[R, FLIGHT_COLS]; seq column -1 = empty
    seq: torch.Tensor    # int64 0-d
    batch: torch.Tensor  # int64 0-d


def flight_init(records: int,
                device: str | torch.device = DEFAULT_DEVICE) -> FlightState:
    """A fresh ring of ``records`` rows."""
    if records < 1:
        raise ValueError("the flight ring needs at least one row")
    dev = resolve_device(device)
    return FlightState(
        buf=torch.full((records, FLIGHT_COLS), -1, dtype=torch.int64,
                       device=dev),
        seq=torch.zeros((), dtype=torch.int64, device=dev),
        batch=torch.zeros((), dtype=torch.int64, device=dev))


def flight_record(fl: FlightState, slot, cls, tag, cost, live=True,
                  margin=None, gate=None) -> FlightState:
    """Append one batch's commit records.

    ``slot`` (``[k]``, -1 = no record) selects the rows; validity need
    not be a contiguous prefix (ranks come from a cumsum).  When a batch
    carries more than R records only the newest R land, but ``seq``
    still advances by the full count.  ``live`` (0-d bool tensor or
    True) gates the whole batch.  ``margin`` (``[k]``) and ``gate``
    (0-d) are the provenance columns; without them -1 and 0 are
    written."""
    buf = fl.buf
    r = buf.shape[0]
    dev = buf.device
    mask = slot >= 0
    if live is not True:
        mask = mask & live
    m64 = mask.to(torch.int64)
    rank = torch.cumsum(m64, 0) - 1
    total = torch.sum(m64)
    keep = mask & (rank >= total - r)
    idx = torch.where(keep, torch.remainder(fl.seq + rank, r), r)
    k = slot.shape[0]
    if margin is None:
        margin = torch.full((k,), -1, dtype=torch.int64, device=dev)
    if gate is None:
        gate = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.stack([
        fl.seq + rank, fl.batch.expand(k), slot.to(torch.int64),
        cls.to(torch.int64), tag.to(torch.int64), cost.to(torch.int64),
        margin.to(torch.int64).expand(k), gate.to(torch.int64).expand(k),
    ], dim=1)
    # row r takes every dropped lane and is cut off
    out = torch.cat([buf, buf[:1]]).index_copy_(0, idx, rows)[:r]
    step = 1 if live is True else live.to(torch.int64)
    return FlightState(buf=out, seq=fl.seq + total, batch=fl.batch + step)


def _ring_rows(buf2d) -> np.ndarray:
    """One ring's valid rows in seq order (oldest -> newest)."""
    buf2d = _np64(buf2d)
    rows = buf2d[buf2d[:, 0] >= 0]
    return rows[np.argsort(rows[:, 0], kind="stable")]


def flight_drain(fl: FlightState) -> list:
    """Host drain: one read back of the ring, decoded into dict records
    ordered oldest -> newest."""
    return [dict(zip(FLIGHT_FIELDS, (int(x) for x in row)))
            for row in _ring_rows(fl.buf)]


def flight_dump(fl: FlightState, path: str) -> int:
    """Drain the ring to a JSONL file; returns the record count."""
    return _write_jsonl(flight_drain(fl), path)


def _write_jsonl(records: list, path: str) -> int:
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    return len(records)


def flight_merge_stacked(fl: FlightState):
    """Shard-order merge of a mesh job's stacked per-shard rings
    (``buf`` int64[S, R, COLS], ``seq`` int64[S]): each shard's valid
    rows in its own seq order, shards concatenated 0..S-1.  Returns
    ``(rows int64[V, COLS], total_seq int)``."""
    buf = _np64(fl.buf)
    if buf.ndim != 3:
        raise ValueError(f"expected a stacked [S, R, COLS] ring, got "
                         f"{buf.shape}")
    parts = [_ring_rows(buf[s]) for s in range(buf.shape[0])]
    merged = np.concatenate(parts, axis=0) if parts else \
        np.zeros((0, FLIGHT_COLS), dtype=np.int64)
    return merged, int(_np64(fl.seq).sum())


def flight_drain_stacked(fl: FlightState) -> list:
    """Host drain of a stacked per-shard ring: dict records with a
    ``shard`` key, in the :func:`flight_merge_stacked` order."""
    buf = _np64(fl.buf)
    out = []
    for s in range(buf.shape[0]):
        for row in _ring_rows(buf[s]):
            rec = dict(zip(FLIGHT_FIELDS, (int(x) for x in row)))
            rec["shard"] = s
            out.append(rec)
    return out


def flight_dump_any(fl: FlightState, path: str) -> int:
    """:func:`flight_dump` that takes a single or a stacked ring."""
    if fl.buf.dim() == 3:
        return _write_jsonl(flight_drain_stacked(fl), path)
    return flight_dump(fl, path)


def flight_from_arrays(buf, seq, batch, *,
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> FlightState:
    """Rebuild a FlightState from numpy leaves on ``device``."""
    dev = resolve_device(device)
    return FlightState(*(torch.from_numpy(np.asarray(x, dtype=np.int64))
                         .to(dev) for x in (buf, seq, batch)))
