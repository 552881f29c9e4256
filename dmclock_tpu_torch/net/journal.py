"""The fsync'd arrival journal (docs/RPC.md "Crash equivalence"; the
port's copy of ``dmclock_tpu/net/journal.py``: the record format is the
JAX package's, so either package replays the other's journal).

Write-ahead admission on the checkpoint-boundary grid, the same WAL
discipline as the controller's :class:`control.journal
.DecisionJournal`: one JSON line per chunk boundary, appended --
``write`` + ``flush`` + ``fsync`` -- BEFORE the chunk is applied to
the device.  A SIGKILL between the fsync and the apply therefore
leaves a journaled-but-unapplied record, and resume REPLAYS it
instead of re-taking from the (gone) socket buffers: the admitted-
counts trace of the resumed run is byte-identical to an
uninterrupted one, which is the whole crash-equivalence contract of
``--mode rpc``.

Each record carries everything admission needs to be exactly-once:

- ``counts``: the coalesced ``int32[epochs, n]`` superwave matrix
  this boundary admits (the device sees nothing else);
- ``marks``: the per-client dedup watermarks AFTER this take (a
  resumed server rehydrates them, so a client retrying an already-
  journaled seq gets ST_DUP, not a double admission);
- ``events``: the cumulative fault/backpressure counter snapshot
  (the chaos gate's exact-accounting read).

Torn tails (a crash mid-append) are truncated away on load, exactly
like the decision journal: a record is either durable and complete
or it never happened.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

_FILENAME = "arrivals.jsonl"


class ArrivalJournal:
    """Append-only, strictly sequential boundary records.

    ``workdir=None`` keeps the journal in memory (unit tests and the
    self-generated replay twin, where durability is meaningless)."""

    def __init__(self, workdir: Optional[str] = None) -> None:
        self.path = None if workdir is None else os.path.join(
            os.fspath(workdir), _FILENAME)
        self.entries: List[dict] = []
        if self.path is not None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        keep = 0
        with open(self.path, "rb") as f:
            raw = f.read()
        for line in raw.split(b"\n"):
            if not line:
                continue
            end = raw.find(b"\n", keep)
            if end < 0:
                break          # torn tail: no newline -> not durable
            try:
                ent = json.loads(raw[keep:end].decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                break          # torn/corrupt line: truncate from here
            if int(ent.get("seq", -1)) != len(self.entries):
                break          # sequence gap: refuse the suffix
            self.entries.append(ent)
            keep = end + 1
        if keep < len(raw):
            # drop the torn suffix ON DISK too, so the next append
            # starts at a clean line boundary
            with open(self.path, "r+b") as f:
                f.truncate(keep)
                f.flush()
                os.fsync(f.fileno())

    def __len__(self) -> int:
        return len(self.entries)

    def entry_at(self, seq: int) -> Optional[dict]:
        seq = int(seq)
        return self.entries[seq] if 0 <= seq < len(self.entries) \
            else None

    def append(self, entry: dict) -> dict:
        """Durably append the next boundary record; returns it.  The
        fsync completes BEFORE this returns -- callers apply the
        chunk only after."""
        entry = dict(entry)
        entry["seq"] = len(self.entries)
        if self.path is not None:
            line = json.dumps(entry, sort_keys=True,
                              separators=(",", ":")) + "\n"
            with open(self.path, "ab") as f:
                f.write(line.encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
        self.entries.append(entry)
        return entry

    def counts_trace(self) -> List[list]:
        """The admitted-counts trace, one matrix per boundary -- what
        the self-generated replay twin is fed (the digest gate)."""
        return [ent["counts"] for ent in self.entries]

    def last_marks(self) -> Optional[dict]:
        """The newest record's dedup watermarks (server rehydration
        on resume); None when the journal is empty."""
        return self.entries[-1]["marks"] if self.entries else None
