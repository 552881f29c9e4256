"""Write-ahead decision journal: fsync-before-apply, replay-not-
re-decide (the port's copy of ``dmclock_tpu/control/journal.py``; the
file format is the JAX package's, so either package resumes the other's
journal).

One JSON line per decision, strictly sequential ``seq``::

    {"seq": 3, "epoch": 8, "rule": "clamp_down",
     "digest": "9f2c...", "old": [1, 0, 100, 0], "new": [1, 0, 75, 0]}

Contract (docs/CONTROLLER.md "Replay"):

1. The entry is written + ``flush`` + ``fsync`` BEFORE the knob
   vector moves (``append`` is called before apply).
2. The checkpoint payload carries the APPLIED cursor (``ctl_cursor``),
   which can only trail the journal.  A resumed run re-derives each
   boundary's decisions (the policy is pure) and, where the journal
   already has the entry at that seq, REPLAYS the journaled knob
   vector instead of re-deciding -- so a kill at any point
   (before-write / after-write-before-apply / after-apply) yields the
   exact knob trajectory of the uninterrupted run, and the journal
   never holds two entries for one seq.
3. A kill mid-write can tear the last line; on open the torn tail is
   truncated away (the decision was never applied -- the resumed run
   re-decides it identically and rewrites it).

``workdir=None`` (the bare runner / controller smoke without a
supervisor) keeps the journal in memory only: same replay semantics
within the process, nothing durable.
"""

from __future__ import annotations

import json
import os
from typing import Optional

FILENAME = "controller.journal"


class DecisionJournal:

    def __init__(self, workdir: Optional[str] = None):
        self.path = os.path.join(os.fspath(workdir), FILENAME) \
            if workdir is not None else None
        self.entries: list = []
        if self.path is not None and os.path.exists(self.path):
            self._load()

    def _load(self) -> None:
        with open(self.path, "rb") as fh:
            data = fh.read()
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break               # torn tail: kill landed mid-write
            try:
                self.entries.append(json.loads(line))
            except ValueError:      # torn/rotted line: stop trusting
                break
            good += len(line)
        if good != len(data):
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
                fh.flush()
                os.fsync(fh.fileno())

    def __len__(self) -> int:
        return len(self.entries)

    def entry_at(self, seq: int) -> Optional[dict]:
        """The journaled entry for decision ``seq`` (None when the
        journal hasn't reached it -- the fresh-decision case)."""
        if 0 <= seq < len(self.entries):
            return self.entries[seq]
        return None

    def append(self, entry: dict) -> None:
        """Durably journal one decision BEFORE it is applied."""
        assert int(entry["seq"]) == len(self.entries), \
            (entry["seq"], len(self.entries))
        if self.path is not None:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(entry, sort_keys=True) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        self.entries.append(entry)
