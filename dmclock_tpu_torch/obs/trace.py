"""Bounded JSONL decision trace (the port's copy of
``dmclock_tpu/obs/trace.py``: the same schema, byte for byte).

One JSON object per scheduling decision, streamed to disk as the sim
runs (no unbounded in-memory list), capped at ``limit`` rows -- past
the cap rows are counted but not written, so a runaway sim cannot fill
the disk.  Schema v2 (``docs/OBSERVABILITY.md``):

    {"t": <virtual ns>, "server": <id>, "client": <id>,
     "phase": "reservation" | "priority", "cost": <int>,
     "tag": [resv, prop, limit] | null,
     "margin": <int ns> | null, "eligible_depth": <int> | null,
     "gate": <int> | null}

``tag`` is the served request's tag triple when the backend exposes it
(the host oracle queues do via ``PullReq.tag``); backends that never
materialize per-decision tags on the host (the device batch engine) emit
``null`` -- the field is optional-by-null, never absent.

``margin`` / ``eligible_depth`` / ``gate`` are the decision-provenance
columns (v2; ``obs.provenance``): the winner's margin over the
runner-up candidate (ns), the eligible-set depth, and the limit-gated
client count at the decision's instant -- ``null`` when the backend
does not surface them (the flight ring, ``obs.flight``, is the
always-populated device-side record).  The reader is backward
compatible: v1 rows (no provenance fields) load with nulls.
"""

from __future__ import annotations

import json
from typing import IO, Optional

TRACE_FIELDS_V1 = ("t", "server", "client", "phase", "cost", "tag")
PROVENANCE_FIELDS = ("margin", "eligible_depth", "gate")
TRACE_FIELDS = TRACE_FIELDS_V1 + PROVENANCE_FIELDS
_PHASES = ("reservation", "priority")


class DecisionTrace:
    """Streaming bounded JSONL writer for scheduling decisions."""

    def __init__(self, path: str, limit: int = 1_000_000):
        self.path = path
        self.limit = int(limit)
        self.rows_written = 0
        self.rows_dropped = 0
        self._fh: Optional[IO[str]] = open(path, "w")

    def record(self, t_ns: int, server, client, phase: int, cost: int,
               tag=None, margin=None, eligible_depth=None,
               gate=None) -> None:
        if self._fh is None:
            return
        if self.rows_written >= self.limit:
            self.rows_dropped += 1
            return
        row = {"t": int(t_ns), "server": server, "client": client,
               "phase": _PHASES[int(phase)], "cost": int(cost),
               "tag": [int(x) for x in tag] if tag is not None else None,
               "margin": int(margin) if margin is not None else None,
               "eligible_depth": int(eligible_depth)
               if eligible_depth is not None else None,
               "gate": int(gate) if gate is not None else None}
        self._fh.write(json.dumps(row, separators=(",", ":")) + "\n")
        self.rows_written += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _check_row(path: str, i: int, row: dict) -> None:
    """Schema validation of one row (v1 or v2); raises ValueError."""
    got = set(row)
    if got != set(TRACE_FIELDS) and got != set(TRACE_FIELDS_V1):
        raise ValueError(
            f"{path}:{i+1}: fields {sorted(row)} match neither the "
            f"v2 schema {sorted(TRACE_FIELDS)} nor the v1 schema "
            f"{sorted(TRACE_FIELDS_V1)}")
    if row["phase"] not in _PHASES:
        raise ValueError(f"{path}:{i+1}: bad phase "
                         f"{row['phase']!r}")
    if not isinstance(row["t"], int) or \
            not isinstance(row["cost"], int):
        raise ValueError(f"{path}:{i+1}: t/cost must be ints")
    tag = row["tag"]
    if tag is not None and (
            not isinstance(tag, list) or len(tag) != 3 or
            not all(isinstance(x, int) for x in tag)):
        raise ValueError(f"{path}:{i+1}: tag must be null or "
                         "[resv, prop, limit] ints")
    for field in PROVENANCE_FIELDS:
        v = row.get(field)
        if v is not None and not isinstance(v, int):
            raise ValueError(f"{path}:{i+1}: {field} must be null "
                             "or an int")


def load_trace(path: str) -> list:
    """Read a trace back as dict rows, validating each; v1 rows load
    with ``None`` in the provenance columns (the backward-compatible
    reader)."""
    rows = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i+1}: not JSON: {e}")
            _check_row(path, i, row)
            for field in PROVENANCE_FIELDS:
                row.setdefault(field, None)
            rows.append(row)
    return rows


def validate_trace_file(path: str) -> dict:
    """Validate a trace file against the schema (v1 or v2 rows);
    raises ``ValueError`` on the first bad row.  Returns summary stats
    the CI smoke checks against the conformance table:

        {"rows": N, "per_client": {client: count},
         "per_phase": {"reservation": n, "priority": n},
         "v1_rows": n, "v2_rows": n,
         "margin": {"count": n, "max_ns": x},
         "gate": {"count": n, "max": x}}
    """
    per_client: dict = {}
    per_phase = {"reservation": 0, "priority": 0}
    rows = v1_rows = v2_rows = 0
    margin_n = 0
    margin_max = 0
    gate_n = 0
    gate_max = 0
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i+1}: not JSON: {e}")
            _check_row(path, i, row)
            if set(row) == set(TRACE_FIELDS_V1):
                v1_rows += 1
            else:
                v2_rows += 1
            rows += 1
            key = row["client"]
            per_client[key] = per_client.get(key, 0) + 1
            per_phase[row["phase"]] += 1
            m = row.get("margin")
            if m is not None:
                margin_n += 1
                margin_max = max(margin_max, m)
            g = row.get("gate")
            if g is not None:
                gate_n += 1
                gate_max = max(gate_max, g)
    return {"rows": rows, "per_client": per_client,
            "per_phase": per_phase,
            "v1_rows": v1_rows, "v2_rows": v2_rows,
            "margin": {"count": margin_n, "max_ns": margin_max},
            "gate": {"count": gate_n, "max": gate_max}}


def summarize(path: str, device_metrics=None) -> dict:
    """:func:`validate_trace_file` plus the device cross-check: with
    ``device_metrics`` (a fetched ``obs.device`` vector, dict, or
    ``(resv, prop)`` pair) the trace's per-phase totals must equal the
    device ``MET_RESV`` / ``MET_PROP`` counters EXACTLY -- the trace
    is a host-side transcript of the same decisions, so any mismatch
    means rows were dropped, duplicated, or mis-phased.  Raises
    ``ValueError`` on mismatch (``dmc_sim --ledger-check`` turns that
    into a nonzero exit)."""
    stats = validate_trace_file(path)
    if device_metrics is not None:
        if isinstance(device_metrics, dict):
            resv = int(device_metrics["decisions_reservation"])
            prop = int(device_metrics["decisions_priority"])
        elif isinstance(device_metrics, tuple):
            resv, prop = (int(x) for x in device_metrics)
        else:
            from . import device as obsdev
            vec = device_metrics
            resv = int(vec[obsdev.MET_RESV])
            prop = int(vec[obsdev.MET_PROP])
        got = stats["per_phase"]
        if got["reservation"] != resv or got["priority"] != prop:
            raise ValueError(
                f"{path}: per-phase totals diverge from the device "
                f"counters: trace reservation={got['reservation']} "
                f"priority={got['priority']} vs device MET_RESV="
                f"{resv} MET_PROP={prop}")
        stats["device_cross_check"] = {"reservation": resv,
                                       "priority": prop}
    return stats
