"""Chrome trace-event / Perfetto export for the span tracer (the port's
copy of ``dmclock_tpu/obs/trace_export.py``, over the port's
``obs.spans``; the file is byte for byte the JAX package's).

Any run that collected spans (``obs.spans.SpanTracer``) exports a
timeline loadable in ``chrome://tracing`` / https://ui.perfetto.dev:

    from dmclock_tpu_torch.obs import spans, trace_export
    tr = spans.SpanTracer()
    ...
    trace_export.export_chrome_trace(tr, "trace.json")

The format is the Trace Event Format's JSON object form
(``{"traceEvents": [...]}``), one complete ("X") event per span --
``ts``/``dur`` in microseconds (floats, so ns resolution survives),
``pid`` fixed at 0, ``tid`` the recording thread.  An X event IS a
matched begin/end pair by construction; :func:`validate_chrome_trace`
checks the stream the way a B/E validator would -- per-tid events must
nest (every span fully contains its children; partial overlap is a
corrupted begin/end pairing) with monotone, non-negative timestamps
and categories from the fixed taxonomy -- and returns per-category
SELF-time sums so CI can gate "category sums ~= wall time"
(``scripts/ci.sh`` tracing smoke).

:func:`load_rows` reads either format (Chrome JSON or the tracer's
JSONL) back into span rows for ``scripts/torch_trace_report.py``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

from .spans import CATEGORIES, SpanTracer, load_jsonl

# 1 ns expressed in the export's microsecond unit: float-division slop
# for the nesting sweeps
_EPS_US = 1e-3


def chrome_events(rows: List[dict], pid: int = 0) -> List[dict]:
    """Span rows -> trace-event dicts (complete "X" events), sorted by
    (ts, -dur) so a parent precedes the children it contains at the
    same timestamp (the orientation viewers and the validator rely
    on)."""
    events = []
    for r in rows:
        ev = {"name": r["name"], "cat": r["cat"], "ph": "X",
              "ts": r["ts"] / 1000.0, "dur": r["dur"] / 1000.0,
              "pid": pid, "tid": r.get("tid", 0)}
        args = r.get("args")
        if args:
            ev["args"] = dict(args)
        events.append(ev)
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    return events


def export_chrome_trace(src: Union[SpanTracer, List[dict]],
                        path: str, *,
                        metadata: Optional[dict] = None) -> int:
    """Write ``src`` (a tracer, or raw span rows) as a Chrome
    trace-event JSON file; returns the event count."""
    rows = src.rows() if isinstance(src, SpanTracer) else list(src)
    events = chrome_events(rows)
    obj = {"traceEvents": events, "displayTimeUnit": "ns"}
    if isinstance(src, SpanTracer):
        obj["otherData"] = {"spans_recorded": src.spans_recorded,
                            "spans_dropped": src.spans_dropped}
    if metadata:
        obj.setdefault("otherData", {}).update(metadata)
    with open(path, "w") as fh:
        json.dump(obj, fh, separators=(",", ":"))
    return len(events)


def rows_self_times(rows: List[dict]) -> List[int]:
    """Per-row SELF time (ns).  Tracer JSONL rows carry a recorded
    ``self`` field -- trusted verbatim; otherwise (Chrome exports
    loaded back) a per-tid nesting sweep over (ts, -dur)-ordered rows
    subtracts each span's direct children from it.  This is THE
    canonical sweep -- ``validate_chrome_trace`` and
    ``scripts/torch_trace_report.py`` both use it, so the CI self-time gate
    and the attribution table can never disagree on the same file."""
    if rows and all("self" in r for r in rows):
        return [int(r["self"]) for r in rows]
    order = sorted(range(len(rows)),
                   key=lambda i: (rows[i]["ts"],
                                  -rows[i].get("dur", 0)))
    selfs = [0] * len(rows)
    stacks: Dict[int, list] = {}    # tid -> [[end_ns, row_idx]]
    for i in order:
        r = rows[i]
        ts, dur = r["ts"], r.get("dur", 0)
        st = stacks.setdefault(r.get("tid", 0), [])
        # 1ns slop: a us-float round trip can land a child's end 1ns
        # past its parent's
        while st and ts >= st[-1][0] - 1:
            st.pop()
        if st:
            selfs[st[-1][1]] -= dur
        selfs[i] += dur
        st.append([ts + dur, i])
    return [max(s, 0) for s in selfs]


def _self_time_sweep(events: List[dict]) -> Dict[str, float]:
    """Per-category SELF time (ns) over X events: the canonical
    :func:`rows_self_times` sweep applied to the events' ns-domain
    rows."""
    rows = [{"cat": ev.get("cat", "?"),
             "ts": int(round(ev["ts"] * 1000.0)),
             "dur": int(round(ev.get("dur", 0) * 1000.0)),
             "tid": ev.get("tid", 0)} for ev in events]
    out: Dict[str, float] = {}
    for r, self_ns in zip(rows, rows_self_times(rows)):
        out[r["cat"]] = out.get(r["cat"], 0.0) + self_ns
    return out


def validate_chrome_trace(path: str) -> dict:
    """Validate an exported trace file; raises ``ValueError`` on the
    first violation.  Checks:

    - the envelope is ``{"traceEvents": [...]}`` of "X" events;
    - ``ts``/``dur`` non-negative numbers, ``ts`` monotone
      non-decreasing in file order (the exporter sorts);
    - every ``cat`` is in the fixed taxonomy (``spans.CATEGORIES``);
    - per ``tid``, events NEST: each event either starts at/after the
      enclosing event's end (a sibling) or ends within it (a child) --
      partial overlap means a corrupted begin/end pairing.

    Returns ``{"events", "tids", "cat_self_ns", "cat_count",
    "span_ns"}``: ``cat_self_ns`` sums SELF time per category
    (children subtracted from parents), ``span_ns`` their total -- the
    quantity CI compares against wall time.
    """
    with open(path) as fh:
        obj = json.load(fh)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(f"{path}: no traceEvents envelope")
    events = obj["traceEvents"]
    cat_count: Dict[str, int] = {}
    stacks: Dict[int, list] = {}    # tid -> [end_us, ...] open spans
    prev_ts = None
    for i, ev in enumerate(events):
        if ev.get("ph") != "X":
            raise ValueError(f"{path}: event {i}: phase "
                             f"{ev.get('ph')!r} != 'X'")
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or ts < 0 or \
                not isinstance(dur, (int, float)) or dur < 0:
            raise ValueError(f"{path}: event {i}: bad ts/dur "
                             f"({ts!r}, {dur!r})")
        if prev_ts is not None and ts < prev_ts:
            raise ValueError(f"{path}: event {i}: ts regressed "
                             f"({ts} < {prev_ts})")
        prev_ts = ts
        cat = ev.get("cat")
        if cat not in CATEGORIES:
            raise ValueError(f"{path}: event {i}: category {cat!r} "
                             f"not in the taxonomy {CATEGORIES}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{path}: event {i}: missing name")
        tid = ev.get("tid", 0)
        st = stacks.setdefault(tid, [])
        end = ts + dur
        while st and ts >= st[-1] - _EPS_US:
            st.pop()
        if st and end > st[-1] + _EPS_US:
            raise ValueError(
                f"{path}: event {i} ({ev['name']!r} tid {tid}): ends "
                f"at {end} past its enclosing span's end {st[-1]} "
                "-- begin/end pairs are not properly nested")
        st.append(end)
        cat_count[cat] = cat_count.get(cat, 0) + 1
    cat_self = _self_time_sweep(events)
    return {"events": len(events), "tids": len(stacks),
            "cat_self_ns": cat_self, "cat_count": cat_count,
            "span_ns": sum(cat_self.values())}


def load_rows(path: str) -> List[dict]:
    """Load span rows from either export format: the tracer's JSONL
    (rows pass through) or a Chrome trace-event JSON file (X events
    map back to rows; ``self`` is recomputed by the consumer's nesting
    sweep when absent)."""
    # format sniffing: a Chrome export is ONE json object; the
    # tracer's JSONL is one object per line (both start with "{", so
    # only a whole-file parse distinguishes them)
    try:
        with open(path) as fh:
            obj = json.load(fh)
    except json.JSONDecodeError:
        return load_jsonl(path)
    if isinstance(obj, dict) and "traceEvents" in obj:
        rows = []
        for ev in obj["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            rows.append({"name": ev.get("name", "?"),
                         "cat": ev.get("cat", "?"),
                         "ts": int(round(ev["ts"] * 1000.0)),
                         "dur": int(round(ev.get("dur", 0) * 1000.0)),
                         "tid": ev.get("tid", 0),
                         "args": ev.get("args")})
        return rows
    if isinstance(obj, dict) and "name" in obj and "ts" in obj:
        return [obj]    # a single-row JSONL stream parses whole
    raise ValueError(f"{path}: neither a traceEvents envelope nor "
                     "span JSONL")
