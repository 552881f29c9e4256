#!/usr/bin/env python
"""Span-trace attribution report and before/after diff, on the port.

The counterpart of ``scripts/trace_report.py`` over the port's span
categories and trace reader (``dmclock_tpu_torch.obs.spans``,
``dmclock_tpu_torch.obs.trace_export``), so that a box without JAX
renders the port's traces: the same flags, the same tables, the same
output byte for byte.  Its input is a span file: Chrome trace-event JSON
(``--trace-out`` of ``python -m dmclock_tpu_torch.bench`` or of
``serve``) or the tracer's raw JSONL (a supervisor ``span_log``):

    python scripts/torch_trace_report.py trace.json

prints per-(name, category) rows -- count, total / self time, mean,
and per-span duration percentiles -- sorted by self time, the
per-category rollup, and the **dispatch-vs-compute ratio** (host
``dispatch`` self-time over ``device_compute`` self-time: how many
seconds of launching the run paid per second of device work).

    python scripts/torch_trace_report.py after.json --diff before.json

diffs two trace files by (name, category): delta count / total / self
/ mean per row plus the ratio shift.  ``--decisions N`` adds the
per-decision amortized column.

Exit status: 0 ok, 2 bad input.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Tuple

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dmclock_tpu_torch.obs.spans import CATEGORIES           # noqa: E402
from dmclock_tpu_torch.obs.trace_export import (            # noqa: E402
    load_rows, rows_self_times)


def _percentile(sorted_vals: List[int], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return float(sorted_vals[idx])


def aggregate(rows: List[dict]) -> Dict[Tuple[str, str], dict]:
    """(name, cat) -> {count, total_ns, self_ns, durs (sorted)};
    self time from the canonical ``trace_export.rows_self_times``
    sweep (recorded ``self`` fields trusted, Chrome rows swept)."""
    selfs = rows_self_times(rows)
    agg: Dict[Tuple[str, str], dict] = {}
    for r, self_ns in zip(rows, selfs):
        key = (r["name"], r.get("cat", "?"))
        a = agg.setdefault(key, {"count": 0, "total_ns": 0,
                                 "self_ns": 0, "durs": []})
        a["count"] += 1
        a["total_ns"] += r["dur"]
        a["self_ns"] += self_ns
        a["durs"].append(r["dur"])
    for a in agg.values():
        a["durs"].sort()
    return agg


def cat_rollup(agg) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for (_name, cat), a in agg.items():
        c = out.setdefault(cat, {"count": 0, "self_ns": 0})
        c["count"] += a["count"]
        c["self_ns"] += a["self_ns"]
    return out


def dispatch_ratio(cats: Dict[str, dict]) -> float:
    """dispatch self-time per unit of device_compute self-time; inf
    (represented as -1) when no device time was observed."""
    dev = cats.get("device_compute", {}).get("self_ns", 0)
    disp = cats.get("dispatch", {}).get("self_ns", 0)
    return disp / dev if dev else (-1.0 if disp else 0.0)


def _ms(ns: float) -> str:
    return f"{ns / 1e6:.2f}"


def print_report(path: str, agg, cats, top: int,
                 decisions: int = 0) -> None:
    """``decisions`` > 0 adds the per-decision AMORTIZED column
    (self_ns / decisions): under the streaming serve loop one launch
    covers a whole chunk of rounds, so per-LAUNCH dispatch numbers
    stop being comparable across loop modes -- per-decision cost is
    the loop-structure-independent currency
    (docs/OBSERVABILITY.md)."""
    print(f"== span attribution: {path} ==")
    amort = f" {'ns/dec':>8}" if decisions else ""
    print(f"{'name':<28} {'cat':<14} {'count':>8} {'total ms':>10} "
          f"{'self ms':>10} {'mean us':>9} {'p50 us':>8} {'p90 us':>8} "
          f"{'p99 us':>8}" + amort)
    ranked = sorted(agg.items(), key=lambda kv: -kv[1]["self_ns"])
    for (name, cat), a in ranked[:top]:
        durs = a["durs"]
        mean_us = a["total_ns"] / max(a["count"], 1) / 1e3
        row = (f"{name:<28} {cat:<14} {a['count']:>8} "
               f"{_ms(a['total_ns']):>10} {_ms(a['self_ns']):>10} "
               f"{mean_us:>9.1f} "
               f"{_percentile(durs, 0.50) / 1e3:>8.1f} "
               f"{_percentile(durs, 0.90) / 1e3:>8.1f} "
               f"{_percentile(durs, 0.99) / 1e3:>8.1f}")
        if decisions:
            row += f" {a['self_ns'] / decisions:>8.1f}"
        print(row)
    if len(ranked) > top:
        print(f"  ... {len(ranked) - top} more rows (--top)")
    print("-- categories (self time) --")
    total = sum(c["self_ns"] for c in cats.values()) or 1
    for cat in CATEGORIES:
        if cat in cats:
            c = cats[cat]
            line = (f"  {cat:<16} {_ms(c['self_ns']):>10} ms "
                    f"({100.0 * c['self_ns'] / total:5.1f}%)  "
                    f"{c['count']} spans")
            if decisions:
                line += f"  {c['self_ns'] / decisions:.1f} ns/dec"
            print(line)
    ratio = dispatch_ratio(cats)
    label = "inf (no device spans)" if ratio < 0 else f"{ratio:.3f}"
    print(f"dispatch-vs-compute ratio: {label} "
          "(host dispatch self-time / device_compute self-time)")
    if decisions:
        disp = cats.get("dispatch", {}).get("self_ns", 0)
        print(f"dispatch amortized: {disp / decisions:.1f} "
              f"ns/decision over {decisions} decisions (one launch "
              "may cover a whole stream chunk; per-decision cost is "
              "the loop-independent comparison)")


def print_diff(path_a: str, path_b: str, agg_a, agg_b, top: int,
               decisions: int = 0) -> None:
    """``path_a`` is the AFTER file, ``path_b`` the baseline.
    ``decisions`` > 0 adds the per-decision amortized delta column --
    the round-vs-stream A/B covers the SAME decision count on both
    sides by construction (stream is digest-pinned to round), so one
    N amortizes both."""
    print(f"== span diff: {path_a} vs baseline {path_b} ==")
    keys = set(agg_a) | set(agg_b)
    zero = {"count": 0, "total_ns": 0, "self_ns": 0, "durs": []}
    rows = []
    for k in keys:
        a, b = agg_a.get(k, zero), agg_b.get(k, zero)
        rows.append((k, a["self_ns"] - b["self_ns"], a, b))
    rows.sort(key=lambda r: -abs(r[1]))
    amort = f" {'d ns/dec':>9}" if decisions else ""
    print(f"{'name':<28} {'cat':<14} {'d count':>8} {'d total ms':>11} "
          f"{'d self ms':>10} {'d mean us':>10}" + amort)
    for (name, cat), dself, a, b in rows[:top]:
        mean_a = a["total_ns"] / max(a["count"], 1) / 1e3
        mean_b = b["total_ns"] / max(b["count"], 1) / 1e3
        row = (f"{name:<28} {cat:<14} {a['count'] - b['count']:>+8} "
               f"{(a['total_ns'] - b['total_ns']) / 1e6:>+11.2f} "
               f"{dself / 1e6:>+10.2f} {mean_a - mean_b:>+10.1f}")
        if decisions:
            row += f" {dself / decisions:>+9.1f}"
        print(row)
    ca, cb = cat_rollup(agg_a), cat_rollup(agg_b)
    ra, rb = dispatch_ratio(ca), dispatch_ratio(cb)
    fmt = lambda r: "inf" if r < 0 else f"{r:.3f}"  # noqa: E731
    print(f"dispatch-vs-compute ratio: {fmt(rb)} -> {fmt(ra)}")
    if decisions:
        da = ca.get("dispatch", {}).get("self_ns", 0) / decisions
        db = cb.get("dispatch", {}).get("self_ns", 0) / decisions
        print(f"dispatch amortized: {db:.1f} -> {da:.1f} ns/decision "
              f"over {decisions} decisions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="span-trace attribution report "
                    "(Chrome trace JSON or span JSONL)")
    ap.add_argument("trace", help="trace file (--trace-out JSON or "
                    "span_log JSONL)")
    ap.add_argument("--diff", metavar="BASELINE", default=None,
                    help="diff against a baseline trace (before/after "
                    "tool: TRACE is the after side)")
    ap.add_argument("--top", type=int, default=20,
                    help="rows to print (default 20)")
    ap.add_argument("--decisions", type=int, default=0, metavar="N",
                    help="decisions the trace covers: adds the "
                    "per-decision amortized column (self_ns / N) -- "
                    "the loop-structure-independent cost view when "
                    "one stream launch covers a whole chunk of "
                    "rounds (docs/OBSERVABILITY.md).  With --diff, N "
                    "amortizes BOTH sides, so the two traces must "
                    "cover the same decision count (true for the "
                    "digest-pinned round-vs-stream A/B; meaningless "
                    "for runs of different lengths)")
    args = ap.parse_args(argv)

    try:
        rows = load_rows(args.trace)
        if not rows:
            print(f"torch_trace_report: {args.trace}: no spans",
                  file=sys.stderr)
            return 2
        agg = aggregate(rows)
        if args.diff:
            base = aggregate(load_rows(args.diff))
            print_diff(args.trace, args.diff, agg, base, args.top,
                       decisions=max(args.decisions, 0))
        else:
            print_report(args.trace, agg, cat_rollup(agg), args.top,
                         decisions=max(args.decisions, 0))
        return 0
    except (OSError, ValueError, KeyError) as e:
        print(f"torch_trace_report: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
