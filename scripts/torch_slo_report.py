#!/usr/bin/env python
"""Offline SLO conformance report from a closed-window JSONL export, on
the port.

The counterpart of ``scripts/slo_report.py`` over the port's reader
(``dmclock_tpu_torch.obs.slo.load_windows_jsonl``), so that a box
without JAX renders the port's SLO logs: the same flags, the same table,
the same output byte for byte.  It reads the judged closed-window stream
a supervised run appends via ``EpochJob(slo_log=...)`` (or
``SloPlane.export_jsonl``) and renders the delivered-vs-contract verdict
per ``(client, contract_epoch)`` series:

    python scripts/torch_slo_report.py RUN.slo.jsonl
    python scripts/torch_slo_report.py RUN.slo.jsonl --diff BASELINE.jsonl
    python scripts/torch_slo_report.py RUN.slo.jsonl --client 7 --limit 40

Per series the table shows windows, delivered ops/rate, reservation
misses, worst/mean share error, limit excess, and mean reservation
tardiness.  ``--diff`` prints per-series deltas of the violation
counts and share errors against a baseline export.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dmclock_tpu_torch.obs.slo import load_windows_jsonl  # noqa: E402


def _series(rows):
    """Group judged rows by (client, contract_epoch), in first-seen
    order, computing the per-series aggregate the table prints."""
    out = {}
    for r in rows:
        key = (int(r.get("client", -1)),
               int(r.get("contract_epoch", 0)))
        s = out.setdefault(key, {
            "windows": 0, "ops": 0, "cost": 0, "resv_ops": 0,
            "tardy_ops": 0, "lb_ops": 0, "resv_miss": 0,
            "share_errs": [], "limit_excess": 0.0, "tard_means": [],
            "reservation": r.get("reservation", 0.0),
            "weight": r.get("weight", 0.0),
            "limit": r.get("limit", 0.0),
            "rate_sum": 0.0,
        })
        s["windows"] += 1
        s["ops"] += int(r.get("ops", 0))
        s["cost"] += int(r.get("cost", 0))
        s["resv_ops"] += int(r.get("resv_ops", 0))
        s["tardy_ops"] += int(r.get("tardy_ops", 0))
        s["lb_ops"] += int(r.get("lb_ops", 0))
        s["resv_miss"] += int(bool(r.get("resv_miss")))
        s["rate_sum"] += float(r.get("rate", 0.0))
        if r.get("entitled_share", 0) > 0:
            s["share_errs"].append(abs(float(r.get("share_err", 0.0))))
        s["limit_excess"] = max(s["limit_excess"],
                                float(r.get("limit_excess", 0.0)))
        if r.get("resv_ops", 0):
            s["tard_means"].append(float(
                r.get("tardiness_mean_ns", 0.0)))
    return out


def _fmt_row(key, s):
    cid, ce = key
    share = max(s["share_errs"], default=0.0)
    tard = (sum(s["tard_means"]) / len(s["tard_means"]) / 1e6) \
        if s["tard_means"] else 0.0
    return (f"{cid:>7} {ce:>3} {s['windows']:>5} {s['ops']:>9} "
            f"{s['rate_sum'] / max(s['windows'], 1):>10.1f} "
            f"{s['reservation']:>8.1f} {s['weight']:>6.1f} "
            f"{s['resv_miss']:>5} {s['tardy_ops']:>6} "
            f"{share:>9.3f} {s['lb_ops']:>6} "
            f"{s['limit_excess']:>8.1f} {tard:>9.2f}")


_HDR = (f"{'client':>7} {'ce':>3} {'win':>5} {'ops':>9} "
        f"{'rate/s':>10} {'resv/s':>8} {'weight':>6} {'miss':>5} "
        f"{'tardy':>6} {'|shr err|':>9} {'lb':>6} {'lim xs':>8} "
        f"{'tard ms':>9}")


def _totals(series):
    return {
        "series": len(series),
        "windows": sum(s["windows"] for s in series.values()),
        "ops": sum(s["ops"] for s in series.values()),
        "resv_miss": sum(s["resv_miss"] for s in series.values()),
        "tardy_ops": sum(s["tardy_ops"] for s in series.values()),
        "lb_ops": sum(s["lb_ops"] for s in series.values()),
        "worst_share_err": max(
            (max(s["share_errs"], default=0.0)
             for s in series.values()), default=0.0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="windowed SLO conformance report "
                    "(docs/OBSERVABILITY.md 'SLO plane')")
    ap.add_argument("jsonl", help="closed-window JSONL export "
                    "(EpochJob slo_log / SloPlane.export_jsonl)")
    ap.add_argument("--diff", metavar="BASELINE",
                    help="second export; print per-series deltas")
    ap.add_argument("--client", type=int, default=None,
                    help="restrict to one client id")
    ap.add_argument("--limit", type=int, default=60,
                    help="max series rows printed (most-violating "
                    "first; 0 = all)")
    args = ap.parse_args(argv)

    rows = load_windows_jsonl(args.jsonl)
    if not rows:
        print(f"torch_slo_report: no rows in {args.jsonl}", file=sys.stderr)
        return 1
    skipped = rows[0].pop("_skipped", 0) if rows else 0
    if skipped:
        print(f"torch_slo_report: skipped {skipped} malformed line(s)",
              file=sys.stderr)
    if args.client is not None:
        rows = [r for r in rows if r.get("client") == args.client]
    series = _series(rows)

    def badness(item):
        _key, s = item
        return (s["resv_miss"], s["tardy_ops"],
                max(s["share_errs"], default=0.0), s["lb_ops"])

    ordered = sorted(series.items(), key=badness, reverse=True)
    shown = ordered if not args.limit else ordered[:args.limit]
    print(f"# SLO windowed conformance: {args.jsonl} "
          f"({len(rows)} windows, {len(series)} "
          f"(client, contract-epoch) series)")
    print(_HDR)
    for key, s in shown:
        print(_fmt_row(key, s))
    if len(ordered) > len(shown):
        print(f"... {len(ordered) - len(shown)} more series "
              f"(--limit 0 for all)")
    t = _totals(series)
    print(f"# totals: {t['ops']} ops over {t['windows']} windows; "
          f"{t['resv_miss']} resv-miss windows, "
          f"{t['tardy_ops']} tardy ops, {t['lb_ops']} limit breaks, "
          f"worst |share err| {t['worst_share_err']:.3f}")

    if args.diff:
        base_rows = load_windows_jsonl(args.diff)
        if not base_rows:
            print(f"torch_slo_report: no rows in baseline {args.diff}",
                  file=sys.stderr)
            return 1
        if args.client is not None:
            base_rows = [r for r in base_rows
                         if r.get("client") == args.client]
        base = _series(base_rows)
        tb = _totals(base)
        print(f"\n# diff vs {args.diff} ({tb['windows']} baseline "
              f"windows)")
        for name in ("resv_miss", "tardy_ops", "lb_ops"):
            print(f"#   {name}: {tb[name]} -> {t[name]} "
                  f"({t[name] - tb[name]:+d})")
        print(f"#   worst |share err|: {tb['worst_share_err']:.3f} "
              f"-> {t['worst_share_err']:.3f} "
              f"({t['worst_share_err'] - tb['worst_share_err']:+.3f})")
        both = sorted(set(series) & set(base))
        moved = []
        for key in both:
            d = series[key]["resv_miss"] - base[key]["resv_miss"]
            if d:
                moved.append((abs(d), key, d))
        for _a, key, d in sorted(moved, reverse=True)[:20]:
            print(f"#   client {key[0]} ce {key[1]}: "
                  f"resv-miss windows {d:+d}")
        only_new = sorted(set(series) - set(base))
        if only_new:
            print(f"#   {len(only_new)} series only in {args.jsonl} "
                  f"(new clients / new contract epochs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
