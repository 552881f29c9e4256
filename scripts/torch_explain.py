#!/usr/bin/env python
"""torch_explain.py -- offline "why" forensics for one client's SLO
windows, on the port.

The counterpart of ``scripts/explain.py``: the same flags, causes and
output byte for byte, with ``--trace`` read by the port's
``dmclock_tpu_torch.obs.trace.load_trace``, so that a box without JAX
explains the port's runs.

Joins the three decision-provenance artifacts a run leaves behind
(docs/OBSERVABILITY.md "Provenance plane"):

- the **SLO window log** (``--slo``): judged closed-window JSONL rows
  from ``SloPlane.export_jsonl`` (the supervisor's ``slo_log``, the
  bench's per-chain rolls, or ``scripts/slo_report.py``'s input);
- the **flight ring dump** (``--flight``, optional): the HBM black
  box's last-R commit records (``obs.flight``), now carrying the
  provenance ``margin``/``gate`` columns;
- the **decision trace** (``--trace``, optional): schema-v2 JSONL
  (``obs.trace``; v1 rows load with nulls).

and answers ``--client C [--window W]`` with a RANKED causal
attribution of the client's delivered-vs-contract behavior:

    limit_capped        delivered rate pinned at the limit ceiling
                        while demand remained (backlog/tardiness)
    out_competed        eligible and backlogged, but the delivered
                        cost share fell short of the weight
                        entitlement -- lost the proportional race
    reservation_tardy   constraint-phase serves landed past their
                        reservation deadlines / the floor ran a
                        deficit with demand present
    no_demand           nothing delivered because nothing was asked
                        (zero ops AND zero backlog): not a violation

Each cause gets a [0, 1] score from the window rows, with the flight
ring and trace contributing corroborating evidence (limit-gate
pressure, margin tightness).  ``--diff BASELINE`` re-runs the
attribution against a baseline run's window log and prints the score
deltas -- "what changed between these two runs for this client".

Exit status: 0 on success, 2 when the client has no windows in the
log (nothing to explain).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CAUSES = ("limit_capped", "out_competed", "reservation_tardy",
          "no_demand")


def load_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict):
                rows.append(obj)
    return rows


def client_windows(rows: List[dict], client: int,
                   window: Optional[int] = None) -> List[dict]:
    out = [r for r in rows if r.get("client") == client
           and "ops" in r]
    if window is not None:
        out = [r for r in out if r.get("seq") == window]
    return out


def _mean(vals):
    vals = list(vals)
    return sum(vals) / len(vals) if vals else 0.0


def flight_evidence(rows: List[dict], client: int) -> dict:
    """Corroborating signals from the flight ring: the client's own
    commit records (phase mix, margin tightness) and the global
    limit-gate pressure the ring observed."""
    mine = [r for r in rows if r.get("client") == client]
    margins = [r["margin"] for r in rows
               if r.get("margin", -1) is not None
               and r.get("margin", -1) >= 0]
    my_margins = [r["margin"] for r in mine
                  if r.get("margin", -1) is not None
                  and r.get("margin", -1) >= 0]
    gates = [r["gate"] for r in rows if r.get("gate") is not None]
    return {
        "records": len(rows), "client_records": len(mine),
        "client_resv_frac": _mean(1.0 if r.get("cls") == 0 else 0.0
                                  for r in mine),
        "margin_mean_ns": _mean(margins),
        "client_margin_mean_ns": _mean(my_margins),
        "gate_mean": _mean(gates),
        "gate_max": max(gates) if gates else 0,
    }


def trace_evidence(rows: List[dict], client: int) -> dict:
    mine = [r for r in rows if r.get("client") == client]
    gates = [r["gate"] for r in rows if r.get("gate") is not None]
    depths = [r["eligible_depth"] for r in rows
              if r.get("eligible_depth") is not None]
    return {
        "rows": len(rows), "client_rows": len(mine),
        "client_resv_frac": _mean(
            1.0 if r.get("phase") == "reservation" else 0.0
            for r in mine),
        "gate_mean": _mean(gates),
        "eligible_depth_mean": _mean(depths),
    }


def attribute(wins: List[dict], flight: Optional[dict] = None,
              trace: Optional[dict] = None) -> dict:
    """Score the four causes over one client's window rows (see
    module doc); returns ``{"scores", "ranked", "cause",
    "evidence"}``."""
    ops = _mean(w["ops"] for w in wins)
    backlog = _mean(w.get("backlog", 0) for w in wins)
    rate = _mean(w.get("rate", 0.0) for w in wins)
    limit = _mean(w.get("limit", 0.0) for w in wins)
    resv = _mean(w.get("reservation", 0.0) for w in wins)
    share_err = _mean(w.get("share_err", 0.0) for w in wins)
    entitled = _mean(w.get("entitled_share", 0.0) for w in wins)
    resv_ops = sum(w.get("resv_ops", 0) for w in wins)
    tardy_ops = sum(w.get("tardy_ops", 0) for w in wins)
    resv_deficit = _mean(w.get("resv_deficit", 0.0) for w in wins)
    any_miss = any(w.get("resv_miss") for w in wins)
    demand = backlog > 0 or tardy_ops > 0

    evidence: List[str] = []
    scores = {c: 0.0 for c in CAUSES}

    share = _mean(w.get("share", 0.0) for w in wins)
    # the client's own row carries enough to reconstruct the window's
    # delivered total (rate / share), hence its ENTITLED absolute
    # rate -- the counterfactual the limit is capping
    total_rate = rate / share if share > 0 else 0.0
    entitled_abs = entitled * total_rate

    if ops == 0 and backlog == 0:
        scores["no_demand"] = 1.0
        evidence.append("zero delivered ops AND zero backlog at "
                        "every close: the client asked for nothing")
    if limit > 0 and rate >= 0.4 * limit and demand:
        base = min(rate / limit, 1.0)
        if entitled_abs > limit:
            # the weight entitlement EXCEEDS the ceiling: whatever the
            # tag-spacing quantization delivered, the limit -- not the
            # proportional race -- is the binding constraint
            base = max(base, 0.8)
            evidence.append(
                f"entitled rate {entitled_abs:.1f}/s exceeds the "
                f"{limit:.1f}/s limit ceiling: the limit binds")
        scores["limit_capped"] = base
        evidence.append(
            f"delivered rate {rate:.1f}/s against a {limit:.1f}/s "
            f"limit ceiling with demand remaining "
            f"(backlog {backlog:.1f})")
        if flight and flight["gate_mean"] > 0:
            scores["limit_capped"] = min(
                scores["limit_capped"] + 0.1, 1.0)
            evidence.append(
                f"flight ring corroborates: {flight['gate_mean']:.1f}"
                " clients limit-gated per recorded batch "
                f"(max {flight['gate_max']})")
    if resv > 0:
        tardy_frac = tardy_ops / max(resv_ops, 1)
        deficit_frac = min(resv_deficit / resv, 1.0)
        s = max(deficit_frac, tardy_frac)
        if s > 0:
            scores["reservation_tardy"] = s * (1.0 if any_miss
                                               else 0.6)
            evidence.append(
                f"{tardy_ops}/{max(resv_ops, 1)} constraint serves "
                f"landed past their reservation deadline; floor "
                f"deficit {resv_deficit:.2f}/s of {resv:.1f}/s"
                + (" (judged resv_miss)" if any_miss else ""))
    if entitled > 0 and share_err < -0.05 and \
            scores["limit_capped"] < 0.5:
        scores["out_competed"] = min(-share_err, 1.0) * \
            (1.0 if backlog > 0 else 0.4)
        evidence.append(
            f"delivered cost share ran {-100 * share_err:.0f}% below "
            f"the weight entitlement ({entitled:.3f}) with "
            + ("backlog queued" if backlog > 0 else "no backlog"))
        if flight and 0 < flight["client_margin_mean_ns"] \
                < flight["margin_mean_ns"]:
            evidence.append(
                "flight ring corroborates: the client's own wins "
                f"were tight (mean margin "
                f"{flight['client_margin_mean_ns']:.0f} ns vs "
                f"{flight['margin_mean_ns']:.0f} ns overall) -- a "
                "contested proportional race")
    if trace and trace["rows"]:
        resv_pct = 100 * trace["client_resv_frac"]
        evidence.append(
            f"trace: {trace['client_rows']}/{trace['rows']} decisions"
            f" were this client's ({resv_pct:.0f}% constraint-phase)")

    order = {c: i for i, c in enumerate(CAUSES)}
    ranked = sorted(scores, key=lambda c: (-scores[c], order[c]))
    # an honest null: when no cause scores, the windows are conforming
    # (delivered ~ entitled, floor met, limit respected) -- reporting
    # a tie-broken cause here would invent a violation
    cause = ranked[0] if scores[ranked[0]] > 0 else "conforming"
    if cause == "conforming" and not evidence:
        evidence.append("no cause scored: delivered tracked the "
                        "contract in every window examined")
    return {"scores": {c: round(scores[c], 4) for c in CAUSES},
            "ranked": ranked, "cause": cause,
            "windows": len(wins), "evidence": evidence}


def explain(slo_path: str, client: int, *,
            window: Optional[int] = None,
            flight_path: Optional[str] = None,
            trace_path: Optional[str] = None) -> Optional[dict]:
    """The full join for one run; None when the client has no
    windows in the log."""
    wins = client_windows(load_jsonl(slo_path), client, window)
    if not wins:
        return None
    fl = flight_evidence(load_jsonl(flight_path), client) \
        if flight_path else None
    tr = None
    if trace_path:
        from dmclock_tpu_torch.obs.trace import load_trace
        tr = trace_evidence(load_trace(trace_path), client)
    out = attribute(wins, fl, tr)
    out["client"] = client
    out["window"] = window
    if fl:
        out["flight"] = fl
    if tr:
        out["trace"] = tr
    return out


def _fmt(res: dict) -> str:
    lines = [f"client {res['client']}"
             + (f" window {res['window']}" if res["window"] is not None
                else f" ({res['windows']} windows)")
             + f": {res['cause']}"]
    for c in res["ranked"]:
        bar = "#" * int(20 * res["scores"][c])
        lines.append(f"  {c:<18} {res['scores'][c]:6.3f} {bar}")
    lines.append("evidence:")
    for e in res["evidence"]:
        lines.append(f"  - {e}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="explain", description=__doc__.splitlines()[0])
    ap.add_argument("--slo", required=True, metavar="JSONL",
                    help="judged closed-window log "
                    "(SloPlane.export_jsonl / supervisor slo_log)")
    ap.add_argument("--client", required=True, type=int)
    ap.add_argument("--window", type=int, default=None, metavar="SEQ",
                    help="restrict to one roll seq (default: "
                    "aggregate every window of the client)")
    ap.add_argument("--flight", metavar="JSONL", default=None,
                    help="flight ring dump (obs.flight.flight_dump)")
    ap.add_argument("--trace", metavar="JSONL", default=None,
                    help="decision trace (obs.trace, v1 or v2)")
    ap.add_argument("--diff", metavar="BASELINE_SLO", default=None,
                    help="baseline run's window log: print score "
                    "deltas vs it")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    res = explain(args.slo, args.client, window=args.window,
                  flight_path=args.flight, trace_path=args.trace)
    if res is None:
        print(f"torch_explain: client {args.client} has no windows in "
              f"{args.slo}", file=sys.stderr)
        return 2
    if args.diff:
        base = explain(args.diff, args.client, window=args.window)
        res["diff"] = None
        if base is not None:
            res["diff"] = {
                "baseline_cause": base["cause"],
                "deltas": {c: round(res["scores"][c]
                                    - base["scores"][c], 4)
                           for c in CAUSES}}
    if args.json:
        print(json.dumps(res, indent=1))
        return 0
    print(_fmt(res))
    if args.diff:
        if res.get("diff") is None:
            print(f"diff vs baseline: client {args.client} absent "
                  "from the baseline log")
        else:
            d = res["diff"]
            print(f"diff vs baseline (was: {d['baseline_cause']}):")
            for c in CAUSES:
                delta = d["deltas"][c]
                if delta:
                    print(f"  {c:<18} {delta:+.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
