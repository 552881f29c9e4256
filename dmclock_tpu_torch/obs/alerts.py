"""Burn-rate SLO alerting over the windowed conformance plane.

Counterpart of ``dmclock_tpu/obs/alerts.py``, over the port's
``obs.slo.SloPlane`` and ``ClosedWindow``.  Multiwindow burn-rate rules
(a fast window to catch the burn, a slow window to suppress blips)
evaluated at every window roll:

- ``resv_miss``: a client with a reservation floor is backlogged (or
  served late) and delivered below its floor;
- ``limit_break``: the AtLimit::Allow break rate exceeds its budget (or
  delivered rate exceeds a configured limit);
- ``share_skew``: the delivered cost share deviates from the weight
  entitlement (among clients with demand) past tolerance.

A rule fires once per episode per ``(client, contract_epoch, rule)``:
on the rising edge (fast and slow windows in violation), re-armed by a
clean fast window.  A re-registered client or a live QoS update opens a
new contract epoch, whose burn is a new episode.  Warnings are one JSON
line each (prefix ``# slo:``), a ``dmclock_slo_*`` registry bump, and a
row of :attr:`SloEvaluator.fired`; the evaluator's state encodes into
flat ``slo_alert_*`` leaves and loads back.  The JAX package's watchdog
routing has no counterpart yet (``obs/watchdog.py`` is not ported).
"""

from __future__ import annotations

import json
import sys
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .slo import ClosedWindow, SloPlane

RULES = ("resv_miss", "limit_break", "share_skew")

# most-recent per-window tardiness observations kept for the p99
# scalar (bounds host memory AND the slo_alert_tard checkpoint leaf)
TARD_P99_WINDOW = 4096


def _stderr_log(line: str) -> None:
    print(line, file=sys.stderr)


class SloEvaluator:
    """Evaluate burn-rate rules at every roll.

    The FAST horizon is the just-closed roll; the SLOW horizon is the
    last ``slow_windows`` judged rolls (clamped to the plane's ring
    depth: the slow horizon must be reconstructible from the ring on
    a checkpoint resume, or a resumed run could fire episodes the
    uninterrupted run suppresses).  ``slow_frac`` is the fraction of
    slow-horizon windows that must be in violation for the slow
    condition to hold.  Thresholds: ``limit_break_budget`` (allowed
    limit-break fraction of delivered ops), ``share_tol`` (relative
    share error).  The reservation rule's per-window predicate is the
    plane's ``resv_miss`` judgment (floor deficit + backlog)."""

    def __init__(self, plane: SloPlane, *,
                 slow_windows: int = 4,
                 slow_frac: float = 0.5,
                 limit_break_budget: float = 0.05,
                 share_tol: float = 0.5,
                 registry=None, watchdog=None,
                 log: Callable[[str], None] = _stderr_log):
        self.plane = plane
        self.slow_windows = min(max(int(slow_windows), 1),
                                plane.ring_depth)
        self.slow_frac = float(slow_frac)
        self.limit_break_budget = float(limit_break_budget)
        self.share_tol = float(share_tol)
        self._log = log
        self._watchdog = watchdog
        self.fired: List[dict] = []
        self.fired_counts: Dict[str, int] = {r: 0 for r in RULES}
        self.violations_total = 0
        # burn-episode duration accounting: a roll with >=1 rising
        # edge is one BURNING window, and its epoch span adds to the
        # total burn duration ("how long did the run spend
        # burning").  Rides the encoded scalars.
        self.burn_windows = 0
        self.burn_epochs = 0
        self.worst_share_err = 0.0
        # per-window mean reservation tardiness, for the p99 of the
        # summary.  Bounded: a long run accumulates one entry per
        # client-window with reservation activity, so keep the most
        # recent TARD_P99_WINDOW (a recent-tail verdict)
        self._tard_means: deque = deque(maxlen=TARD_P99_WINDOW)
        # active episodes keyed by (cid, contract_epoch, rule): the
        # once-per-episode damping is per TENANCY/VERSION -- an
        # evicted-and-re-registered client (or a live QoS update)
        # opens a new contract epoch, whose burn is a new episode
        self.active: Set[Tuple[int, int, str]] = set()
        # bounded judged-roll history for the slow horizon: (seq,
        # {cid: judged row}) for the last slow_windows rolls.  Derived
        # state -- rebuilt from the plane's ring on a checkpoint
        # resume (deterministic, so episode firing replays
        # identically).
        self._judged: deque = deque(maxlen=self.slow_windows)
        self._counter = None
        self._worst_gauge = None
        self._registry = None
        if registry is not None:
            self.attach_registry(registry)

    # -- registry families ---------------------------------------------
    def attach_registry(self, registry) -> None:
        self._counter = registry.counter(
            "dmclock_slo_violations_total",
            "burn-rate SLO episodes fired (resv_miss / limit_break / "
            "share_skew; once per episode -- docs/OBSERVABILITY.md "
            "SLO plane)")
        for rule in RULES:
            registry.counter(
                f"dmclock_slo_{rule}_total",
                f"{rule} burn-rate episodes fired")
        registry.gauge(
            "dmclock_slo_windows_closed_total",
            "closed conformance windows across the run") \
            .set_function(lambda: float(self.plane.windows_closed))
        self._worst_gauge = registry.gauge(
            "dmclock_slo_worst_window_share_err",
            "worst per-window relative share error observed "
            "(delivered cost share vs weight entitlement)")
        self._registry = registry

    # -- per-window predicates -----------------------------------------
    def _violates(self, rule: str, row: dict) -> bool:
        if rule == "resv_miss":
            return bool(row["resv_miss"])
        if rule == "limit_break":
            if row["limit_excess"] > 0:
                return True
            return row["ops"] > 0 and \
                row["lb_ops"] / row["ops"] > self.limit_break_budget
        if rule == "share_skew":
            return row["entitled_share"] > 0 and \
                abs(row["share_err"]) > self.share_tol
        raise ValueError(f"unknown SLO rule {rule!r}")

    def _slow_ok(self, rule: str, cid: int) -> bool:
        """Slow-horizon condition: over the client's windows in the
        last ``slow_windows`` judged rolls, at least ``slow_frac`` are
        in violation.  Each roll was judged against its own contract
        versions, so a mid-run update never smears into the slow
        horizon."""
        mine = [by_cid[cid] for _seq, by_cid in self._judged
                if cid in by_cid]
        if len(mine) < self.slow_windows:
            # ramp-up suppression: with fewer judged windows than the
            # slow horizon, the gate would degenerate to the fast
            # window and a single first-window blip would fire -- the
            # exact flap the two-horizon design exists to prevent
            return False
        bad = sum(1 for r in mine if self._violates(rule, r))
        return bad >= max(1, int(np.ceil(self.slow_frac * len(mine))))

    def _rebuild_judged(self) -> None:
        """Re-derive the judged-roll cache from the plane's ring (the
        checkpoint-resume path): group ring windows by roll seq, keep
        the newest ``slow_windows`` rolls, judge each once."""
        grouped: Dict[int, List[ClosedWindow]] = {}
        for w in self.plane.ring_rows():
            grouped.setdefault(w.seq, []).append(w)
        self._judged.clear()
        for seq in sorted(grouped)[-self.slow_windows:]:
            rows = self.plane.conformance_rows(grouped[seq])
            self._judged.append((seq, {r["client"]: r for r in rows}))

    # -- the roll hook -------------------------------------------------
    def observe_roll(self, closed: List[ClosedWindow]) -> List[dict]:
        """Judge one roll's closed windows; returns the warnings fired
        (rising edges only).  Deterministic: the same window stream
        fires the same episodes, so the counts survive the
        crash-equivalence gate."""
        # drop episodes of DEAD contract versions (evicted tenancies,
        # superseded QoS updates): their keys can never match again
        # and would otherwise accumulate for the run's lifetime
        self.active = {k for k in self.active
                       if self.plane.cepoch.get(k[0]) == k[1]}
        rows = self.plane.conformance_rows(closed)
        if closed:
            # the newest roll joins the slow horizon before judgment:
            # the fast window is this roll, the slow condition reads
            # the last slow_windows rolls INCLUDING it
            self._judged.append(
                (closed[0].seq, {r["client"]: r for r in rows}))
        out: List[dict] = []
        for row in rows:
            cid = row["client"]
            err = abs(row["share_err"]) if row["entitled_share"] > 0 \
                else 0.0
            if err > self.worst_share_err:
                self.worst_share_err = err
            if row["resv_ops"] > 0:
                self._tard_means.append(row["tardiness_mean_ns"])
            for rule in RULES:
                key = (cid, row["contract_epoch"], rule)
                fast_bad = self._violates(rule, row)
                if not fast_bad:
                    self.active.discard(key)   # clean fast window
                    continue                    # re-arms the episode
                if key in self.active:
                    continue                    # once per episode
                if not self._slow_ok(rule, cid):
                    continue                    # blip, not a burn
                self.active.add(key)
                w = {"kind": "slo_" + rule, "client": cid,
                     "contract_epoch": row["contract_epoch"],
                     "window": [row["e0"], row["e1"]],
                     "rate": round(row["rate"], 3),
                     "reservation": row["reservation"],
                     "share": round(row["share"], 4),
                     "entitled_share": round(row["entitled_share"], 4),
                     "share_err": round(row["share_err"], 4),
                     "limit_excess": round(row["limit_excess"], 3)}
                out.append(w)
                self.fired.append(w)
                self.fired_counts[rule] += 1
                self.violations_total += 1
        if out:
            # every row of one roll closes the same [e0, e1) span
            # (windows roll on the checkpoint grid), so the roll
            # contributes its span once no matter how many clients
            # or rules fired inside it
            self.burn_windows += 1
            self.burn_epochs += int(out[0]["window"][1]
                                    - out[0]["window"][0])
        for w in out:
            if self._watchdog is not None:
                # one structured warning stream for the whole run
                # (anything with ``external_warning(w)``)
                self._watchdog.external_warning(w)
            else:
                self._log("# slo: " +
                          json.dumps(w, separators=(",", ":")))
            if self._counter is not None:
                self._counter.inc()
                self._registry.counter(
                    "dmclock_slo_" + w["kind"][4:] + "_total").inc()
        if self._worst_gauge is not None:
            self._worst_gauge.set(float(self.worst_share_err))
        return out

    # -- reports -------------------------------------------------------
    def window_tardiness_p99_ns(self) -> float:
        """p99 over closed windows of the per-window mean reservation
        tardiness -- the slo block's tail-QoS scalar (0.0 with no
        reservation activity)."""
        if not self._tard_means:
            return 0.0
        return float(np.percentile(np.asarray(self._tard_means), 99))

    def summary(self) -> dict:
        return {"violations_total": int(self.violations_total),
                **{f"{r}_episodes": int(self.fired_counts[r])
                   for r in RULES},
                "burn_windows": int(self.burn_windows),
                "burn_epochs": int(self.burn_epochs),
                "worst_window_share_err":
                    round(float(self.worst_share_err), 6),
                "window_tardiness_p99_ns":
                    round(self.window_tardiness_p99_ns(), 1),
                "active_episodes": len(self.active),
                **self.plane.summary()}

    # -- checkpoint round-trip (rides the slo_* leaves) ----------------
    def encode(self) -> dict:
        act = np.asarray(
            sorted((cid, ce, RULES.index(rule))
                   for cid, ce, rule in self.active),
            dtype=np.int64).reshape(len(self.active), 3)
        return {"slo_alert_scalars": np.asarray(
                    [self.violations_total]
                    + [self.fired_counts[r] for r in RULES]
                    + [self.burn_windows, self.burn_epochs],
                    dtype=np.int64),
                "slo_alert_active": act,
                "slo_alert_worst": np.float64(self.worst_share_err),
                "slo_alert_tard": np.asarray(self._tard_means,
                                             dtype=np.float64)}

    def load(self, payload: dict) -> None:
        sc = np.asarray(payload["slo_alert_scalars"], dtype=np.int64)
        self.violations_total = int(sc[0])
        for i, r in enumerate(RULES):
            self.fired_counts[r] = int(sc[1 + i])
        if len(sc) > 1 + len(RULES):   # pre-burn-scalar checkpoints
            self.burn_windows = int(sc[1 + len(RULES)])
            self.burn_epochs = int(sc[2 + len(RULES)])
        self.active = {
            (int(c), int(ce), RULES[int(i)])
            for c, ce, i in np.asarray(payload["slo_alert_active"],
                                       dtype=np.int64).reshape(-1, 3)}
        self.worst_share_err = float(payload["slo_alert_worst"])
        self._tard_means = deque(
            np.asarray(payload["slo_alert_tard"], dtype=np.float64),
            maxlen=TARD_P99_WINDOW)
        self._rebuild_judged()

    @staticmethod
    def empty_leaves() -> dict:
        return {"slo_alert_scalars": np.zeros(3 + len(RULES),
                                              dtype=np.int64),
                "slo_alert_active": np.zeros((0, 3), dtype=np.int64),
                "slo_alert_worst": np.float64(0.0),
                "slo_alert_tard": np.zeros((0,), dtype=np.float64)}


# ----------------------------------------------------------------------
# HTTP surface: GET /slo on the scrape/admin endpoint
# ----------------------------------------------------------------------

class SloAPI:
    """``handler(method, path, body)`` for
    ``MetricsHTTPServer.mount("/slo", ...)``: the live SLO summary +
    recent warnings, next to the Prometheus families."""

    def __init__(self, evaluator: SloEvaluator):
        self.evaluator = evaluator

    def handler(self, method: str, path: str, body: bytes):
        if method != "GET":
            return (405, "application/json",
                    json.dumps({"error": f"{method} not allowed"})
                    .encode())
        out = dict(self.evaluator.summary())
        out["recent_warnings"] = self.evaluator.fired[-16:]
        return (200, "application/json", json.dumps(out).encode())


def mount_slo_api(server, evaluator: SloEvaluator
                  ) -> Optional[SloAPI]:
    """Mount ``GET /slo`` on a (possibly None, fail-soft) scrape
    endpoint and register the ``dmclock_slo_*`` families into its
    registry."""
    if server is None:
        return None
    api = SloAPI(evaluator)
    server.mount("/slo", api.handler)
    evaluator.attach_registry(server.registry)
    return api
