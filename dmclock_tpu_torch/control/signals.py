"""ControlSignals: one typed snapshot per checkpoint boundary (the port's
copy of ``dmclock_tpu/control/signals.py``; the journal stores the digest,
so the fields, their order and the hash are the JAX package's).

The controller (docs/CONTROLLER.md) decides from ONE immutable
snapshot assembled at each checkpoint boundary.  Fields split into two
tiers, and the split is the whole determinism story:

- **Deterministic fields** (:data:`DETERMINISTIC_FIELDS`) are derived
  exclusively from state that rides the rotation checkpoints or is
  replay-deterministic from it: SLO episode-count deltas
  (``obs.alerts.SloEvaluator`` fired counts restore from the
  ``slo_alert_*`` leaves), device metric-row deltas (``met`` vector,
  RESUME_ROWS excluded), engine backlog (``state.depth``), lifecycle
  slot occupancy, and the provenance starvation watermark.  Rules read
  ONLY these, and the journal's ``digest`` hashes ONLY these -- so a
  resumed incarnation re-deciding a boundary reproduces the
  uninterrupted run's decisions bit-for-bit.
- **Advisory fields** are best-effort host telemetry (capacity-plane
  retraces/compile wall, projected HBM, bound_class, the span
  watchdog's dispatch share, launch/stream fallback counts).  They are
  carried for observability but are EXCLUDED from both the rule table
  and the digest: retrace counts and wall-clock shares restart at zero
  in a resumed process, and a signal that differs across a resume
  would break crash equivalence.  The port compiles nothing per shape,
  so its ``retraces`` and ``compile_ms`` stay 0.
"""

from __future__ import annotations

import hashlib
import json
from typing import NamedTuple


class ControlSignals(NamedTuple):
    """One boundary's snapshot.  Deltas (``*_d``) are since the
    previous boundary of the same run (a resumed incarnation's
    baseline is the restored checkpoint state, which IS the previous
    boundary)."""

    epoch: int                # the boundary epoch this snapshot is for
    # -- deterministic tier (rules + digest) ---------------------------
    backlog: int              # sum of per-slot queue depths
    live: int                 # lifecycle live slots (0: no plane)
    capacity: int             # lifecycle slot capacity (0: no plane)
    resv_miss_d: int          # SLO episodes fired since last boundary
    limit_break_d: int
    share_skew_d: int
    violations_d: int
    guard_trips_d: int        # device metric-row deltas
    ingest_drops_d: int
    ladder_steps_d: int
    starvation_ns: int        # provenance PS_STARVE_MAX watermark
    press_backlog: int        # hottest shard's backlog (== backlog, S=1)
    # mid-epoch pressure PEAKS (deterministic: the chunk's per-shard
    # post-ingest pre-serve probe maxima, replay-exact from the
    # checkpointed RNG + state -- obs.provenance.pressure_vec through
    # engine.stream.make_epoch_step).  The boundary-time depth reads
    # above are structurally zero on calendar engines (deadline
    # commits drain depth within the epoch); these peaks are the
    # migrate rule's calendar-capable twin.  Default 0 = no probe
    # (round/stream loops, controller off), which keeps the peak
    # branch of the migrate rule inert there.
    press_peak: int = 0       # hottest shard's mid-epoch backlog peak
    backlog_peak: int = 0     # sum of per-shard mid-epoch peaks
    # -- advisory tier (observability only; NOT rules, NOT digest) -----
    retraces: int = 0         # capacity plane, this process only
    compile_ms: float = 0.0
    projected_hbm: int = 0
    bound_class: str = ""
    dispatch_share: float = 0.0   # span watchdog, this process only
    fallbacks: int = 0        # stream/mesh launch fallbacks, process


DETERMINISTIC_FIELDS = (
    "epoch", "backlog", "live", "capacity",
    "resv_miss_d", "limit_break_d", "share_skew_d", "violations_d",
    "guard_trips_d", "ingest_drops_d", "ladder_steps_d",
    "starvation_ns", "press_backlog", "press_peak", "backlog_peak",
)


def digest(sig: ControlSignals) -> str:
    """Short stable hash of the deterministic tier -- journaled with
    every decision so a replayed boundary can be audited against the
    signals it originally decided from."""
    blob = json.dumps({k: int(getattr(sig, k))
                       for k in DETERMINISTIC_FIELDS},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
