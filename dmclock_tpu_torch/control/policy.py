"""The deterministic guarded-transition table (docs/CONTROLLER.md; the
port's copy of ``dmclock_tpu/control/policy.py``, reading the port's own
``robust.guarded.LADDER_RUNGS``, which lists the JAX package's rungs in
the same order).

The policy is a PURE function of ``(pstate, knobs, signals, spec)``:
no clocks, no randomness, no hidden state -- the same triple always
yields the same decisions, which is what lets a resumed run REPLAY its
journal instead of re-deciding (control/journal.py).

Knob vector (``int64[NUM_KNOBS]``, rides the rotation checkpoints as
the ``ctl_knobs`` leaf):

- ``counter_sync_every`` -- the mesh staleness knob; read live
  at each chunk launch.
- ``ladder_level`` -- how many :data:`robust.guarded.LADDER_RUNGS`
  the controller has conceded, applied through :func:`overlay` as an
  exact-twin config substitution (the SAME safety order the
  DegradationLadder uses, so every actuation is digest-explainable).
- ``clamp_pct`` -- admission clamp percentage (100 = off).  Applied
  host-side to already-drawn arrival counts, so RNG consumption is
  IDENTICAL with the controller on or off.
- ``compact_trigger`` -- monotone count of compaction/migration-
  eligible triggers fired (the actuation itself is the digest-neutral
  ``LifecyclePlane.force_compact``; on the mesh it marks
  migration-eligible without moving state).
- ``migrate_trigger`` -- monotone count of AUTHORIZED migration slots
  (bumped by ``migrate_max`` each time the ``migrate`` rule fires on
  per-shard pressure skew; the actuation is the supervisor's
  ``_mesh_migrate`` executing digest-neutral EVICT/REGISTER handoffs
  through :mod:`~dmclock_tpu.lifecycle.placement`).

Per-rule hysteresis and cooldown: protective moves (``*_down``) fire
on the FIRST triggering boundary; relaxing moves (``*_up``) and
``compact`` need ``spec["hysteresis"]`` consecutive triggering
boundaries.  Every applied decision starts a per-rule cooldown of
``spec["cooldown"]`` boundaries during which the rule is inert --
that, plus the clean-streak requirement on the ``*_up`` twin of every
``*_down`` rule, is what keeps the loop from flapping.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

RULES = ("staleness_down", "staleness_up", "ladder_down", "ladder_up",
         "clamp_down", "clamp_up", "compact", "migrate")
NUM_RULES = len(RULES)

# fast-first rules: one triggering boundary is enough
_IMMEDIATE = frozenset(("staleness_down", "ladder_down", "clamp_down"))

KNOB_SYNC, KNOB_LADDER, KNOB_CLAMP, KNOB_COMPACT, KNOB_MIGRATE = \
    0, 1, 2, 3, 4
KNOB_NAMES = ("counter_sync_every", "ladder_level", "clamp_pct",
              "compact_trigger", "migrate_trigger")
NUM_KNOBS = 5

# ``0`` means auto: backlog_hi <- n * ring * 3 // 4, occ_floor <- the
# job's initial slot capacity, ladder_max <- len(LADDER_RUNGS);
# migrate_skew_hi == 0 keeps the migrate rule OFF (its trigger is a
# per-shard skew ratio, meaningless off the mesh -- migrate_shards is
# filled in by the Controller ctor from the job's n_shards).
DEFAULT_SPEC = dict(enabled=True, hysteresis=2, cooldown=2,
                    sync_min=1, sync_max=8,
                    clamp_min=25, clamp_step=25,
                    backlog_hi=0, occ_lo=0.5, occ_floor=0,
                    ladder_max=0,
                    migrate_skew_hi=0.0, migrate_max=4,
                    migrate_pick="hot", migrate_shards=1)


def ladder_max_default() -> int:
    from ..robust.guarded import LADDER_RUNGS
    return len(LADDER_RUNGS)


def _hysteresis(rule: str, spec: dict) -> int:
    return 1 if rule in _IMMEDIATE else max(int(spec["hysteresis"]), 1)


def _propose(rule: str, knobs: List[int], sig,
             spec: dict) -> Optional[List[int]]:
    """Proposed knob vector when ``rule`` triggers on ``sig``, else
    None.  Evaluated against the CURRENT (possibly just-updated this
    boundary) knobs, in fixed RULES order."""
    sync, level, clamp, compact, migr = knobs
    burn = sig.resv_miss_d + sig.limit_break_d + sig.share_skew_d
    trips = sig.guard_trips_d
    clean = burn == 0 and trips == 0
    backlog_hi = int(spec["backlog_hi"])
    if rule == "staleness_down":
        # resv-miss burn: counters are too stale to honor reservations
        if sig.resv_miss_d > 0 and sync > spec["sync_min"]:
            return [int(spec["sync_min"]), level, clamp, compact, migr]
    elif rule == "staleness_up":
        # clean streak: widen the sync grid, buy back collective share
        if clean and sync < spec["sync_max"]:
            return [min(sync * 2, int(spec["sync_max"])), level, clamp,
                    compact, migr]
    elif rule == "ladder_down":
        if trips > 0 and level < int(spec["ladder_max"]):
            return [sync, level + 1, clamp, compact, migr]
    elif rule == "ladder_up":
        if clean and level > 0:
            return [sync, level - 1, clamp, compact, migr]
    elif rule == "clamp_down":
        pressured = sig.limit_break_d > 0 or \
            (backlog_hi > 0 and sig.backlog > backlog_hi)
        if pressured and clamp > spec["clamp_min"]:
            return [sync, level,
                    max(clamp - int(spec["clamp_step"]),
                        int(spec["clamp_min"])), compact, migr]
    elif rule == "clamp_up":
        drained = backlog_hi <= 0 or sig.backlog <= backlog_hi // 2
        if clean and drained and clamp < 100:
            return [sync, level,
                    min(clamp + int(spec["clamp_step"]), 100), compact,
                    migr]
    elif rule == "compact":
        # low occupancy after growth: slots fragmented / shard shrunk
        sparse = sig.capacity > int(spec["occ_floor"]) and \
            sig.live > 0 and sig.live < spec["occ_lo"] * sig.capacity
        if sparse:
            return [sync, level, clamp, compact + 1, migr]
    elif rule == "migrate":
        # per-shard pressure skew: the hottest shard's backlog exceeds
        # migrate_skew_hi times the all-shard mean (press_backlog * S
        # > hi * backlog avoids the division).  Two interchangeable
        # reads of the same ratio: the boundary-time depth read
        # (press_backlog / backlog) and the mid-epoch pressure-peak
        # read (press_peak / backlog_peak) -- the peaks are what arms
        # the rule on calendar engines, whose deadline commits drain
        # state.depth within the epoch so the boundary read is
        # structurally zero there.  Hysteresis applies (migrate is NOT
        # in _IMMEDIATE): moving clients is never an emergency action,
        # and cooldown spaces the handoffs out so a move's effect
        # lands before the next decision.
        hi = float(spec.get("migrate_skew_hi", 0.0))
        shards = int(spec.get("migrate_shards", 1))
        if hi > 0 and shards > 1:
            depth_skew = sig.backlog > 0 and \
                sig.press_backlog * shards > hi * sig.backlog
            peak_skew = sig.backlog_peak > 0 and \
                sig.press_peak * shards > hi * sig.backlog_peak
            if depth_skew or peak_skew:
                return [sync, level, clamp, compact,
                        migr + int(spec.get("migrate_max", 4))]
    else:
        raise ValueError(f"unknown controller rule {rule!r}")
    return None


def step(pstate, knobs, sig, spec) -> Tuple[np.ndarray, list]:
    """Evaluate one boundary.  ``pstate`` is ``int64[2*NUM_RULES]``
    ([streak, cooldown] per rule, the ``ctl_policy`` checkpoint leaf);
    returns ``(new_pstate, decisions)`` with ``decisions`` a list of
    ``(rule, new_knob_vector)`` in firing order.  Later rules see
    earlier rules' knob updates (fixed order keeps this
    deterministic)."""
    ps = np.asarray(pstate, dtype=np.int64).reshape(NUM_RULES, 2).copy()
    knobs = [int(k) for k in knobs]
    decisions: list = []
    for ri, rule in enumerate(RULES):
        streak, cool = int(ps[ri, 0]), int(ps[ri, 1])
        if cool > 0:
            ps[ri] = (0, cool - 1)      # cooling: inert, streak resets
            continue
        new = _propose(rule, knobs, sig, spec)
        if new is None:
            ps[ri] = (0, 0)
            continue
        streak += 1
        if streak >= _hysteresis(rule, spec):
            decisions.append((rule, list(new)))
            knobs = list(new)
            ps[ri] = (0, max(int(spec["cooldown"]), 0))
        else:
            ps[ri] = (streak, 0)
    return ps.reshape(-1), decisions


def overlay(cfg: dict, level: int) -> dict:
    """Map an engine config through the first ``level`` engageable
    :data:`robust.guarded.LADDER_RUNGS` -- the controller's ladder
    actuation, and the reason every step is digest-explainable: each
    rung swaps a fast path for its pinned always-exact twin.  Chains
    the shared-knob calendar rungs exactly like
    ``DegradationLadder.apply`` (wheel->bucketed rewrites the value
    bucketed->minstop then reads)."""
    from ..robust.guarded import LADDER_RUNGS
    out = dict(cfg)
    engaged = 0
    for knob, fast, safe in LADDER_RUNGS:
        if engaged >= level:
            break
        if out.get(knob) == fast:
            out[knob] = safe
            engaged += 1
    return out
