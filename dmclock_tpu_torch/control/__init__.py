"""The closed-loop serving controller (counterpart of
``dmclock_tpu/control/``; host code, so the port keeps its own copy).

A thin host control plane at checkpoint-boundary cadence (the
RackSched two-level shape: a reactive policy layer steering otherwise
unmodified per-server engines).  Per boundary it assembles one
:class:`~.signals.ControlSignals` snapshot from the
existing observability planes, runs the pure guarded-transition table
(:mod:`~.policy`), write-ahead-journals every
decision (:mod:`~.journal`), and only then moves
the knob vector.  Every actuation goes through an existing
exact-twin/digest-neutral mechanism, so ``controller=off`` is
bit-identical to the bare runner and every individual actuation is
digest-explainable.  docs/CONTROLLER.md is the full contract.

On the card the signals come from one boundary read: ``state.depth``
and, with provenance, the starvation watermark of ``prov.scal`` cross to
the host in one ``.cpu()`` of a packed tensor, after the drain has
already waited for the device.  The advisory tier has no source in the
port (nothing compiles per shape), so ``retraces`` and ``compile_ms``
stay 0; the digest reads only the deterministic tier, so trajectories
equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import journal as journal_mod
from . import policy as policy_mod
from . import signals as signals_mod
from .policy import (KNOB_CLAMP, KNOB_COMPACT, KNOB_LADDER,  # noqa: F401
                     KNOB_MIGRATE, KNOB_NAMES, KNOB_SYNC, NUM_KNOBS,
                     NUM_RULES, RULES)
from .signals import ControlSignals  # noqa: F401

__all__ = ["Controller", "ControllerConfig", "ControlSignals",
           "as_spec", "publish_controller", "RULES", "KNOB_NAMES"]


def _boundary_read(state, prov):
    """The boundary's device reads in one copy to the host: the engine's
    ``depth`` (``[N]`` or stacked ``[S, N]``) and, with provenance, the
    ``PS_STARVE_MAX`` column of ``prov.scal``.  Returns ``(depth,
    starve)`` as int64 arrays (None where absent).  A mesh laid out over
    device groups reads one copy a group, joined in shard order: the
    same ``[S, N]`` host array as the one stack gives."""
    from ..obs import provenance as obs_prov
    from ..parallel import groups

    node = state if state is not None else prov
    if groups.is_grouped(node):
        reads = [_boundary_read(None if state is None else state.parts[g],
                                None if prov is None else prov.parts[g])
                 for g in range(node.n_groups)]
        return tuple(None if reads[0][j] is None
                     else np.concatenate([r[j] for r in reads])
                     for j in range(2))
    parts = []
    if state is not None:
        parts.append(state.depth.reshape(-1).to(torch.int64))
    if prov is not None:
        parts.append(prov.scal[..., obs_prov.PS_STARVE_MAX]
                     .reshape(-1).to(torch.int64))
    if not parts:
        return None, None
    flat = torch.cat(parts).cpu().numpy() if len(parts) > 1 \
        else parts[0].cpu().numpy()
    depth = starve = None
    at = 0
    if state is not None:
        size = int(state.depth.numel())
        depth = flat[:size].reshape(tuple(state.depth.shape))
        at = size
    if prov is not None:
        starve = flat[at:]
    return depth, starve


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Typed spell of the policy spec (``EpochJob(controller=...)``
    accepts this, a plain dict with the same keys, or None).  ``0``
    fields mean auto -- see :data:`policy.DEFAULT_SPEC`."""

    enabled: bool = True
    hysteresis: int = 2
    cooldown: int = 2
    sync_min: int = 1
    sync_max: int = 8
    clamp_min: int = 25
    clamp_step: int = 25
    backlog_hi: int = 0
    occ_lo: float = 0.5
    occ_floor: int = 0
    ladder_max: int = 0
    migrate_skew_hi: float = 0.0
    migrate_max: int = 4
    migrate_pick: str = "hot"


def as_spec(obj) -> Optional[dict]:
    """Normalize ``EpochJob.controller`` (None/False, spec dict, or
    :class:`ControllerConfig`) to a complete spec dict -- or None when
    the controller is off, which the supervisor treats as
    zero-plumbing (the ``controller=off`` == bare-runner gate)."""
    if obj is None or obj is False:
        return None
    if obj is True:
        obj = {}
    if isinstance(obj, ControllerConfig):
        obj = dataclasses.asdict(obj)
    obj = dict(obj)
    unknown = set(obj) - set(policy_mod.DEFAULT_SPEC)
    assert not unknown, f"unknown controller spec keys {sorted(unknown)}"
    spec = dict(policy_mod.DEFAULT_SPEC)
    spec.update(obj)
    if not spec.get("enabled", True):
        return None
    if int(spec["ladder_max"]) <= 0:
        spec["ladder_max"] = policy_mod.ladder_max_default()
    return spec


class Controller:
    """One job loop's controller instance.

    Host state is three checkpoint leaves (``ctl_cursor`` applied-
    decision count, ``ctl_knobs`` knob vector, ``ctl_policy``
    per-rule streak/cooldown) plus the on-disk journal; everything
    else re-derives.  Delta baselines (:meth:`observe_baseline`) pin
    to the restored state at incarnation start, which IS the previous
    boundary's snapshot -- deltas replay identically across a resume.
    """

    def __init__(self, spec: dict, *, n: int, ring: int,
                 counter_sync_every: int = 1, capacity0: int = 0,
                 n_shards: int = 1,
                 workdir: Optional[str] = None, registry=None):
        self.spec = dict(spec)
        if int(self.spec.get("backlog_hi", 0)) <= 0:
            self.spec["backlog_hi"] = max(int(n) * int(ring) * 3 // 4, 1)
        if int(self.spec.get("occ_floor", 0)) <= 0:
            self.spec["occ_floor"] = max(int(capacity0), 0)
        # the migrate rule needs the shard count for its skew ratio
        # (pure policy sees only the spec, so the ctor pins it there)
        self.spec["migrate_shards"] = max(int(n_shards), 1)
        self.knobs = [max(int(counter_sync_every), 1), 0, 100, 0, 0]
        self.pstate = np.zeros(2 * NUM_RULES, dtype=np.int64)
        self.applied = 0            # the ctl_cursor leaf
        self.replays = 0            # journaled decisions replayed
        self.journal = journal_mod.DecisionJournal(workdir)
        self.decisions_by_rule = {r: 0 for r in RULES}
        self._prev = self._zero_snap()
        # (epoch, depth): the host copy of the depth the last ``collect``
        # read, which the mesh's migrate actuation reuses
        self.boundary_depth = (None, None)
        if registry is not None:
            publish_controller(registry, self)

    # -- checkpoint leaves ---------------------------------------------
    def encode(self) -> dict:
        return {"ctl_cursor": np.asarray(self.applied, dtype=np.int64),
                "ctl_knobs": np.asarray(self.knobs, dtype=np.int64),
                "ctl_policy": np.asarray(self.pstate, dtype=np.int64)}

    @staticmethod
    def empty_leaves() -> dict:
        """Always-present payload leaves for controller-off jobs (the
        every-leaf-always-present checkpoint convention)."""
        return {"ctl_cursor": np.zeros((), dtype=np.int64),
                "ctl_knobs": np.zeros((NUM_KNOBS,), dtype=np.int64),
                "ctl_policy": np.zeros((2 * NUM_RULES,),
                                       dtype=np.int64)}

    def load(self, payload: dict) -> None:
        if "ctl_cursor" not in payload:
            return
        self.applied = int(np.asarray(payload["ctl_cursor"]))
        self.knobs = [int(x) for x in np.asarray(payload["ctl_knobs"])]
        self.pstate = np.asarray(payload["ctl_policy"],
                                 dtype=np.int64).copy()
        self.decisions_by_rule = {r: 0 for r in RULES}
        for ent in self.journal.entries[:self.applied]:
            self.decisions_by_rule[str(ent["rule"])] += 1

    # -- signal assembly -----------------------------------------------
    @staticmethod
    def _zero_snap() -> dict:
        return {"met": np.zeros(3, dtype=np.int64),
                "slo": np.zeros(4, dtype=np.int64)}

    @staticmethod
    def _snap(met=None, slo_eval=None) -> dict:
        s = Controller._zero_snap()
        if met is not None:
            from ..obs import device as obs_device
            m = np.asarray(met, dtype=np.int64)
            if m.ndim > 1:          # stacked per-shard mesh vector
                m = m.sum(axis=0)
            s["met"] = np.asarray(
                [m[obs_device.MET_GUARD_TRIPS],
                 m[obs_device.MET_INGEST_DROPS],
                 m[obs_device.MET_LADDER_STEPS]], dtype=np.int64)
        if slo_eval is not None:
            from ..obs.alerts import RULES as SLO_RULES
            s["slo"] = np.asarray(
                [slo_eval.violations_total]
                + [slo_eval.fired_counts[r] for r in SLO_RULES],
                dtype=np.int64)
        return s

    def observe_baseline(self, *, met=None, slo_eval=None) -> None:
        """Pin the delta baseline at incarnation start (post-restore).
        The restored counters equal their values at the last completed
        boundary, so a resumed run's first delta matches the
        uninterrupted run's."""
        self._prev = self._snap(met=met, slo_eval=slo_eval)

    def collect(self, epoch: int, *, state=None, met=None,
                slo_eval=None, prov=None, planes=None,
                press=None, advisory=None) -> ControlSignals:
        """Assemble one boundary's snapshot and advance the delta
        baseline.  ``planes`` is a list of LifecyclePlane (or None
        entries); ``press`` the chunk's per-shard mid-epoch pressure
        peaks (``int64[S, PRESS_FIELDS]``, ``MeshGuarded.press``) --
        replay-deterministic, so the peak fields stay in the
        deterministic tier; ``advisory`` a dict of best-effort
        extras."""
        cur = self._snap(met=met, slo_eval=slo_eval)
        dmet = cur["met"] - self._prev["met"]
        dslo = cur["slo"] - self._prev["slo"]
        self._prev = cur
        depth, starve_col = _boundary_read(state, prov)
        self.boundary_depth = (int(epoch), depth)
        backlog = press_bk = 0
        if depth is not None:
            backlog = int(depth.sum())
            press_bk = int(depth.sum(axis=-1).max()) \
                if depth.ndim > 1 else backlog
        press_peak = backlog_peak = 0
        if press is not None:
            from ..obs import provenance as obs_prov
            peaks = np.asarray(press, dtype=np.int64) \
                .reshape(-1, obs_prov.PRESS_FIELDS)[
                    :, obs_prov.PRESS_BACKLOG]
            press_peak = int(peaks.max())
            backlog_peak = int(peaks.sum())
        live = cap = 0
        for p in (planes or []):
            if p is not None:
                live += int(p.slots.live_count)
                cap += int(p.slots.capacity)
        starve = 0 if starve_col is None else int(starve_col.max())
        adv = dict(advisory or {})
        return ControlSignals(
            epoch=int(epoch), backlog=backlog, live=live, capacity=cap,
            resv_miss_d=int(dslo[1]), limit_break_d=int(dslo[2]),
            share_skew_d=int(dslo[3]), violations_d=int(dslo[0]),
            guard_trips_d=int(dmet[0]), ingest_drops_d=int(dmet[1]),
            ladder_steps_d=int(dmet[2]), starvation_ns=starve,
            press_backlog=press_bk,
            press_peak=press_peak, backlog_peak=backlog_peak,
            retraces=int(adv.get("retraces", 0)),
            compile_ms=float(adv.get("compile_ms", 0.0)),
            projected_hbm=int(adv.get("projected_hbm", 0)),
            bound_class=str(adv.get("bound_class", "")),
            dispatch_share=float(adv.get("dispatch_share", 0.0)),
            fallbacks=int(adv.get("fallbacks", 0)))

    # -- the boundary step ---------------------------------------------
    def step(self, epoch: int, sig: ControlSignals,
             fault=None) -> list:
        """Run the rule table at boundary ``epoch`` and apply (or
        REPLAY) its decisions under the fsync-before-apply discipline.
        ``fault(epoch, stage)`` -- the HostFaultInjector seam -- fires
        at ``before_journal`` / ``after_journal`` / ``after_apply``
        around each decision.  Returns the rules applied, in order."""
        new_pstate, decisions = policy_mod.step(
            self.pstate, self.knobs, sig, self.spec)
        dig = signals_mod.digest(sig)
        fired = []
        for rule, new in decisions:
            seq = self.applied
            if fault is not None:
                fault(epoch, "before_journal")
            ent = self.journal.entry_at(seq)
            if ent is not None:
                # resumed incarnation: the decision is already durable.
                # Replay it -- and verify the pure policy agreed.
                assert str(ent["rule"]) == rule \
                    and int(ent["epoch"]) == int(epoch), \
                    (ent, rule, epoch)
                self.replays += 1
            else:
                ent = {"seq": seq, "epoch": int(epoch), "rule": rule,
                       "digest": dig,
                       "old": [int(k) for k in self.knobs],
                       "new": [int(k) for k in new]}
                self.journal.append(ent)    # flush+fsync BEFORE apply
            if fault is not None:
                fault(epoch, "after_journal")
            self.knobs = [int(k) for k in ent["new"]]
            self.applied += 1
            self.decisions_by_rule[rule] += 1
            fired.append(rule)
            if fault is not None:
                fault(epoch, "after_apply")
        self.pstate = new_pstate
        return fired

    # -- actuation accessors -------------------------------------------
    def knob_sync(self) -> int:
        return int(self.knobs[KNOB_SYNC])

    def clamp_pct(self) -> int:
        return int(self.knobs[KNOB_CLAMP])

    def migrate_batch(self) -> int:
        """Max clients the ``migrate`` actuation moves per firing."""
        return max(int(self.spec.get("migrate_max", 4)), 0)

    def migrate_pick(self) -> str:
        """Candidate pick policy for the migrate actuation: ``"hot"``
        (largest served-demand first) or ``"cold"`` (never-served
        first -- the digest-gate mode: quiet movers are exactly the
        clients whose move is provably placement-equivalent)."""
        return str(self.spec.get("migrate_pick", "hot"))

    def overlay(self, cfg: dict) -> dict:
        """Engine config through the controller's conceded ladder
        rungs (exact twins only)."""
        return policy_mod.overlay(cfg, int(self.knobs[KNOB_LADDER]))

    def clamp_counts(self, counts, waves: int):
        """Admission clamp on already-drawn arrival counts: cap every
        per-client count at ``clamp_pct`` of the superwave.  Applied
        AFTER the Poisson draw, so RNG consumption never depends on
        the knob."""
        pct = self.clamp_pct()
        if pct >= 100:
            return counts
        cap = max(1, (int(waves) * pct) // 100)
        if torch.is_tensor(counts):
            return torch.minimum(counts, torch.tensor(
                cap, dtype=counts.dtype, device=counts.device))
        arr = np.asarray(counts)
        return np.minimum(arr, np.asarray(cap, dtype=arr.dtype))

    # -- reporting -----------------------------------------------------
    def trajectory(self) -> list:
        """Applied decisions as JSON-able rows
        ``[seq, epoch, rule, new_knob...]`` -- the crash-equivalence
        comparand (journal entries are durable across restarts, so a
        resumed run reports the FULL run's trajectory)."""
        return [[int(e["seq"]), int(e["epoch"]), str(e["rule"])]
                + [int(x) for x in e["new"]]
                for e in self.journal.entries[:self.applied]]

    def describe(self) -> dict:
        return {"decisions": int(self.applied),
                "replays": int(self.replays),
                "knobs": [int(k) for k in self.knobs],
                "by_rule": {r: int(c)
                            for r, c in self.decisions_by_rule.items()
                            if c},
                "trajectory": self.trajectory()}


def publish_controller(registry, ctl: Controller) -> None:
    """Mount the ``dmclock_controller_*`` families on ``registry``
    (callback-backed: zero hot-path cost, exact across resume because
    they read the journal-rebuilt controller state)."""
    for rule in RULES:
        registry.gauge(
            "dmclock_controller_decisions_total",
            "controller decisions applied, by rule "
            "(docs/CONTROLLER.md)",
            labels={"rule": rule}) \
            .set_function(lambda r=rule: float(ctl.decisions_by_rule[r]))
    for i, name in enumerate(KNOB_NAMES):
        registry.gauge(
            "dmclock_controller_knob",
            "current actuated knob vector (counter_sync_every / "
            "ladder_level / clamp_pct / compact_trigger / "
            "migrate_trigger)",
            labels={"knob": name}) \
            .set_function(lambda i=i: float(ctl.knobs[i]))
    registry.gauge(
        "dmclock_controller_journal_replays_total",
        "journaled decisions REPLAYED (not re-decided) after a "
        "resume") \
        .set_function(lambda: float(ctl.replays))
