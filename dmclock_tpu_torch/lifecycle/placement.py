"""Shard placement: the inter-server routing layer over the per-shard
lifecycle planes (counterpart of ``dmclock_tpu/lifecycle/placement.py``).

- **Placement** (:meth:`PlacementMap.place_batch`): new registrations
  sample two candidate shards from the checkpointed placement RNG and
  take the one with the lower per-shard backlog (power-of-two-choices).
  ``mode="static"`` keeps the ``cid % n_shards`` ownership bit for bit
  (the supervisor builds no map then); scenario pins
  (:func:`placement_pins`) keep workloads whose shape is the ownership
  function -- ``shard_skew``'s hot mask is ``cid % n_shards ==
  hot_shard`` -- on their scripted shards without consuming the RNG.
  Under a fault plan a registration whose sampled choices are down
  re-routes to the live one, or defers one boundary when both are down.
- **Determinism**: the RNG is a PCG64 stream of its own (the job seed,
  its own spawn key), checkpointed as the ``pm_*`` leaves; pinned ids
  never draw, unpinned registrations always draw exactly two, so a
  resumed incarnation and a twin given ``overrides`` replay the same
  placement stream.

Live migration (``plan_moves``, the move log and the supervisor's
``_mesh_migrate``) is fired only by the closed-loop controller and is
ROADMAP.md item 12: the ``pm_moves`` leaf stays ``(0, 4)`` here, and a
snapshot that carries moves is refused on load.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PM_COUNTER_KEYS = ("placements", "p2c_draws", "migrations",
                   "reroutes", "defers", "overrides")


def parse_placement(obj) -> Tuple[str, Dict[int, int]]:
    """Normalize ``EpochJob.placement`` (None / ``"static"`` / ``"p2c"``
    / ``{"mode": .., "overrides": {cid: shard}}``) to ``(mode,
    overrides)``; JSON keys arrive as strings."""
    if obj is None or obj == "static":
        return "static", {}
    if obj == "p2c":
        return "p2c", {}
    if isinstance(obj, dict):
        mode = str(obj.get("mode", "p2c"))
        if mode not in ("static", "p2c"):
            raise ValueError(f"unknown placement mode {mode!r} "
                             "(one of 'static', 'p2c')")
        ov = {int(k): int(v)
              for k, v in (obj.get("overrides") or {}).items()}
        return mode, ov
    raise ValueError(f"unknown placement spec {obj!r} (expected "
                     "'static', 'p2c', or a {'mode', 'overrides'} "
                     "dict)")


def placement_pins(spec: Optional[dict], n_shards: int) -> np.ndarray:
    """Scenario pins, ``bool[total_ids]``: True where the churn
    scenario's shape is the ownership function and p2c must not re-route
    it.  ``shard_skew`` pins every id (its hot mask is ``cid % n_shards
    == hot_shard``); every other scenario is placement-free."""
    del n_shards
    if spec is None:
        return np.zeros(0, dtype=bool)
    total = int(spec["total_ids"])
    return np.full(total, spec.get("scenario") == "shard_skew",
                   dtype=bool)


def empty_leaves() -> dict:
    """Zero-size ``pm_*`` leaves for jobs without a placement map (every
    supervisor payload carries them, so its structure depends only on
    the job's config)."""
    return {"pm_assign": np.zeros(0, dtype=np.int64),
            "pm_rng": np.zeros(6, dtype=np.uint64),
            "pm_counters": np.zeros(len(PM_COUNTER_KEYS),
                                    dtype=np.int64),
            "pm_moves": np.zeros((0, 4), dtype=np.int64),
            "pm_deferred": np.zeros(0, dtype=np.int64)}


class PlacementMap:
    """The cluster-wide client->shard assignment, one instance shared by
    every per-shard :class:`~.plane.LifecyclePlane` (their ``_owner_of``
    consults it instead of ``slots.owner_shard``).

    Checkpoint state (the ``pm_*`` leaves): the assignment, the
    placement RNG (PCG64 as ``uint64[6]``), the counters and the
    deferred registrations.  Pins, overrides and the mode re-derive from
    the job's config."""

    empty_leaves = staticmethod(empty_leaves)

    def __init__(self, n_shards: int, total_ids: int, *,
                 mode: str = "p2c", seed: int = 0,
                 pins: Optional[np.ndarray] = None,
                 overrides: Optional[Dict[int, int]] = None):
        self.mode = str(mode)
        self.n_shards = int(n_shards)
        self.total = int(total_ids)
        self.assign = np.full(self.total, -1, dtype=np.int64)
        if self.mode == "static":
            self.assign = np.arange(self.total,
                                    dtype=np.int64) % self.n_shards
        self.pins = np.zeros(self.total, dtype=bool) \
            if pins is None else np.asarray(pins, dtype=bool).copy()
        self.override = np.full(self.total, -1, dtype=np.int64)
        for cid, s in (overrides or {}).items():
            if not 0 <= int(s) < self.n_shards:
                raise ValueError(f"placement override for client "
                                 f"{cid} targets shard {s} outside "
                                 f"[0, {self.n_shards})")
            self.override[int(cid)] = int(s)
        # a stream distinct from the arrival RNG (same job seed, own
        # spawn key), so placement draws never perturb arrival draws
        self.rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([int(seed), 0x706C6163])))
        self.counters = {k: 0 for k in PM_COUNTER_KEYS}
        self.deferred: List[int] = []

    # -- lookups -------------------------------------------------------
    def shard_of(self, cid: int) -> int:
        """Owner shard of ``cid`` (-1: not placed yet -- never
        registered, or deferred while both its choices were down)."""
        return int(self.assign[int(cid)])

    def shard_counts(self) -> np.ndarray:
        """Placed clients per shard (``int64[S]``)."""
        out = np.zeros(self.n_shards, dtype=np.int64)
        np.add.at(out, self.assign[self.assign >= 0], 1)
        return out

    # -- power-of-two-choices placement --------------------------------
    def _draw2(self) -> Tuple[int, int]:
        a = int(self.rng.integers(self.n_shards))
        b = int(self.rng.integers(self.n_shards))
        self.counters["p2c_draws"] += 2
        return a, b

    def place_batch(self, cids: Sequence[int], *, backlog,
                    up: Optional[np.ndarray] = None) -> List[int]:
        """Assign shards to the registrations due at one boundary, in the
        caller's order (last boundary's deferrals first, then ascending
        ids).  ``backlog`` is the per-shard queued total the choice
        minimizes; ``up`` the boundary's liveness row (None: all live).
        A pinned id takes ``cid % n_shards`` with no draw; an unpinned id
        always draws two (override ids too, so a twin run's stream stays
        aligned), takes the lower-backlog live choice, and defers to the
        next boundary when both are down.  Returns the ids placed."""
        backlog = np.asarray(backlog, dtype=np.int64)
        placed: List[int] = []
        deferred: List[int] = []
        for cid in cids:
            cid = int(cid)
            if self.assign[cid] >= 0:
                continue                      # a replayed boundary
            if self.pins[cid] and self.override[cid] < 0:
                self.assign[cid] = cid % self.n_shards
                self.counters["placements"] += 1
                placed.append(cid)
                continue
            a = b = None
            if not self.pins[cid]:
                a, b = self._draw2()
            if self.override[cid] >= 0:
                self.assign[cid] = int(self.override[cid])
                self.counters["placements"] += 1
                self.counters["overrides"] += 1
                placed.append(cid)
                continue
            live = [s for s in (a, b) if up is None or bool(up[s])]
            if not live:
                deferred.append(cid)
                self.counters["defers"] += 1
                continue
            if len(live) < 2:
                self.counters["reroutes"] += 1
            dst = min(live, key=lambda s: (int(backlog[s]), s))
            self.assign[cid] = dst
            self.counters["placements"] += 1
            placed.append(cid)
        self.deferred = deferred
        return placed

    def take_deferred(self) -> List[int]:
        """The registrations deferred at the previous boundary, in their
        order; cleared on read (the caller re-offers them)."""
        out, self.deferred = list(self.deferred), []
        return out

    def snapshot(self) -> dict:
        return {"mode": self.mode, "n_shards": self.n_shards,
                "deferred": len(self.deferred),
                **{k: int(v) for k, v in self.counters.items()}}

    # -- observability -------------------------------------------------
    def publish(self, registry, labels=None) -> None:
        """Mount the ``dmclock_placement_*`` and ``dmclock_migration_*``
        gauges (the JAX package's families)."""
        rows = (
            ("dmclock_placement_total", "placements",
             "registrations routed by the placement map (pins + "
             "power-of-two-choices)"),
            ("dmclock_placement_draws_total", "p2c_draws",
             "placement RNG samples consumed (2 per unpinned "
             "registration, 2 per migration candidate)"),
            ("dmclock_placement_reroutes_total", "reroutes",
             "registrations re-routed off a DOWN sampled shard to "
             "the live choice"),
            ("dmclock_placement_defers_total", "defers",
             "registrations deferred one boundary because both "
             "sampled shards were down"),
            ("dmclock_placement_overrides_total", "overrides",
             "registrations placed by an explicit override (the "
             "digest gate's placed-from-start twin)"),
            ("dmclock_migration_total", "migrations",
             "live clients moved between shards (EVICT on source + "
             "REGISTER on destination with carried counter views)"),
        )
        for name, key, help_text in rows:
            registry.gauge(name, help_text, labels=labels) \
                .set_function(lambda k=key: float(self.counters[k]))
        registry.gauge(
            "dmclock_migration_last_boundary",
            "epoch boundary of the most recent migration (-1 = "
            "never)", labels=labels).set_function(lambda: -1.0)

    # -- checkpoint round trip -----------------------------------------
    def encode(self) -> dict:
        from ..robust.supervisor import _rng_state_array

        return {"pm_assign": self.assign.copy(),
                "pm_rng": _rng_state_array(self.rng),
                "pm_counters": np.asarray(
                    [self.counters[k] for k in PM_COUNTER_KEYS],
                    dtype=np.int64),
                "pm_moves": np.zeros((0, 4), dtype=np.int64),
                "pm_deferred": np.asarray(self.deferred,
                                          dtype=np.int64)}

    def load(self, payload: dict) -> None:
        from ..robust.supervisor import _rng_from_array

        assign = np.asarray(payload["pm_assign"], dtype=np.int64)
        if assign.shape[0] == 0:
            return                       # a payload without a map
        if np.asarray(payload["pm_moves"]).shape[0]:
            raise NotImplementedError(
                "the snapshot holds live migrations (pm_moves), which "
                "the closed-loop controller fires: ROADMAP.md item 12")
        self.assign = assign.copy()
        self.rng = _rng_from_array(payload["pm_rng"])
        ctr = np.asarray(payload["pm_counters"], dtype=np.int64)
        self.counters = {k: int(v) for k, v in zip(PM_COUNTER_KEYS, ctr)}
        self.deferred = [int(x) for x in
                         np.asarray(payload["pm_deferred"],
                                    dtype=np.int64)]
