"""Shard placement specs (the single-device part of
``dmclock_tpu/lifecycle/placement.py``).

The supervisor validates ``EpochJob.placement`` with
:func:`parse_placement`.  ``PlacementMap`` itself (with the scenario pins
it is built from), the power-of-two-choices router over the per-shard
planes and the live migrations between them, needs the mesh and is
ROADMAP.md item 11.  Its zero-size checkpoint leaves
(:func:`empty_leaves`) are here, because every supervisor payload
carries them: a payload's structure depends only on the job's config,
and equals the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def empty_leaves() -> dict:
    """Zero-size ``pm_*`` leaves for jobs without a placement map."""
    return {"pm_assign": np.zeros(0, dtype=np.int64),
            "pm_rng": np.zeros(6, dtype=np.uint64),
            "pm_counters": np.zeros(len(PM_COUNTER_KEYS),
                                    dtype=np.int64),
            "pm_moves": np.zeros((0, 4), dtype=np.int64),
            "pm_deferred": np.zeros(0, dtype=np.int64)}
