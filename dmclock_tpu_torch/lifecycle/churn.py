"""Churn scenarios: deterministic open-population workload scripts.

Counterpart of ``dmclock_tpu/lifecycle/churn.py`` (numpy only; every
output equals the JAX package's).  A churn spec is a plain JSON-able
dict describing an open client population over an epoch loop:
per-epoch arrival intensities (``lam_vector``) and the lifecycle events
due at each boundary (``events``): cohort registrations and scripted QoS
updates.  Everything is a pure function of the spec, so two runs of the
same spec are bit-identical.

:func:`static_variant` returns the same scenario with every client
registered at boundary 0, eviction turned into idle marks, compaction
off and the initial capacity equal to the id space: the statically
pre-registered population the lifecycle digest gate compares against.
Arrival draws, QoS update scripts and the idle policy are shared, so
the only difference between the two runs is the slot dynamics.

What the generators keep so that the gate can hold (the plane does not
enforce it):

- cohorts occupy ascending client-id ranges in start order, so dynamic
  registration order matches the static run's ascending-id order (the
  engines break ties on creation order);
- a cohort's arrival rate is zero strictly before its start boundary;
- once a departing cohort's rate reaches zero it stays zero, and
  ``evict_after`` exceeds any temporary quiet window, so an evicted
  client never returns (a re-registration would be a new client).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SCENARIOS = ("flash_crowd", "diurnal", "churn_storm", "limit_thrash",
             "shard_skew")


def make_spec(scenario: str, *, total_ids: int, seed: int = 0,
              capacity0: int = 0, static: bool = False,
              base_lam: float = 1.0, evict_after: int = 2,
              compact_every: int = 4, qos_r: float = 0.0,
              qos_l: float = 0.0, qos_wmod: int = 4,
              **params) -> dict:
    """Build a churn spec with per-scenario parameter defaults.

    ``capacity0`` is the dynamic run's initial slot capacity (0 picks
    ``max(8, total_ids // 4)`` -- small on purpose, so grow-on-demand
    is exercised); ``evict_after`` the number of consecutive
    no-arrival boundaries before an idle client's slot is recycled
    (0 = never); ``compact_every`` compacts at every k-th boundary
    (0 = off).  Initial QoS of client ``c`` is ``(qos_r,
    1 + c % qos_wmod, qos_l)`` -- shared by init-time registration and
    the static variant."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown churn scenario {scenario!r} "
                         f"(one of {SCENARIOS})")
    total_ids = int(total_ids)
    spec = {
        "scenario": scenario, "total_ids": total_ids,
        "seed": int(seed), "static": bool(static),
        "capacity0": int(capacity0) or max(8, total_ids // 4),
        "base_lam": float(base_lam), "evict_after": int(evict_after),
        "compact_every": int(compact_every),
        "qos_r": float(qos_r), "qos_l": float(qos_l),
        "qos_wmod": int(qos_wmod),
    }
    defaults: Dict[str, dict] = {
        # steady base cohort + a crowd cohort that arrives in one
        # burst, stays for crowd_len epochs, and departs for good
        "flash_crowd": {"base_frac": 0.5, "crowd_at": 8,
                        "crowd_len": 8, "crowd_lam_x": 4.0},
        # everyone registered up front; day/night square wave with
        # per-cohort phase.  night_x > 0 keeps night arrivals trickling
        # so nobody idles into eviction (evict_after=0 by default here)
        "diurnal": {"cohorts": 4, "period": 8, "night_x": 0.25},
        # G generations of cohorts, each living `life` epochs starting
        # `stride` apart: continuous register/depart traffic, heavy
        # slot recycling, fragmentation for compaction to repack
        "churn_storm": {"gens": 6, "stride": 4, "life": 10},
        # static population, but a victim cohort's limit flip-flops
        # between tight and disabled at EVERY boundary -- the
        # adversarial control-plane load shape
        "limit_thrash": {"victim_frac": 0.25, "tight_limit": 50.0,
                         "thrash_every": 1},
        # an imbalance workload: everyone registered from epoch 0,
        # but the ids owned by one shard (cid % n_shards == hot_shard)
        # carry a Zipf(zipf_a) head at hot_x times the base rate while
        # every other shard's ids trickle at idle_x.  cold_frac /
        # cold_until keep the lowest-rate cold_frac of the hot shard's
        # Zipf ranks at lam = 0 until epoch cold_until (0 = off).
        "shard_skew": {"n_shards": 4, "hot_shard": 0,
                       "zipf_a": 1.2, "hot_x": 8.0, "idle_x": 0.1,
                       "cold_frac": 0.0, "cold_until": 0},
    }
    d = dict(defaults[scenario])
    unknown = set(params) - set(d)
    if unknown:
        raise ValueError(f"unknown {scenario} params: {sorted(unknown)}")
    d.update(params)
    spec.update(d)
    if scenario == "diurnal":
        spec["evict_after"] = int(params.get("evict_after", 0)) or 0
    if scenario == "limit_thrash":
        spec.setdefault("evict_after", 0)
        spec["evict_after"] = 0
    if scenario == "shard_skew":
        # static-population imbalance shape: nobody departs (the cold
        # shards' trickle is the point -- they idle, not evict)
        spec["evict_after"] = 0
    return spec


def static_variant(spec: dict) -> dict:
    """The statically pre-registered reference of ``spec``: same
    arrival trace, same QoS update script, and the same idle-marking
    policy (``evict_after`` is KEPT -- where the dynamic run evicts a
    drained client, the static run idle-marks it, so departure leaves
    the engines' idle-reactivation min identically); no registration
    timing, no erasure, no growth, no compaction."""
    s = dict(spec)
    s["static"] = True
    s["compact_every"] = 0
    s["capacity0"] = s["total_ids"]
    return s


def init_qos(spec: dict, cid: int):
    """Initial (reservation, weight, limit) of client ``cid``."""
    return (spec["qos_r"], 1.0 + (int(cid) % spec["qos_wmod"]),
            spec["qos_l"])


# ----------------------------------------------------------------------
# cohort tables (host-side, derived once per call; specs are tiny)
# ----------------------------------------------------------------------

def _cohorts(spec: dict) -> List[dict]:
    """[{lo, hi, start, end, lam}] id ranges in ascending-id = start
    order; ``end`` is the epoch the cohort's rate drops to zero
    forever (None = never)."""
    n = spec["total_ids"]
    lam = spec["base_lam"]
    sc = spec["scenario"]
    if sc == "flash_crowd":
        nb = max(1, int(n * spec["base_frac"]))
        return [
            {"lo": 0, "hi": nb, "start": 0, "end": None, "lam": lam},
            {"lo": nb, "hi": n, "start": spec["crowd_at"],
             "end": spec["crowd_at"] + spec["crowd_len"],
             "lam": lam * spec["crowd_lam_x"]},
        ]
    if sc == "churn_storm":
        g, stride, life = spec["gens"], spec["stride"], spec["life"]
        gs = n // g
        out = []
        for i in range(g):
            hi = (i + 1) * gs if i < g - 1 else n
            out.append({"lo": i * gs, "hi": hi, "start": i * stride,
                        "end": i * stride + life, "lam": lam})
        return out
    # diurnal / limit_thrash: everyone from epoch 0
    return [{"lo": 0, "hi": n, "start": 0, "end": None, "lam": lam}]


def lam_vector(spec: dict, epoch: int) -> np.ndarray:
    """Per-client Poisson arrival rate for ``epoch``
    (``float64[total_ids]``).  Shared verbatim by the dynamic run and
    its static variant -- identical RNG consumption is what makes the
    digest gate meaningful."""
    lam = np.zeros(spec["total_ids"], dtype=np.float64)
    for c in _cohorts(spec):
        live = epoch >= c["start"] and \
            (c["end"] is None or epoch < c["end"])
        if live:
            lam[c["lo"]:c["hi"]] = c["lam"]
    if spec["scenario"] == "diurnal":
        n, period = spec["total_ids"], spec["period"]
        cohorts, night_x = spec["cohorts"], spec["night_x"]
        size = max(1, n // cohorts)
        cidx = np.minimum(np.arange(n) // size, cohorts - 1)
        phase = (epoch + cidx * (period // max(cohorts, 1))) % period
        night = phase >= (period + 1) // 2
        lam = np.where(night, lam * night_x, lam)
    if spec["scenario"] == "shard_skew":
        n, S = spec["total_ids"], int(spec["n_shards"])
        ids = np.arange(n)
        hot = ids % S == int(spec["hot_shard"])
        # Zipf head over the hot shard's owned ids, by ownership
        # rank: the head client melts hardest, the tail still runs
        # hotter than any cold shard.  Mean over the hot partition is
        # pinned at base_lam * hot_x so the aggregate offered load is
        # a pure function of the spec knobs.
        rank = ids // S   # ownership rank within a shard's partition
        zipf = 1.0 / np.power(rank + 1.0, float(spec["zipf_a"]))
        n_hot = max(int(hot.sum()), 1)
        zipf_mean = float(zipf[hot].sum()) / n_hot if hot.any() \
            else 1.0
        lam = np.where(
            hot,
            lam * float(spec["hot_x"]) * zipf / max(zipf_mean, 1e-12),
            lam * float(spec["idle_x"]))
        cf = float(spec.get("cold_frac", 0.0))
        until = int(spec.get("cold_until", 0))
        if cf > 0 and epoch < until:
            # quiet tail: the coldest cold_frac of the hot shard's
            # ranks arrive NOTHING until cold_until -- drained,
            # zero-completion residents the migrate rule can move
            # with a provably placement-equivalent digest
            n_cold = int(round(cf * n_hot))
            quiet = hot & (rank >= n_hot - n_cold)
            lam = np.where(quiet, 0.0, lam)
    return lam


def events(spec: dict, boundary: int, every: int) -> List[dict]:
    """Scripted lifecycle ops due at ``boundary`` (ascending-cid
    registration order), for a boundary cadence of ``every`` epochs:
    cohorts starting in ``[boundary, boundary + every)`` register now
    (their rate is still zero strictly before ``start``, so an early
    registration just idles).  Update scripts fire on their own
    cadence.  Registrations/evictions are ignored by a static-mode
    plane; updates apply in both modes."""
    out: List[dict] = []
    for c in _cohorts(spec):
        due = boundary <= c["start"] < boundary + every or \
            (c["start"] < boundary == 0)
        if due:
            for cid in range(c["lo"], c["hi"]):
                r, w, l = init_qos(spec, cid)
                out.append({"op": "register", "cid": cid,
                            "r": r, "w": w, "l": l})
    if spec["scenario"] == "limit_thrash" and boundary > 0:
        te = max(1, spec["thrash_every"])
        if (boundary // every) % te == 0:
            n = spec["total_ids"]
            nv = max(1, int(n * spec["victim_frac"]))
            tight = (boundary // every // te) % 2 == 1
            for cid in range(n - nv, n):
                r, w, _ = init_qos(spec, cid)
                lim = spec["tight_limit"] if tight else 0.0
                out.append({"op": "update", "cid": cid,
                            "r": r, "w": w, "l": lim})
    return out


def peak_ids(spec: dict) -> int:
    """Maximum simultaneously-live client count the script reaches
    (a sizing hint)."""
    marks = sorted({c["start"] for c in _cohorts(spec)})
    peak = 0
    for t in marks:
        live = sum(c["hi"] - c["lo"] for c in _cohorts(spec)
                   if c["start"] <= t and
                   (c["end"] is None or t < c["end"]))
        peak = max(peak, live)
    return peak
