"""Deterministic, seeded fault plans for chaos runs.

Counterpart of ``dmclock_tpu/robust/faults.py``, a copy kept in the port
(plans are host numpy data and sampled by the same PCG64 draws, so a
plan is byte-equal in both packages).  A :class:`FaultPlan` holds
per-step, per-server masks and values for every fault the robust
cluster (``robust.cluster``) and the mesh chunk (``parallel.mesh``)
inject:

- **server dropout / restart** (``up``): a down server commits nothing
  and its decision slots read NONE; a restarted server re-syncs its
  tracker marks from the monotone global counters before serving;
- **delayed / lost piggyback counter updates** (``delay_counters``):
  the server serves from its held view of the global delta/rho
  counters instead of the fresh sum (reference
  ``dmclock_client.h:39-84``);
- **clock skew** (``skew_ns``): the server's clock reads ``now +
  skew_ns`` for this step's tag tests (a per-step lens, not drift);
- **duplicated completions** (``dup_completions``): this step's
  completions fold into the counters twice.

``plan=None`` everywhere means no fault plumbing at all; an all-benign
plan (:func:`zero_plan`) runs the plumbing with every mask off and is
bit-identical to ``None``.  A plan moves to the card only when a mesh
chunk takes it (:func:`plan_chunk`'s arrays).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class FaultPlan(NamedTuple):
    """Per-step fault schedule; every leaf is [T, S] (steps, servers)."""

    up: np.ndarray                # bool[T, S] server is live this step
    skew_ns: np.ndarray           # int64[T, S] clock skew for the step
    delay_counters: np.ndarray    # bool[T, S] hold the stale counter view
    dup_completions: np.ndarray   # bool[T, S] fold completions twice

    @property
    def steps(self) -> int:
        return self.up.shape[0]

    @property
    def n_servers(self) -> int:
        return self.up.shape[1]


class FaultStep(NamedTuple):
    """One time-slice of a plan ([S] leaves) plus the previous step's
    liveness -- what one cluster step consumes."""

    up: np.ndarray
    skew_ns: np.ndarray
    delay_counters: np.ndarray
    dup_completions: np.ndarray


def zero_plan(steps: int, n_servers: int) -> FaultPlan:
    """The all-benign plan: every server up, zero skew, no delays, no
    duplicates.  Running it must be bit-identical to ``plan=None``."""
    return FaultPlan(
        up=np.ones((steps, n_servers), dtype=bool),
        skew_ns=np.zeros((steps, n_servers), dtype=np.int64),
        delay_counters=np.zeros((steps, n_servers), dtype=bool),
        dup_completions=np.zeros((steps, n_servers), dtype=bool),
    )


def sample_plan(seed: int, steps: int, n_servers: int, *,
                p_dropout: float = 0.0, mean_outage_steps: float = 2.0,
                p_delay: float = 0.0, p_dup: float = 0.0,
                max_skew_ns: int = 0) -> FaultPlan:
    """Sample a deterministic plan from ``seed`` (PCG64; stable across
    runs and platforms).

    Liveness is a per-server Markov chain: an up server goes down with
    ``p_dropout`` per step; a down server restarts with probability
    ``1/mean_outage_steps``.  Every server starts up.  ``delay`` /
    ``dup`` masks and skew draw i.i.d. per (step, server); faults other
    than dropout only apply to live steps (the runner masks them)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    up = np.ones((steps, n_servers), dtype=bool)
    alive = np.ones((n_servers,), dtype=bool)
    p_restart = 1.0 / max(mean_outage_steps, 1.0)
    for t in range(steps):
        u = rng.random(n_servers)
        alive = np.where(alive, u >= p_dropout, u < p_restart)
        up[t] = alive
    skew = rng.integers(-max_skew_ns, max_skew_ns + 1,
                        size=(steps, n_servers), dtype=np.int64) \
        if max_skew_ns else np.zeros((steps, n_servers), np.int64)
    return FaultPlan(
        up=up,
        skew_ns=skew,
        delay_counters=rng.random((steps, n_servers)) < p_delay,
        dup_completions=rng.random((steps, n_servers)) < p_dup,
    )


def single_outage_plan(steps: int, n_servers: int, *, server: int,
                       down_from: int, down_until: int) -> FaultPlan:
    """One server down for ``[down_from, down_until)`` -- the minimal
    dropout + restart scenario the CI chaos smoke and the degraded-mode
    test drive."""
    plan = zero_plan(steps, n_servers)
    plan.up[down_from:down_until, server] = False
    return plan


def plan_step(plan: FaultPlan, t: int) -> FaultStep:
    """Slice step ``t`` for one cluster step."""
    return FaultStep(up=plan.up[t], skew_ns=plan.skew_ns[t],
                     delay_counters=plan.delay_counters[t],
                     dup_completions=plan.dup_completions[t])


class FaultChunk(NamedTuple):
    """A chunk-window slice of a plan for the FUSED mesh chunk
    (``parallel.mesh.build_mesh_chunk``): shard-axis-leading ``[S, E]``
    mask/value arrays plus the
    liveness entering the window (``up_prev``, [S] -- derived from the
    plan's previous step, so dropout/restart transitions land on the
    same epochs the host loop sees).  Host numpy data; a captured chunk
    takes them as tensors on its layout
    (``parallel.mesh.fault_inputs``)."""

    up: np.ndarray               # bool[S, E]
    skew_ns: np.ndarray          # int64[S, E]
    delay_counters: np.ndarray   # bool[S, E]
    dup_completions: np.ndarray  # bool[S, E]
    up_prev: np.ndarray          # bool[S] liveness entering the chunk


def plan_chunk(plan: FaultPlan, e0: int, e1: int) -> FaultChunk:
    """Slice epochs ``[e0, e1)`` of a plan into the fused-chunk layout.
    ``up_prev`` comes from step ``e0 - 1`` (all-up at the origin), so
    chunked chaos launches compose exactly like the per-step host
    loop."""
    e0, e1 = int(e0), int(e1)
    assert 0 <= e0 < e1 <= plan.steps, (e0, e1, plan.steps)
    prev = plan.up[e0 - 1] if e0 > 0 \
        else np.ones((plan.n_servers,), dtype=bool)
    return FaultChunk(
        up=np.ascontiguousarray(plan.up[e0:e1].T),
        skew_ns=np.ascontiguousarray(plan.skew_ns[e0:e1].T),
        delay_counters=np.ascontiguousarray(
            plan.delay_counters[e0:e1].T),
        dup_completions=np.ascontiguousarray(
            plan.dup_completions[e0:e1].T),
        up_prev=prev.copy())


def plan_events(plan: FaultPlan) -> dict:
    """Host-side ground truth of the fault events a run of this plan
    must surface in the device metrics vector -- the exact-match oracle
    for ``server_dropouts`` / ``tracker_resyncs`` / ``faults_injected``
    (the visibility half of the chaos differential suite)."""
    prev = np.vstack([np.ones((1, plan.n_servers), dtype=bool),
                      plan.up[:-1]])
    dropouts = int((prev & ~plan.up).sum())
    resyncs = int((~prev & plan.up).sum())
    live = plan.up
    perturbations = int((plan.delay_counters & live).sum()
                        + (plan.dup_completions & live).sum()
                        + ((plan.skew_ns != 0) & live).sum())
    return {
        "server_dropouts": dropouts,
        "tracker_resyncs": resyncs,
        "faults_injected": dropouts + resyncs + perturbations,
    }


def plan_shard_events(plan: FaultPlan) -> dict:
    """Per-shard form of :func:`plan_events` (``int64[S]`` arrays):
    the exact-match oracle for the ``shard``-labelled
    ``dmclock_fault_*`` families and the bench's per-shard
    dropout/resync record rows.  Summing each array reproduces the
    cluster totals of :func:`plan_events` by construction."""
    prev = np.vstack([np.ones((1, plan.n_servers), dtype=bool),
                      plan.up[:-1]])
    dropouts = (prev & ~plan.up).sum(axis=0).astype(np.int64)
    resyncs = (~prev & plan.up).sum(axis=0).astype(np.int64)
    live = plan.up
    perturb = ((plan.delay_counters & live).sum(axis=0)
               + (plan.dup_completions & live).sum(axis=0)
               + ((plan.skew_ns != 0) & live).sum(axis=0)
               ).astype(np.int64)
    return {"server_dropouts": dropouts,
            "tracker_resyncs": resyncs,
            "faults_injected": dropouts + resyncs + perturb}


# keys parse_fault_spec accepts (everything sample_plan takes except
# the run-derived steps/n_servers); "seed" rides separately
_SPEC_KEYS = ("p_dropout", "mean_outage_steps", "p_delay", "p_dup",
              "max_skew_ns")


def parse_fault_spec(spec) -> Optional[dict]:
    """Parse a ``--fault-plan`` value into :func:`sample_plan` kwargs
    (plus ``seed``), or None when the value is a plain LABEL (the
    older semantics: ``--fault-plan`` tagged a run without running
    anything).  A spec is a comma-separated ``key=value`` string --
    e.g. ``"seed=7,p_dropout=0.05,mean_outage_steps=2,p_dup=0.1"`` --
    or an already-parsed dict; ``"none"``/empty parses to None."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        out = dict(spec)
    else:
        s = str(spec).strip()
        if not s or s.lower() == "none" or "=" not in s:
            return None
        out = {}
        for part in s.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in _SPEC_KEYS + ("seed",):
                raise ValueError(
                    f"unknown fault-plan spec key {k!r} (one of "
                    f"{('seed',) + _SPEC_KEYS})")
            out[k] = float(v) if "." in v or "e" in v.lower() \
                else int(v)
    out.setdefault("seed", 0)
    unknown = set(out) - set(_SPEC_KEYS) - {"seed"}
    if unknown:
        raise ValueError(f"unknown fault-plan spec keys "
                         f"{sorted(unknown)}")
    out["seed"] = int(out["seed"])
    out["max_skew_ns"] = int(out.get("max_skew_ns", 0))
    return out


def plan_from_spec(spec: dict, steps: int, n_servers: int) -> FaultPlan:
    """Sample the plan a parsed spec describes for a ``steps`` x
    ``n_servers`` run -- the one deterministic construction shared by
    ``EpochJob(fault_plan=...)`` and ``bench.py --fault-plan``, so a
    bench run and its supervised twin inject the identical
    schedule."""
    kw = dict(spec)
    seed = int(kw.pop("seed", 0))
    return sample_plan(seed, int(steps), int(n_servers), **kw)


def describe(plan: FaultPlan | None) -> str:
    """Compact history tag for bench/JSON records: ``"none"`` for no
    plan or an all-benign plan, else a summary naming the fault mix --
    chaos runs must never pollute the clean-run regression series."""
    if plan is None:
        return "none"
    ev = plan_events(plan)
    if ev["faults_injected"] == 0:
        return "none"
    return (f"T{plan.steps}xS{plan.n_servers}:"
            f"drop{ev['server_dropouts']}"
            f"+resync{ev['tracker_resyncs']}"
            f"+inject{ev['faults_injected']}")
