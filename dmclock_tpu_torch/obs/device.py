"""On-device scheduling metrics: one small int64 vector.

Counterpart of ``dmclock_tpu/obs/device.py``: the same 20 rows, in the
same order, with the same merge (counters add, high-water marks take
the maximum).  The epoch loop and the serial engine fold one delta per
batch/step into the vector on the device; it is read back once, with
the decisions, so no batch waits on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel import groups as _groups

# -- indices (meanings in dmclock_tpu/obs/device.py) ------------------
MET_DECISIONS = 0
MET_RESV = 1
MET_PROP = 2
MET_LIMIT_BREAK = 3
MET_STALLS = 4
MET_RING_HWM = 5
MET_GUARD_TRIPS = 6
MET_INGEST_DROPS = 7
MET_REBASE_FALLBACKS = 8
MET_SERVER_DROPOUTS = 9
MET_TRACKER_RESYNCS = 10
MET_FAULTS_INJECTED = 11
MET_CAL_LADDER_LEVELS = 12
MET_CAL_LADDER_BASE = 13
MET_CAL_LADDER_FALLBACKS = 14
MET_LADDER_STEPS = 15
MET_SUPERVISOR_RESUMES = 16
MET_WHEEL_OCC_HWM = 17
MET_WHEEL_RESLOTS = 18
MET_PALLAS_FALLBACKS = 19
NUM_METRICS = 20

METRIC_NAMES = (
    "decisions_total", "decisions_reservation", "decisions_priority",
    "decisions_limit_break", "limit_stalls", "ring_occupancy_hwm",
    "rebase_guard_trips", "ingest_drops", "rebase_fallbacks",
    "server_dropouts", "tracker_resyncs", "faults_injected",
    "calendar_ladder_levels_used", "calendar_ladder_base_decisions",
    "calendar_ladder_fallbacks", "degradation_ladder_steps",
    "supervisor_resumes", "wheel_bucket_occupancy_hwm",
    "wheel_reslots_total", "wheel_pallas_fallbacks",
)

# keyword of metrics_delta -> row
_DELTA_ROWS = {
    "decisions": MET_DECISIONS, "resv": MET_RESV, "prop": MET_PROP,
    "limit_break": MET_LIMIT_BREAK, "stalls": MET_STALLS,
    "ring_hwm": MET_RING_HWM, "guard_trips": MET_GUARD_TRIPS,
    "ingest_drops": MET_INGEST_DROPS,
    "rebase_fallbacks": MET_REBASE_FALLBACKS,
    "server_dropouts": MET_SERVER_DROPOUTS,
    "tracker_resyncs": MET_TRACKER_RESYNCS,
    "faults_injected": MET_FAULTS_INJECTED,
    "cal_ladder_levels_used": MET_CAL_LADDER_LEVELS,
    "cal_ladder_base_decisions": MET_CAL_LADDER_BASE,
    "cal_ladder_fallbacks": MET_CAL_LADDER_FALLBACKS,
    "ladder_steps": MET_LADDER_STEPS,
    "supervisor_resumes": MET_SUPERVISOR_RESUMES,
    "wheel_occ_hwm": MET_WHEEL_OCC_HWM,
    "wheel_reslots": MET_WHEEL_RESLOTS,
    "pallas_fallbacks": MET_PALLAS_FALLBACKS,
}

# the rows a killed-and-resumed run legitimately grows (the supervisor's
# crash-equivalence gate zeroes them on both sides before comparing)
RESUME_ROWS = (MET_SUPERVISOR_RESUMES,)

# the max-accumulated rows (everything else adds)
_HWM_ROWS = (MET_RING_HWM, MET_WHEEL_OCC_HWM)
_HWM_MASK = np.zeros((NUM_METRICS,), dtype=bool)
_HWM_MASK[list(_HWM_ROWS)] = True


@functools.lru_cache(maxsize=8)
def _hwm_mask(device: torch.device) -> torch.Tensor:
    """The max-rows mask on ``device``, made there once
    (:func:`obs.histograms.col_mask`: no copy from the host, so a
    program's warm-up may be its first use)."""
    from .histograms import col_mask

    return col_mask(NUM_METRICS, _HWM_ROWS, device)


def metrics_zero(device: str | torch.device = DEFAULT_DEVICE
                 ) -> torch.Tensor:
    return torch.zeros((NUM_METRICS,), dtype=torch.int64,
                       device=resolve_device(device))


def metrics_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two metric vectors: counters add, high-water marks max.
    Associative and commutative."""
    return torch.where(_hwm_mask(a.device), torch.maximum(a, b), a + b)


def metrics_combine_np(acc, *vecs) -> np.ndarray:
    """Host mirror of :func:`metrics_combine` over numpy vectors (or
    tensors, read back): the supervisor folds each epoch's vector into
    its running total with it.  The max rows come from the same
    ``_HWM_MASK`` as the device merge."""
    acc = np.asarray(acc, dtype=np.int64)
    for v in vecs:
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        acc = np.where(_HWM_MASK, np.maximum(acc, v), acc + v)
    return acc


def metrics_delta(*, device: str | torch.device, **rows) -> torch.Tensor:
    """A one-batch delta vector from scalar contributions, keyed as in
    the JAX package's ``metrics_delta`` (``decisions=``, ``resv=``,
    ...).  Values are 0-d tensors on ``device`` or Python ints; a
    Python int is written with a fill, never copied from the host, so
    building a delta never waits on the card."""
    unknown = set(rows) - set(_DELTA_ROWS)
    if unknown:
        raise TypeError(f"unknown metric rows {sorted(unknown)}")
    out = torch.zeros((NUM_METRICS,), dtype=torch.int64,
                      device=torch.device(device))
    for name, v in rows.items():
        if torch.is_tensor(v) or v:
            out[_DELTA_ROWS[name]] = v
    return out


def metrics_combine_axis(mat: torch.Tensor) -> torch.Tensor:
    """Reduce a stacked ``[S, NUM_METRICS]`` matrix along its leading
    axis with the vector's merge (counters add, high-water marks max)."""
    return torch.where(_hwm_mask(mat.device), mat.max(dim=0).values,
                       mat.sum(dim=0))


def metrics_mesh_reduce(mat) -> torch.Tensor:
    """The JAX package's mesh merge of per-shard metric vectors (counter
    rows ``psum``, high-water rows ``pmax`` over the servers axis).  On
    one device the shards are the leading axis of one stacked tensor, so
    the collective is :func:`metrics_combine_axis` over it; a grouped
    matrix (``parallel.groups``) reduces each group on its device and
    merges the partials on the first group's device."""
    return _groups.reduce(mat, metrics_combine_axis, metrics_combine)


def admission_clamp(counts: torch.Tensor, headroom: torch.Tensor):
    """Clamp per-client arrival counts to ring headroom (the AtLimit
    Reject/EAGAIN analog applied before ``ingest_superwave``); returns
    ``(clamped, dropped_total)`` with the int64 drop count for the
    ``ingest_drops`` row."""
    clamped = torch.minimum(counts, headroom)
    dropped = torch.sum((counts - clamped).to(torch.int64))
    return clamped, dropped


def metrics_dict(vec) -> dict:
    """Name the rows of a metrics vector (host side)."""
    if torch.is_tensor(vec):
        vec = vec.detach().cpu().numpy()
    v = np.asarray(vec).reshape(-1)
    return {name: int(v[i]) for i, name in enumerate(METRIC_NAMES)}


FAULT_FAMILIES = (
    ("dmclock_fault_server_dropouts_total", MET_SERVER_DROPOUTS,
     "up -> down shard transitions injected by the fault plan "
     "(docs/ROBUSTNESS.md 'Degraded-mode mesh')"),
    ("dmclock_fault_tracker_resyncs_total", MET_TRACKER_RESYNCS,
     "down -> up restarts that re-synced the shard's held counter "
     "view / tracker marks from the monotone global counters"),
    ("dmclock_fault_injected_total", MET_FAULTS_INJECTED,
     "total injected fault events (dropouts, restarts, delayed "
     "counters, duplicated completions, nonzero clock skew)"),
)


def publish_shard_faults(registry, per_shard, labels=None) -> None:
    """Register the ``shard``-labelled ``dmclock_fault_*`` families from
    a ``[S, NUM_METRICS]`` per-shard metric matrix (or a ``[S, 3]``
    dropouts/resyncs/injected matrix, e.g. ``robust.faults.
    plan_shard_events`` stacked column-wise): one gauge per family per
    shard plus a ``shard="all"`` total."""
    mat = _np_metrics(per_shard)
    if mat.ndim != 2:
        raise ValueError(f"expected a [S, cols] matrix, got {mat.shape}")
    for j, (name, row, help_text) in enumerate(FAULT_FAMILIES):
        col = row if mat.shape[1] == NUM_METRICS else j
        for s in range(mat.shape[0]):
            registry.gauge(
                name, help_text,
                labels={**(labels or {}), "shard": str(s)}
            ).set(int(mat[s, col]))
        registry.gauge(
            name, help_text,
            labels={**(labels or {}), "shard": "all"}
        ).set(int(mat[:, col].sum()))


def publish(registry, vec, prefix: str = "dmclock_engine",
            labels=None) -> None:
    """Fold a metrics vector (read back once) into a host
    ``MetricsRegistry``: every row becomes a gauge (the vector is itself
    cumulative per run; the hwm rows are maxima)."""
    for name, value in metrics_dict(vec).items():
        registry.gauge(f"{prefix}_{name}",
                       "on-device scheduling metric (see "
                       "docs/OBSERVABILITY.md)",
                       labels=labels).set(value)


def _np_metrics(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)
