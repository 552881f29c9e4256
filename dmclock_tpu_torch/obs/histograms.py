"""On-device QoS telemetry: log2-bucketed histograms and the per-client
conformance ledger.

Counterpart of ``dmclock_tpu/obs/histograms.py`` (its module docstring
states the observation semantics).  Both structures ride the epoch
loops next to the ``obs.device`` metrics vector, are folded from
reductions over tensors the batches already hold, and are read back
once at the end; decisions are identical with telemetry on or off.

**Histograms** (``int64[NUM_HISTS, NUM_BUCKETS + 1]``): four families x
48 log2 buckets + one value-sum column.  Bucket 0 holds values <= 0;
bucket i (1..46) holds ``2^(i-1) <= v < 2^i``; bucket 47 holds
``v >= 2^46``.  Bucketing counts passed powers of two in int64 -- no
float log2, so a value lands in the same bucket on every device and in
the JAX package.  Merge is elementwise add.

**Ledger** (``int64[N, LED_COLS]``): per-client served ops,
reservation-phase ops, limit-break serves, reservation-tardiness sum
and max.  Counter columns add, the max column maxes.

The registry export (:func:`publish_hists`, :func:`publish_ledger`)
reads a block back once and writes it into a host registry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

# -- histogram families ------------------------------------------------
HIST_DECISION_LATENCY = 0   # weight-phase entry: now - effective prop tag
HIST_RESV_TARDINESS = 1     # constraint-phase entry: now - resv tag
HIST_LIMIT_STALL = 2        # stalled batch: time to next eligibility
HIST_COMMIT_SIZE = 3        # per batch/level committed decisions
NUM_HISTS = 4

HIST_NAMES = ("decision_latency_ns", "resv_tardiness_ns",
              "limit_stall_ns", "commit_size")

NUM_BUCKETS = 48
HIST_SUM_COL = NUM_BUCKETS          # value-sum rides as column 48

# Prometheus-facing upper bounds: bucket 0 -> le=0; bucket i -> the
# largest value it can hold (2^i - 1); bucket 47 drains as le=+Inf.
BUCKET_BOUNDS = tuple([0.0] + [float((1 << i) - 1)
                               for i in range(1, NUM_BUCKETS - 1)]
                      + [float("inf")])


@functools.lru_cache(maxsize=8)
def _powers(device: torch.device) -> torch.Tensor:
    """``2^0 .. 2^46`` as int64 on ``device``, made there (a shift, not
    a copy from the host)."""
    return torch.ones((NUM_BUCKETS - 1,), dtype=torch.int64,
                      device=device) << torch.arange(
                          NUM_BUCKETS - 1, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=8)
def _bucket_iota(device: torch.device) -> torch.Tensor:
    return torch.arange(NUM_BUCKETS, dtype=torch.int32, device=device)


def hist_zero(device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    return torch.zeros((NUM_HISTS, NUM_BUCKETS + 1), dtype=torch.int64,
                       device=resolve_device(device))


def bucket_index(v: torch.Tensor) -> torch.Tensor:
    """Exact log2 bucket of int64 values (elementwise): 0 for v <= 0,
    else ``floor(log2(v)) + 1`` clipped to 47, as the count of passed
    power-of-two thresholds."""
    v = v.to(torch.int64)
    return torch.sum(v[..., None] >= _powers(v.device), dim=-1,
                     dtype=torch.int32)


def _hist_row(values, mask) -> torch.Tensor:
    """One family's ``[NUM_BUCKETS + 1]`` row from a masked batch of
    observations: bucket counts by an integer scatter-add (exact, so
    equal to the JAX one-hot sum) and the masked value sum.  Negative
    values clamp to bucket 0 and add 0 to the sum."""
    v = torch.clamp(values.to(torch.int64), min=0)
    m = mask.to(torch.int64)
    counts = torch.zeros((NUM_BUCKETS,), dtype=torch.int64,
                         device=v.device).index_add_(
                             0, bucket_index(v).to(torch.int64), m)
    return torch.cat([counts, torch.sum(v * m).reshape(1)])


def _scalar_row(value, weight) -> torch.Tensor:
    """One (possibly weight-0) scalar observation as a family row."""
    v = torch.clamp(value.to(torch.int64), min=0)
    w = weight.to(torch.int64) if torch.is_tensor(weight) else int(weight)
    row = torch.where(_bucket_iota(v.device) == bucket_index(v), w, 0)
    return torch.cat([row, (v * w).reshape(1)])


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.full((), int(x), dtype=torch.int64, device=device)


def hist_observe(h: torch.Tensor, family: int, values, mask
                 ) -> torch.Tensor:
    """Fold a dense masked batch of observations into one family."""
    out = h.clone()
    out[family] += _hist_row(_as_tensor(values, h.device),
                             torch.as_tensor(mask, device=h.device))
    return out


def hist_observe_scalar(h: torch.Tensor, family: int, value, weight
                        ) -> torch.Tensor:
    """One (possibly weight-0) scalar observation -- per-batch values
    like the commit size or a stall duration."""
    out = h.clone()
    out[family] += _scalar_row(_as_tensor(value, h.device), weight)
    return out


def hist_combine(a, b):
    """Merge two histogram blocks (counters add)."""
    return a + b


def hist_fold(h, delta, live):
    """Fold a batch delta gated on liveness (the tag32 dead-batch gate:
    a tripped batch's telemetry must not land).  ``live`` is a 0-d bool
    tensor or the constant True."""
    if live is True:
        return h + delta
    return h + torch.where(live, delta, 0)


def hist_mesh_reduce(h: torch.Tensor) -> torch.Tensor:
    """The JAX package's mesh merge of per-shard histogram blocks (one
    ``psum``: every cell is a counter), over the leading shard axis of
    a stacked ``[S, NUM_HISTS, NUM_BUCKETS + 1]`` block."""
    return h.sum(dim=0)


def hist_dict(h) -> dict:
    """Name a fetched histogram block (host side): per family the
    bucket counts, count, and sum."""
    a = _np64(h)
    out = {}
    for i, name in enumerate(HIST_NAMES):
        counts = a[i, :NUM_BUCKETS]
        out[name] = {"buckets": counts.tolist(),
                     "count": int(counts.sum()),
                     "sum": int(a[i, HIST_SUM_COL])}
    return out


def hist_percentile(h, family: int, q: float) -> float:
    """Percentile estimate from the log2 buckets: the upper bound of the
    bucket where the cumulative count crosses ``q`` (never
    under-reports; within one octave).  0.0 on an empty family."""
    a = _np64(h)
    counts = a[family, :NUM_BUCKETS]
    total = int(counts.sum())
    if total == 0:
        return 0.0
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, q * total, side="left"))
    i = min(i, NUM_BUCKETS - 1)
    if i == 0:
        return 0.0
    # the open top bucket reports its nominal next-octave bound
    return float((1 << (i + 1)) - 1) if i == NUM_BUCKETS - 1 \
        else float((1 << i) - 1)


def hist_mean(h, family: int) -> float:
    a = _np64(h)
    n = int(a[family, :NUM_BUCKETS].sum())
    return float(a[family, HIST_SUM_COL]) / n if n else 0.0


def _np64(x) -> np.ndarray:
    """A tensor (any device) or array as an int64 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def publish_hists(registry, h, prefix: str = "dmclock",
                  labels=None) -> None:
    """Expose a histogram block (a tensor on any device, read back once)
    as Prometheus histogram families (``_bucket``/``_sum``/``_count``)
    through the host registry: get-or-create a fixed-bucket histogram per
    family at the log2 bounds and overwrite its counts (the block is
    itself cumulative per run, so set-not-add is the correct drain)."""
    a = _np64(h)
    for i, name in enumerate(HIST_NAMES):
        m = registry.histogram(
            f"{prefix}_{name}",
            "on-device log2-bucketed QoS histogram "
            "(docs/OBSERVABILITY.md)",
            labels=labels, buckets=BUCKET_BOUNDS)
        m.set_counts(a[i, :NUM_BUCKETS].tolist(),
                     float(a[i, HIST_SUM_COL]))


# ----------------------------------------------------------------------
# per-client conformance ledger
# ----------------------------------------------------------------------

LED_OPS = 0           # decisions served
LED_RESV_OPS = 1      # constraint-phase decisions
LED_LIMIT_BREAKS = 2  # AtLimit::Allow limit-break entries
LED_TARD_SUM = 3      # reservation tardiness sum, ns (entry-head obs)
LED_TARD_MAX = 4      # reservation tardiness max, ns (merge: max)
LED_COLS = 5

LEDGER_COL_NAMES = ("ops", "resv_ops", "limit_breaks",
                    "tardiness_sum_ns", "tardiness_max_ns")

# max-merged columns (host constant; the device copy is made per device)
_LED_MAX_MASK = np.zeros((LED_COLS,), dtype=bool)
_LED_MAX_MASK[LED_TARD_MAX] = True


@functools.lru_cache(maxsize=32)
def col_mask(width: int, cols: tuple, device: torch.device) -> torch.Tensor:
    """A bool ``[width]`` mask with ``cols`` set, made on ``device`` by
    fills (no copy from the host); cached per device."""
    m = torch.zeros((width,), dtype=torch.bool, device=device)
    for c in cols:
        m[c] = True
    return m


def ledger_zero(n: int, device: str | torch.device = DEFAULT_DEVICE
                ) -> torch.Tensor:
    return torch.zeros((n, LED_COLS), dtype=torch.int64,
                       device=resolve_device(device))


def ledger_combine(a, b):
    """Merge two ledgers over the same client set: counter columns add,
    the tardiness max maxes."""
    mask = col_mask(LED_COLS, (LED_TARD_MAX,), a.device)
    return torch.where(mask, torch.maximum(a, b), a + b)


def ledger_fold(led, delta, live):
    """Fold a batch delta gated on liveness (every delta entry is >= 0,
    so a zeroed dead-batch delta is the merge identity)."""
    if live is not True:
        delta = torch.where(live, delta, 0)
    return ledger_combine(led, delta)


def ledger_mesh_reduce(led: torch.Tensor) -> torch.Tensor:
    """The JAX package's mesh merge for replicated client sets (every
    shard holds rows for the same ``[N]`` clients): counter columns
    ``psum``, the max column ``pmax``, over the leading shard axis of a
    stacked ``[S, N, LED_COLS]`` ledger.  Sharded-client layouts
    concatenate instead."""
    mask = col_mask(LED_COLS, (LED_TARD_MAX,), led.device)
    return torch.where(mask, led.max(dim=0).values, led.sum(dim=0))


def ledger_combine_np(acc, *ledgers):
    """Host-side mirror of :func:`ledger_combine` (numpy)."""
    acc = _np64(acc)
    for v in ledgers:
        v = _np64(v)
        acc = np.where(_LED_MAX_MASK, np.maximum(acc, v), acc + v)
    return acc


def ledger_totals(led) -> dict:
    """Column totals of a fetched ledger (host side): counters sum, the
    tardiness max maxes."""
    a = _np64(led)
    return {name: int(a[:, i].max()) if _LED_MAX_MASK[i]
            else int(a[:, i].sum())
            for i, name in enumerate(LEDGER_COL_NAMES)}


def ledger_rows(led, limit: int = None) -> list:
    """Per-client dict rows of a fetched ledger (host side), with the
    derived mean tardiness."""
    a = _np64(led)
    n = a.shape[0] if limit is None else min(limit, a.shape[0])
    rows = []
    for c in range(n):
        r = {"client": c}
        r.update({name: int(a[c, i])
                  for i, name in enumerate(LEDGER_COL_NAMES)})
        r["tardiness_mean_ns"] = (a[c, LED_TARD_SUM]
                                  / max(int(a[c, LED_RESV_OPS]), 1))
        rows.append(r)
    return rows


def publish_ledger(registry, led, prefix: str = "dmclock_ledger",
                   labels=None) -> None:
    """Fold a ledger's column totals (read back once) into a host
    registry as gauges (per-client series would explode the scrape; the
    full table drains through the JSON paths instead)."""
    for name, value in ledger_totals(led).items():
        registry.gauge(f"{prefix}_{name}",
                       "device conformance-ledger column total "
                       "(docs/OBSERVABILITY.md)",
                       labels=labels).set(value)
