"""Decision provenance plane: device-resident "why" records.

Counterpart of ``dmclock_tpu/obs/provenance.py`` (its module docstring
gives the semantics of every row).  The block rides the three epoch
loops next to the histograms, ledger, flight ring and SLO window, folded
from tensors the batches already hold; decisions are identical with it
on or off.

- ``margin_hist`` (``int64[NUM_BUCKETS + 1]``): log2 histogram (+ sum
  column) of per-record winner margins -- the runner-up's unified key
  minus the winner's for the sorted engines, the distance from a
  client's last unit-entry pack to the committed boundary for the
  calendar engine.  ``-1`` margins observe nothing.
- ``scal`` (``int64[PS_FIELDS]``): per-batch aggregates (limit-gate
  state, eligible depth, winning phase, starvation high-watermark).
- ``last_served`` (``int64[N]``): virtual time of each client's last
  committed serve (the block's creation time until then).

Counter rows add, ``*_MAX`` rows and ``last_served`` max; a dead tag32
batch's observations never land (:func:`prov_select`).  Host side:
:class:`StarvationMonitor` and the per-shard pressure vector
(:func:`pressure_vec`, read by the stream chunk's ``with_pressure``
probe), the mesh's shard helpers (:func:`prov_mesh_reduce`, the
pressure merges, :func:`publish_shard_pressure`) and the registry export
(:func:`publish_provenance`).
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, NamedTuple, Set

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import histograms as obshist

# -- scalar rows -------------------------------------------------------
PS_BATCHES = 0        # live batches observed
PS_GATED_BATCHES = 1  # batches with >= 1 limit-gated client
PS_GATE_SUM = 2       # sum over batches of limit-gated client count
PS_GATE_MAX = 3       # max limit-gated count in one batch  (merge: max)
PS_ELIG_SUM = 4       # sum over batches of eligible-set depth
PS_ELIG_MAX = 5       # max eligible-set depth               (merge: max)
PS_WIN_RESV = 6       # batches won by the constraint phase (min cls 0)
PS_WIN_PROP = 7       # batches won by the weight phase     (min cls 1)
PS_WIN_LB = 8         # batches won by a limit-break        (min cls 2)
PS_STARVE_MAX = 9     # max time-since-service over backlogged clients
#                       at any batch entry, ns               (merge: max)
PS_FIELDS = 10

PS_NAMES = ("batches", "gated_batches", "limit_gate_sum",
            "limit_gate_max", "eligible_depth_sum",
            "eligible_depth_max", "phase_wins_reservation",
            "phase_wins_weight", "phase_wins_limit_break",
            "starvation_max_ns")

_PS_MAX_ROWS = (PS_GATE_MAX, PS_ELIG_MAX, PS_STARVE_MAX)


class ProvBlock(NamedTuple):
    """The device-resident provenance accumulator."""

    margin_hist: torch.Tensor   # int64[NUM_BUCKETS + 1]
    scal: torch.Tensor          # int64[PS_FIELDS]
    last_served: torch.Tensor   # int64[N]; the block-creation baseline
    #                             until the client is served


def prov_init(n: int, now_ns: int = 0,
              device: str | torch.device = DEFAULT_DEVICE) -> ProvBlock:
    """Fresh block.  ``now_ns`` is the baseline ``last_served`` starts
    from: staleness of a never-served client is measured from block
    creation."""
    dev = resolve_device(device)
    return ProvBlock(
        margin_hist=torch.zeros((obshist.NUM_BUCKETS + 1,),
                                dtype=torch.int64, device=dev),
        scal=torch.zeros((PS_FIELDS,), dtype=torch.int64, device=dev),
        last_served=torch.full((n,), int(now_ns), dtype=torch.int64,
                               device=dev))


def _margin_row(margins) -> torch.Tensor:
    """One batch's margin-histogram delta from a masked margin array
    (``-1`` = no observation)."""
    m = margins.to(torch.int64)
    return obshist._hist_row(m, m >= 0)


def _scal_merge(a, b):
    mask = obshist.col_mask(PS_FIELDS, _PS_MAX_ROWS, a.device)
    return torch.where(mask, torch.maximum(a, b), a + b)


def prov_observe(prov: ProvBlock, *, now, elig, gated, win_cls,
                 served_pc, margins=None) -> ProvBlock:
    """Fold one batch/level's observations: ``elig``/``gated`` are bool
    ``[N]`` masks over the batch-entry state (candidates /
    queued-but-non-candidate clients); ``win_cls`` the 0-d min class
    among candidates (CLS_NONE = none); ``served_pc`` ``[N]`` decisions
    committed per client; ``margins`` the per-record margins (``-1`` =
    no observation).  The caller gates liveness with
    :func:`prov_select`."""
    dev = prov.scal.device
    elig_n = torch.sum(elig, dtype=torch.int64)
    gate_n = torch.sum(gated, dtype=torch.int64)
    # staleness read at batch entry, before this batch's serves land
    starve = torch.max(torch.where(elig | gated, now - prov.last_served,
                                   0))
    wins = (win_cls == torch.arange(3, dtype=torch.int32, device=dev)) \
        .to(torch.int64)
    one = torch.ones((1,), dtype=torch.int64, device=dev)
    delta = torch.cat([one, torch.stack([
        (gate_n > 0).to(torch.int64), gate_n, gate_n, elig_n, elig_n]),
        wins, starve.reshape(1)])
    hist = prov.margin_hist if margins is None \
        else prov.margin_hist + _margin_row(margins)
    last = torch.where(served_pc > 0, now, prov.last_served)
    return ProvBlock(margin_hist=hist, scal=_scal_merge(prov.scal, delta),
                     last_served=last)


def prov_select(live, new: ProvBlock, old: ProvBlock) -> ProvBlock:
    """Whole-block liveness gate (the tag32 dead-batch rule): a dead
    batch's observations, its ``last_served`` writes included, never
    land.  ``live`` is a 0-d bool tensor or the constant True."""
    if live is True:
        return new
    return ProvBlock(*(torch.where(live, a, b) for a, b in zip(new, old)))


def prov_combine(a: ProvBlock, b: ProvBlock) -> ProvBlock:
    """Merge two blocks over the same client set: histogram and counter
    rows add, ``*_MAX`` rows and ``last_served`` max."""
    return ProvBlock(margin_hist=a.margin_hist + b.margin_hist,
                     scal=_scal_merge(a.scal, b.scal),
                     last_served=torch.maximum(a.last_served,
                                               b.last_served))


def prov_mesh_reduce(p: ProvBlock) -> ProvBlock:
    """The JAX package's mesh merge for replicated client sets over a
    stacked block (every leaf with a leading shard axis): histogram and
    counter rows sum, ``*_MAX`` rows and ``last_served`` max."""
    mask = obshist.col_mask(PS_FIELDS, _PS_MAX_ROWS, p.scal.device)
    return ProvBlock(
        margin_hist=p.margin_hist.sum(dim=0),
        scal=torch.where(mask, p.scal.max(dim=0).values,
                         p.scal.sum(dim=0)),
        last_served=p.last_served.max(dim=0).values)


def prov_from_arrays(margin_hist, scal, last_served, *,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> ProvBlock:
    """Rebuild a ProvBlock from numpy leaves on ``device``."""
    dev = resolve_device(device)
    return ProvBlock(*(torch.from_numpy(np.asarray(x, dtype=np.int64))
                       .to(dev) for x in (margin_hist, scal, last_served)))


# ----------------------------------------------------------------------
# host side: percentiles, dict views
# ----------------------------------------------------------------------

def margin_percentile(prov, q: float) -> float:
    """Margin percentile from the log2 buckets (bucket upper bound)."""
    h = obshist._np64(getattr(prov, "margin_hist", prov))
    block = np.zeros((obshist.NUM_HISTS, obshist.NUM_BUCKETS + 1),
                     dtype=np.int64)
    block[0] = h
    return obshist.hist_percentile(block, 0, q)


def prov_dict(prov) -> dict:
    """Name a fetched block (host side): the scalar rows plus the
    derived margin percentiles and the limit-gate share."""
    scal = obshist._np64(prov.scal)
    out = {name: int(scal[i]) for i, name in enumerate(PS_NAMES)}
    batches = max(out["batches"], 1)
    out["limit_gate_share"] = out["gated_batches"] / batches
    out["eligible_depth_mean"] = out["eligible_depth_sum"] / batches
    out["margin_p50_ns"] = margin_percentile(prov, 0.50)
    out["margin_p99_ns"] = margin_percentile(prov, 0.99)
    h = obshist._np64(prov.margin_hist)
    n = int(h[:obshist.NUM_BUCKETS].sum())
    out["margin_count"] = n
    out["margin_mean_ns"] = float(h[obshist.HIST_SUM_COL]) / n \
        if n else 0.0
    return out


def stale_clients(prov, now_ns: int, threshold_ns: int,
                  backlog=None) -> List[dict]:
    """Clients whose time-since-service exceeds ``threshold_ns`` at
    ``now_ns``, worst first; ``backlog`` (optional ``[N]``) restricts to
    clients with queued work."""
    last = obshist._np64(prov.last_served)
    stale = np.int64(now_ns) - last
    mask = stale > threshold_ns
    if backlog is not None:
        mask &= obshist._np64(backlog) > 0
    rows = [{"client": int(c), "stale_ns": int(stale[c]),
             "last_served_ns": int(last[c])} for c in np.nonzero(mask)[0]]
    rows.sort(key=lambda r: -r["stale_ns"])
    return rows


def publish_provenance(registry, prov, labels=None) -> None:
    """Fold a block (read back once) into a host registry:
    ``dmclock_provenance_*`` gauges (margin percentiles, gate share,
    eligible depth, phase wins) and the ``dmclock_starvation_max_ns``
    watermark."""
    d = prov_dict(prov)
    for key in ("margin_p50_ns", "margin_p99_ns", "limit_gate_share",
                "eligible_depth_mean", "eligible_depth_max",
                "phase_wins_reservation", "phase_wins_weight",
                "phase_wins_limit_break"):
        registry.gauge(f"dmclock_provenance_{key}",
                       "decision provenance plane scalar "
                       "(docs/OBSERVABILITY.md)",
                       labels=labels).set(float(d[key]))
    registry.gauge("dmclock_starvation_max_ns",
                   "max time-since-service over backlogged clients "
                   "observed at any batch entry (provenance plane)",
                   labels=labels).set(float(d["starvation_max_ns"]))


def _stderr_log(line: str) -> None:
    print(line, file=sys.stderr)


class StarvationMonitor:
    """Once-per-episode ``client_starved`` warnings over the provenance
    watermark: fires on the rising edge of ``now - last_served >
    threshold_ns`` per backlogged client and re-arms when the client is
    served again.  Warnings route through a watchdog's
    ``external_warning`` hook when one is attached (one warning stream
    and counter for the run), else ``log`` gets a ``# starvation:`` JSON
    line.  With a registry (``registry=`` or :meth:`attach_registry`)
    the episodes count in ``dmclock_starvation_episodes_total`` and each
    pass sets the worst staleness and the stale-client gauges."""

    def __init__(self, threshold_ns: int, *, watchdog=None,
                 registry=None,
                 log: Callable[[str], None] = _stderr_log):
        self.threshold_ns = int(threshold_ns)
        self._watchdog = watchdog
        self._log = log
        self.active: Set[int] = set()
        self.fired: List[dict] = []
        self.episodes_total = 0
        self._counter = None
        self._max_gauge = None
        self._stale_gauge = None
        if registry is not None:
            self.attach_registry(registry)

    def attach_registry(self, registry) -> None:
        self._counter = registry.counter(
            "dmclock_starvation_episodes_total",
            "client_starved episodes fired (once per episode; "
            "provenance plane, docs/OBSERVABILITY.md)")
        self._max_gauge = registry.gauge(
            "dmclock_starvation_max_ns",
            "max time-since-service over backlogged clients "
            "(provenance plane)")
        self._stale_gauge = registry.gauge(
            "dmclock_starvation_stale_clients",
            "backlogged clients currently past the starvation "
            "threshold (provenance plane)")

    def observe(self, prov, now_ns: int, backlog=None) -> List[dict]:
        """One drain-point pass; returns the warnings fired."""
        rows = stale_clients(prov, now_ns, self.threshold_ns,
                             backlog=backlog)
        over = {r["client"] for r in rows}
        self.active &= over
        out = []
        for r in rows:
            if r["client"] in self.active:
                continue
            self.active.add(r["client"])
            w = {"kind": "client_starved", **r,
                 "threshold_ns": self.threshold_ns}
            out.append(w)
            self.fired.append(w)
            self.episodes_total += 1
            if self._counter is not None:
                self._counter.inc()
            if self._watchdog is not None:
                self._watchdog.external_warning(w)
            else:
                self._log("# starvation: "
                          + json.dumps(w, separators=(",", ":")))
        if self._max_gauge is not None:
            worst = rows[0]["stale_ns"] if rows else 0
            self._max_gauge.set(float(worst))
            self._stale_gauge.set(float(len(over)))
        return out


# ----------------------------------------------------------------------
# the pressure vector (the stream chunk's with_pressure probe)
# ----------------------------------------------------------------------

PRESS_ELIG = 0       # live eligible-set depth            (merge: add)
PRESS_BACKLOG = 1    # queued requests across clients     (merge: add)
PRESS_ELIG_PEAK = 2  # peak eligible depth                (merge: max)
PRESS_WAIT_WM = 3    # head-wait starvation watermark, ns (merge: max)
PRESS_FIELDS = 4

PRESS_NAMES = ("eligible_live", "backlog", "eligible_peak",
               "head_wait_max_ns")


def pressure_vec(engine_state, now) -> torch.Tensor:
    """One server's pressure vector (``int64[PRESS_FIELDS]``) from its
    state: candidates at ``now`` (limit-break allowed), backlog, the
    same depth as the peak, and ``max(now - head_arrival)`` over queued
    heads."""
    from ..engine import fastpath

    st = engine_state
    cls, _key = fastpath._classify(st, now, True)
    elig = torch.sum(cls != fastpath.CLS_NONE, dtype=torch.int64)
    has_req = st.active & (st.depth > 0)
    backlog = torch.sum(torch.where(has_req, st.depth, 0),
                        dtype=torch.int64)
    wait = torch.max(torch.where(
        has_req, torch.clamp(now - st.head_arrival, min=0), 0))
    return torch.stack([elig, backlog, elig, wait])


_PRESS_MAX_ROWS = (PRESS_ELIG_PEAK, PRESS_WAIT_WM)


def pressure_combine_axis(mat: torch.Tensor) -> torch.Tensor:
    """Reduce stacked ``[S, PRESS_FIELDS]`` vectors along the leading
    axis (counters add, peaks max)."""
    mask = obshist.col_mask(PRESS_FIELDS, _PRESS_MAX_ROWS, mat.device)
    return torch.where(mask, mat.max(dim=0).values, mat.sum(dim=0))


def pressure_mesh_reduce(mat: torch.Tensor) -> torch.Tensor:
    """The JAX package's mesh merge of per-shard pressure vectors
    (counters ``psum``, peaks ``pmax``): on one card,
    :func:`pressure_combine_axis` over the stacked shards."""
    return pressure_combine_axis(mat)


def pressure_dict(vec) -> dict:
    v = obshist._np64(vec).reshape(-1)
    return {name: int(v[i]) for i, name in enumerate(PRESS_NAMES)}


def publish_shard_pressure(registry, per_shard, merged=None) -> None:
    """Publish a ``[S, PRESS_FIELDS]`` per-shard matrix (plus the
    optional merged total) as ``dmclock_shard_pressure_*`` gauges
    labelled by shard."""
    mat = obshist._np64(per_shard)
    if mat.ndim == 1:
        mat = mat[None]
    for s in range(mat.shape[0]):
        for i, name in enumerate(PRESS_NAMES):
            registry.gauge(
                f"dmclock_shard_pressure_{name}",
                "per-shard scheduling pressure (provenance plane; "
                "docs/OBSERVABILITY.md)",
                labels={"shard": str(s)}).set(float(mat[s, i]))
    if merged is not None:
        vec = obshist._np64(merged).reshape(-1)
        for i, name in enumerate(PRESS_NAMES):
            registry.gauge(
                f"dmclock_shard_pressure_{name}",
                "mesh-merged scheduling pressure (provenance plane)",
                labels={"shard": "all"}).set(float(vec[i]))
