"""Static device-memory ledger, capacity planner, roofline attributor.

Counterpart of ``dmclock_tpu/obs/capacity.py``.  Three questions:

1. **How many device bytes does a configuration pin?**
   :func:`hbm_ledger` walks the resident tensors per subsystem -- the
   ``EngineState`` client block and its rings, the telemetry
   histograms and ledger, the flight ring, the SLO window block, the
   lifecycle slot map -- and the epoch's own output blocks.  The state
   and accumulators are built by the port's own constructors on
   ``device="meta"``, which allocates no storage; the output blocks
   come from the tensors of one real epoch of the port's
   ``epoch_scan_fn`` on the CPU at that ``n`` (state and accumulator
   echoes excluded), so the ledger cannot drift from the code.
2. **How many clients fit a card?**  Every subsystem is linear in N,
   so :func:`capacity_model` fits the exact line from two ledgers (n =
   256 and 512) and :func:`plan_capacity` inverts it against a budget
   (:func:`device_hbm_budget`: the card's total memory;
   ``DMCLOCK_HBM_BUDGET_BYTES`` overrides; None on the CPU).
3. **Is a workload compute-, memory- or dispatch-bound?**
   :func:`classify` joins operation and byte counts with measured
   dispatch and device times against the card's peaks
   (:func:`device_peaks`, an H100 entry only).

The JAX bench row's compile-plane fields (``compile_ms_total``,
``retraces``) have no counterpart: the port compiles nothing per shape.
Everything here is host arithmetic over shapes and cannot move a
decision.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

_META = torch.device("meta")


def leaf_bytes(leaf) -> int:
    """Logical bytes of one tensor or array leaf; 0 for None and for
    objects without a shape and dtype."""
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return 0
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize


def tree_bytes(tree) -> int:
    """Bytes of every leaf of a tensor, a NamedTuple/tuple/list/dict
    tree, or None."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return leaf_bytes(tree)


def abstract_state(n: int, ring: int):
    """``EngineState`` tensors for (n, ring) on the meta device: shapes
    and dtypes without a byte of storage."""
    from ..engine.state import init_state

    return init_state(n, ring, device=_META)


def _tele(n: int, device, *, telemetry: bool, slo: bool,
          flight_records: int) -> dict:
    """The telemetry accumulators on ``device``, by the real
    constructors."""
    out = {}
    if telemetry:
        from . import histograms as obshist
        out["hists"] = obshist.hist_zero(device)
        out["ledger"] = obshist.ledger_zero(n, device)
    if flight_records:
        from . import flight as obsflight
        out["flight"] = obsflight.flight_init(flight_records, device)
    if slo:
        from . import slo as obsslo
        out["slo"] = obsslo.window_zero(n, device)
    return out


def _epoch_output_bytes(n: int, ring: int, engine: str, m: int,
                        tele: dict, kw: dict) -> int:
    """Bytes of one real epoch's output blocks (state and accumulator
    echoes excluded: they alias their inputs), run on the CPU on a
    fresh state."""
    from ..engine import fastpath
    from ..engine.state import init_state

    st = init_state(n, ring, device="cpu")
    ep = fastpath.epoch_scan_fn(engine)(st, 0, m=m, **kw, **tele)
    skip = {"state", "hists", "ledger", "flight", "slo"}
    return sum(tree_bytes(getattr(ep, f)) for f in ep._fields
               if f not in skip)


def hbm_ledger(n: int, *, ring: int = 64, engine: Optional[str] = None,
               m: int = 0, k: int = 0, chain_depth: int = 4,
               select_impl: str = "sort", tag_width: int = 64,
               window_m: Optional[int] = None,
               calendar_impl: str = "minstop", ladder_levels: int = 8,
               telemetry: bool = False, slo: bool = False,
               flight_records: int = 0, lifecycle: bool = False,
               stream_chunk: int = 0) -> Dict[str, int]:
    """Per-subsystem resident device bytes for one configuration.

    Subsystems: ``client_state`` (the [N] fields), ``rings`` (the
    [N, Q] int64 pair), ``telemetry_hists`` / ``telemetry_ledger`` /
    ``flight`` / ``slo_window`` (each when enabled), ``lifecycle`` (the
    resident slot map) and, with ``engine`` and ``m``, ``epoch_outputs``:
    the epoch's decision and metric blocks.  ``stream_chunk`` > 1
    multiplies the output blocks (a chunk stacks its epochs'
    outputs)."""
    st = abstract_state(n, ring)
    rings = leaf_bytes(st.q_arrival) + leaf_bytes(st.q_cost)
    out: Dict[str, int] = {
        "client_state": tree_bytes(st) - rings,
        "rings": rings,
    }
    tele = _tele(n, _META, telemetry=telemetry, slo=slo,
                 flight_records=flight_records)
    if "hists" in tele:
        out["telemetry_hists"] = tree_bytes(tele["hists"])
        out["telemetry_ledger"] = tree_bytes(tele["ledger"])
    if "flight" in tele:
        out["flight"] = tree_bytes(tele["flight"])
    if "slo" in tele:
        out["slo_window"] = tree_bytes(tele["slo"])
    if lifecycle:
        # the resident slot map (client id <-> slot); the boundary op
        # vectors are transient call arguments
        out["lifecycle"] = n * np.dtype(np.int64).itemsize
    if engine and m > 0:
        from ..engine import fastpath

        kw = fastpath.epoch_scan_kwargs(
            engine, k=k, chain_depth=chain_depth,
            select_impl=select_impl, tag_width=tag_width,
            window_m=window_m, calendar_impl=calendar_impl,
            ladder_levels=ladder_levels, with_metrics=True)
        blocks = _epoch_output_bytes(
            n, ring, engine, m,
            _tele(n, "cpu", telemetry=telemetry, slo=slo,
                  flight_records=flight_records), kw)
        out["epoch_outputs"] = blocks * max(stream_chunk, 1)
    return out


def projected_total(ledger: Dict[str, int]) -> int:
    return int(sum(ledger.values()))


class CapacityModel:
    """The exact per-subsystem linear model bytes(N) = a*N + b, fitted
    from two ledgers (every subsystem is linear in N)."""

    def __init__(self, slopes: Dict[str, float],
                 intercepts: Dict[str, float]):
        self.slopes = slopes
        self.intercepts = intercepts

    @property
    def bytes_per_client(self) -> float:
        return float(sum(self.slopes.values()))

    @property
    def fixed_bytes(self) -> float:
        return float(sum(self.intercepts.values()))

    def ledger(self, n: int) -> Dict[str, int]:
        return {s: int(round(self.slopes[s] * n + self.intercepts[s]))
                for s in self.slopes}

    def total(self, n: int) -> int:
        return projected_total(self.ledger(n))


_MODEL_N0, _MODEL_N1 = 256, 512
_MODEL_CACHE: Dict[tuple, CapacityModel] = {}


def capacity_model(**cfg) -> CapacityModel:
    """Fit the linear model for one knob setting (cached per setting:
    each fit runs two CPU epochs)."""
    key = tuple(sorted(cfg.items()))
    model = _MODEL_CACHE.get(key)
    if model is None:
        l0 = hbm_ledger(_MODEL_N0, **cfg)
        l1 = hbm_ledger(_MODEL_N1, **cfg)
        dn = _MODEL_N1 - _MODEL_N0
        slopes = {s: (l1[s] - l0[s]) / dn for s in l0}
        inter = {s: l0[s] - slopes[s] * _MODEL_N0 for s in l0}
        model = _MODEL_CACHE[key] = CapacityModel(slopes, inter)
    return model


def projected_hbm(n: int, **cfg) -> int:
    """Projected resident device bytes for ``n`` clients at this knob
    setting (the row's ``projected_hbm_bytes``)."""
    return capacity_model(**cfg).total(n)


def plan_capacity(budget_bytes: Optional[int] = None, *,
                  slack_frac: float = 0.1, device=None, **cfg) -> dict:
    """Invert the ledger: max clients per card for a budget and a knob
    setting.  ``budget_bytes`` defaults to :func:`device_hbm_budget`
    (ValueError when neither is known).  ``slack_frac`` reserves
    headroom for temporaries and the allocator's own use."""
    if budget_bytes is None:
        budget_bytes = device_hbm_budget(device)
        if budget_bytes is None:
            raise ValueError(
                "no device memory budget: pass budget_bytes, set "
                "DMCLOCK_HBM_BUDGET_BYTES, or run on the card")
    model = capacity_model(**cfg)
    usable = int(budget_bytes * (1.0 - slack_frac))
    per = model.bytes_per_client
    n = int(max((usable - model.fixed_bytes) // max(per, 1e-9), 0))
    while n > 0 and model.total(n) > usable:
        n -= 1
    return {
        "max_clients": n,
        "budget_bytes": int(budget_bytes),
        "usable_bytes": usable,
        "slack_frac": slack_frac,
        "bytes_per_client": per,
        "fixed_bytes": model.fixed_bytes,
        "projected_bytes": model.total(n),
        "ledger": model.ledger(n),
        "config": dict(cfg),
    }


def fits(n: int, budget_bytes: int, *, slack_frac: float = 0.1,
         **cfg) -> bool:
    """Does an ``n``-client configuration fit the budget, with the
    planner's slack?  ``fits(plan_capacity(b)["max_clients"], b)`` is
    True and any larger N refuses."""
    return projected_hbm(n, **cfg) <= int(budget_bytes
                                          * (1.0 - slack_frac))


def device_hbm_budget(device=None) -> Optional[int]:
    """The card's memory budget in bytes: its total memory
    (``torch.cuda.get_device_properties(...).total_memory``).
    ``DMCLOCK_HBM_BUDGET_BYTES`` overrides (0 disables detection); a
    CPU device, or no card, gives None."""
    env = os.environ.get("DMCLOCK_HBM_BUDGET_BYTES")
    if env:
        try:
            return int(env) or None
        except ValueError:
            pass
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


# ----------------------------------------------------------------------
# roofline attribution
# ----------------------------------------------------------------------

# variant -> (peak CUDA-core float32 ops/s, peak memory bytes/s), by the
# card's name: NVIDIA's H100 data sheet, at the full power limit.  The
# scheduler's work is integer compare/select on the CUDA cores, so the
# CUDA-core rate stands for its peak; the classification reads the
# ridge (ops per byte), not a utilization.
H100_PEAKS = {
    "SXM": (67e12, 3.35e12),
    "PCIe": (51e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
}
_UNKNOWN_PEAKS = {"label": "unknown", "peak_flops": 1e14,
                  "peak_bytes_per_s": 1e12}


def device_peaks(device=None) -> dict:
    """Peak ops/s and memory bytes/s of the attached H100, by the
    variant its name gives (an H100 without "PCIe" or "NVL" in its name
    is the SXM part); an unknown label and nominal peaks elsewhere."""
    dev = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (dev is not None
                                         and dev.type != "cuda"):
        return dict(_UNKNOWN_PEAKS)
    name = torch.cuda.get_device_name(dev)
    if "H100" not in name:
        return dict(_UNKNOWN_PEAKS, label=name)
    variant = next((v for v in ("NVL", "PCIe") if v in name), "SXM")
    ops, bw = H100_PEAKS[variant]
    return {"label": f"H100 {variant}", "device_name": name,
            "peak_flops": ops, "peak_bytes_per_s": bw}


def classify(*, flops: float, bytes_accessed: float,
             device_time_s: Optional[float] = None,
             dispatch_time_s: Optional[float] = None,
             peak_flops: Optional[float] = None,
             peak_bytes_per_s: Optional[float] = None,
             dispatch_share_warn: float = 0.5) -> dict:
    """The classification rule:

    1. with measured times, a dispatch share of (dispatch + device)
       past ``dispatch_share_warn`` -> ``dispatch_bound``;
    2. otherwise arithmetic intensity (ops / bytes) against the machine
       balance (peak ops / peak bandwidth): below -> ``memory_bound``,
       at or above -> ``compute_bound``;
    3. no ops and no bytes -> ``unknown``."""
    if peak_flops is None or peak_bytes_per_s is None:
        pk = device_peaks()
        peak_flops = peak_flops or pk["peak_flops"]
        peak_bytes_per_s = peak_bytes_per_s or pk["peak_bytes_per_s"]
    out: dict = {"peak_flops": peak_flops,
                 "peak_bytes_per_s": peak_bytes_per_s,
                 "machine_balance": peak_flops / peak_bytes_per_s}
    if device_time_s is not None and dispatch_time_s is not None \
            and (device_time_s + dispatch_time_s) > 0:
        share = dispatch_time_s / (device_time_s + dispatch_time_s)
        out["dispatch_share"] = share
        if share > dispatch_share_warn:
            out["bound_class"] = "dispatch_bound"
            return out
    if not flops and not bytes_accessed:
        out["bound_class"] = "unknown"
        return out
    ai = flops / max(bytes_accessed, 1.0)
    out["arithmetic_intensity"] = ai
    if device_time_s:
        out["achieved_flops_per_s"] = flops / device_time_s
        out["achieved_bytes_per_s"] = bytes_accessed / device_time_s
    out["bound_class"] = "compute_bound" \
        if ai >= out["machine_balance"] else "memory_bound"
    return out


def classify_bench_row(row: dict, *, peaks: Optional[dict] = None,
                       dispatch_share_warn: float = 0.5) -> dict:
    """Roofline verdict for one row: its ``cost_analysis`` (per-launch
    ops/bytes) joined with its ``spans`` block's per-launch dispatch and
    device times when spans ran; without spans, intensity only."""
    ca = row.get("cost_analysis") or {}
    sp = row.get("spans") or {}
    kw: dict = dict(flops=float(ca.get("flops", 0.0)),
                    bytes_accessed=float(ca.get("bytes_accessed", 0.0)),
                    dispatch_share_warn=dispatch_share_warn)
    if "device_ms_per_launch" in sp and "dispatch_ms_per_launch" in sp:
        kw["device_time_s"] = sp["device_ms_per_launch"] / 1e3
        kw["dispatch_time_s"] = sp["dispatch_ms_per_launch"] / 1e3
    if peaks:
        kw["peak_flops"] = peaks.get("peak_flops")
        kw["peak_bytes_per_s"] = peaks.get("peak_bytes_per_s")
    return classify(**kw)


def publish_capacity_metrics(registry, *, projected_bytes=None,
                             budget_bytes=None, max_clients=None,
                             workload: Optional[str] = None) -> None:
    """``dmclock_capacity_*`` gauges on the scrape endpoint."""
    lbl = {"workload": workload} if workload else None
    if projected_bytes is not None:
        registry.gauge(
            "dmclock_capacity_projected_hbm_bytes",
            "projected resident device bytes for the workload's knob "
            "setting (obs.capacity ledger)", labels=lbl) \
            .set(float(projected_bytes))
    if budget_bytes is not None:
        registry.gauge(
            "dmclock_capacity_budget_bytes",
            "detected device memory budget (total memory or "
            "DMCLOCK_HBM_BUDGET_BYTES)").set(float(budget_bytes))
    if max_clients is not None:
        registry.gauge(
            "dmclock_capacity_max_clients",
            "plan_capacity() max clients per card at the current budget "
            "and knob setting", labels=lbl).set(float(max_clients))


def capacity_row(out: dict, cap_cfg: dict) -> dict:
    """Fold the capacity record into a result row: the projected
    resident bytes for its knob setting (a failure degrades to a note,
    never eats the row).  The JAX row's roofline verdict is left out:
    it joins the row's ``cost_analysis`` and span times, which no row
    of the port records, so it could only say ``unknown``."""
    try:
        cfg = dict(cap_cfg)
        out["projected_hbm_bytes"] = projected_hbm(cfg.pop("n"), **cfg)
    except (ValueError, RuntimeError) as e:
        out["projected_hbm_error"] = f"{type(e).__name__}: {e}"
    return out
