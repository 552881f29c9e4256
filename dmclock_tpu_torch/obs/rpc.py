"""``dmclock_rpc_*`` metric families (docs/OBSERVABILITY.md; the port's
copy of ``dmclock_tpu/obs/rpc.py``, on the port's registry).

The ingest front-end's scrape surface: admission/backpressure/chaos
counters from :class:`net.server.IngestServer`, per-shard routed-ops
attribution (PlacementMap ownership), and the host-side admission-
to-commit latency summary the serving loop measures at each chunk
boundary.  All host-side, all advisory: nothing here participates
in the chain digest.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

_HELP = "RPC ingest front-end (docs/RPC.md; docs/OBSERVABILITY.md)"

#: server counter -> metric suffix (``dmclock_rpc_<suffix>``)
COUNTER_FAMILIES = {
    "requests": "requests_total",
    "admitted_reqs": "admitted_requests_total",
    "admitted_ops": "admitted_ops_total",
    "deduped": "deduped_total",
    "busy": "busy_total",
    "drops_injected": "chaos_drops_total",
    "dup_frames": "chaos_dups_total",
    "reordered": "chaos_reorders_total",
    "proto_errors": "protocol_errors_total",
    "conns_opened": "connections_opened_total",
    "conns_timed_out": "connections_timed_out_total",
    "notify_batches": "notify_batches_total",
    "device_drop_signals": "device_drop_signals_total",
    "datagrams": "datagrams_total",
}


def publish_rpc(registry, status: dict) -> None:
    """Publish one :meth:`IngestServer.status` snapshot.  Fail-soft
    by caller convention (the serving loop wraps this in the same
    best-effort guard every other publisher gets)."""
    if registry is None:
        return
    counters = status.get("counters", {})
    for key, suffix in COUNTER_FAMILIES.items():
        registry.gauge(f"dmclock_rpc_{suffix}", _HELP) \
            .set(float(counters.get(key, 0)))
    registry.gauge("dmclock_rpc_notify_oversized_total", _HELP) \
        .set(float(status.get("notify_oversized", 0)))
    registry.gauge("dmclock_rpc_queue_depth", _HELP) \
        .set(float(status.get("queue_depth", 0)))
    registry.gauge("dmclock_rpc_connections_live", _HELP) \
        .set(float(status.get("connections", 0)))
    registry.gauge("dmclock_rpc_backpressure_engaged", _HELP) \
        .set(1.0 if status.get("device_pressure") else 0.0)
    for shard, ops in status.get("shard_rx", {}).items():
        registry.gauge("dmclock_rpc_shard_routed_ops_total", _HELP,
                       labels={"shard": str(shard)}).set(float(ops))


def latency_summary(samples_ns: Sequence[int]) -> Dict[str, float]:
    """p50/p99/max of admission-to-commit latencies in milliseconds
    (empty -> zeros; the bench guard's warn-only series reads the
    p99)."""
    if not samples_ns:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0,
                "samples": 0}
    a = np.asarray(samples_ns, dtype=np.float64) / 1e6
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()), "samples": int(a.size)}


def publish_rpc_latency(registry,
                        summary: Optional[Dict[str, float]]) -> None:
    if registry is None or not summary:
        return
    for key in ("p50_ms", "p99_ms", "max_ms"):
        registry.gauge(f"dmclock_rpc_admit_to_commit_{key}", _HELP) \
            .set(float(summary.get(key, 0.0)))
