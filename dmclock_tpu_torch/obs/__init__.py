"""Scheduling observability for the PyTorch port: the on-device metrics
vector and the admission clamp (``obs.device``), and the telemetry
accumulators that ride the epoch loops: log2 histograms and the
per-client conformance ledger (``obs.histograms``), the SLO window block
and its host plane (``obs.slo``), the provenance block
(``obs.provenance``) and the flight ring (``obs.flight``); and the host
side: spans, the tracing watchdog (``obs.watchdog``), the registry and
the publishers into it, the burn-rate evaluator (``obs.alerts``), the
bounded JSONL decision trace (``obs.trace``) and its Chrome trace export
(``obs.trace_export``); and the capacity plane: the device-memory ledger
and planner (``obs.capacity``) and its time axis, the kernel build
records and the cost counter (``obs.compile_plane``)."""

from . import compile_plane
from .compile_plane import CompilePlane, publish_compile_metrics
from .compile_plane import plane as compile_plane_singleton

__all__ = ["CompilePlane", "compile_plane", "compile_plane_singleton",
           "publish_compile_metrics"]
