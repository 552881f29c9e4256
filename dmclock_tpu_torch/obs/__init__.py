"""Scheduling observability for the PyTorch port: the on-device metrics
vector and the admission clamp (``obs.device``), and the telemetry
accumulators that ride the epoch loops: log2 histograms and the
per-client conformance ledger (``obs.histograms``), the SLO window block
and its host plane (``obs.slo``), the provenance block
(``obs.provenance``) and the flight ring (``obs.flight``); and the host
side: spans, the registry, the bounded JSONL decision trace
(``obs.trace``) and its Chrome trace export (``obs.trace_export``); and
the capacity plane: the device-memory ledger and planner
(``obs.capacity``)."""
