"""Host-side metrics registry and its HTTP endpoint.

Counterpart of ``dmclock_tpu/obs/registry.py`` (stdlib only): counters,
gauges (optionally callback-backed, read at drain time), fixed-bucket
histograms, and summaries over ``utils.profile`` timers.  Two drains:
``prometheus()`` (text exposition format 0.0.4, byte for byte the JAX
package's for the same metrics) and ``snapshot()`` (a JSON-able dict).
``MetricsHTTPServer`` serves both on a background thread, with
path-prefixed sub-APIs mounted beside them (the lifecycle plane's admin
API, ``lifecycle.api``).

Durations are exposed in nanoseconds with an explicit ``_ns`` unit in
the metric name, like the tag algebra.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.profile import ProfileCombiner, _ProfileBase

_DEFAULT_BUCKETS = (1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, float("inf"))


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    """Common name/help/labels plumbing."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_text
        self.labels = dict(labels or {})

    def sample_rows(self) -> List[Tuple[str, Dict[str, str], float]]:
        """(suffix, extra labels, value) rows for exposition."""
        raise NotImplementedError

    def value_obj(self):
        """JSON-able value for ``snapshot()``."""
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name, help_text="", labels=None):
        super().__init__(name, help_text, labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        assert n >= 0, "counters only go up"
        self._value += n

    @property
    def value(self):
        return self._value

    def sample_rows(self):
        return [("", {}, self._value)]

    def value_obj(self):
        return self._value


class Gauge(_Metric):
    """Point-in-time value; ``set_function`` makes it callback-backed
    (read lazily at drain time -- zero hot-path cost)."""

    kind = "gauge"

    def __init__(self, name, help_text="", labels=None):
        super().__init__(name, help_text, labels)
        self._value = 0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v) -> None:
        self._value = v

    def inc(self, n=1) -> None:
        self._value += n

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._value

    def sample_rows(self):
        return [("", {}, self.value)]

    def value_obj(self):
        return self.value


class Histogram(_Metric):
    """Fixed upper-bound buckets (cumulative, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name, help_text="", labels=None,
                 buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        b = sorted(float(x) for x in buckets)
        if not b or b[-1] != float("inf"):
            b.append(float("inf"))
        self.buckets = tuple(b)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break

    def set_counts(self, counts, sum_value: float) -> None:
        """Overwrite the per-bucket counts wholesale -- the drain for
        device-accumulated histograms (``obs.histograms``), whose
        blocks are already cumulative per run: re-observing them would
        double-count, so the publisher SETS."""
        assert len(counts) == len(self.buckets), \
            f"{len(counts)} counts for {len(self.buckets)} buckets"
        self.counts = [int(c) for c in counts]
        self.sum = float(sum_value)
        self.count = sum(self.counts)

    def sample_rows(self):
        rows = []
        cum = 0
        for ub, c in zip(self.buckets, self.counts):
            cum += c
            rows.append(("_bucket", {"le": _fmt_value(ub)}, cum))
        rows.append(("_sum", {}, self.sum))
        rows.append(("_count", {}, self.count))
        return rows

    def value_obj(self):
        return {"buckets": {_fmt_value(ub): c for ub, c
                            in zip(self.buckets, self.counts)},
                "sum": self.sum, "count": self.count}


class TimerMetric(_Metric):
    """Summary view over one or more ``utils.profile`` accumulators
    (``ProfileTimer`` / ``ProfileCombiner``).  Multiple sources are
    merged at drain time with ``ProfileCombiner`` -- the reference's
    multi-thread merge semantics (profile.h:100-120) -- so registering
    each server's timer under one name yields the combined stats."""

    kind = "summary"

    def __init__(self, name, help_text="", labels=None):
        super().__init__(name, help_text, labels)
        self._sources: List[_ProfileBase] = []

    def add_source(self, timer: _ProfileBase) -> None:
        self._sources.append(timer)

    def _combined(self) -> ProfileCombiner:
        comb = ProfileCombiner()
        for t in self._sources:
            comb.combine(t)
        return comb

    def _reentries(self) -> int:
        """Reentrant start() calls across the sources (ProfileTimer
        counts them when a running timer is restarted -- the abandoned
        in-flight interval deflates count/sum, so the stat must be
        VISIBLE at the drain or the discard stays silent)."""
        return sum(getattr(t, "reentries", 0) for t in self._sources)

    def sample_rows(self):
        c = self._combined()
        return [("_count", {}, c.count),
                ("_sum", {}, c.sum_ns),
                ("_min", {}, c.low_ns or 0),
                ("_max", {}, c.high_ns or 0),
                ("_mean", {}, c.mean_ns()),
                ("_stddev", {}, c.std_dev_ns()),
                ("_reentries", {}, self._reentries())]

    def value_obj(self):
        c = self._combined()
        return {"count": c.count, "sum_ns": c.sum_ns,
                "min_ns": c.low_ns or 0, "max_ns": c.high_ns or 0,
                "mean_ns": c.mean_ns(), "stddev_ns": c.std_dev_ns(),
                "reentries": self._reentries()}


class MetricsRegistry:
    """Get-or-create registry keyed by (name, labels).

    All factories are idempotent: asking for an existing
    (name, labels) pair returns the live instance, so independent
    modules can share counters without plumbing objects around.
    """

    def __init__(self):
        self._mtx = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], _Metric] = {}

    def _get_or_create(self, cls, name, help_text, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._mtx:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help_text, labels, **kw)
                self._metrics[key] = m
            else:
                assert isinstance(m, cls), \
                    f"{name} already registered as {m.kind}"
            return m

    def counter(self, name, help_text="", labels=None) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", labels=None) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name, help_text="", labels=None,
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets=buckets)

    def timer(self, name, help_text="", labels=None,
              source: Optional[_ProfileBase] = None) -> TimerMetric:
        t = self._get_or_create(TimerMetric, name, help_text, labels)
        if source is not None and source not in t._sources:
            t.add_source(source)
        return t

    # -- drains --------------------------------------------------------
    def metrics(self) -> List[_Metric]:
        with self._mtx:
            return list(self._metrics.values())

    def prometheus(self) -> str:
        """Text exposition format 0.0.4.  Label variants of one metric
        name register independently (possibly interleaved with other
        registrations), but a metric family must be one contiguous
        group in the output -- strict parsers reject interleaving -- so
        the drain groups by name first."""
        by_name: Dict[str, List[_Metric]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name, group in by_name.items():
            help_text = next((m.help for m in group if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {group[0].kind}")
            for m in group:
                for suffix, extra, value in m.sample_rows():
                    labels = dict(m.labels)
                    labels.update(extra)
                    lines.append(f"{name}{suffix}{_label_str(labels)} "
                                 f"{_fmt_value(float(value))}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {name: [{labels, kind, value}, ...]}."""
        out: Dict[str, list] = {}
        for m in self.metrics():
            out.setdefault(m.name, []).append(
                {"labels": m.labels, "kind": m.kind,
                 "value": m.value_obj()})
        return out

    def snapshot_json(self, **json_kw) -> str:
        return json.dumps(self.snapshot(), **json_kw)


def publish_span_gauges(registry: MetricsRegistry, summary: dict,
                        labels: Optional[Dict[str, str]] = None
                        ) -> None:
    """Expose span-derived gauges from a span summary (a dict with
    any of the keys below, computed from ``obs.spans.SpanTracer``
    category totals over a timed region) beside the other families.
    The help texts are the JAX package's, so the exposition is too:

    - ``dmclock_dispatch_ms_per_launch`` -- host dispatch self-time
      per device launch;
    - ``dmclock_device_ms_per_launch`` -- device-side time per launch;
    - ``dmclock_host_overhead_frac`` -- host-side (non-device) share
      of the measured wall time.
    """
    rows = (
        ("dmclock_dispatch_ms_per_launch", "dispatch_ms_per_launch",
         "host dispatch self-time per device launch over the timed "
         "region (span tracer; docs/OBSERVABILITY.md tracing plane)"),
        ("dmclock_device_ms_per_launch", "device_ms_per_launch",
         "device-side time per launch over the timed region (span "
         "tracer)"),
        ("dmclock_host_overhead_frac", "host_overhead_frac",
         "host-side (dispatch + prep + fetch + drain) share of the "
         "measured wall time (span tracer)"),
    )
    for name, key, help_text in rows:
        if key in summary:
            registry.gauge(name, help_text,
                           labels=labels).set(float(summary[key]))


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry, for modules with no natural owner."""
    return _DEFAULT


# ----------------------------------------------------------------------
# scrape endpoint (stdlib http.server)
# ----------------------------------------------------------------------

class MetricsHTTPServer:
    """Small background HTTP server exposing a registry's drains, so
    a long run can be scraped while it runs:

    - ``GET /metrics`` (or ``/``) -> Prometheus text exposition 0.0.4
    - ``GET /metrics.json``       -> the JSON ``snapshot()``
    - ``GET /healthz``            -> ``{"status": "ok"}``, a liveness
      probe that touches no registry drain

    ``mount(prefix, handler)`` adds a path-prefixed sub-API under the
    same endpoint (GET/POST/PUT/DELETE): ``handler(method, path,
    body_bytes) -> (status, content_type, body_bytes)``.  The
    lifecycle plane's admin API (``lifecycle.api``) mounts
    ``/clients`` this way, so one port serves scrape and control.
    Mounted prefixes are consulted before the built-in GET routes; a
    handler exception answers 500 without killing the server thread.

    Drains are read lazily per request (callback gauges, timer merges),
    so serving a scrape costs the hot path nothing.  ``port=0`` binds
    an ephemeral port (read it back from ``.port``); ``close()`` shuts
    the daemon thread down.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry if registry is not None else default_registry()
        self.registry = reg
        # [(prefix, handler)] consulted in mount order; the list object
        # is closed over by the Handler below, so mounts added after
        # the server started are live immediately
        self._mounts: List[Tuple[str, Callable]] = []
        mounts = self._mounts

        def dispatch_mounted(handler, method: str) -> bool:
            """Route one request through the mounted sub-APIs; True
            when a mount claimed the path (response already sent)."""
            path = handler.path.split("?", 1)[0]
            for prefix, fn in mounts:
                if path == prefix or path.startswith(prefix + "/"):
                    n = int(handler.headers.get("Content-Length", 0)
                            or 0)
                    body = handler.rfile.read(n) if n else b""
                    try:
                        status, ctype, out = fn(method, path, body)
                    except Exception as e:   # a control-plane bug must
                        status, ctype = 500, "application/json"
                        out = json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode()           # not kill the endpoint
                    handler.send_response(status)
                    handler.send_header("Content-Type", ctype)
                    handler.send_header("Content-Length",
                                        str(len(out)))
                    handler.end_headers()
                    handler.wfile.write(out)
                    return True
            return False

        class ReuseServer(ThreadingHTTPServer):
            # SO_REUSEADDR set explicitly (it is also the stdlib
            # HTTPServer default): a restarted process rebinds its
            # port at once instead of waiting out TIME_WAIT sockets
            allow_reuse_address = True
            daemon_threads = True

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if dispatch_mounted(self, "GET"):
                    return
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path in ("/", "/metrics"):
                    body = reg.prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = reg.snapshot_json().encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body = b'{"status": "ok"}'
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                if not dispatch_mounted(self, "POST"):
                    self.send_error(404)

            def do_PUT(self):  # noqa: N802
                if not dispatch_mounted(self, "PUT"):
                    self.send_error(404)

            def do_DELETE(self):  # noqa: N802
                if not dispatch_mounted(self, "DELETE"):
                    self.send_error(404)

            def log_message(self, *_args):  # scrapes are not news
                pass

        self._srv = ReuseServer((host, port), Handler)
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()

    def mount(self, prefix: str, handler: Callable) -> None:
        """Mount ``handler(method, path, body) -> (status, ctype,
        body)`` under ``prefix`` (e.g. ``"/clients"``).  Live
        immediately; later mounts are consulted after earlier ones."""
        if not prefix.startswith("/") or prefix.endswith("/"):
            # ValueError, not assert: under PYTHONOPTIMIZE a stripped
            # check would accept a prefix the dispatcher can never
            # match -- an API that looks mounted but 404s everything
            raise ValueError(
                f"mount prefix must start with '/' and not end with "
                f"one, got {prefix!r}")
        if any(p == prefix for p, _ in self._mounts):
            # first-mount-wins dispatch would silently shadow the
            # second handler forever -- reject the collision instead
            # (re-mount-after-rebind creates a FRESH server, so a
            # legitimate caller never hits this)
            raise ValueError(f"prefix {prefix!r} already mounted")
        self._mounts.append((prefix, handler))

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    @property
    def healthz_url(self) -> str:
        return f"http://{self.host}:{self.port}/healthz"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_http_server(registry: Optional[MetricsRegistry] = None,
                      port: int = 0, host: str = "127.0.0.1", *,
                      fail_soft: bool = True
                      ) -> Optional[MetricsHTTPServer]:
    """Start a background scrape endpoint over ``registry`` (default:
    the process-wide registry).

    Telemetry must never kill the run it observes: with ``fail_soft``
    (the default) a bind failure -- the port still held by another
    process, a previous incarnation not fully torn down, a privileged
    port -- logs a warning and returns ``None`` instead of raising,
    so repeated calls on the same port degrade to "no scrape
    endpoint" rather than an exception out of the serving layer.  The
    server binds with ``SO_REUSEADDR``, so a restarted process
    normally rebinds its old port cleanly."""
    try:
        return MetricsHTTPServer(registry, port=port, host=host)
    except (OSError, OverflowError) as e:
        # OverflowError: out-of-range port from CPython's bind()
        if not fail_soft:
            raise
        import sys

        print(f"# metrics: scrape endpoint disabled "
              f"({host}:{port}: {e})", file=sys.stderr)
        return None
