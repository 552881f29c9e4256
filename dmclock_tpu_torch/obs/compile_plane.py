"""Compile records and the cost counter: the capacity plane's time axis.

Counterpart of ``dmclock_tpu/obs/compile_plane.py``.  The JAX plane
records every lower+compile of the package's jitted programs and each
program's ``cost_analysis()``.  The port has one compile, the ``nvcc``
build of its kernel library (``engine/_ext.py`` ``build``), and runs its
programs op by op, so the two halves become:

- **Build records.**  Each ``build()`` call is one record of the cache
  ``kernels`` under the library's file name: ``compiles`` counts the
  ``nvcc`` runs (0 when a current library was found), ``compile_ms`` is
  the compiler's wall and ``lower_ms`` the hashing of the sources and
  the look for a current library (the leg before the compiler, as
  lowering is in JAX).  With a tracer attached (:func:`set_tracer`) a
  compiler run is one ``compile``-category span, ``compile.kernels``,
  and a ``compile.kernels.record`` instant carrying the record, as the
  JAX plane's ``_timed_compile`` emits.  ``retraces`` stays in the
  totals and is 0 by construction: nothing is specialised per shape, so
  no entry is ever built twice.
- **The cost counter** (:class:`CostCounter`), the port's
  ``cost_analysis``: a ``TorchDispatchMode`` that counts every aten op
  run inside one launch of a row's program, by XLA's rules: a view op
  moves and does nothing; any other op reads each tensor operand once,
  writes each output once and does one op per output element; a
  reduction does one op per input element; ``sort`` does
  ``n * ceil(log2 n)`` ops a sorted row; a transcendental op (``exp``,
  ``log``, ``sqrt``, ``pow`` and the like) counts one ``transcendentals``
  an output element and no ``flops``; ``.item()`` reads the element's
  bytes.  Host-device copies move nothing on the device and count 0 (an
  XLA program holds no transfers), and ``empty`` writes nothing.  The
  CUDA kernels launch through ``ctypes``, out of the mode's sight: each
  wrapper opens a :func:`kernel_region` that records the kernel's cost
  by formula (``fastpath.ring_window_cost``, ``kernels.wheel_scan_cost``)
  and hides the ops inside it, the plain version's on the CPU, so the
  CPU and the card count the same work.

The counter counts the launch that actually ran, loops broken early
included, where XLA counts the static program once; the two packages'
whole-program totals are therefore not held equal, only the convention
op for op.  :func:`normalize_cost_analysis` turns either into the row's
``{"flops", "bytes_accessed", "transcendentals"}``.

Records export as the JAX plane's: :meth:`CompilePlane.snapshot`,
:func:`publish_compile_metrics` (the ``dmclock_compile_*`` families)
and the spans.  ``enable(False)`` or ``DMCLOCK_COMPILE_PLANE=0`` stops
the build records; nothing here changes a decision, and the counter runs
a launch that the caller has set aside (a clone of the row's state).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time as _walltime
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .spans import span as _span


# ----------------------------------------------------------------------
# build records
# ----------------------------------------------------------------------

class _EntryStats:
    """The record of one cache entry (one kernel library)."""

    __slots__ = ("cache", "entry", "compiles", "found", "lower_ns",
                 "compile_ns")

    def __init__(self, cache: str, entry: str):
        self.cache = cache
        self.entry = entry
        self.compiles = 0
        self.found = 0
        self.lower_ns = 0
        self.compile_ns = 0

    def to_dict(self) -> dict:
        return {"cache": self.cache, "entry": self.entry,
                "compiles": self.compiles, "found": self.found,
                "retraces": 0, "lower_ms": self.lower_ns / 1e6,
                "compile_ms": self.compile_ns / 1e6,
                "cost_analysis": {}, "memory_analysis": {},
                "last_retrace_diff": [], "dispatch_fallbacks": 0}


class CompilePlane:
    """Process-wide build ledger.  ``clock_ns`` is injectable for
    deterministic tests."""

    def __init__(self, clock_ns: Callable[[], int] =
                 _walltime.perf_counter_ns):
        self._mtx = threading.Lock()
        self.clock_ns = clock_ns
        self.enabled = os.environ.get(
            "DMCLOCK_COMPILE_PLANE", "1").lower() not in (
                "0", "off", "false")
        self._tracer_ref = None     # weakref to a SpanTracer, or None
        self._entries: Dict[Tuple[str, str], _EntryStats] = {}

    def enable(self, on: bool) -> "CompilePlane":
        self.enabled = bool(on)
        return self

    def set_tracer(self, tracer) -> None:
        """Route future compiler runs into ``tracer`` as
        ``compile``-category spans (None detaches).  Held weakly, as the
        JAX plane holds it: the plane is process-wide, tracers are per
        run."""
        self._tracer_ref = None if tracer is None \
            else weakref.ref(tracer)

    @property
    def tracer(self):
        return None if self._tracer_ref is None else self._tracer_ref()

    def reset(self) -> None:
        with self._mtx:
            self._entries.clear()

    def record_build(self, cache: str, entry: str, *, compiled: bool,
                     lower_ns: int, compile_ns: int = 0) -> dict:
        """Fold one ``build()`` call into the entry's record: a compiler
        run (``compiled``) or a current library found.  Returns the
        record's span-args payload."""
        with self._mtx:
            key = (cache, entry)
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _EntryStats(cache, entry)
            if compiled:
                e.compiles += 1
            else:
                e.found += 1
            e.lower_ns += int(lower_ns)
            e.compile_ns += int(compile_ns)
        return {"cache": cache, "entry": entry, "retrace": False,
                "compiled": bool(compiled), "lower_ms": lower_ns / 1e6,
                "compile_ms": compile_ns / 1e6}

    def entries(self) -> List[dict]:
        with self._mtx:
            return [e.to_dict() for e in self._entries.values()]

    def totals(self) -> dict:
        """The JAX plane's totals, key for key."""
        with self._mtx:
            es = list(self._entries.values())
            return {
                "entries": len(es),
                "compiles": sum(e.compiles for e in es),
                "retraces": 0,
                "lower_ms_total": sum(e.lower_ns for e in es) / 1e6,
                "compile_ms_total": sum(e.compile_ns for e in es) / 1e6,
                "dispatch_fallbacks": 0,
            }

    def snapshot(self) -> dict:
        return {"totals": self.totals(), "entries": self.entries()}


_PLANE = CompilePlane()


def plane() -> CompilePlane:
    """The process-wide compile plane."""
    return _PLANE


def set_tracer(tracer) -> None:
    _PLANE.set_tracer(tracer)


def record_found(cache: str, entry: str, lower_ns: int) -> None:
    """A ``build()`` that found a current library (no compiler run)."""
    if _PLANE.enabled:
        _PLANE.record_build(cache, entry, compiled=False,
                            lower_ns=lower_ns)


class timed_build:
    """``with timed_build(cache, entry, lower_ns): <run the compiler>``:
    one ``compile.<cache>`` span around the run and its record (with a
    ``compile.<cache>.record`` instant) once it returned.  A run that
    raises is not recorded, as the JAX plane records no failed
    compile."""

    def __init__(self, cache: str, entry: str, lower_ns: int):
        self.cache, self.entry, self.lower_ns = cache, entry, lower_ns
        self._span = None
        self._t0 = 0

    def __enter__(self):
        if _PLANE.enabled:
            self._span = _span(_PLANE.tracer, f"compile.{self.cache}",
                               "compile")
            self._span.__enter__()
            self._t0 = _PLANE.clock_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._span is None:
            return False
        t1 = _PLANE.clock_ns()
        self._span.__exit__(exc_type, exc, tb)
        if exc_type is None:
            rec = _PLANE.record_build(self.cache, self.entry,
                                      compiled=True, lower_ns=self.lower_ns,
                                      compile_ns=t1 - self._t0)
            tracer = _PLANE.tracer
            if tracer is not None:
                tracer.instant(f"compile.{self.cache}.record", "compile",
                               **rec)
        return False


def publish_compile_metrics(registry, pl: Optional[CompilePlane] = None
                            ) -> None:
    """The plane into a registry as the JAX plane's ``dmclock_compile_*``
    families: the process totals, then a rollup a cache family
    (``{cache=...}``).  A build has no cost or memory analysis, so the
    per-family ``flops``, ``bytes_accessed`` and ``hbm_bytes`` gauges
    read 0."""
    pl = pl or _PLANE
    t = pl.totals()
    rows = (
        ("dmclock_compile_events_total", "compiler runs recorded by the "
         "compile plane (kernel library builds)", t["compiles"]),
        ("dmclock_compile_retraces_total", "cache entries rebuilt for a "
         "changed signature (0: nothing is specialised per shape)",
         t["retraces"]),
        ("dmclock_compile_ms_total", "total compiler wall (ms)",
         t["compile_ms_total"]),
        ("dmclock_compile_lower_ms_total", "total source hashing and "
         "library lookup wall (ms)", t["lower_ms_total"]),
        ("dmclock_compile_cache_entries", "kernel library entries",
         t["entries"]),
    )
    for name, help_text, v in rows:
        registry.gauge(name, help_text).set(float(v))
    by_cache: Dict[str, dict] = {}
    for e in pl.entries():
        acc = by_cache.setdefault(e["cache"], {
            "compile_ms": 0.0, "retraces": 0, "flops": 0.0,
            "bytes_accessed": 0.0, "hbm_total_bytes": 0})
        acc["compile_ms"] += e["compile_ms"]
        acc["retraces"] += e["retraces"]
    for cache, acc in by_cache.items():
        lbl = {"cache": cache}
        registry.gauge("dmclock_compile_ms_total", "", labels=lbl) \
            .set(acc["compile_ms"])
        registry.gauge("dmclock_compile_retraces_total", "",
                       labels=lbl).set(acc["retraces"])
        registry.gauge("dmclock_compile_flops", "cost_analysis flops of "
                       "the cache family's builds (none)",
                       labels=lbl).set(acc["flops"])
        registry.gauge("dmclock_compile_bytes_accessed", "cost_analysis "
                       "bytes accessed of the cache family's builds "
                       "(none)", labels=lbl).set(acc["bytes_accessed"])
        registry.gauge("dmclock_compile_hbm_bytes", "memory analysis of "
                       "the cache family's builds (none)",
                       labels=lbl).set(acc["hbm_total_bytes"])


# ----------------------------------------------------------------------
# the cost counter
# ----------------------------------------------------------------------

def normalize_cost_analysis(ca) -> Dict[str, float]:
    """ONE normalization of a raw cost analysis (a list of dicts or a
    dict with XLA's key names) into the row's ``flops``,
    ``bytes_accessed`` and ``transcendentals``, the keys present only."""
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    out = {}
    for key in ("flops", "bytes accessed", "transcendentals"):
        if key in (ca or {}):
            out[key.replace(" ", "_")] = float(ca[key])
    return out


def cost_analysis_dict(counted) -> Dict[str, float]:
    """Normalized costs from ``counted.cost_analysis()`` (a
    :class:`CostCounter` after its launch); empty if it raises."""
    try:
        ca = counted.cost_analysis()
    except Exception:
        return {}
    return normalize_cost_analysis(ca)


TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "pow", "float_power", "sin", "cos", "tan", "asin", "acos",
    "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "sigmoid", "logit", "erf", "erfc", "erfinv", "cbrt"))
# one op an input element
REDUCTIONS = frozenset((
    "sum", "prod", "mean", "amin", "amax", "aminmax", "min", "max",
    "argmin", "argmax", "any", "all", "count_nonzero", "std", "var",
    "logsumexp", "nansum", "linalg_vector_norm", "norm", "topk",
    "bincount", "histc"))
# one op an element of the largest operand that is not the destination
SCATTERS = frozenset((
    "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
    "index_put", "index_put_", "_index_put_impl_", "index_copy",
    "index_copy_", "masked_scatter", "masked_scatter_"))
# ops that write their destination without reading it
OVERWRITES = frozenset(("copy_", "fill_", "zero_"))
# allocations: nothing read, nothing written
ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided", "resize_"))
# reinterpretations the schema does not mark as views
NO_DATA = frozenset(("_unsafe_view", "lift_fresh", "detach", "alias"))

_LOCAL = threading.local()


def _active() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


_Tensor = torch.Tensor


def _tensors(items, out: list) -> list:
    """The tensors among ``items`` and the lists or tuples in them, into
    ``out`` (the arguments of an aten op nest one level at most)."""
    for x in items:
        if isinstance(x, _Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, _Tensor))
    return out


# how an op counts, by its name (``_kind``)
_SKIP, _PLAIN, _TRANS, _SORT, _REDUCE, _SCATTER, _OVERWRITE, _TO_COPY = \
    range(8)


def _kind(func) -> tuple:
    """``(label, kind)`` of an aten overload (cached a counter)."""
    name = func.overloadpacket.__name__
    if func.is_view or name in NO_DATA or name in ALLOCATIONS:
        kind = _SKIP
    elif name in TRANSCENDENTAL:
        kind = _TRANS
    elif name == "sort":
        kind = _SORT
    elif name in REDUCTIONS:
        kind = _REDUCE
    elif name in SCATTERS:
        kind = _SCATTER
    elif name in OVERWRITES:
        kind = _OVERWRITE
    elif name == "_to_copy":
        kind = _TO_COPY
    else:
        kind = _PLAIN
    return str(func), kind


def _sort_ops(t: torch.Tensor, dim: int) -> int:
    if t.dim() == 0:
        return 0
    n = t.shape[dim]
    if n <= 1:
        return 0
    return (t.numel() // n) * n * math.ceil(math.log2(n))


class CostCounter(TorchDispatchMode):
    """Counts the aten ops run inside ``with CostCounter() as c:`` (this
    thread), by the rules of the module docstring.
    :meth:`cost_analysis` gives the totals under XLA's key names,
    :meth:`ops` the table by op (each kernel region as
    ``kernel:<name>``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self._ops: Dict[str, list] = {}
        self._kinds: dict = {}
        self._hidden = 0

    def __enter__(self):
        _active().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _active().remove(self)

    def _add(self, name: str, flops: int, nbytes: int, trans: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += trans
        row = self._ops.get(name)
        if row is None:
            row = self._ops[name] = [0, 0, 0, 0]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += trans

    def add_kernel(self, name: str, cost: Dict[str, float]) -> None:
        """One kernel launch by its formula (``kernel_region``)."""
        self._add(f"kernel:{name}", int(cost.get("flops", 0)),
                  int(cost.get("bytes_accessed", 0)),
                  int(cost.get("transcendentals", 0)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        known = self._kinds.get(func)
        if known is None:
            known = self._kinds[func] = _kind(func)
        label, kind = known
        if kind == _SKIP:
            return
        ins = _tensors(args, [])
        if kwargs:
            _tensors([v for k, v in kwargs.items()
                      if not k.startswith("out")], ins)
        outs = _tensors((out,), [])
        if kind == _TO_COPY and len({t.device for t in ins + outs}) > 1:
            return          # a host-device copy: no device traffic
        if kind == _OVERWRITE and ins:
            ins = ins[1:]
        nbytes = 0
        n_out = 0
        for t in outs:
            n = t.numel()
            n_out += n
            nbytes += n * t.element_size()
        for t in ins:
            nbytes += t.numel() * t.element_size()
        flops = trans = 0
        if kind == _TRANS:
            trans = n_out
        elif kind == _SORT:
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
                else kwargs.get("dim", -1)
            flops = _sort_ops(args[0], dim)
        elif kind == _REDUCE:
            flops = max((t.numel() for t in ins), default=0)
        elif kind == _SCATTER:
            flops = max((t.numel() for t in ins[1:]), default=0)
        else:
            flops = n_out
        self._add(label, flops, nbytes, trans)

    def cost_analysis(self) -> dict:
        """The totals under XLA's key names (normalize with
        :func:`normalize_cost_analysis`)."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "transcendentals": float(self.transcendentals)}

    def ops(self) -> Dict[str, dict]:
        return {k: {"calls": v[0], "flops": v[1], "bytes_accessed": v[2],
                    "transcendentals": v[3]}
                for k, v in sorted(self._ops.items())}


class _Region:
    __slots__ = ("name", "cost", "counters")

    def __init__(self, name: str, cost: Callable[[], dict]):
        self.name, self.cost = name, cost
        self.counters = ()

    def __enter__(self):
        self.counters = tuple(_active())
        cost = self.cost()
        for c in self.counters:
            c.add_kernel(self.name, cost)
            c._hidden += 1
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c._hidden -= 1
        return False


_NO_REGION = contextlib.nullcontext()


def kernel_region(name: str, cost: Callable[[], dict]):
    """A kernel's launch (or its plain version) as one counted unit:
    while a :class:`CostCounter` is active in this thread, ``cost()``
    (the kernel's formula) is recorded once and the ops inside are
    hidden.  With none active it does nothing and calls nothing."""
    if not getattr(_LOCAL, "stack", None):
        return _NO_REGION
    return _Region(name, cost)


_DEVICE_FAILURES = ("cuda", "nvcc", "kernel build failed",
                    "kernel launch failed")


def device_failure(e: BaseException) -> bool:
    """A CUDA error, or a kernel of the port that failed to build or
    launch: what no telemetry may catch."""
    if isinstance(e, torch.cuda.OutOfMemoryError) or \
            type(e).__name__ == "AcceleratorError":
        return True
    return isinstance(e, RuntimeError) and any(
        s in str(e).lower() for s in _DEVICE_FAILURES)


def count_launch(fn: Callable[[], object]) -> dict:
    """``fn()`` (one launch of a row's program) under a
    :class:`CostCounter`: its normalized ``cost_analysis``.  A failure
    degrades to ``{"error": ...}`` as the JAX row's does, except a
    device or kernel failure (:func:`device_failure`), which raises."""
    counter = CostCounter()
    try:
        with counter:
            fn()
    except Exception as e:
        if device_failure(e):
            raise
        return {"error": f"{type(e).__name__}: {e}"}
    return normalize_cost_analysis(counter.cost_analysis())
