"""Compile records, captured programs and the cost counter: the capacity
plane's time axis.

Counterpart of ``dmclock_tpu/obs/compile_plane.py``.  The JAX plane
records every lower+compile of the package's jitted programs and each
program's ``cost_analysis()``.  The port has two kinds of compile, the
``nvcc`` build of its kernel library (``engine/_ext.py`` ``build``) and
the capture of a device program as a CUDA graph, so the plane has three
parts:

- **Build records.**  Each ``build()`` call is one record of the cache
  ``kernels`` under the library's file name: ``compiles`` counts the
  ``nvcc`` runs (``found`` the calls that found a current library),
  ``compile_ms`` is the compiler's wall and ``lower_ms`` the hashing of
  the sources and the look for a current library (the leg before the
  compiler, as lowering is in JAX).  With a tracer attached
  (:func:`set_tracer`) a compiler run is one ``compile``-category span,
  ``compile.kernels``, and a ``compile.kernels.record`` instant carrying
  the record, as the JAX plane's ``_timed_compile`` emits.
- **Captured programs** (:class:`InstrumentedJit`, the counterpart of
  ``jax.jit`` plus the JAX plane's wrapper).  A program is one body (an
  epoch, a round, a stream chunk) and a cache entry (its static
  configuration).  Its first call for an argument signature (the tensor
  leaves' shapes, dtypes, devices and strides, the Python scalars'
  types, the pytree structure, ``None`` leaves included) copies the
  inputs into static buffers, runs the body once on a side stream with
  synchronising operations made errors (the warm-up, ``lower_ms``; its
  result is the call's result), then captures the body as one
  ``torch.cuda.CUDAGraph`` with a private memory pool and instantiates
  it (``compile_ms``).  Later calls copy each tensor into its static
  buffer (no copy when it is that buffer) and replay the graph.  A
  Python int, bool or float argument is an input, as JAX traces it
  weakly: it is lifted to a 0-d device tensor, filled on every call.
  A string, a dtype or a device is a constant of the program; any other
  leaf (a numpy array above all) raises ``TypeError`` naming its path.
  A second signature on one entry is a new capture and a **retrace**,
  recorded with the leaf-level diff that caused it.  A capture that
  fails raises, naming the cache and the entry; nothing runs eagerly on
  the card in its place.  On CPU tensors (the caller's explicit choice)
  the program is the body run eagerly, with the same signatures and
  records (``compile_ms`` 0).  A program of many serial steps
  (:class:`SerialJit`) captures a block of them and replays it; called
  in another program's body, its block is a child graph of that
  program's graph, or, for a leg of several blocks, its replays run
  between two graph segments of that program (no read back either
  way).  A program whose body holds what no graph can (a host read of
  a device value), or that spans a layout of several groups, is a
  :class:`StagedJit`: one entry whose body runs on the host around
  captured legs (the device sim's step; one leg a group of a grouped
  program, :func:`group_legs`, the steps across groups between them).
  Inside :func:`eager` every program runs its body eagerly with no
  record: the reference a check holds a program against.
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
  CPU and the card count the same work.  It counts a program's eager
  body (``InstrumentedJit.fn``).

The counter counts the launch that actually ran, loops broken early
included, where XLA counts the static program once; the two packages'
whole-program totals are therefore not held equal, only the convention
op for op.  :func:`normalize_cost_analysis` turns either into the row's
``{"flops", "bytes_accessed", "transcendentals"}``.  A capture record's
``cost_analysis`` stays ``{}``; its ``memory_analysis`` reads the
program's bytes: ``argument_bytes`` (the static inputs), ``output_bytes``,
``alias_bytes`` (the donated inputs the outputs are written back into),
``pool_bytes`` (the graph's private pool) and ``total_bytes`` (static
inputs plus pool: what the program keeps on the card).

Records export as the JAX plane's: :meth:`CompilePlane.snapshot`,
:func:`publish_compile_metrics` (the ``dmclock_compile_*`` families),
:meth:`CompilePlane.retrace_events` (the watchdog's retrace-storm feed)
and the spans.  ``enable(False)`` or ``DMCLOCK_COMPILE_PLANE=0`` stops
the records; programs are captured and replayed either way, nothing
here changes a decision, and the counter runs a launch that the caller
has set aside (a clone of the row's state).
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import math
import os
import threading
import time as _walltime
import warnings
import weakref
from collections import deque
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .spans import span as _span


# ----------------------------------------------------------------------
# the plane: build and capture records
# ----------------------------------------------------------------------

# one retrace event ring entry per retrace, what the watchdog's
# retrace-storm check windows over
_RETRACE_RING = 1024
# how many leaf-level diffs a retrace record keeps
_DIFF_LIMIT = 8
_ENTRY_STR_LIMIT = 160


def _entry_str(entry: Any) -> str:
    s = repr(entry)
    return s if len(s) <= _ENTRY_STR_LIMIT else \
        s[:_ENTRY_STR_LIMIT - 3] + "..."


def _sig_diff(old: Dict[str, tuple], new: Dict[str, tuple]) -> List[str]:
    """Human-readable leaf diffs between two path-spec maps: what changed
    shape, dtype, device, strides or type to cause the retrace."""
    diffs = []
    for path in new:
        if path not in old:
            diffs.append(f"{path}: added {new[path]}")
        elif old[path] != new[path]:
            diffs.append(f"{path}: {old[path]} -> {new[path]}")
    for path in old:
        if path not in new:
            diffs.append(f"{path}: removed (was {old[path]})")
    return diffs[:_DIFF_LIMIT]


class _EntryStats:
    """The record of one cache entry: a kernel library, or one static
    configuration of a captured program."""

    __slots__ = ("cache", "entry", "compiles", "found", "retraces",
                 "lower_ns", "compile_ns", "cost", "hbm", "path_specs",
                 "last_diff")

    def __init__(self, cache: str, entry: str):
        self.cache = cache
        self.entry = entry
        self.compiles = 0
        self.found = 0
        self.retraces = 0
        self.lower_ns = 0
        self.compile_ns = 0
        self.cost: Dict[str, float] = {}
        self.hbm: Dict[str, int] = {}
        self.path_specs: Optional[Dict[str, tuple]] = None
        self.last_diff: List[str] = []

    def to_dict(self) -> dict:
        return {"cache": self.cache, "entry": self.entry,
                "compiles": self.compiles, "found": self.found,
                "retraces": self.retraces, "lower_ms": self.lower_ns / 1e6,
                "compile_ms": self.compile_ns / 1e6,
                "cost_analysis": dict(self.cost),
                "memory_analysis": dict(self.hbm),
                "last_retrace_diff": list(self.last_diff),
                "dispatch_fallbacks": 0}


class CompilePlane:
    """Process-wide compile ledger: kernel builds and program captures.
    ``clock_ns`` is injectable for deterministic tests (the watchdog's
    clock domain)."""

    def __init__(self, clock_ns: Callable[[], int] =
                 _walltime.perf_counter_ns):
        self._mtx = threading.Lock()
        self.clock_ns = clock_ns
        self.enabled = os.environ.get(
            "DMCLOCK_COMPILE_PLANE", "1").lower() not in (
                "0", "off", "false")
        self._tracer_ref = None     # weakref to a SpanTracer, or None
        self._entries: Dict[Tuple[str, str], _EntryStats] = {}
        self._retraces: deque = deque(maxlen=_RETRACE_RING)

    def enable(self, on: bool) -> "CompilePlane":
        self.enabled = bool(on)
        return self

    def set_tracer(self, tracer) -> None:
        """Route future compiles into ``tracer`` as ``compile``-category
        spans (None detaches).  Held weakly, as the JAX plane holds it:
        the plane is process-wide, tracers are per run."""
        self._tracer_ref = None if tracer is None \
            else weakref.ref(tracer)

    @property
    def tracer(self):
        return None if self._tracer_ref is None else self._tracer_ref()

    def reset(self) -> None:
        with self._mtx:
            self._entries.clear()
            self._retraces.clear()

    def _entry(self, cache: str, entry: str) -> _EntryStats:
        key = (cache, entry)
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _EntryStats(cache, entry)
        return e

    def record_build(self, cache: str, entry: str, *, compiled: bool,
                     lower_ns: int, compile_ns: int = 0) -> dict:
        """Fold one ``build()`` call into the entry's record: a compiler
        run (``compiled``) or a current library found.  Returns the
        record's span-args payload."""
        with self._mtx:
            e = self._entry(cache, entry)
            if compiled:
                e.compiles += 1
            else:
                e.found += 1
            e.lower_ns += int(lower_ns)
            e.compile_ns += int(compile_ns)
        return {"cache": cache, "entry": entry, "retrace": False,
                "compiled": bool(compiled), "lower_ms": lower_ns / 1e6,
                "compile_ms": compile_ns / 1e6}

    def record_compile(self, cache: str, entry: str, *, lower_ns: int,
                       compile_ns: int, cost: Dict[str, float],
                       hbm: Dict[str, int],
                       path_specs: Optional[Dict[str, tuple]] = None
                       ) -> dict:
        """Fold one capture into the entry's record (the JAX plane's
        ``record_compile``, key for key): a second one on an entry is a
        retrace, with the diff of its leaf specs.  Returns the span-args
        payload."""
        with self._mtx:
            e = self._entry(cache, entry)
            retrace = e.compiles > 0
            diff: List[str] = []
            if retrace:
                e.retraces += 1
                if e.path_specs is not None and path_specs is not None:
                    diff = _sig_diff(e.path_specs, path_specs)
                e.last_diff = diff
                self._retraces.append((self.clock_ns(),
                                       f"{cache}:{entry}"))
            e.compiles += 1
            e.lower_ns += int(lower_ns)
            e.compile_ns += int(compile_ns)
            if cost:
                e.cost = dict(cost)
            if hbm:
                e.hbm = dict(hbm)
            if path_specs is not None:
                e.path_specs = path_specs
        out = {"cache": cache, "entry": entry, "retrace": retrace,
               "lower_ms": lower_ns / 1e6, "compile_ms": compile_ns / 1e6}
        if hbm.get("total_bytes") is not None:
            out["hbm_total_bytes"] = hbm["total_bytes"]
        if diff:
            out["sig_diff"] = diff
        return out

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
                "retraces": sum(e.retraces for e in es),
                "lower_ms_total": sum(e.lower_ns for e in es) / 1e6,
                "compile_ms_total": sum(e.compile_ns for e in es) / 1e6,
                "dispatch_fallbacks": 0,
            }

    def snapshot(self) -> dict:
        return {"totals": self.totals(), "entries": self.entries()}

    def retrace_events(self) -> List[Tuple[int, str]]:
        """``(clock_ns, "cache:entry")`` per retrace, newest-bounded: the
        watchdog's retrace-storm feed."""
        with self._mtx:
            return list(self._retraces)


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
    (``{cache=...}``).  No record carries a cost analysis, so the
    per-family ``flops`` and ``bytes_accessed`` gauges read 0; the
    ``hbm_bytes`` gauge sums the captured programs' ``total_bytes``."""
    pl = pl or _PLANE
    t = pl.totals()
    rows = (
        ("dmclock_compile_events_total", "compiles recorded by the "
         "compile plane (kernel library builds and program captures)",
         t["compiles"]),
        ("dmclock_compile_retraces_total", "cache entries captured again "
         "for a changed argument signature", t["retraces"]),
        ("dmclock_compile_ms_total", "total compiler and capture wall "
         "(ms)", t["compile_ms_total"]),
        ("dmclock_compile_lower_ms_total", "total library lookup and "
         "warm-up wall (ms)", t["lower_ms_total"]),
        ("dmclock_compile_cache_entries", "kernel library and program "
         "entries", t["entries"]),
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
        acc["hbm_total_bytes"] += \
            e["memory_analysis"].get("total_bytes", 0)
    for cache, acc in by_cache.items():
        lbl = {"cache": cache}
        registry.gauge("dmclock_compile_ms_total", "", labels=lbl) \
            .set(acc["compile_ms"])
        registry.gauge("dmclock_compile_retraces_total", "",
                       labels=lbl).set(acc["retraces"])
        registry.gauge("dmclock_compile_flops", "cost_analysis flops of "
                       "the cache family's records (none)",
                       labels=lbl).set(acc["flops"])
        registry.gauge("dmclock_compile_bytes_accessed", "cost_analysis "
                       "bytes accessed of the cache family's records "
                       "(none)", labels=lbl).set(acc["bytes_accessed"])
        registry.gauge("dmclock_compile_hbm_bytes", "static inputs and "
                       "private pools of the cache family's captured "
                       "programs", labels=lbl).set(acc["hbm_total_bytes"])

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
    """A CUDA error, a kernel of the port that failed to build or launch,
    or a program that failed to capture: what no telemetry may catch."""
    if isinstance(e, (torch.cuda.OutOfMemoryError, CaptureError)) or \
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


# ----------------------------------------------------------------------
# captured programs
# ----------------------------------------------------------------------

# every live InstrumentedJit, so clear_compiled() reaches them all
_ALL_PROGRAMS: "weakref.WeakSet" = weakref.WeakSet()


def clear_compiled() -> None:
    """Drop every program's captured graphs and static buffers (records
    are kept): the next call of a signature captures it again, recorded
    as a retrace.  ``torch.cuda.empty_cache()`` afterwards returns the
    pools to the card."""
    for w in list(_ALL_PROGRAMS):
        w.clear_compiled()


# per thread: ``eager`` (programs run their bodies eagerly) and
# ``collect``, the lists the captures of a staged program's first call
# are appended to
_LOCAL = threading.local()


@contextlib.contextmanager
def eager():
    """Inside it, on this thread, every program runs its body eagerly on
    its device, with no capture and no record: the reference a check
    holds a program's replays against (a serial program runs its
    ``steps`` in one body, a staged one its legs op by op)."""
    prev = getattr(_LOCAL, "eager", False)
    _LOCAL.eager = True
    try:
        yield
    finally:
        _LOCAL.eager = prev


def _eager_on() -> bool:
    return getattr(_LOCAL, "eager", False)


def _collectors() -> list:
    if not hasattr(_LOCAL, "collect"):
        _LOCAL.collect = []
    return _LOCAL.collect


def _capturing() -> list:
    """Per thread, the programs whose capture is under way (innermost
    last)."""
    if not hasattr(_LOCAL, "capturing"):
        _LOCAL.capturing = []
    return _LOCAL.capturing


def _embedded() -> list:
    """Per thread, one list a capture under way: the nested programs'
    graphs it holds as child nodes."""
    if not hasattr(_LOCAL, "embedded"):
        _LOCAL.embedded = []
    return _LOCAL.embedded


class CaptureError(RuntimeError):
    """A program that cannot be captured on the card: its body
    synchronises with the host, uses an operation a CUDA graph cannot
    hold, or its graph fails to instantiate.  The message names the
    cache and the entry."""


_SCALARS = (bool, int, float, np.bool_, np.integer, np.floating)
# the leaves a program may hold as constants: values whose repr is an
# exact image of the value, so equal signatures mean equal constants
_CONSTANTS = (str, bytes, torch.dtype, torch.device)


class _NotAConstant(Exception):
    """A leaf no signature can hold (raised inside :func:`_leaf_spec`)."""


def _scalar_dtype(x) -> torch.dtype:
    if isinstance(x, (bool, np.bool_)):
        return torch.bool
    if isinstance(x, (int, np.integer)):
        return torch.int64
    return torch.float64


def _leaf_spec(x):
    """The hashable signature of one leaf: a tensor by shape, dtype,
    device and strides (values never retrace); a Python or numpy scalar
    by its type only (it is an input, lifted to a 0-d tensor); ``None``
    as itself; a string, a dtype or a device by its repr (a constant of
    the program).  Any other leaf raises :class:`_NotAConstant`: a numpy
    array's repr elides a large array's middle, so two different arrays
    could share a signature and the graph would replay the first one's
    values."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device, x.stride())
    if isinstance(x, _SCALARS):
        return type(x)
    if x is None:
        return None
    if isinstance(x, _CONSTANTS):
        return ("obj", repr(x))
    raise _NotAConstant


def _signature(what: str, leaves, spec, args, kwargs) -> tuple:
    """A call's signature; a leaf that can be neither an input nor a
    constant raises ``TypeError`` naming its path."""
    try:
        return spec, tuple(map(_leaf_spec, leaves))
    except _NotAConstant:
        for path, x in pytree.tree_flatten_with_path((args, kwargs))[0]:
            try:
                _leaf_spec(x)
            except _NotAConstant:
                raise TypeError(
                    f"{what}: argument leaf {pytree.keystr(path)} is a "
                    f"{type(x).__module__}.{type(x).__qualname__}, which "
                    f"a program can neither take as an input nor hold as "
                    f"a constant: pass a tensor") from None
        raise


def _leaf_spec_readable(x) -> tuple:
    """The human-facing form of :func:`_leaf_spec`, for retrace diffs."""
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), str(x.dtype).replace("torch.", ""),
                str(x.device), tuple(x.stride()))
    if isinstance(x, _SCALARS):
        return ("py", type(x).__name__)
    if x is None:
        return ("none",)
    return ("obj", repr(x))


def _path_name(path, argnames) -> Optional[str]:
    """The field or argument name a leaf path ends in (None for a list
    position): a bare positional argument takes its parameter's name."""
    if len(path) == 2 and getattr(path[0], "idx", None) == 0 and \
            getattr(path[1], "idx", None) is not None and \
            path[1].idx < len(argnames):
        return argnames[path[1].idx]
    if not path:
        return None
    name = getattr(path[-1], "name", None)
    if name is None:
        name = getattr(path[-1], "key", None)
    return name if isinstance(name, str) else None


def _argnames(fn) -> tuple:
    try:
        return tuple(p.name for p in inspect.signature(fn).parameters
                     .values() if p.kind in (p.POSITIONAL_ONLY,
                                             p.POSITIONAL_OR_KEYWORD))
    except (TypeError, ValueError):
        return ()


def _program_device(leaves) -> torch.device:
    """The one device of a call's tensor leaves (the CPU when it has
    none)."""
    devs = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"a program's tensor inputs must be on one "
                         f"device, got {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _lift(x, dev: torch.device):
    return torch.full((), x, dtype=_scalar_dtype(x), device=dev) \
        if isinstance(x, _SCALARS) else x


_DRIVER: list = []      # [the CUDA driver's entry points, or None]


def _driver():
    """``(cuStreamGetCaptureInfo_v2, cuGraphGetNodes,
    cuGraphAddChildGraphNode, cuStreamUpdateCaptureDependencies)`` of
    the CUDA driver, typed, or None where it has not got them."""
    if not _DRIVER:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            fns = (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes,
                   lib.cuGraphAddChildGraphNode,
                   lib.cuStreamUpdateCaptureDependencies)
        except (OSError, AttributeError):
            _DRIVER.append(None)
        else:
            P, VP = ctypes.POINTER, ctypes.c_void_p
            fns[0].argtypes = [VP, P(ctypes.c_int), P(ctypes.c_uint64),
                               P(VP), P(VP), P(ctypes.c_size_t)]
            fns[1].argtypes = [VP, VP, P(ctypes.c_size_t)]
            fns[2].argtypes = [P(VP), VP, VP, ctypes.c_size_t, VP]
            fns[3].argtypes = [VP, P(VP), ctypes.c_size_t, ctypes.c_uint]
            for fn in fns:
                fn.restype = ctypes.c_int
            _DRIVER.append(fns)
    return _DRIVER[0]


def _capture_info(stream):
    """``(graph, dependencies, count)`` of the capture under way on
    ``stream`` (the driver's ``cuStreamGetCaptureInfo_v2``), or None."""
    fns = _driver()
    if fns is None:
        return None
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), \
        ctypes.c_size_t()
    if fns[0](stream.cuda_stream, ctypes.byref(status), ctypes.byref(cid),
              ctypes.byref(graph), ctypes.byref(deps),
              ctypes.byref(ndeps)) != 0 or not graph.value:
        return None
    return graph, deps, ndeps


def _capture_nodes(stream) -> Optional[int]:
    """Nodes in the graph being captured on ``stream`` (the CUDA
    driver's ``cuStreamGetCaptureInfo_v2`` and ``cuGraphGetNodes``);
    None where libcuda does not say."""
    info = _capture_info(stream)
    if info is None:
        return None
    n = ctypes.c_size_t()
    if _driver()[1](info[0], None, ctypes.byref(n)) != 0:
        return None
    return int(n.value)


# CU_STREAM_SET_CAPTURE_DEPENDENCIES
_SET_DEPENDENCIES = 1


def _embed_child(stream, raw_graph: int) -> None:
    """Add the CUDA graph ``raw_graph`` (a ``cudaGraph_t``) as one child
    graph node to the capture under way on ``stream``, after everything
    captured so far, and make it the capture's only dependency: what the
    stream captures next runs after it.  A replay of the program being
    captured replays the child's nodes there, on the child's memory."""
    info = _capture_info(stream)
    if info is None:
        raise CaptureError("a nested program needs the CUDA driver's "
                           "capture entry points (libcuda)")
    graph, deps, ndeps = info
    node = ctypes.c_void_p()
    fns = _driver()
    err = fns[2](ctypes.byref(node), graph, deps, ndeps,
                 ctypes.c_void_p(raw_graph))
    if err == 0:
        err = fns[3](stream.cuda_stream, ctypes.byref(node), 1,
                     _SET_DEPENDENCIES)
    if err != 0:
        raise CaptureError(f"embedding a nested program's graph failed: "
                           f"CUDA driver error {err}")


_T, _S, _C = range(3)   # a leaf's kind: tensor, lifted scalar, constant


class _Eager:
    """A program on the CPU: the body run eagerly, scalars lifted as on
    the card."""

    __slots__ = ("fn", "spec", "dev", "info")

    def __init__(self, fn, spec, dev):
        self.fn, self.spec, self.dev = fn, spec, dev
        self.info: dict = {}

    def run(self, leaves):
        args, kwargs = pytree.tree_unflatten(
            [_lift(x, self.dev) for x in leaves], self.spec)
        return self.fn(*args, **kwargs)


# the donated static buffers of the programs that share them
# (``InstrumentedJit(share_donated=True)``), by ``id``: a sharing
# program's donated input found here is taken over, not cloned
_SHARED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class _Graph:
    """One signature of a program on the card: static inputs, the
    captured graph and its outputs.  With ``share`` a donated input that
    is another sharing program's donated static buffer becomes this
    graph's static buffer too (once a graph: a buffer passed twice is
    cloned the second time), and this graph's donated buffers are
    offered to the next.  A ``nestable`` graph keeps its CUDA graph
    after instantiation, so a call of it inside another program's
    capture adds it there as a child graph node (:func:`_embed_child`)
    instead of replaying it; the outer graph keeps every graph it holds
    (``children``) and their memory alive."""

    def __init__(self, fn, what: str, leaves, spec, dev, donated: set,
                 names: list, share: bool = False, nestable: bool = False):
        self.fn, self.what, self.spec, self.dev = fn, what, spec, dev
        self.nestable = nestable
        self.children: list = []
        self.kinds, self.static = [], []
        taken = set()
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor):
                self.kinds.append(_T)
                if share and i in donated and id(x) not in taken and \
                        _SHARED.get(id(x)) is x:
                    taken.add(id(x))
                    self.static.append(x)
                else:
                    self.static.append(x.clone())
            elif isinstance(x, _SCALARS):
                self.kinds.append(_S)
                self.static.append(_lift(x, dev))
            else:
                self.kinds.append(_C)
                self.static.append(x)
        self.donated = [i for i in sorted(donated) if self.kinds[i] == _T]
        if share:
            for i in self.donated:
                _SHARED[id(self.static[i])] = self.static[i]
        self.names = names
        self.alias: Optional[List[Tuple[int, int]]] = None
        self.out_spec = None
        # [graph, host step or None] in replay order (one graph unless
        # the body holds a serial leg of several blocks, :meth:`split`)
        self.segments: list = []
        self._open = None
        self._cs = None
        self._nodes = 0
        self._pool = None
        self.out_leaves: list = []
        self.fresh: set = set()
        self.launches: Dict[str, int] = {}
        self.info: dict = {}

    # -- the body with donation ---------------------------------------
    def _match(self, out_leaves, out_names) -> List[Tuple[int, int]]:
        """Pair output leaves with the donated inputs they are written
        back into, as XLA pairs donated buffers: by shape and dtype, an
        output that is its input first, then by field name, then in
        order."""
        free = list(self.donated)
        pairs: List[Tuple[int, int]] = []
        taken = set()

        def spec(t):
            return (tuple(t.shape), t.dtype)

        for oi, o in enumerate(out_leaves):
            for di in free:
                if o is self.static[di]:
                    pairs.append((oi, di))
                    taken.add(oi)
                    free.remove(di)
                    break
        for by_name in (True, False):
            for oi, o in enumerate(out_leaves):
                if oi in taken or not isinstance(o, torch.Tensor):
                    continue
                for di in free:
                    if spec(o) == spec(self.static[di]) and (
                            not by_name or (out_names[oi] is not None and
                                            out_names[oi] ==
                                            self.names[di])):
                        pairs.append((oi, di))
                        taken.add(oi)
                        free.remove(di)
                        break
        return pairs

    def body(self):
        args, kwargs = pytree.tree_unflatten(self.static, self.spec)
        out = self.fn(*args, **kwargs)
        if self.alias is None:
            flat = pytree.tree_flatten_with_path(out)[0]
            out_names = [_path_name(p, ()) for p, _ in flat]
            out_leaves, out_spec = pytree.tree_flatten(out)
            self.alias = self._match(out_leaves, out_names)
            self.out_spec = out_spec
        else:
            out_leaves, out_spec = pytree.tree_flatten(out)
            if out_spec != self.out_spec:
                raise CaptureError(f"{self.what}: the body's output "
                                   f"structure changed between runs")
        # write the carried tensors back into the donated inputs; a
        # source that is (a view of) a donated input is copied first,
        # so no write-back reads a buffer another one has overwritten
        held = {self.static[di].untyped_storage().data_ptr()
                for di in self.donated}
        srcs = {}
        for oi, di in self.alias:
            o = out_leaves[oi]
            if o is self.static[di]:
                continue
            srcs[oi] = o.clone() if o.untyped_storage().data_ptr() in held \
                else o
        for oi, di in self.alias:
            if oi in srcs:
                self.static[di].copy_(srcs[oi])
            out_leaves[oi] = self.static[di]
        return out_leaves

    def _own(self, out_leaves) -> list:
        """Outputs the caller may keep: a clone of any that is a static
        input not written back (the next call overwrites it)."""
        mine = {t.untyped_storage().data_ptr()
                for t, k in zip(self.static, self.kinds) if k != _C}
        aliased = {oi for oi, _ in self.alias}
        return [o.clone() if i not in aliased and
                isinstance(o, torch.Tensor) and
                o.untyped_storage().data_ptr() in mine else o
                for i, o in enumerate(out_leaves)]

    # -- the first call: warm-up, then capture ------------------------
    def warm_up(self):
        """The body once, eagerly, on a side stream with synchronising
        operations made errors; its outputs are the first call's.  A
        nested program called for the first time here is captured here
        (its own first call), so this program's capture finds it."""
        cur = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(cur)
        prev = torch.cuda.get_sync_debug_mode()
        _LOCAL.warming = getattr(_LOCAL, "warming", 0) + 1
        try:
            with torch.cuda.device(self.dev), torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out_leaves = self.body()
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
                    _LOCAL.warming -= 1
        except RuntimeError as e:
            if "synchronizing" in str(e):
                raise CaptureError(f"{self.what}: the body synchronises "
                                   f"with the host, which a CUDA graph "
                                   f"cannot hold: {e}") from e
            e.add_note(f"in the warm-up of {self.what}")
            raise
        cur.wait_stream(side)
        return self._own(out_leaves)

    def capture(self) -> None:
        from ..engine import _ext

        if not getattr(_LOCAL, "warming", 0):
            # (inside another program's warm-up, whose syncs are errors,
            # the streams' order is enough)
            torch.cuda.synchronize(self.dev)
        n0 = dict(_ext.LAUNCHES)
        r0 = torch.cuda.memory_reserved(self.dev)
        cur = torch.cuda.current_stream(self.dev)
        cs = torch.cuda.Stream(self.dev)
        cs.wait_stream(cur)
        self._cs, self._nodes, self.segments, self._pool = cs, 0, [], None
        held, capturing = _embedded(), _capturing()
        held.append(self.children)
        capturing.append(self)
        try:
            with torch.cuda.device(self.dev), torch.cuda.stream(cs):
                self._begin(None)
                try:
                    out_leaves = self.body()
                    self._end()
                except BaseException as e:
                    if self._open is not None:
                        try:
                            self._open.capture_end()
                        except Exception:
                            pass
                    if isinstance(e, CaptureError):
                        raise
                    raise CaptureError(f"{self.what}: the capture "
                                       f"failed: {e}") from e
        finally:
            held.pop()
            capturing.remove(self)
            self.launches = {k: v - n0[k] for k, v in _ext.LAUNCHES.items()
                             if v != n0[k]}
            _ext.LAUNCHES.update(n0)    # captured, not launched
        cur.wait_stream(cs)
        self._cs = None
        self.out_leaves = out_leaves
        aliased = {oi for oi, _ in self.alias}
        self.fresh = {i for i, o in enumerate(out_leaves)
                      if i not in aliased and isinstance(o, torch.Tensor)}
        arg = sum(_nbytes(t) for t, k in zip(self.static, self.kinds)
                  if k != _C)
        pool = torch.cuda.memory_reserved(self.dev) - r0
        nodes = self._nodes
        if nodes is not None and self.children:
            # a child graph node stands for the nodes of its graph
            nodes += sum(c.info.get("graph_nodes") or 0
                         for c in self.children) - len(self.children)
        self.info = {
            "graph_nodes": nodes, "launches": dict(self.launches),
            "child_graphs": len(self.children),
            "segments": len(self.segments),
            "memory_analysis": {
                "argument_bytes": arg,
                "output_bytes": sum(_nbytes(o) for o in out_leaves
                                    if isinstance(o, torch.Tensor)),
                "alias_bytes": sum(_nbytes(self.static[di])
                                   for _, di in self.alias),
                "pool_bytes": pool, "total_bytes": arg + pool}}

    def _begin(self, pool) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=self.nestable)
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        self._open = g

    def _end(self) -> None:
        g, self._open = self._open, None
        n = _capture_nodes(self._cs)
        self._nodes = None if n is None or self._nodes is None \
            else self._nodes + n
        try:
            with warnings.catch_warnings():
                # a segment may be empty (the body opens with a leg)
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                g.capture_end()
            if self.nestable:
                g.instantiate()
        except Exception as e:
            raise CaptureError(f"{self.what}: the graph did not "
                               f"instantiate: {e}") from e
        if n == 0 and not self.nestable:
            g = None                    # nothing to replay
        else:
            self._pool = g.pool()       # the next segment's pool
        self.segments.append([g, None])

    def split(self, fn, args):
        """Inside this program's capture: end the graph segment under
        way, run ``fn(*args)`` now, outside any capture (a program of its
        own: a serial leg of several blocks), and capture the rest of the
        body as the next segment, in the same pool.  ``fn``'s result (its
        tensors read by the next segment) is kept: a replay runs the
        segments in order and, after this one, ``fn`` on the same
        ``args``, copying its result into those tensors.  Here ``fn``
        runs dry: its programs hand back their output buffers without
        replaying (during a capture only the shapes matter).  Returns
        the result."""
        from ..engine import _ext

        if self.nestable:
            raise CaptureError(f"{self.what}: a nestable program holds one "
                               f"graph, no host step")
        self._end()
        capturing = _capturing()
        capturing.remove(self)
        n0 = dict(_ext.LAUNCHES)
        _LOCAL.dry = True
        try:
            out = fn(*args)
        finally:
            _LOCAL.dry = False
            _ext.LAUNCHES.update(n0)    # run at capture, not a replay's
            capturing.append(self)
        self.segments[-1][1] = (fn, args, pytree.tree_leaves(out))
        self._begin(self._pool)
        return out

    # -- later calls ----------------------------------------------------
    def run(self, leaves):
        if getattr(_LOCAL, "dry", False):
            # a host step at its program's capture: the buffers, no run
            return pytree.tree_unflatten(
                [o.clone() if i in self.fresh else o
                 for i, o in enumerate(self.out_leaves)], self.out_spec)
        st, kinds = self.static, self.kinds
        for i, x in enumerate(leaves):
            k = kinds[i]
            if k == _T:
                if x.data_ptr() != st[i].data_ptr():
                    st[i].copy_(x)
            elif k == _S:
                st[i].fill_(x)
        if torch.cuda.is_current_stream_capturing():
            # a call inside another program's capture
            if not self.nestable:
                raise CaptureError(f"{self.what}: called inside another "
                                   f"program's capture, and not nestable")
            _embed_child(torch.cuda.current_stream(self.dev),
                         self.segments[0][0].raw_cuda_graph())
            stack = _embedded()
            if stack:
                stack[-1].append(self)
        else:
            for g, step in self.segments:
                if g is not None:
                    g.replay()
                if step is not None:
                    fn, args, held = step
                    for h, x in zip(held, pytree.tree_leaves(fn(*args))):
                        if isinstance(h, torch.Tensor):
                            h.copy_(x)
        if self.launches:
            from ..engine import _ext

            for name, d in self.launches.items():
                _ext.LAUNCHES[name] += d
        fresh = self.fresh
        return pytree.tree_unflatten(
            [o.clone() if i in fresh else o
             for i, o in enumerate(self.out_leaves)], self.out_spec)


class InstrumentedJit:
    """A captured program: ``fn`` (the body) under one cache entry.  On
    the card, the first call of an argument signature runs the body once
    (the warm-up, whose result it returns) and captures it as a CUDA
    graph; every later call of that signature replays the graph.  A new
    signature on the entry is a new capture, recorded as a retrace with
    its diff.  ``donate_argnums`` is JAX's: the body ends by writing the
    carried tensors of those arguments back into their static inputs and
    returns those, so a chain of donated calls copies nothing in and a
    returned tensor stays valid until the next call; any other output is
    the caller's own (a clone of the graph's).  Kernel launch counts
    (``engine/_ext.py`` ``LAUNCHES``) taken at capture are added on
    every replay.  On CPU tensors the program is the body run eagerly.
    ``fn`` is the eager body (the JAX wrapper's ``jitted``).

    ``device`` pins the device its tensors lie on (a leg of a grouped
    program, :func:`group_legs`): a signature on another device raises.
    ``nestable=True`` lets another program's body call this one: the
    first such call (in that program's warm-up) captures it, and inside
    that program's capture a call adds its graph as a child node, so
    the outer graph replays it whole with no host step between
    (:class:`SerialJit`'s blocks are nestable).
    ``record=False`` keeps the program out of the plane's records and
    spans, as a bare ``jax.jit`` is.  ``share_donated=True`` lets a
    chain of such programs (the legs of a staged program) carry one set
    of donated buffers, as XLA hands a donated buffer from one program
    to the next: a donated input that is another sharing program's
    donated static buffer is taken over at capture, not cloned, so
    passing one leg's result to the next copies nothing."""

    __slots__ = ("fn", "cache", "entry", "donate_argnums", "device",
                 "record", "share_donated", "nestable", "_argnames",
                 "_programs", "_mtx", "__weakref__")

    def __init__(self, fn, *, cache: str, entry: Any,
                 donate_argnums=(), device=None,
                 record: bool = True, share_donated: bool = False,
                 nestable: bool = False):
        self.fn = fn
        self.cache = cache
        self.entry = _entry_str(entry)
        self.donate_argnums = tuple(sorted({int(i) for i in
                                            donate_argnums}))
        self.device = None if device is None else torch.device(device)
        self.record = bool(record)
        self.share_donated = bool(share_donated)
        self.nestable = bool(nestable)
        self._argnames = _argnames(fn)
        self._programs: Dict[tuple, Any] = {}
        self._mtx = threading.RLock()
        _ALL_PROGRAMS.add(self)

    def clear_compiled(self) -> None:
        with self._mtx:
            self._programs.clear()

    def captures(self) -> List[dict]:
        """One dict a captured signature: its graph's node count, the
        kernel launches replayed a call, and its memory analysis."""
        with self._mtx:
            return [dict(p.info) for p in self._programs.values()]

    def __call__(self, *args, **kwargs):
        if _eager_on():
            return self.fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        sig = _signature(f"program {self.cache} {self.entry}", leaves,
                         spec, args, kwargs)
        prog = self._programs.get(sig)
        if prog is None:
            with self._mtx:
                prog = self._programs.get(sig)
                if prog is None:
                    prog, out = self._first_call(leaves, spec, args, kwargs)
                    self._programs[sig] = prog
                    return out
        return prog.run(leaves)

    def _donated_leaves(self, args) -> set:
        out, off = set(), 0
        for i, a in enumerate(args):
            n = len(pytree.tree_leaves(a))
            if i in self.donate_argnums:
                out.update(range(off, off + n))
            off += n
        return out

    def _first_call(self, leaves, spec, args, kwargs):
        pl = _PLANE
        recorded = pl.enabled and self.record
        dev = _program_device(leaves)
        if self.device is not None and dev != self.device:
            raise ValueError(f"program {self.cache} {self.entry}: its "
                             f"tensors lie on {dev}, its leg on "
                             f"{self.device}")
        paths = pytree.tree_flatten_with_path((args, kwargs))[0]
        tracer = pl.tracer if recorded else None
        with _span(tracer, f"compile.{self.cache}", "compile"):
            t0 = pl.clock_ns()
            if dev.type != "cuda":
                prog = _Eager(self.fn, spec, dev)
                out = prog.run(leaves)
                t1 = t2 = pl.clock_ns()
            else:
                if torch.cuda.is_current_stream_capturing():
                    raise CaptureError(
                        f"program {self.cache} {self.entry}: first called "
                        f"inside another program's capture (a signature "
                        f"its warm-up did not call)")
                prog = _Graph(self.fn, f"program {self.cache} {self.entry}",
                              leaves, spec, dev, self._donated_leaves(args),
                              [_path_name(p, self._argnames)
                               for p, _ in paths], self.share_donated,
                              self.nestable)
                out_leaves = prog.warm_up()
                t1 = pl.clock_ns()
                prog.capture()
                t2 = pl.clock_ns()
                out = pytree.tree_unflatten(out_leaves, prog.out_spec)
        prog.info.update(lower_ms=(t1 - t0) / 1e6, compile_ms=(t2 - t1) / 1e6)
        for infos in _collectors():
            infos.append(prog.info)
        if recorded:
            rec = pl.record_compile(
                self.cache, self.entry, lower_ns=t1 - t0,
                compile_ns=t2 - t1, cost={},
                hbm=prog.info.get("memory_analysis", {}),
                path_specs={pytree.keystr(p): _leaf_spec_readable(x)
                            for p, x in paths})
            if tracer is not None:
                tracer.instant(f"compile.{self.cache}.record", "compile",
                               **rec)
        return prog, out


def instrumented_jit(fn, *, cache: str, entry: Any, donate_argnums=()
                     ) -> InstrumentedJit:
    """The module-cache building block:
    ``_CACHE[key] = instrumented_jit(fn, cache="stream.chunk",
    entry=key)``, the JAX package's ``instrumented_jit`` for a captured
    program."""
    return InstrumentedJit(fn, cache=cache, entry=entry,
                           donate_argnums=donate_argnums)


# the most graph replays of a serial program that another program's
# capture holds as child nodes (a block and a remainder); a longer leg
# runs between that program's graph segments
EMBED_REPLAYS = 2


class SerialJit:
    """A captured program of ``steps`` serial steps, the counterpart of
    a JAX program that runs a step under ``lax.scan``.  ``make_body(n)``
    is the body of ``n`` steps, ``(carry, t) -> (carry, t, outs)`` with
    ``outs`` a tree of tensors on a leading ``[n]`` axis.  A CUDA graph
    of every step would hold ``steps`` times a step's launches, so the
    program captures a block of ``block`` steps, the carry donated
    (written back into its static inputs), replays it ``steps // block``
    times, then runs a remainder block of ``steps % block`` steps (a
    second graph of the same entry), and joins ``outs`` in step order:
    the same stream as the body of ``steps`` steps, for any ``steps``
    and ``block``.  It is one cache entry: a signature's first call is
    one compile record (the blocks' warm-ups and captures, summed), a
    new signature a retrace, and the blocks' replays are replays;
    ``record=False`` keeps it out of the records (a leg of a
    :class:`StagedJit`, whose entry records it).  The carry it returns
    is the caller's own (a copy of the static buffers).  On the CPU each
    block is its body run eagerly.  ``fn`` is the eager body of all
    ``steps``.

    Called inside another program's capture (a queue or cluster program
    whose body runs a serial leg), a program of at most
    :data:`EMBED_REPLAYS` graph replays (a block and a remainder) adds
    its graphs to that capture as child nodes; a longer one splits that
    program's graph (:meth:`_Graph.split`): its blocks are replayed from
    the host between the program's segments, as one graph holding every
    replay's copy of the block's nodes would take seconds to instantiate
    at a long ``pull_batch``.

    ``start(carry, t)`` and ``finish(carry, t, outs)`` wrap the blocks:
    the caller's arguments (the signature's) become the blocks' carry,
    and the last block's carry the call's result; a carry may hold
    accumulators each block folds into (a minimum, a metrics vector).
    By default the carry is the caller's and the result ``(carry, t,
    outs)``."""

    __slots__ = ("fn", "cache", "entry", "steps", "block", "record",
                 "start", "finish", "replays", "_parts", "_seen", "_mtx",
                 "__weakref__")

    def __init__(self, make_body, *, steps: int, block: int, cache: str,
                 entry: Any, record: bool = True, start=None, finish=None):
        self.steps = int(steps)
        if self.steps < 1:
            raise ValueError(f"a serial program needs a step, got "
                             f"{self.steps}")
        self.block = max(1, min(int(block), self.steps))
        self.fn = make_body(self.steps)
        self.cache = cache
        self.entry = _entry_str(entry)
        self.record = bool(record)
        self.start = start or (lambda carry, t: carry)
        self.finish = finish or (lambda carry, t, outs: (carry, t, outs))
        reps, rem = divmod(self.steps, self.block)
        self._parts = [(n, InstrumentedJit(
            make_body(size), cache=cache, entry=entry, donate_argnums=(0,),
            record=False, nestable=True))
            for n, size in ((reps, self.block), (1, rem)) if n and size]
        self.replays = sum(n for n, _ in self._parts)
        self._seen: set = set()
        self._mtx = threading.RLock()
        _ALL_PROGRAMS.add(self)

    def clear_compiled(self) -> None:
        with self._mtx:
            self._seen.clear()
            for _, prog in self._parts:
                prog.clear_compiled()

    def captures(self) -> List[dict]:
        """The blocks' captures, the full block first, each with the
        times a call replays it (``replays``)."""
        return [dict(c, replays=n) for n, prog in self._parts
                for c in prog.captures()]

    def __call__(self, carry, t):
        if _eager_on():
            return self.finish(*self.fn(self.start(carry, t), t))
        outer = _capturing()
        if outer and self.replays > EMBED_REPLAYS:
            # inside another program's capture, a longer leg's replays
            # run between that program's graph segments
            return outer[-1].split(self, (carry, t))
        leaves, spec = pytree.tree_flatten(((carry, t), {}))
        sig = _signature(f"program {self.cache} {self.entry}", leaves,
                         spec, (carry, t), {})
        dev = _program_device(leaves)
        args = (carry, t)
        # a Python ``t`` is lifted once, so every block sees one signature
        t = _lift(t, dev)
        with self._mtx:
            first = sig not in self._seen
            held = [len(prog._programs) for _, prog in self._parts]
            carry = self.start(carry, t)
            outs = []
            for n, prog in self._parts:
                for _ in range(n):
                    carry, t, out = prog(carry, t)
                    outs.append(out)
            if first:
                self._seen.add(sig)
                self._record(held, args)
            # the blocks' carry is their static buffers, which the next
            # call (from any thread) rewrites: the copy is taken here
            if dev.type == "cuda":
                carry = pytree.tree_map(
                    lambda x: x.clone() if torch.is_tensor(x) else x, carry)
        joined = outs[0] if len(outs) == 1 else pytree.tree_map(
            lambda *xs: torch.cat(xs), *outs)
        return self.finish(carry, t, joined)

    def _record(self, held, args) -> None:
        """One compile record of the programs the blocks made in this
        call (``held``: each block's count of programs before it)."""
        pl = _PLANE
        if not (pl.enabled and self.record):
            return
        infos = [p.info for (_, prog), n in zip(self._parts, held)
                 for p in list(prog._programs.values())[n:]]
        compile_ns, hbm = _sum_infos(infos)
        paths = pytree.tree_flatten_with_path((args, {}))[0]
        rec = pl.record_compile(
            self.cache, self.entry,
            lower_ns=int(sum(i["lower_ms"] for i in infos) * 1e6),
            compile_ns=compile_ns, cost={}, hbm=hbm,
            path_specs={pytree.keystr(p): _leaf_spec_readable(x)
                        for p, x in paths})
        tracer = pl.tracer
        if tracer is not None:
            tracer.instant(f"compile.{self.cache}.record", "compile", **rec)


def _sum_infos(infos: List[dict]) -> Tuple[int, Dict[str, int]]:
    """The captures' ``compile_ms`` (in ns) and ``memory_analysis``
    summed."""
    hbm: Dict[str, int] = {}
    for info in infos:
        for key, v in info.get("memory_analysis", {}).items():
            hbm[key] = hbm.get(key, 0) + v
    return int(sum(i["compile_ms"] for i in infos) * 1e6), hbm


class Leg(NamedTuple):
    """One leg of a grouped program (:func:`group_legs`): a captured
    program whose tensors all lie on its group's device.  A call runs
    with that device current, so its graph captures and replays on the
    device's current stream (groups that share a device share that
    stream)."""

    name: str
    group: int
    device: torch.device
    program: "InstrumentedJit"

    def __call__(self, *args, **kwargs):
        if self.device.type != "cuda":
            return self.program(*args, **kwargs)
        with torch.cuda.device(self.device):
            return self.program(*args, **kwargs)


def group_legs(make_body: Callable[[int], Callable], devices, *, name: str,
               cache: str, entry: Any, donate_argnums=()) -> Tuple[Leg, ...]:
    """The legs of a program over a layout of ``len(devices)`` groups,
    one a group: group ``g``'s is ``make_body(g)`` as an
    :class:`InstrumentedJit` outside the records (its entry
    ``(name, g) + entry``), pinned to ``devices[g]``, whose donated
    arguments share buffers with the other legs' (``share_donated``), so
    a group's carry passes from one leg to the next with no copy.  A
    bare ``cuda`` is the current card.  Nothing is captured here: the
    plan is read from the layout alone."""
    devs = [_indexed(torch.device(d)) for d in devices]
    return tuple(
        Leg(name, g, d, InstrumentedJit(
            make_body(g), cache=cache, entry=(name, g) + tuple(entry),
            donate_argnums=donate_argnums, device=d, record=False,
            share_donated=True))
        for g, d in enumerate(devs))


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its card's index: a bare ``cuda`` is the current
    card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class StagedJit:
    """A program whose body runs on the host on every call, around legs
    that are captured programs of their own.  Two kinds of body need it:
    one that holds what a CUDA graph cannot (a host read of a device
    value: the device sim's step, ``sim/device_sim.py``
    ``jit_device_sim_step``, reads its loop's status between blocks),
    and a program over a layout of several groups (``parallel/mesh.py``
    ``jit_mesh_chunk``, the three cluster programs of
    ``parallel/cluster.py``), whose ``legs`` are one
    :func:`group_legs` program a group: between the legs the body runs
    the steps that cross groups (the counter sums and the merges) as
    plain operations and copies, with no read back.  ``fn`` is the body;
    its legs are programs outside the records (``record=False``).  Which
    legs there are is fixed before any capture, from the layout and the
    body's own structure; a leg that fails to capture raises
    :class:`CaptureError`, and nothing runs eagerly in its place.

    It is one cache entry with JAX's records: the first call of an
    argument signature (:class:`InstrumentedJit`'s rules: a numpy leaf
    raises ``TypeError``) is one compile record, whose ``compile_ms``
    and ``memory_analysis`` are the captures that call made, summed,
    and ``lower_ms`` the rest of its wall; a new signature on the entry
    is a retrace with its diff.  ``record=False`` keeps the program out
    of the records and spans, as a bare ``jax.jit`` is.  On the CPU the
    legs run their bodies eagerly."""

    __slots__ = ("fn", "cache", "entry", "record", "legs", "_seen", "_mtx",
                 "__weakref__")

    def __init__(self, fn, *, cache: str, entry: Any, record: bool = True,
                 legs=()):
        self.fn = fn
        self.cache = cache
        self.entry = _entry_str(entry)
        self.record = bool(record)
        self.legs: Tuple[Leg, ...] = tuple(legs)
        self._seen: Dict[tuple, List[dict]] = {}
        self._mtx = threading.RLock()
        _ALL_PROGRAMS.add(self)

    def clear_compiled(self) -> None:
        with self._mtx:
            self._seen.clear()
            for leg in self.legs:
                leg.program.clear_compiled()

    def captures(self) -> List[dict]:
        """With ``legs``, every leg's captures, each marked with the
        leg's name, group and device; else the captures each
        signature's first call made (its legs' blocks not captured
        before by another entry)."""
        if self.legs:
            return [dict(c, leg=leg.name, group=leg.group,
                         device=str(leg.device))
                    for leg in self.legs for c in leg.program.captures()]
        with self._mtx:
            return [dict(i) for infos in self._seen.values()
                    for i in infos]

    def __call__(self, *args, **kwargs):
        if _eager_on():
            return self.fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        sig = _signature(f"program {self.cache} {self.entry}", leaves,
                         spec, args, kwargs)
        if sig in self._seen:
            return self.fn(*args, **kwargs)
        with self._mtx:
            if sig in self._seen:
                return self.fn(*args, **kwargs)
            return self._first_call(sig, args, kwargs)

    def _first_call(self, sig, args, kwargs):
        pl = _PLANE
        recorded = pl.enabled and self.record
        tracer = pl.tracer if recorded else None
        infos: List[dict] = []
        stack = _collectors()
        stack.append(infos)
        try:
            with _span(tracer, f"compile.{self.cache}", "compile"):
                t0 = pl.clock_ns()
                out = self.fn(*args, **kwargs)
                t1 = pl.clock_ns()
        finally:
            stack.remove(infos)
        self._seen[sig] = infos
        if recorded:
            compile_ns, hbm = _sum_infos(infos)
            rec = pl.record_compile(
                self.cache, self.entry,
                lower_ns=max(t1 - t0 - compile_ns, 0),
                compile_ns=compile_ns, cost={}, hbm=hbm,
                path_specs={pytree.keystr(p): _leaf_spec_readable(x)
                            for p, x in
                            pytree.tree_flatten_with_path((args,
                                                           kwargs))[0]})
            if tracer is not None:
                tracer.instant(f"compile.{self.cache}.record", "compile",
                               **rec)
        return out


def aot_record(cache: str, entry: Any, fn, *args, donate_argnums=(),
               **kwargs) -> InstrumentedJit:
    """Bench's ahead-of-time discipline: a fresh program of ``fn`` under
    ``(cache, entry)``, captured now on ``args`` (and ``kwargs``) as its
    first call would capture it, that call's result dropped, so the
    first call the caller times is a replay.  The warm-up runs the body
    once on copies of the arguments, which it does not change."""
    prog = InstrumentedJit(fn, cache=cache, entry=entry,
                           donate_argnums=donate_argnums)
    prog(*args, **kwargs)
    return prog
