"""Structured host spans: where wall time goes around device launches.

Counterpart of ``dmclock_tpu/obs/spans.py``; host code only, so the port
keeps its own copy.  A thread-safe, ns-resolution span tracer:

- spans nest (per-thread stacks), carry one of the fixed
  :data:`CATEGORIES`, and record wall ``ts``/``dur`` from the injected
  clock (``perf_counter_ns`` by default) plus **self time** (duration
  minus child spans), so category sums attribute wall time without
  double counting;
- storage is a bounded ring (past the cap the oldest rows drop,
  counted) with per-(name, category) aggregates that survive the ring
  wrapping;
- export: JSONL (one row per span) and an append-and-clear
  ``drain_jsonl`` for periodic flushes.

Spans observe wall time around launches and never touch a tensor, so
decisions are identical with a tracer or without.  The tracing-off path
is one ``None`` check per call site (:func:`span` returns a shared no-op
context manager).
"""

from __future__ import annotations

import json
import threading
import time as _walltime
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

# The fixed category taxonomy, the JAX package's ("compile" holds the
# kernel library's build, ``obs/compile_plane.py``).  Every span carries
# exactly one; an unknown category raises.
CATEGORIES = ("ingest", "host_prep", "dispatch", "device_compute",
              "fetch", "drain", "checkpoint", "retry", "compile")

# JSONL row schema: ts/dur/self in ns from the tracer's clock
# (perf_counter_ns by default: monotonic within a process, not
# comparable across processes).
ROW_FIELDS = ("name", "cat", "ts", "dur", "self", "tid", "depth",
              "args")


class _NullSpan:
    """Shared no-op context manager: the entire tracing-off cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(tracer: Optional["SpanTracer"], name: str, cat: str, **args):
    """``with span(tracer, name, cat):`` -- a no-op when ``tracer`` is
    None, so call sites need no branching and the off path costs one
    function call + a None test."""
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(name, cat, **args)


def instant(tracer: Optional["SpanTracer"], name: str, cat: str,
            **args) -> None:
    """Zero-duration event (a retry, a ladder step) -- no-op when
    ``tracer`` is None."""
    if tracer is not None:
        tracer.instant(name, cat, **args)


class _Span:
    """One open span; the context manager ``SpanTracer.span`` returns.
    Mutable slots only -- allocation per span is the on-path cost, and
    it is a few hundred ns."""

    __slots__ = ("_tr", "name", "cat", "args", "t0", "child_ns",
                 "depth")

    def __init__(self, tracer, name, cat, args):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0
        self.child_ns = 0
        self.depth = 0

    def __enter__(self):
        self._tr._push(self)
        return self

    def __exit__(self, *exc):
        self._tr._pop(self)
        return False


class SpanTracer:
    """Thread-safe ns-resolution structured span tracer.

    ``limit`` bounds the in-memory ring (rows past it drop oldest
    first, counted in ``spans_dropped``); the per-(name, cat)
    aggregates and per-category self-time totals are unbounded and
    exact regardless of ring wrap.  ``clock_ns`` is injectable for
    deterministic tests.
    """

    def __init__(self, limit: int = 200_000,
                 clock_ns: Callable[[], int] =
                 _walltime.perf_counter_ns):
        self.limit = int(limit)
        self._clock = clock_ns
        self._mtx = threading.Lock()
        self._ring: deque = deque(maxlen=self.limit)
        self._local = threading.local()
        self.spans_recorded = 0
        self.spans_dropped = 0
        # spans lost to broken enter/exit discipline (a child left
        # open when its parent exited, a double __exit__): their rows
        # and time are NOT recorded, so the loss must at least be
        # countable
        self.spans_leaked = 0
        # per-category SELF time + span count: parents never double
        # count their children, so summing categories attributes wall
        # time exactly (the >=95%-of-wall acceptance gate's currency)
        self._cat_self: Dict[str, int] = {c: 0 for c in CATEGORIES}
        self._cat_count: Dict[str, int] = {c: 0 for c in CATEGORIES}
        # (name, cat) -> [count, total_ns, self_ns]
        self._agg: Dict[Tuple[str, str], List[int]] = {}
        # cat -> last span-end timestamp (watchdog stall detection)
        self._last_end: Dict[str, int] = {}
        # tid -> that thread's open-span stack, for cross-thread
        # in-flight reads (open_categories); registered once per
        # thread, so the hot path stays lock-free
        self._all_stacks: Dict[int, list] = {}

    # -- recording -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            with self._mtx:
                self._all_stacks[threading.get_ident()] = st
        return st

    def span(self, name: str, cat: str, **args) -> _Span:
        # a real raise, not an assert: under PYTHONOPTIMIZE an assert
        # strips and a typo'd category would silently fragment the
        # attribution tables (the ProfileTimer double-start lesson)
        if cat not in CATEGORIES:
            raise ValueError(f"unknown span category {cat!r} "
                             f"(taxonomy: {CATEGORIES})")
        return _Span(self, name, cat, args or None)

    def _push(self, sp: _Span) -> None:
        st = self._stack()
        sp.depth = len(st)
        # t0 BEFORE the append: the cross-thread readers
        # (oldest_open_ns / open_categories) walk the stack lock-free,
        # and a span visible with t0 still 0 would read as infinitely
        # old -- defeating the watchdog's in-flight stall suppression
        # it exists to serve
        sp.t0 = self._clock()
        st.append(sp)

    def _pop(self, sp: _Span) -> None:
        end = self._clock()
        st = self._stack()
        if sp not in st:
            # double __exit__, or a child exiting after its parent
            # already popped through it: recording again would
            # duplicate (or fabricate) a row -- count the discipline
            # break instead of corrupting the stack
            with self._mtx:
                self.spans_leaked += 1
            return
        # tolerate exits out of order (a caller leaking an open child
        # while the parent exits): pop through to this span, counting
        # each leaked child -- their rows are lost, not silent
        leaked = 0
        while st[-1] is not sp:
            st.pop()
            leaked += 1
        st.pop()
        if leaked:
            with self._mtx:
                self.spans_leaked += leaked
        dur = end - sp.t0
        if st:
            st[-1].child_ns += dur
        self._record(sp.name, sp.cat, sp.t0, dur,
                     dur - sp.child_ns, sp.depth, sp.args)

    def instant(self, name: str, cat: str, **args) -> None:
        if cat not in CATEGORIES:
            raise ValueError(f"unknown span category {cat!r} "
                             f"(taxonomy: {CATEGORIES})")
        self._record(name, cat, self._clock(), 0, 0,
                     len(self._stack()), args or None)

    def _record(self, name, cat, ts, dur, self_ns, depth, args) -> None:
        row = {"name": name, "cat": cat, "ts": ts, "dur": dur,
               "self": self_ns, "tid": threading.get_ident(),
               "depth": depth, "args": args}
        with self._mtx:
            if len(self._ring) == self.limit:
                self.spans_dropped += 1
            self._ring.append(row)
            self.spans_recorded += 1
            self._cat_self[cat] = self._cat_self.get(cat, 0) + self_ns
            self._cat_count[cat] = self._cat_count.get(cat, 0) + 1
            a = self._agg.get((name, cat))
            if a is None:
                self._agg[(name, cat)] = [1, dur, self_ns]
            else:
                a[0] += 1
                a[1] += dur
                a[2] += self_ns
            self._last_end[cat] = ts + dur

    # -- reading -------------------------------------------------------
    def rows(self) -> List[dict]:
        """Snapshot of the ring (oldest first), without clearing."""
        with self._mtx:
            return list(self._ring)

    def drain(self) -> List[dict]:
        """Take everything currently in the ring and clear it -- the
        epoch-boundary flush primitive (aggregates are untouched)."""
        with self._mtx:
            rows = list(self._ring)
            self._ring.clear()
            return rows

    def category_totals(self) -> Dict[str, int]:
        """cat -> accumulated SELF time ns (copy)."""
        with self._mtx:
            return dict(self._cat_self)

    def category_counts(self) -> Dict[str, int]:
        with self._mtx:
            return dict(self._cat_count)

    def last_end_ns(self, cat: str) -> Optional[int]:
        """End timestamp of the most recent span in ``cat`` (watchdog
        stall detection); None before the first one closes."""
        with self._mtx:
            return self._last_end.get(cat)

    def _live_stacks(self):
        """Snapshot (tid, stack) pairs for LIVE threads, pruning dead
        threads' stacks as a side effect.  A thread that exited with
        spans still open is a discipline break: its orphans are folded
        into ``spans_leaked`` and its registry entry dropped, so they
        neither report as in-flight work forever (which would
        permanently blind the watchdog's stall check) nor pin the
        registry's memory under thread churn.  Best-effort snapshot:
        the stacks mutate lock-free on their owning threads, so a span
        entered/exited mid-walk may be missed or double-seen for one
        poll -- fine for a sampler."""
        with self._mtx:
            items = list(self._all_stacks.items())
        alive = {t.ident for t in threading.enumerate()}
        live = []
        dead = []
        for tid, st in items:
            if tid not in alive:
                dead.append((tid, len(tuple(st))))
            else:
                live.append((tid, st))
        if dead:
            with self._mtx:
                # ONE fresh alive snapshot under the lock (the
                # recording hot path contends on this mutex, so the
                # critical section must stay O(threads), not
                # O(dead x threads)): CPython reuses thread idents,
                # and a new thread may have re-registered a dead key
                # since the first snapshot
                alive2 = {t.ident for t in threading.enumerate()}
                for tid, leaked in dead:
                    if tid in self._all_stacks and tid not in alive2:
                        self._all_stacks.pop(tid)
                        self.spans_leaked += leaked
        return live

    def open_categories(self) -> Dict[str, int]:
        """cat -> number of spans currently OPEN across all threads --
        the watchdog's in-flight-dispatch awareness: a fused stream
        launch legitimately runs for seconds with no dispatch span
        COMPLETING, but the blocked ``device_wait`` span is open the
        whole time, and an open launch is not a stalled cadence."""
        out: Dict[str, int] = {}
        for _tid, st in self._live_stacks():
            for sp in tuple(st):
                out[sp.cat] = out.get(sp.cat, 0) + 1
        return out

    def oldest_open_ns(self, cats=("dispatch", "device_compute")
                       ) -> Optional[int]:
        """Start timestamp of the OLDEST currently-open span in
        ``cats`` across live threads (None when nothing is open) --
        what bounds the watchdog's in-flight stall suppression: an
        open launch suppresses the stall warning only while it is
        younger than the wedge threshold, so a launch the runtime
        wedged INSIDE still surfaces."""
        oldest = None
        for _tid, st in self._live_stacks():
            for sp in tuple(st):
                if sp.cat in cats and \
                        (oldest is None or sp.t0 < oldest):
                    oldest = sp.t0
        return oldest

    def name_stats(self) -> Dict[Tuple[str, str], Tuple[int, int, int]]:
        """(name, cat) -> (count, total_ns, self_ns); exact past ring
        wrap."""
        with self._mtx:
            return {k: tuple(v) for k, v in self._agg.items()}

    def summary(self) -> dict:
        """JSON-able rollup of the counters and aggregates."""
        with self._mtx:
            return {
                "spans": self.spans_recorded,
                "dropped": self.spans_dropped,
                "leaked": self.spans_leaked,
                "categories": {
                    c: {"count": self._cat_count.get(c, 0),
                        "self_ns": self._cat_self.get(c, 0)}
                    for c in CATEGORIES if self._cat_count.get(c, 0)},
                "by_name": {
                    f"{name}|{cat}": {"count": v[0], "total_ns": v[1],
                                      "self_ns": v[2]}
                    for (name, cat), v in self._agg.items()},
            }

    # -- export --------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Write every ring row as JSONL (the raw-span interchange
        format ``scripts/torch_trace_report.py`` and ``trace_export``
        consume).  Returns the row count."""
        rows = self.rows()
        with open(path, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r, separators=(",", ":")) + "\n")
        return len(rows)

    def drain_jsonl(self, path: str) -> int:
        """Append the un-flushed rows to ``path`` and clear the ring:
        a periodic flush loses at most the rows since the last one if
        the process dies."""
        rows = self.drain()
        if not rows:
            return 0
        with open(path, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r, separators=(",", ":")) + "\n")
            fh.flush()
        return len(rows)


def load_jsonl(path: str) -> List[dict]:
    """Read a span JSONL stream back (skips blank lines; raises
    ``ValueError`` on a malformed row)."""
    rows = []
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON: {e}")
            if not isinstance(row, dict) or "name" not in row \
                    or "ts" not in row:
                raise ValueError(f"{path}:{i}: not a span row")
            rows.append(row)
    return rows
