"""The guarded-commit contract: trip -> commit nothing -> resume
(the port of ``dmclock_tpu/robust/guarded.py``'s ``retry_with_backoff``,
``GuardedEpoch`` and ``run_epoch_guarded``).

1. **Device side**: an epoch batch that trips a guard (the int32 tag
   window, the creation-order/cost rebase guard, calendar no-progress)
   commits nothing; the epoch keeps the last good state and reports the
   trip in ``guards_ok``/``progress_ok``.  :func:`run_epoch_guarded` is
   the host half that resumes the remaining batches on the exact path.
2. **Host side**: transient host-side failures around a launch retry
   with bounded exponential backoff (:func:`retry_with_backoff`; the
   pull queue wraps every launch in it).  Launches are pure (state
   rebinds only from a returned value), so a failed attempt commits
   nothing.

Only transport-level failures are retried: ``OSError`` (which covers
``ConnectionError``) and ``TimeoutError``.  The JAX set adds its device
runtime error; PyTorch has no counterpart to add.  A CUDA error is
sticky in a process -- every later call on that context fails too -- so
a retry cannot clear it: it is never caught here, and nothing falls
back to the CPU.  Plain ``RuntimeError`` is not retried either: a
generic host error is a caller bug.

The same contract at stream-chunk granularity is
:func:`run_stream_chunk_guarded`: a chunk that trips a guard anywhere is
discarded and its epochs re-run one by one on the round path.  Above
both sits the :class:`DegradationLadder`: repeated guard trips step a
job down to an exact twin of its fast path (wheel -> bucketed ->
minstop, radix -> sort, tag32 -> tag64).  The ladder never sees a CUDA
error: those are not in :data:`RECOVERABLE_ERRORS`, so they propagate
out of the job and nothing steps down for them.

Every launch here is a captured program (``obs/compile_plane.py``) of
a module cache under the JAX package's cache name and key: the epoch
(:func:`_jit_epoch`, ``guarded.epoch``), its serial resume
(:func:`_jit_serial`, ``guarded.serial``), the stream chunk and its
ingest leg (``engine.stream``) and the mesh chunk (``parallel.mesh``
``jit_mesh_chunk``).  Where the port differs from JAX: the JAX key of an
epoch carries ``('wheel_kernel', ...)``, a knob the port has not got, so
the port's key lacks that one item; the serial resume replays a captured
block of ``engine.kernels.SERIAL_BLOCK`` steps and a remainder where JAX
scans one step; and the host replay's pressure probe
(:func:`_pressure_probe`) is a captured program kept out of the plane's
records, as JAX's bare ``jax.jit`` is.  The count and guard read of an
epoch (:func:`_count_and_guards`) and the wait for its device stay
outside every program: they are an epoch's one read back.
"""

from __future__ import annotations

import time as _time
from typing import Callable, NamedTuple, Optional

import torch

RECOVERABLE_ERRORS = (OSError, TimeoutError)


def retry_with_backoff(fn: Callable, *, retries: int = 3,
                       base_s: float = 0.05, factor: float = 2.0,
                       max_s: float = 2.0,
                       recoverable=RECOVERABLE_ERRORS,
                       on_retry: Optional[Callable[[int, BaseException],
                                                   None]] = None,
                       sleep: Callable[[float], None] = _time.sleep,
                       jitter_seed: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       clock: Callable[[], float] = _time.monotonic):
    """Call ``fn()``; on a recoverable error sleep
    ``min(base_s * factor**i, max_s)`` and retry, at most ``retries``
    times, then re-raise the last error.  ``on_retry(attempt, exc)``
    observes each retry.  ``fn`` must be idempotent.

    ``jitter_seed`` scales every sleep by a deterministic per-seed
    multiplier in ``[0.5, 1.5)`` (numpy PCG64), so callers retrying
    after one shared failure spread out.  ``deadline_s`` bounds the
    total time measured by ``clock()``: once spent, the next
    recoverable error re-raises even with retries left, and a final
    sleep is cut to the remaining budget."""
    rng = None
    if jitter_seed is not None:
        import numpy as np
        rng = np.random.Generator(np.random.PCG64(int(jitter_seed)))
    t0 = clock() if deadline_s is not None else 0.0
    attempt = 0
    while True:
        try:
            return fn()
        except recoverable as e:
            if attempt >= retries:
                raise
            if deadline_s is not None and clock() - t0 >= deadline_s:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = min(base_s * (factor ** attempt), max_s)
            if rng is not None:
                delay *= 0.5 + rng.random()
            if deadline_s is not None:
                delay = min(delay, max(deadline_s - (clock() - t0), 0.0))
            sleep(delay)
            attempt += 1


class GuardedEpoch(NamedTuple):
    """Result of :func:`run_epoch_guarded`."""

    state: object            # EngineState after every committed batch
    count: int               # decisions committed (the resumes included)
    results: tuple           # the raw epoch result(s), in run order
    rebase_fallbacks: int    # tag32 window trips resumed on int64
    serial_fallbacks: int    # order/cost guard trips resumed serially
    retries: int             # transient errors retried
    # telemetry accumulators after the LAST scan attempt (pass-through
    # state: a tag32 resume continues from the first attempt's outputs;
    # the serial fallback's decisions are not telemetered).  None when
    # the caller passed none in.
    hists: object = None
    ledger: object = None
    flight: object = None
    slo: object = None
    prov: object = None


# module caches of captured programs keyed by the static epoch
# configuration, as the JAX package's ``_EPOCH_JIT_CACHE``: the epoch
# programs and the serial resumes share it
_EPOCH_JIT_CACHE: dict = {}

# the host replay's pressure probe: one captured program, outside the
# plane's records
_PRESSURE_PROBE_JIT: list = []


def _jit_epoch(engine: str, m_run: int, kw: dict, tele_sig=()):
    """The captured epoch of ``engine`` at ``m_run`` batches and the scan
    kwargs ``kw`` (cache ``guarded.epoch``).  ``tele_sig`` names the
    telemetry accumulators the program takes as its third argument, a
    dict: inputs, never closed over, so one capture serves every call.
    Not donated, as in JAX: a tripped epoch resumes from its input.  The
    scan is looked up from ``fastpath.epoch_scan_fn`` each time the body
    runs (each call on the CPU, the warm-up and the capture on the
    card)."""
    key = (engine, m_run, tuple(sorted(kw.items())), tele_sig)
    if key not in _EPOCH_JIT_CACHE:
        from ..engine import fastpath
        from ..obs import compile_plane

        if tele_sig:
            def run(st, t, tele):
                return fastpath.epoch_scan_fn(engine)(st, t, m=m_run, **kw,
                                                      **tele)
        else:
            def run(st, t):
                return fastpath.epoch_scan_fn(engine)(st, t, m=m_run, **kw)
        _EPOCH_JIT_CACHE[key] = compile_plane.instrumented_jit(
            run, cache="guarded.epoch", entry=key)
    return _EPOCH_JIT_CACHE[key]


def _jit_serial(steps: int, allow_limit_break: bool,
                anticipation_ns: int):
    """The captured serial resume ``(state, t) -> (state, t, decisions)``,
    ``engine_run`` for ``steps`` steps at a fixed ``t`` (cache
    ``guarded.serial``): ``engine.kernels.serial_program``'s blocks."""
    key = ("serial", steps, allow_limit_break, anticipation_ns)
    if key not in _EPOCH_JIT_CACHE:
        from ..engine import kernels

        _EPOCH_JIT_CACHE[key] = kernels.serial_program(
            steps, allow_limit_break=allow_limit_break,
            anticipation_ns=anticipation_ns, cache="guarded.serial",
            entry=key)
    return _EPOCH_JIT_CACHE[key]


def _pressure_probe():
    """``obs.provenance.pressure_vec`` captured for the host replay: the
    integer-only reads of the fused chunk's in-epoch probe, so it equals
    that probe bit for bit."""
    if not _PRESSURE_PROBE_JIT:
        from ..obs import compile_plane
        from ..obs import provenance as obsprov

        _PRESSURE_PROBE_JIT.append(compile_plane.InstrumentedJit(
            obsprov.pressure_vec, cache="guarded.pressure_probe",
            entry=(), record=False))
    return _PRESSURE_PROBE_JIT[0]


def _device_wait(state) -> None:
    """Wait for the state's device, or every group's device of a
    grouped tensor (the JAX ``block_until_ready``)."""
    from ..parallel import groups

    for dev in dict.fromkeys(groups.group_devices(state)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _count_and_guards(engine: str, result):
    """``(count, guard vector)`` of an epoch result in one copy to the
    host: the epoch's only read back."""
    ok = result.progress_ok if engine == "calendar" else result.guards_ok
    m = ok.shape[0]
    both = torch.cat([result.count.reshape(-1).to(torch.int64),
                      ok.reshape(-1).to(torch.int64)]).cpu().numpy()
    return int(both[:-m].sum()), both[-m:].astype(bool)


def run_epoch_guarded(state, now, *, engine: str = "prefix",
                      m: int, k: int = 0, chain_depth: int = 4,
                      anticipation_ns: int = 0,
                      allow_limit_break: bool = False,
                      with_metrics: bool = False,
                      select_impl: str = "sort",
                      tag_width: int = 64,
                      window_m: Optional[int] = None,
                      calendar_impl: str = "minstop",
                      ladder_levels: int = 8,
                      skew_ns: int = 0,
                      hists=None, ledger=None, flight=None, slo=None,
                      prov=None,
                      retries: int = 3, base_s: float = 0.05,
                      sleep: Callable[[float], None] = _time.sleep,
                      on_retry=None, tracer=None) -> GuardedEpoch:
    """Run one epoch of any of the three epoch engines under the
    guarded-commit contract, host side included.

    The epoch itself commits nothing on a trip; this wrapper (a) retries
    transient failures with bounded backoff, (b) on a tag32 window trip
    resumes the remaining batches from the returned last-good state on
    the int64 path, and (c) on an order/cost guard trip (or calendar
    no-progress) on the exact path resumes on the serial engine,
    ``max(remaining, 1) * max(k, 1)`` steps at the same ``now``.
    ``skew_ns`` is a fault-injection hook: the epoch sees ``now +
    skew_ns``.  With ``skew_ns=0`` the first attempt is the plain epoch
    call, bit-identical to no wrapper.

    ``hists`` / ``ledger`` / ``flight`` / ``slo`` / ``prov`` (None =
    off) are the telemetry accumulators of ``fastpath.scan_*_epoch``,
    threaded through: a tag32 resume continues accumulating from the
    first attempt's outputs, and the serial fallback passes them through
    untouched (its decisions are not telemetered).

    ``tracer`` (``obs.spans.SpanTracer`` or None) records
    ``guarded.dispatch`` around each call and ``guarded.device_wait``
    around the wait for the state's device, plus ``guarded.retry``,
    ``guarded.rebase_resume`` and ``guarded.serial_resume`` instants.
    Each call is a captured program (:func:`_jit_epoch`,
    :func:`_jit_serial`); a new ``m`` of the int64 resume is a new entry,
    as in JAX.  The JAX package's ``wheel_kernel`` knob has no
    counterpart: the device picks kernel K2's route."""
    from ..engine import fastpath, kernels
    from ..engine.kernels import as_scalar
    from ..obs import spans as _spans

    if engine not in fastpath.EPOCH_ENGINES:
        raise ValueError(f"unknown epoch engine {engine!r}")
    kw = fastpath.epoch_scan_kwargs(
        engine, k=k, chain_depth=chain_depth, select_impl=select_impl,
        tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break,
        with_metrics=with_metrics)
    retry_count = [0]

    def count_retry(attempt, exc):
        retry_count[0] += 1
        _spans.instant(tracer, "guarded.retry", "retry",
                       error=type(exc).__name__)
        if on_retry is not None:
            on_retry(attempt, exc)

    tele = {name: v for name, v in (("hists", hists), ("ledger", ledger),
                                    ("flight", flight), ("slo", slo),
                                    ("prov", prov)) if v is not None}
    tele_sig = tuple(sorted(tele))

    def guarded(one):
        return retry_with_backoff(one, retries=retries, base_s=base_s,
                                  sleep=sleep, on_retry=count_retry)

    def attempt(st, t, m_run, width):
        fn = _jit_epoch(engine, m_run, {**kw, "tag_width": width}, tele_sig)

        def one():
            with _spans.span(tracer, "guarded.dispatch", "dispatch",
                             engine=engine, m=m_run):
                out = fn(st, t, tele) if tele_sig else fn(st, t)
            with _spans.span(tracer, "guarded.device_wait",
                             "device_compute"):
                _device_wait(out.state)
            return out

        return guarded(one)

    def take_tele(ep):
        for name in tele_sig:
            tele[name] = getattr(ep, name)

    t = as_scalar(now, state.device) + int(skew_ns)
    results = []
    rebase_fb = serial_fb = 0
    ep = attempt(state, t, m, tag_width)
    results.append(ep)
    take_tele(ep)
    total, guards = _count_and_guards(engine, ep)
    state = ep.state
    if not guards.all():
        remaining = int(m - guards.sum())
        if tag_width == 32:
            # tag32 window trip: the batch committed nothing; resume the
            # remaining batches on the int64 path
            rebase_fb = 1
            _spans.instant(tracer, "guarded.rebase_resume", "retry",
                           remaining=remaining)
            ep2 = attempt(state, t, remaining, 64)
            results.append(ep2)
            take_tele(ep2)
            c2, guards = _count_and_guards(engine, ep2)
            total += c2
            state = ep2.state
            remaining = int(remaining - guards.sum())
        if not guards.all():
            # order/cost guard (or calendar no-progress) on the exact
            # path: the serial engine for the rest
            serial_fb = 1
            _spans.instant(tracer, "guarded.serial_resume", "retry",
                           remaining=remaining)
            run = _jit_serial(max(remaining, 1) * max(k, 1),
                              allow_limit_break, anticipation_ns)
            st0 = state

            def serial_one():
                with _spans.span(tracer, "guarded.dispatch", "dispatch",
                                 engine="serial"):
                    out = run(st0, t)
                with _spans.span(tracer, "guarded.device_wait",
                                 "device_compute"):
                    _device_wait(out[0])
                return out

            state, _, decs = guarded(serial_one)
            total += int((decs.type == kernels.RETURNING).sum())
            results.append(decs)
    return GuardedEpoch(state=state, count=total,
                        results=tuple(results),
                        rebase_fallbacks=rebase_fb,
                        serial_fallbacks=serial_fb,
                        retries=retry_count[0],
                        hists=tele.get("hists"),
                        ledger=tele.get("ledger"),
                        flight=tele.get("flight"),
                        slo=tele.get("slo"),
                        prov=tele.get("prov"))


class StreamGuarded(NamedTuple):
    """Result of :func:`run_stream_chunk_guarded`: one stream chunk,
    drained to per-epoch rows, so the caller runs the round loop's
    digest, metric-fold and ladder bookkeeping over it unchanged."""

    state: object            # EngineState after the whole chunk
    epochs: tuple            # per epoch, the tuple of raw results (what
    #                          GuardedEpoch.results holds)
    counts: tuple            # per-epoch decisions committed
    guard_trips: tuple       # per-epoch rebase + serial fallbacks
    stream_fallback: int     # 1 when the chunk tripped and re-ran on
    #                          the round path
    retries: int             # transient errors retried
    hists: object = None     # telemetry accumulators after the chunk
    ledger: object = None
    flight: object = None
    slo: object = None
    prov: object = None


def run_stream_chunk_guarded(state, epoch0: int, counts, *,
                             engine: str, epochs: int, m: int,
                             k: int = 0, chain_depth: int = 4,
                             dt_epoch_ns: int, waves: int,
                             anticipation_ns: int = 0,
                             allow_limit_break: bool = False,
                             with_metrics: bool = True,
                             select_impl: str = "sort",
                             tag_width: int = 64,
                             window_m: Optional[int] = None,
                             calendar_impl: str = "minstop",
                             ladder_levels: int = 8,
                             hists=None, ledger=None, flight=None,
                             slo=None, prov=None,
                             retries: int = 3, base_s: float = 0.05,
                             sleep: Callable[[float], None] =
                             _time.sleep,
                             on_retry=None, tracer=None,
                             overlap: Optional[Callable[[], None]]
                             = None) -> StreamGuarded:
    """Run one fused ingest + serve stream chunk (``engine.stream``)
    under the guarded-commit contract, at chunk granularity.

    - The chunk launch retries transient host errors with bounded
      backoff, like the per-epoch launches.
    - ``overlap()`` (idempotent; may be None) runs after the chunk is
      enqueued and before the host waits on it: the double-buffer seam
      where the caller draws chunk T+1's arrivals while the card runs
      chunk T.
    - A guard trip anywhere in the chunk (tag32 window, order/cost
      rebase, calendar no-progress) discards the whole chunk and re-runs
      its epochs one by one through ``stream.jit_ingest_step`` and
      :func:`run_epoch_guarded`, from the entry state and the entry
      telemetry, which the chunk never writes in place.
      ``stream_fallback`` reports it.

    ``counts`` is ``int32[epochs, N]`` of raw Poisson draws (numpy or a
    tensor), or None for a chunk without ingest; the chunk clamps them
    on the device.  The chunk reads back once, its stacked outputs with
    the guard row among them.  ``tracer`` records ``stream.dispatch``,
    ``stream.device_wait``, ``stream.retry`` and ``stream.fallback``."""
    import numpy as np

    from ..engine import stream as stream_mod
    from ..obs import spans as _spans

    epochs = int(epochs)
    do_ingest = counts is not None
    fn = stream_mod.jit_stream_chunk(
        engine=engine, epochs=epochs, m=m, k=k, chain_depth=chain_depth,
        dt_epoch_ns=dt_epoch_ns, waves=waves,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics,
        select_impl=select_impl, tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        ingest=do_ingest, donate=False)
    retry_count = [0]

    def count_retry(attempt, exc):
        retry_count[0] += 1
        _spans.instant(tracer, "stream.retry", "retry",
                       error=type(exc).__name__)
        if on_retry is not None:
            on_retry(attempt, exc)

    counts_dev = None
    if do_ingest:
        counts_dev = counts.to(state.device, torch.int32) \
            if torch.is_tensor(counts) else torch.from_numpy(
                np.ascontiguousarray(counts, dtype=np.int32)).to(
                    state.device)

    def one():
        with _spans.span(tracer, "stream.dispatch", "dispatch",
                         engine=engine, epochs=epochs):
            out = fn(state, int(epoch0), counts_dev, hists, ledger,
                     flight, slo, prov)
        if overlap is not None:
            overlap()     # the host's draws ride the chunk's device time
        with _spans.span(tracer, "stream.device_wait",
                         "device_compute"):
            _device_wait(out.state)
        return out

    out = retry_with_backoff(one, retries=retries, base_s=base_s,
                             sleep=sleep, on_retry=count_retry)

    # the chunk's one read back: every stacked output, the guard row
    # among them
    fetched = {name: v.cpu() for name, v in out.outs.items()}
    if bool(fetched[stream_mod.STREAM_GUARD_FIELD[engine]].all()):
        return StreamGuarded(
            state=out.state,
            epochs=tuple((stream_mod.epoch_view(engine, fetched, i),)
                         for i in range(epochs)),
            counts=tuple(stream_mod.epoch_decisions(engine, fetched, i)
                         for i in range(epochs)),
            guard_trips=(0,) * epochs, stream_fallback=0,
            retries=retry_count[0], hists=out.hists, ledger=out.ledger,
            flight=out.flight, slo=out.slo, prov=out.prov)

    # a guard tripped in the chunk: the chunk cannot resume mid-run, so
    # its outputs are dropped and its epochs replay on the round path
    # from the entry state; the epochs before the trip recompute bit
    # for bit, the tripped one resumes as the round loop would
    _spans.instant(tracer, "stream.fallback", "retry", engine=engine,
                   epochs=epochs)
    ingest_step = stream_mod.jit_ingest_step(
        dt_epoch_ns=dt_epoch_ns, waves=waves) if do_ingest else None
    st = state
    cur = {"hists": hists, "ledger": ledger, "flight": flight,
           "slo": slo, "prov": prov}
    ep_rows, count_rows, trip_rows = [], [], []
    for i in range(epochs):
        t_base = (int(epoch0) + i) * int(dt_epoch_ns)
        if ingest_step is not None:
            st = ingest_step(st, counts_dev[i], t_base)
        ep = run_epoch_guarded(
            st, t_base + int(dt_epoch_ns), engine=engine, m=m, k=k,
            chain_depth=chain_depth, anticipation_ns=anticipation_ns,
            allow_limit_break=allow_limit_break,
            with_metrics=with_metrics, select_impl=select_impl,
            tag_width=tag_width, window_m=window_m,
            calendar_impl=calendar_impl, ladder_levels=ladder_levels,
            retries=retries, base_s=base_s, sleep=sleep,
            on_retry=on_retry, tracer=tracer, **cur)
        st = ep.state
        for name in cur:
            if cur[name] is not None:
                cur[name] = getattr(ep, name)
        retry_count[0] += ep.retries
        ep_rows.append(ep.results)
        count_rows.append(ep.count)
        trip_rows.append(ep.rebase_fallbacks + ep.serial_fallbacks)
    return StreamGuarded(
        state=st, epochs=tuple(ep_rows), counts=tuple(count_rows),
        guard_trips=tuple(trip_rows), stream_fallback=1,
        retries=retry_count[0], **cur)


# ----------------------------------------------------------------------
# the degradation ladder
# ----------------------------------------------------------------------

# Cheapest concession first: each (knob, fast, safe) rung trades a fast
# path for its exact twin, so a degraded run is slower, never divergent.
# The two calendar rungs share a knob and chain (wheel -> bucketed, then
# bucketed -> minstop): a rung is keyed by (knob, fast), not knob alone.
LADDER_RUNGS = (
    ("calendar_impl", "wheel", "bucketed"),
    ("calendar_impl", "bucketed", "minstop"),
    ("select_impl", "radix", "sort"),
    ("tag_width", 32, 64),
)


class LadderStep(NamedTuple):
    """One recorded step-down."""

    knob: str
    from_value: object
    to_value: object
    reason: str     # "guard_trips" | "launch_failures" | "resumed"


class DegradationLadder:
    """Escalation policy over the guarded-commit contract: when an epoch
    loop trips guards (or exhausts its transient-error retries) for
    ``threshold`` consecutive epochs, step down one rung of
    :data:`LADDER_RUNGS` (the first still engaged in the caller's
    config) and keep serving.  Disabled, it is inert: ``apply`` is the
    identity and ``note_epoch`` never steps.

    :meth:`encode` / :meth:`load` round-trip the engaged rungs and the
    trip counter through an int64 vector, so a resumed run keeps
    serving at the same degraded operating point.  A CUDA error never
    reaches the ladder: it is not recoverable and propagates."""

    def __init__(self, enabled: bool = True, threshold: int = 2,
                 tracer=None):
        self.enabled = bool(enabled)
        self.threshold = max(int(threshold), 1)
        self.steps: list = []       # LadderStep, in engagement order
        self._consecutive = 0
        # optional obs.spans.SpanTracer: each step-down records a
        # "ladder.step" instant
        self.tracer = tracer

    @property
    def steps_taken(self) -> int:
        return len(self.steps)

    def _engaged(self, knob: str, fast) -> bool:
        return any(s.knob == knob and s.from_value == fast
                   for s in self.steps)

    def apply(self, cfg: dict) -> dict:
        """Map a config through the engaged rungs; rung order chains the
        two calendar rungs (wheel -> bucketed -> minstop)."""
        out = dict(cfg)
        for knob, fast, safe in LADDER_RUNGS:
            if self._engaged(knob, fast) and out.get(knob) == fast:
                out[knob] = safe
        return out

    def can_step(self, cfg: dict) -> bool:
        """True while a rung is still engageable for ``cfg``: a failure
        with nothing left to concede must surface, not spin."""
        return self.enabled and any(
            cfg.get(knob) == fast and not self._engaged(knob, fast)
            for knob, fast, _safe in LADDER_RUNGS)

    def note_epoch(self, cfg: dict, *, guard_trips: int = 0,
                   launch_failures: int = 0) -> int:
        """Observe one epoch's fault counts (``cfg`` after ``apply``).
        Returns the step-downs taken (0 or 1); a clean epoch resets the
        consecutive-trip counter."""
        if not self.enabled:
            return 0
        if not (guard_trips or launch_failures):
            self._consecutive = 0
            return 0
        self._consecutive += 1
        if self._consecutive < self.threshold:
            return 0
        self._consecutive = 0
        for knob, fast, safe in LADDER_RUNGS:
            if cfg.get(knob) == fast and not self._engaged(knob, fast):
                reason = "guard_trips" if guard_trips \
                    else "launch_failures"
                self.steps.append(LadderStep(knob, fast, safe, reason))
                if self.tracer is not None:
                    self.tracer.instant("ladder.step", "retry",
                                        knob=knob, to=str(safe),
                                        reason=reason)
                return 1
        return 0    # fully degraded already

    def describe(self) -> list:
        """JSON-able step list."""
        return [{"knob": s.knob, "from": s.from_value,
                 "to": s.to_value, "reason": s.reason}
                for s in self.steps]

    def encode(self):
        """``int64[len(LADDER_RUNGS) + 1]``: engaged flags, then the
        consecutive-trip counter."""
        import numpy as np
        vec = [1 if self._engaged(knob, fast) else 0
               for knob, fast, _ in LADDER_RUNGS]
        return np.asarray(vec + [self._consecutive], dtype=np.int64)

    def load(self, vec) -> None:
        import numpy as np
        if torch.is_tensor(vec):
            vec = vec.cpu().numpy()
        vec = np.asarray(vec, dtype=np.int64)
        if vec.shape != (len(LADDER_RUNGS) + 1,):
            raise ValueError(f"ladder vector of shape {vec.shape}, want "
                             f"({len(LADDER_RUNGS) + 1},)")
        self.steps = [LadderStep(knob, fast, safe, "resumed")
                      for flag, (knob, fast, safe)
                      in zip(vec[:-1], LADDER_RUNGS) if flag]
        self._consecutive = int(vec[-1])


# ----------------------------------------------------------------------
# the guarded mesh chunk
# ----------------------------------------------------------------------

class MeshGuarded(NamedTuple):
    """Result of :func:`run_mesh_chunk_guarded`: one mesh chunk of epochs
    across all shards, drained to per-epoch rows.  Each row is a tuple of
    per-shard result tuples in shard order (flatten a row for the chain
    digest; the grouping lets a churn job apply each shard's canonical
    slot->cid view to that shard's results).  At S=1 a flattened row is
    the stream loop's."""

    state: object            # stacked EngineState [S, ...]
    cd: object               # int64[S, N] completion counters
    cr: object
    view_d: object           # int64[S, N] held counter views
    view_r: object
    epochs: tuple            # per-epoch tuples of per-shard tuples
    counts: tuple            # per-epoch decisions over all shards (int)
    guard_trips: tuple       # per-epoch rebase + serial fallbacks
    mesh_fallback: int       # 1 when the chunk tripped a guard and was
    #                          discarded and replayed on the host loop
    retries: int
    hists: object = None     # stacked telemetry accumulators
    ledger: object = None
    slo: object = None       # int64[S, N, W_FIELDS] per-shard blocks
    prov: object = None
    slo_merged: object = None  # int64[N, W_FIELDS] cluster-wide block
    flight: object = None    # stacked per-shard flight rings
    press: object = None     # int64[S, PRESS_FIELDS] per-shard peaks of
    #                          the mid-epoch pressure probe over the chunk
    #                          (with_pressure; down epochs read zeros on
    #                          both legs)


def _neutral_fields(engine: str, m: int, kw: dict, capacity: int) -> dict:
    """Shapes and dtypes of one epoch's :data:`stream.STREAM_OUT_FIELDS`
    as the epoch scans return them: ``[m]`` per-batch vectors, ``[m,
    k]`` prefix and chain rows (``k`` padded, never cut to the
    population), the calendar's ``served[capacity]`` and ``level_count[m,
    L]`` (``L = 1`` for minstop, else the ladder's levels)."""
    i8, i32, b = torch.int8, torch.int32, torch.bool
    if engine == "prefix":
        k = int(kw["k"])
        return {"count": ((m,), i32), "guards_ok": ((m,), b),
                "slot": ((m, k), i32), "phase": ((m, k), i8),
                "cost": ((m, k), i32), "lb": ((m, k), b)}
    if engine == "chain":
        k = int(kw["k"])
        return {"count": ((m,), i32), "unit_count": ((m,), i32),
                "guards_ok": ((m,), b), "slot": ((m, k), i32),
                "cls": ((m, k), i8), "length": ((m, k), i8)}
    levels = 1 if kw["calendar_impl"] == "minstop" \
        else int(kw["ladder_levels"])
    return {"count": ((m,), i32), "resv_count": ((m,), i32),
            "progress_ok": ((m,), b), "served": ((capacity,), i32),
            "level_count": ((m, levels), i32)}


def neutral_epoch_view(engine: str, state_slice, m: int, kw: dict,
                       fault_met=None):
    """The committed-nothing epoch result of a down shard, on the
    shard's device as a live shard's row is: guard vectors True, slots
    -1, every count, cost and class 0, metrics the epoch's fault-event
    delta -- equal in dtype, shape and values to
    ``parallel.mesh.mask_epoch_outs``'s masks of a real epoch, which is
    what makes the host chaos replay digest-equal to the fused chaos
    chunk.  The JAX package takes the shapes from ``eval_shape`` of the
    epoch program; here they come from the epoch scans' output layout
    (:func:`_neutral_fields`), nothing runs."""
    from ..engine import fastpath
    from ..obs import device as obsdev

    dev = state_slice.device
    fields = {}
    for name, (shape, dtype) in _neutral_fields(
            engine, m, kw, int(state_slice.capacity)).items():
        if name in ("guards_ok", "progress_ok"):
            fields[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif name == "slot":
            fields[name] = torch.full(shape, -1, dtype=dtype, device=dev)
        else:
            fields[name] = torch.zeros(shape, dtype=dtype, device=dev)
    metrics = torch.zeros(obsdev.NUM_METRICS, dtype=torch.int64, device=dev)
    if fault_met is not None:
        metrics = metrics + torch.as_tensor(fault_met, dtype=torch.int64,
                                            device=dev)
    cls = {"prefix": fastpath.PrefixEpoch, "chain": fastpath.ChainEpoch,
           "calendar": fastpath.CalendarEpoch}[engine]
    return cls(state=None, metrics=metrics, **fields)


def _fault_met_vec(dropout: bool, restart: bool, perturb: int):
    """Host twin of the fused chunk's per-epoch fault metric delta (rows
    9-11 of the metrics vector)."""
    import numpy as np

    from ..obs import device as obsdev

    v = np.zeros(obsdev.NUM_METRICS, dtype=np.int64)
    v[obsdev.MET_SERVER_DROPOUTS] = int(dropout)
    v[obsdev.MET_TRACKER_RESYNCS] = int(restart)
    v[obsdev.MET_FAULTS_INJECTED] = \
        int(dropout) + int(restart) + int(perturb)
    return v


def _zero_window_stack(cd):
    """A throwaway stacked zero window block, in ``cd``'s layout, for a
    caller whose SLO plane is off: the counter plane diffs the block's
    delivered columns, and only ``cd``/``cr`` persist."""
    from ..obs import slo as obsslo
    from ..parallel import groups
    from ..parallel import mesh as mesh_mod

    devs = groups.group_devices(cd)
    n = int(groups.first_leaf(cd).shape[1])
    return groups.place(mesh_mod.stack_shards(
        obsslo.window_zero(n, devs[0]), groups.leading(cd)), devs)


def _shard_counts(counts, devs):
    """Raw ``[S, E, N]`` draws (numpy or a tensor) as int32 in the
    layout of ``devs``."""
    import numpy as np

    from ..parallel import groups

    if groups.is_grouped(counts):
        return groups.place(counts, devs)
    if not torch.is_tensor(counts):
        counts = torch.from_numpy(np.ascontiguousarray(counts,
                                                       dtype=np.int32))
    return groups.place(counts.to(devs[0], torch.int32), devs)


def run_mesh_chunk_guarded(state, cd, cr, view_d, view_r,
                           epoch0: int, counts, *, mesh,
                           engine: str, epochs: int, m: int,
                           k: int = 0, chain_depth: int = 4,
                           dt_epoch_ns: int, waves: int,
                           anticipation_ns: int = 0,
                           allow_limit_break: bool = False,
                           with_metrics: bool = True,
                           select_impl: str = "sort",
                           tag_width: int = 64,
                           window_m: Optional[int] = None,
                           calendar_impl: str = "minstop",
                           ladder_levels: int = 8,
                           counter_sync_every: int = 1,
                           collective_skipping: Optional[bool] = None,
                           with_pressure: bool = False,
                           hists=None, ledger=None, slo=None,
                           prov=None, flight=None, faults=None,
                           retries: int = 3, base_s: float = 0.05,
                           sleep: Callable[[float], None] = _time.sleep,
                           on_retry=None, tracer=None) -> MeshGuarded:
    """Run one fused mesh chunk (``parallel.mesh.build_mesh_chunk``)
    under the guarded-commit contract at chunk granularity: bounded retry
    around the one call and, on a guard trip anywhere in the chunk on any
    shard, the whole chunk is discarded and its epochs replay epoch-major
    and shard-minor on the host loop (:func:`mesh_chunk_host_replay`),
    which reproduces the chunk's lockstep sync semantics: epoch e's views
    on every shard read the cluster counters as of the end of epoch
    e - 1.  The chunk never writes its inputs in place, so the replay
    starts from the entry state.

    ``counts`` is ``int32[S, E, N]`` raw draws (numpy or a tensor) or
    None for serve-only chunks; ``slo`` a stacked window block or None
    (a throwaway zero block rides then).  ``faults`` (a
    ``robust.faults.FaultChunk`` or None) runs the fault model inside
    the chunk, and the replay carries the same schedule.  On a grouped
    ``mesh`` every ``[S, ...]`` input and output is grouped
    (``parallel.groups``), and ``counts`` is laid out on it.

    ``collective_skipping=None`` resolves per chunk from the host-side
    ``epoch0``: the grouped program only for a fault-free chunk whose
    ``epochs`` divides by ``counter_sync_every`` > 1 and whose
    ``epoch0`` lies on the sync grid (the bit-identity condition).  The
    chunk is a captured program (``parallel.mesh.jit_mesh_chunk``; the
    draws and the fault arrays become tensors on the layout before the
    call), one graph a group a segment on a layout of several groups.  The
    JAX package's ``wheel_kernel`` knob has no counterpart: the device
    picks kernel K2's route, and every shard runs on the current
    stream."""
    import numpy as np

    from ..engine import stream as stream_mod
    from ..obs import spans as _spans
    from ..parallel import mesh as mesh_mod

    from ..parallel import cluster as CL
    from ..parallel import groups

    epochs = int(epochs)
    n_shards = groups.leading(cd)
    devs = mesh.devices
    state, cd, cr, view_d, view_r, hists, ledger, slo, prov, flight = (
        CL.on_mesh(x, mesh) for x in (state, cd, cr, view_d, view_r, hists,
                                      ledger, slo, prov, flight))
    if slo is None:
        slo = _zero_window_stack(cd)
    every = max(int(counter_sync_every), 1)
    if collective_skipping is None:
        collective_skipping = (faults is None and every > 1
                               and epochs % every == 0
                               and int(epoch0) % every == 0)
    fn = mesh_mod.jit_mesh_chunk(
        mesh, engine=engine, epochs=epochs, m=m, k=k,
        chain_depth=chain_depth, dt_epoch_ns=dt_epoch_ns, waves=waves,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics,
        select_impl=select_impl, tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        counter_sync_every=counter_sync_every,
        collective_skipping=collective_skipping,
        ingest=counts is not None, with_faults=faults is not None,
        with_flight=flight is not None, with_pressure=with_pressure)
    retry_count = [0]

    def count_retry(attempt, exc):
        retry_count[0] += 1
        _spans.instant(tracer, "mesh.retry", "retry",
                       error=type(exc).__name__)
        if on_retry is not None:
            on_retry(attempt, exc)

    counts_dev = None
    if counts is not None:
        counts_dev = _shard_counts(counts, devs)
    faults_dev = mesh_mod.fault_inputs(faults, mesh)

    def one():
        with _spans.span(tracer, "mesh.dispatch", "dispatch",
                         engine=engine, epochs=epochs, shards=n_shards,
                         chaos=faults is not None):
            out = fn(state, cd, cr, view_d, view_r, int(epoch0),
                     counts_dev, hists, ledger, slo, prov, flight,
                     faults_dev)
        with _spans.span(tracer, "mesh.device_wait", "device_compute"):
            _device_wait(out.cd)
        return out

    out = retry_with_backoff(one, retries=retries, base_s=base_s,
                             sleep=sleep, on_retry=count_retry)
    # the chunk's one read back: every stacked output, the guard rows
    # among them
    fetched = {name: groups.gather(v, "cpu")
               for name, v in out.outs.items()}
    if bool(fetched[stream_mod.STREAM_GUARD_FIELD[engine]].all()):
        press = None
        if with_pressure:
            # per-shard chunk peaks: the max over the epoch axis (down
            # epochs read zeros, a no-op on the nonnegative fields)
            press = fetched["pressure"].numpy().astype(np.int64).max(
                axis=1)
        return MeshGuarded(
            state=out.state, cd=out.cd, cr=out.cr, view_d=out.view_d,
            view_r=out.view_r,
            epochs=tuple(mesh_mod.mesh_epoch_results(engine, fetched, i)
                         for i in range(epochs)),
            counts=tuple(mesh_mod.mesh_epoch_decisions(engine, fetched, i)
                         for i in range(epochs)),
            guard_trips=(0,) * epochs, mesh_fallback=0,
            retries=retry_count[0], hists=out.hists, ledger=out.ledger,
            slo=out.slo, prov=out.prov, slo_merged=out.slo_merged,
            flight=out.flight, press=press)

    _spans.instant(tracer, "mesh.fallback", "retry", engine=engine,
                   epochs=epochs, shards=n_shards,
                   chaos=faults is not None)
    return mesh_chunk_host_replay(
        state, cd, cr, view_d, view_r, epoch0, counts_dev,
        engine=engine, epochs=epochs, m=m, k=k, chain_depth=chain_depth,
        dt_epoch_ns=dt_epoch_ns, waves=waves,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics,
        select_impl=select_impl, tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        counter_sync_every=counter_sync_every,
        with_pressure=with_pressure, hists=hists, ledger=ledger,
        slo=slo, prov=prov, flight=flight, faults=faults,
        retries=retries, base_s=base_s, sleep=sleep, on_retry=on_retry,
        tracer=tracer, _retries_so_far=retry_count[0])


def mesh_chunk_host_replay(state, cd, cr, view_d, view_r,
                           epoch0: int, counts, *,
                           engine: str, epochs: int, m: int,
                           k: int = 0, chain_depth: int = 4,
                           dt_epoch_ns: int, waves: int,
                           anticipation_ns: int = 0,
                           allow_limit_break: bool = False,
                           with_metrics: bool = True,
                           select_impl: str = "sort",
                           tag_width: int = 64,
                           window_m: Optional[int] = None,
                           calendar_impl: str = "minstop",
                           ladder_levels: int = 8,
                           counter_sync_every: int = 1,
                           with_pressure: bool = False,
                           hists=None, ledger=None, slo=None,
                           prov=None, flight=None, faults=None,
                           retries: int = 3, base_s: float = 0.05,
                           sleep: Callable[[float], None] = _time.sleep,
                           on_retry=None, tracer=None,
                           _retries_so_far: int = 0) -> MeshGuarded:
    """The host loop: one mesh chunk's epochs epoch-major and shard-minor
    on the per-epoch path (``stream.jit_ingest_step`` and
    :func:`run_epoch_guarded` on each shard's view ``x[s]``), with the
    counter-view sum taken on the host on the same global sync grid and,
    with ``faults``, the in-chunk fault semantics of
    ``parallel.mesh.build_mesh_chunk``: a down shard runs nothing and
    contributes a :func:`neutral_epoch_view` row, its state, telemetry
    and counters frozen; a restart re-syncs its views off the grid; dup
    doubles the completion fold; skew lenses the shard's clock; fault
    events patch the epoch's metrics rows.

    It is both the guard-trip fallback of :func:`run_mesh_chunk_guarded`
    and the reference the chaos chunk is held to.  Every launch runs on
    the current stream on the card the state lies on, as the fused chunk
    does, and launches the same kernels.  The views ``x[s]`` are read,
    never written: every step returns new tensors, and the restack at
    the end copies.  Each shard's epoch is a ``guarded.epoch`` program
    and the probe :func:`_pressure_probe`: the views of one stack share
    one signature, so one capture serves every shard.  A grouped layout
    (``parallel.groups``) replays each shard on its own group's device
    and restacks by group; the counter sum is a host sum, as on one
    device."""
    import numpy as np

    from ..engine import fastpath
    from ..engine import stream as stream_mod
    from ..obs import slo as obsslo
    from ..parallel import groups
    from ..parallel.cluster import shard_view
    from ..parallel.tracker import global_counters_from

    epochs = int(epochs)
    n_shards = groups.leading(cd)
    devs = groups.group_devices(cd)
    if slo is None:
        slo = _zero_window_stack(cd)
    if counts is not None:
        counts = _shard_counts(counts, devs)
        counts = [shard_view(counts, s) for s in range(n_shards)]
    every = max(int(counter_sync_every), 1)
    retry_count = [_retries_so_far]
    sts = [shard_view(state, s) for s in range(n_shards)]
    cur = {name: [shard_view(acc, s) for s in range(n_shards)]
           for name, acc in (("hists", hists), ("ledger", ledger),
                             ("slo", slo), ("prov", prov),
                             ("flight", flight))}
    cd_np, cr_np, vd_np, vr_np = (
        groups.gather(x, "cpu").numpy().astype(np.int64)
        for x in (cd, cr, view_d, view_r))
    if faults is not None:
        f_up, f_skew, f_delay, f_dup, up_prev = (
            (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a))
            .astype(dt) for a, dt in zip(faults, (bool, np.int64, bool,
                                                  bool, bool)))
        up_prev = up_prev.copy()
    neutral_kw = fastpath.epoch_scan_kwargs(
        engine, k=k, chain_depth=chain_depth, select_impl=select_impl,
        tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics)
    press_np = None
    if with_pressure:
        from ..obs import provenance as obsprov
        press_np = np.zeros((n_shards, obsprov.PRESS_FIELDS),
                            dtype=np.int64)
    dt = int(dt_epoch_ns)
    ingest_step = stream_mod.jit_ingest_step(
        dt_epoch_ns=dt, waves=waves) if counts is not None else None
    ep_rows, count_rows, trip_rows = [], [], []
    for i in range(epochs):
        t_base = (int(epoch0) + i) * dt
        sync = (int(epoch0) + i) % every == 0
        # the epoch-entry sum, from the counters as of the end of epoch
        # i - 1; taken only when some shard can refresh this epoch (a
        # sync epoch, or an off-grid restart)
        may_refresh = sync or (
            faults is not None and bool((f_up[:, i] & ~up_prev).any()))
        g_d = g_r = None
        if may_refresh:
            g_d, g_r = global_counters_from(cd_np, cr_np,
                                            lambda x: x.sum(axis=0))
        row, n_dec, trips = [], 0, 0
        for s in range(n_shards):
            if faults is not None:
                up, skew = bool(f_up[s, i]), int(f_skew[s, i])
                delay, dup = bool(f_delay[s, i]), bool(f_dup[s, i])
                restart = up and not up_prev[s]
                dropout = (not up) and up_prev[s]
                refresh = (sync and up and not delay) or restart
                perturb = (int(dup and up) + int(delay and up)
                           + int(skew != 0 and up))
            else:
                up, skew, dup = True, 0, False
                restart = dropout = False
                perturb = 0
                refresh = sync
            if refresh:
                vd_np[s] = g_d
                vr_np[s] = g_r
            if not up:
                # down this epoch: nothing runs or commits (arrivals
                # posted to it are lost); the row reads the neutrals
                row.append((neutral_epoch_view(
                    engine, sts[s], m, neutral_kw,
                    _fault_met_vec(dropout, restart, perturb)),))
                continue
            if ingest_step is not None:
                sts[s] = ingest_step(sts[s], counts[s][i], t_base + skew)
            if press_np is not None:
                # the fused chunk's probe: post-ingest, pre-serve, at
                # the shard's (skewed) serve time
                press_np[s] = np.maximum(press_np[s], _pressure_probe()(
                    sts[s], t_base + skew + dt).cpu().numpy())
            w_prev = cur["slo"][s]
            ep = run_epoch_guarded(
                sts[s], t_base + dt, engine=engine, m=m, k=k,
                chain_depth=chain_depth, anticipation_ns=anticipation_ns,
                allow_limit_break=allow_limit_break,
                with_metrics=with_metrics, select_impl=select_impl,
                tag_width=tag_width, window_m=window_m,
                calendar_impl=calendar_impl, ladder_levels=ladder_levels,
                skew_ns=skew, hists=cur["hists"][s],
                ledger=cur["ledger"][s], flight=cur["flight"][s],
                slo=w_prev, prov=cur["prov"][s], retries=retries,
                base_s=base_s, sleep=sleep, on_retry=on_retry,
                tracer=tracer)
            sts[s] = ep.state
            for name in cur:
                if cur[name][s] is not None:
                    cur[name][s] = getattr(ep, name)
            cols = [obsslo.W_OPS, obsslo.W_RESV_OPS]
            delta = (ep.slo[:, cols] - w_prev[:, cols]).cpu().numpy() \
                .astype(np.int64) * (2 if dup else 1)
            cd_np[s] += delta[:, 0]
            cr_np[s] += delta[:, 1]
            retry_count[0] += ep.retries
            results = ep.results
            if restart or perturb:
                # the fused chunk folds the epoch's fault-event delta
                # into its metrics row; patch the first result so the
                # metric totals match
                fv = torch.from_numpy(_fault_met_vec(False, restart,
                                                     perturb))
                r0 = results[0]
                results = (r0._replace(
                    metrics=r0.metrics + fv.to(r0.metrics.device)),) \
                    + results[1:]
            row.append(tuple(results))
            n_dec += ep.count
            trips += ep.rebase_fallbacks + ep.serial_fallbacks
        if faults is not None:
            up_prev = f_up[:, i].copy()
        ep_rows.append(tuple(row))
        count_rows.append(n_dec)
        trip_rows.append(trips)

    def restack(parts):
        return None if any(p is None for p in parts) \
            else groups.restack(parts, devs)

    def put(a):
        return groups.place(torch.from_numpy(a), devs)

    slo_stacked = restack(cur["slo"])
    slo_np = groups.gather(slo_stacked, "cpu").numpy()
    return MeshGuarded(
        state=restack(sts), cd=put(cd_np), cr=put(cr_np),
        view_d=put(vd_np), view_r=put(vr_np), epochs=tuple(ep_rows),
        counts=tuple(count_rows), guard_trips=tuple(trip_rows),
        mesh_fallback=1, retries=retry_count[0],
        hists=restack(cur["hists"]), ledger=restack(cur["ledger"]),
        slo=slo_stacked, prov=restack(cur["prov"]),
        flight=restack(cur["flight"]),
        slo_merged=torch.from_numpy(obsslo.window_combine_np(
            np.zeros(tuple(slo_np.shape[1:]), dtype=np.int64),
            *slo_np)).to(devs[0]),
        press=press_np)
