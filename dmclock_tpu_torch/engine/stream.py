"""The streaming serve loop: fused ingest + serve + commit chunks.

Counterpart of ``dmclock_tpu/engine/stream.py``.  A **stream chunk** is
a run of epochs, each

1. the admission clamp (``min(raw_counts, min(ring - depth, waves))``,
   computed on the device from the carried state),
2. ``kernels.ingest_superwave`` (the superwave ring pass), and
3. one full epoch of any of the three epoch engines, the telemetry
   accumulators riding it,

with the per-epoch outputs stacked on the device.  The JAX package runs
the chunk as one ``lax.scan``; here it is a Python loop over epochs
that never reads the device back (no ``.item()``, no ``bool(tensor)``,
no copy to the host), so the host only enqueues work and a chunk can
be captured as one CUDA graph (ROADMAP.md item 5).  Decisions are
integer ops in the same order as the round loop's, so a chunk equals
the rounds it fuses bit for bit.

The JAX package's compile caches have their counterparts:
:func:`jit_stream_chunk` (cache ``stream.chunk``, with its ``donate``
switch) and :func:`jit_ingest_step` (cache ``stream.ingest``), each a
module cache of captured programs (``obs/compile_plane.py``
``instrumented_jit``) under the JAX package's keys.  On the card a
chunk is captured once a signature as one CUDA graph and replayed.
``wheel_kernel`` stays in the chunk's key, as in JAX, but picks
nothing: the device picks kernel K2's route.  The guarded chunk runner
is ``robust.guarded.run_stream_chunk_guarded``; the supervisor's stream
loop (``robust.supervisor``) runs one chunk per checkpoint interval
through it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import fastpath
from ..obs.device import metrics_combine, metrics_delta
from .kernels import as_scalar, ingest_superwave
from .state import EngineState


class StreamChunk(NamedTuple):
    """One chunk's device outputs: ``outs`` maps each of the engine's
    :data:`STREAM_OUT_FIELDS` and ``"metrics"`` (and ``"pressure"`` with
    the probe) to its per-epoch values stacked on a leading ``[epochs]``
    axis; :func:`epoch_view` slices one epoch's result back out."""

    state: EngineState
    outs: dict
    hists: object = None
    ledger: object = None
    flight: object = None
    slo: object = None
    prov: object = None


# per-engine stacked output fields, in the epoch result's field order
STREAM_OUT_FIELDS = {
    "prefix": ("count", "guards_ok", "slot", "phase", "cost", "lb"),
    "chain": ("count", "unit_count", "guards_ok", "slot", "cls",
              "length"),
    "calendar": ("count", "resv_count", "progress_ok", "served",
                 "level_count"),
}

# the guard vector each engine exposes (False anywhere: the epoch needs
# the serial fallback path)
STREAM_GUARD_FIELD = {"prefix": "guards_ok", "chain": "guards_ok",
                      "calendar": "progress_ok"}


def admission(state: EngineState, counts, waves: int) -> torch.Tensor:
    """The admission clamp over the carried depth: ``min(raw, min(ring -
    depth, waves))``."""
    headroom = torch.clamp(state.ring_capacity - state.depth, max=waves)
    return torch.minimum(counts, headroom)


def clamped_ingest(state: EngineState, counts, t_base, *, waves: int,
                   dt_wave: int) -> EngineState:
    """The admission clamp (:func:`admission`) + superwave ingest on the
    device: :func:`kernels.ingest_superwave` at wave times ``t_base + j *
    dt_wave`` (cost = rho = delta = 1)."""
    dev = state.device
    c = admission(state, counts, waves)
    wave_times = as_scalar(t_base, dev) + torch.arange(
        waves, dtype=torch.int64, device=dev) * dt_wave
    ones = torch.ones((state.capacity,), dtype=torch.int64, device=dev)
    return ingest_superwave(state, c, wave_times, ones, ones, ones,
                            anticipation_ns=0)


def ingest_step(state: EngineState, counts, t_base, *, dt_epoch_ns: int,
                waves: int) -> EngineState:
    """The chunk's ingest leg standing alone (the JAX package's
    ``jit_ingest_step``): the same clamp, so it ingests exactly what the
    chunk would have."""
    return clamped_ingest(state, counts, t_base, waves=waves,
                          dt_wave=int(dt_epoch_ns) // int(waves))


def make_epoch_step(*, engine: str, m: int, kw: dict, dt_epoch_ns: int,
                    waves: int, ingest: bool, with_pressure: bool = False,
                    count_drops: bool = False):
    """The one per-epoch step of a chunk: clamped superwave ingest at
    ``t_base`` (when ``ingest``) and one epoch of ``engine`` serving at
    ``t_base + dt`` with the telemetry accumulators riding it.

    ``count_drops`` adds the arrivals the clamp refused to the epoch's
    ``ingest_drops`` metric row, as the sustained rows' round body does
    (off: the JAX package's chunk, which does not count them).

    ``with_pressure`` adds a mid-epoch probe,
    ``obs.provenance.pressure_vec`` on the post-ingest, pre-serve state
    at the serve time, in ``outs["pressure"]`` (``int64[PRESS_FIELDS]``).

    Returns ``step(state, t_base, counts_e, hists, ledger, flight, slo,
    prov) -> ((state', hists', ledger', flight', slo', prov'), outs)``
    with ``outs`` the engine's :data:`STREAM_OUT_FIELDS` plus
    ``"metrics"``."""
    fn = fastpath.epoch_scan_fn(engine)
    fields = STREAM_OUT_FIELDS[engine]
    dt = int(dt_epoch_ns)
    dt_wave = dt // int(waves)
    if with_pressure:
        from ..obs.provenance import pressure_vec

    def step(st, t_base, counts_e, h, l, f, s, p):
        if count_drops:
            dropped = torch.sum(
                (counts_e - admission(st, counts_e, waves)).to(torch.int64))
        if ingest:
            st = clamped_ingest(st, counts_e, t_base, waves=waves,
                                dt_wave=dt_wave)
        now = t_base + dt
        if with_pressure:
            press = pressure_vec(st, now)
        ep = fn(st, now, m=m, **kw, hists=h, ledger=l, flight=f, slo=s,
                prov=p)
        outs = {name: getattr(ep, name) for name in fields}
        outs["metrics"] = ep.metrics
        if count_drops:
            outs["metrics"] = metrics_combine(ep.metrics, metrics_delta(
                device=ep.metrics.device, ingest_drops=dropped))
        if with_pressure:
            outs["pressure"] = press
        return (ep.state, ep.hists, ep.ledger, ep.flight, ep.slo,
                ep.prov), outs

    return step


def build_stream_chunk(*, engine: str, epochs: int, m: int, k: int = 0,
                       chain_depth: int = 4, dt_epoch_ns: int,
                       waves: int, anticipation_ns: int = 0,
                       allow_limit_break: bool = False,
                       with_metrics: bool = True,
                       select_impl: str = "sort", tag_width: int = 64,
                       window_m: Optional[int] = None,
                       calendar_impl: str = "minstop",
                       ladder_levels: int = 8, ingest: bool = True,
                       with_pressure: bool = False,
                       count_drops: bool = False):
    """The chunk function ``(state, epoch0, counts, hists, ledger,
    flight, slo, prov) -> StreamChunk`` of one configuration.

    ``epoch0`` (int or 0-d int64 tensor) is the chunk's first epoch;
    ``counts`` is ``int32[epochs, N]`` of raw arrival draws (None with
    ``ingest=False``).  Epoch ``i`` ingests at ``t_base = (epoch0 + i) *
    dt_epoch_ns`` (waves ``dt_epoch_ns // waves`` apart) and serves at
    ``t_base + dt_epoch_ns``: the round loop's schedule.
    ``count_drops`` counts the clamp's refusals in ``ingest_drops``
    (:func:`make_epoch_step`)."""
    if engine not in fastpath.EPOCH_ENGINES:
        raise ValueError(f"unknown epoch engine {engine!r}")
    epochs = int(epochs)
    if epochs < 1:
        raise ValueError("a stream chunk needs at least one epoch")
    kw = fastpath.epoch_scan_kwargs(
        engine, k=k, chain_depth=chain_depth, select_impl=select_impl,
        tag_width=tag_width, window_m=window_m,
        calendar_impl=calendar_impl, ladder_levels=ladder_levels,
        anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break, with_metrics=with_metrics)
    dt = int(dt_epoch_ns)
    epoch_step = make_epoch_step(engine=engine, m=m, kw=kw,
                                 dt_epoch_ns=dt, waves=waves,
                                 ingest=ingest, with_pressure=with_pressure,
                                 count_drops=count_drops)

    def chunk(state: EngineState, epoch0, counts=None, hists=None,
              ledger=None, flight=None, slo=None, prov=None
              ) -> StreamChunk:
        if ingest and counts is None:
            raise ValueError("ingest=True needs raw counts")
        e0 = as_scalar(epoch0, state.device)
        carry = (state, hists, ledger, flight, slo, prov)
        per_epoch = []
        for i in range(epochs):
            t_base = (e0 + i) * dt
            carry, outs = epoch_step(carry[0], t_base,
                                     counts[i] if ingest else None,
                                     *carry[1:])
            per_epoch.append(outs)
        outs = {name: torch.stack([o[name] for o in per_epoch])
                for name in per_epoch[0]}
        st, h, l, f, s, p = carry
        return StreamChunk(state=st, outs=outs, hists=h, ledger=l,
                           flight=f, slo=s, prov=p)

    return chunk


# module caches of captured programs keyed by the full static
# configuration, as the JAX package's (``_STREAM_JIT_CACHE``,
# ``_INGEST_STEP_CACHE``)
_STREAM_JIT_CACHE: dict = {}
_INGEST_STEP_CACHE: dict = {}


def jit_stream_chunk(*, donate: bool = False, **cfg):
    """The captured :func:`build_stream_chunk` of ``cfg`` (``wheel_kernel``
    is kept in the key and dropped from the build).  ``donate=True``
    donates the state and the telemetry accumulators (arguments 0 and
    3-7, the bench discipline): the chunk writes them back into its
    static inputs and returns those.  The guarded runner keeps them
    alive instead, so that a tripped chunk can be re-run from its entry
    state."""
    from ..obs import compile_plane

    key = (donate,) + tuple(sorted(cfg.items()))
    if key not in _STREAM_JIT_CACHE:
        build = {k: v for k, v in cfg.items() if k != "wheel_kernel"}
        _STREAM_JIT_CACHE[key] = compile_plane.instrumented_jit(
            build_stream_chunk(**build), cache="stream.chunk", entry=key,
            donate_argnums=(0, 3, 4, 5, 6, 7) if donate else ())
    return _STREAM_JIT_CACHE[key]


def jit_ingest_step(*, dt_epoch_ns: int, waves: int):
    """The captured ingest leg ``(state, raw_counts, t_base) -> state``
    (:func:`ingest_step`), for the guarded runner's round-path fallback
    and the churn rows' ingest: the chunk's clamp, so it ingests exactly
    what the chunk would have."""
    from ..obs import compile_plane

    key = (int(dt_epoch_ns), int(waves))
    if key not in _INGEST_STEP_CACHE:
        _INGEST_STEP_CACHE[key] = compile_plane.instrumented_jit(
            functools.partial(ingest_step, dt_epoch_ns=key[0],
                              waves=key[1]),
            cache="stream.ingest", entry=key)
    return _INGEST_STEP_CACHE[key]


def epoch_view(engine: str, outs: dict, i: int):
    """Epoch ``i``'s result object from a chunk's stacked outputs: the
    result class the round loop's epoch scan returns, with
    ``state=None``."""
    fields = {name: outs[name][i] for name in STREAM_OUT_FIELDS[engine]}
    cls = {"prefix": fastpath.PrefixEpoch, "chain": fastpath.ChainEpoch,
           "calendar": fastpath.CalendarEpoch}[engine]
    return cls(state=None, metrics=outs["metrics"][i], **fields)


def chunk_bounds(start: int, epochs: int, every: int):
    """Yield ``(e0, e1)`` chunk windows from ``start`` to ``epochs``,
    each ending at the next checkpoint boundary (``(e + 1) % every ==
    0`` or the final epoch)."""
    every = max(int(every), 1)
    e = int(start)
    while e < epochs:
        b = min((e // every + 1) * every, epochs)
        yield e, b
        e = b


def epoch_decisions(engine: str, outs: dict, i: int) -> int:
    """Decisions epoch ``i`` committed: the sum of its per-batch counts
    (reads the device back)."""
    c = outs["count"][i]
    c = c.detach().cpu().numpy() if torch.is_tensor(c) else np.asarray(c)
    return int(c.sum())
