#!/usr/bin/env python
"""The device half of ``benchmark/run_sweeps.py`` on the port.

The rows keep the JAX script's function names, ``tpu_`` prefix and all,
so that a reader finds each row's counterpart; here they run on the
device the caller names (the card by default):

- ``tpu_km_sweep``: the prefix epoch's decisions/s at 100,000 clients
  over a k x m grid (``scan_prefix_epoch``), differenced chains;
- ``tpu_regime_sweep`` (``--regimes``): the pure reservation backlog, a
  reservation -> weight transition (one chain, latency-corrected), the
  weight steady state, and the exact serial engine (``engine_run``) as
  the floor;
- ``tpu_sustained_sweep`` (``--regimes``) and ``cfg4_calibration_sweep``
  (``--calibrate``): bench's sustained closed loop on the prefix engine
  (``serve.sustained_row``) at ``bench_sustained``'s arguments;
- ``device_sim_headline`` (``--devsim``): the device sim's closed loop
  (``sim.device_sim.device_sim_headline``);
- ``tpu_calendar_sweep`` and ``tpu_allow_regime_row`` (``--calendar``):
  the serve-only calendar drain over (m, steps), and AtLimit Allow,
  which serves purely by limit-break, on the sorted and calendar epochs.

The timing protocol is bench's: a chain of epochs is launched back to
back and synchronised once at its end, by reading back
:func:`serve.state_digest`; every epoch's ``guards_ok`` and count are
read after the clock stops; a differenced pair is discarded when
``t_hi <= t_lo`` or ``t_lo < 1.2 *`` :func:`serve.scalar_latency`, and
the rate is the median over ``reps`` pairs from fresh states.

Differences from the JAX script, by design:

- the native K-sweep (``build_native``, ``native_k_sweep``) with its
  ``--skip-native`` and ``--repeat`` flags stays out: it runs the
  reference's C++ binary, not the JAX package.  ``--skip-km`` stands for
  ``--skip-tpu``;
- the markdown goes to ``--out`` (standard output without it), never to
  ``benchmark/RESULTS.md`` or its ``.*_section.md`` parts, and every
  heading names the device (``platform=cuda (<card>, <power limit>)``);
- ``--calendar`` writes two sections of its own (the JAX script only
  prints those rows) and runs beside the other flags;
- a failed launch is not retried: a CUDA error is sticky and re-raises;
- ``--cut`` runs every row at :data:`CUT`, a shape small enough for the
  CPU (``--device cpu``).

Usage:
    python scripts/torch_run_sweeps.py [--skip-km] [--regimes] [--devsim]
        [--calibrate] [--calendar] [--device cuda] [--out PATH]
    python scripts/torch_run_sweeps.py --cut --regimes --calendar \\
        --device cpu
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dmclock_tpu_torch.device import (DEFAULT_DEVICE,     # noqa: E402
                                      resolve_device)
from dmclock_tpu_torch.engine.fastpath import (           # noqa: E402
    calendar_batch, scan_calendar_epoch, scan_prefix_epoch)
from dmclock_tpu_torch.engine.kernels import engine_run   # noqa: E402
from dmclock_tpu_torch.engine.state import EngineState    # noqa: E402
from dmclock_tpu_torch.serve import (_preloaded_state,    # noqa: E402
                                     _sync, scalar_latency, state_digest,
                                     sustained_row)
from dmclock_tpu_torch.sim import device_sim as DS        # noqa: E402

CFG4_RESV_RATE = 25.0    # bench.CFG4_RESV_RATE: cfg4's prefix-engine rate

# the rows' shapes (run_sweeps.py's constants), and CUT for the CPU
FULL = {
    "km": dict(n=100_000, grid=tuple(
        [(65536, m, 320) for m in (8, 21, 32)]
        + [(65536, 64, 384), (16384, 64, 256), (32768, 64, 256),
           (49152, 64, 384), (98304, 64, 384)]),
        chain_decisions=1 << 23, lo_decisions=3 << 21, reps=3),
    "regime": dict(n=100_000, depth=256, k=49152, m=21, epochs=8,
                   lo_decisions=3 << 21, serial_steps=4096, reps=3),
    "sustained": dict(cases=(
        ("cfg3: 10k clients, uniform QoS, Poisson",
         dict(n=10_000, k=4096, m=32, rounds=60, zipf=False,
              resv_rate=100.0, dt_round_ns=100_000_000, ring=256,
              depth0=128, rounds_lo=20)),
        ("cfg4: 100k clients, Zipf weights, resv-constrained",
         dict(n=100_000, k=49152, m=21, rounds=24, zipf=True,
              resv_rate=CFG4_RESV_RATE, dt_round_ns=50_000_000,
              rounds_lo=8)))),
    "calibration": dict(n=100_000, k=49152, m=21, rounds=16, rounds_lo=8,
                        reps=3, cases=(
                            ("mixed staggered", {},
                             (25.0, 50.0, 100.0, 200.0)),
                            ("mixed aligned", {"resv_aligned": True},
                             (100.0, 200.0)),
                            ("split 50/50", {"split_resv": 0.5},
                             (60.0, 90.0, 140.0)))),
    "devsim": dict(n=DS.HEADLINE_CLIENTS, lo=DS.HEADLINE_LO,
                   hi=DS.HEADLINE_HI),
    "calendar": dict(n=100_000, depth=320,
                     points=((4, 8, 10), (8, 8, 5), (8, 16, 4))),
    "allow": dict(n=100_000, depth=256, k=49152, m=21, sorted_epochs=3,
                  cal_m=8, cal_steps=8, cal_epochs=6),
}
CUT = {
    "km": dict(n=2048, grid=((512, 4, 64), (256, 8, 64)),
               chain_decisions=8192, lo_decisions=2048, reps=2),
    "regime": dict(n=2048, depth=64, k=512, m=4, epochs=4,
                   lo_decisions=2048, serial_steps=64, reps=2),
    "sustained": dict(cases=(
        ("cfg3: 2048 clients, uniform QoS, Poisson",
         dict(n=2048, k=512, m=8, rounds=6, zipf=False, resv_rate=50.0,
              dt_round_ns=100_000_000, ring=64, depth0=48, waves=16,
              rounds_lo=2, reps=2)),
        ("cfg4: 2048 clients, Zipf weights, resv-constrained",
         dict(n=2048, k=512, m=4, rounds=6, zipf=True,
              resv_rate=CFG4_RESV_RATE, dt_round_ns=50_000_000,
              rounds_lo=2, reps=2)))),
    "calibration": dict(n=2048, k=512, m=4, rounds=6, rounds_lo=2, reps=2,
                        cases=(("mixed staggered", {}, (25.0,)),
                               ("mixed aligned", {"resv_aligned": True},
                                (100.0,)),
                               ("split 50/50", {"split_resv": 0.5},
                                (60.0,)))),
    "devsim": dict(n=64, lo=1, hi=2),
    "calendar": dict(n=2048, depth=64, points=((4, 8, 3), (2, 16, 2))),
    "allow": dict(n=2048, depth=64, k=512, m=4, sorted_epochs=3, cal_m=4,
                  cal_steps=8, cal_epochs=2),
}


def lo_epochs(epochs_hi: int, k: int, m: int, lo_decisions: int) -> int:
    """The lo chain's epochs: a quarter of the hi chain's, and at least
    ``lo_decisions`` decisions (``3 * 2**21`` in bench and the JAX
    script), so that its wall is well above one synchronisation."""
    return max(1, epochs_hi // 4, -(lo_decisions // -(m * k)))


def _timed_prefix_epochs(make_state, now_ns, epochs_hi, k, m,
                         epochs_lo=None, reps=3):
    """Differenced-chain timing on the prefix engine (``run_sweeps.py``
    ``_timed_prefix_epochs``): per rep a fresh ``make_state()``, one warm
    epoch, then a chain of ``epochs_lo`` and one of ``epochs_hi`` epochs
    at ``now_ns``, each synchronised once at its end.  Before the first
    rep's chains the backlog must feed both with the 1.5x heavy-class
    margin.  Returns ``(decisions/s, fill)``: the median of the valid
    differenced rates, and the decisions over ``m * k`` per epoch."""
    if epochs_lo is None:
        epochs_lo = lo_epochs(epochs_hi, k, m, 3 << 21)
    epochs_hi = max(epochs_hi, epochs_lo + 1)
    lat = None

    def chain(state, n):
        t0 = time.perf_counter()
        counts, guards = [], []
        for _ in range(n):
            ep = scan_prefix_epoch(state, now_ns, m, k, anticipation_ns=0)
            state = ep.state
            counts.append(ep.count)
            guards.append(ep.guards_ok)
        int(state_digest(state))
        wall = time.perf_counter() - t0
        if not all(bool(g.all()) for g in guards):
            raise AssertionError("rebase guards tripped -- counts are not "
                                 "trustworthy")
        return state, int(sum(int(c.sum()) for c in counts)), wall

    rates, d_all, pot_all = [], 0, 0
    for rep in range(max(reps, 1)):
        state = make_state()
        if lat is None:
            lat = scalar_latency(state.device)
        ep = scan_prefix_epoch(state, now_ns, m, k, anticipation_ns=0)
        int(state_digest(ep.state))
        state = ep.state
        if rep == 0:
            # bench's rule: weights 1..4 serve the heaviest class ~1.6x
            # the mean, so chains sized to the mean backlog would drain
            # heavy clients mid-chain and deflate the rate
            backlog = int(state.depth.sum(dtype=torch.int64))
            if (epochs_lo + epochs_hi) * m * k * 3 // 2 > backlog:
                raise AssertionError(
                    f"backlog {backlog} cannot feed chains at k={k} m={m} "
                    f"with heavy-class margin")
        state, d_lo, t_lo = chain(state, epochs_lo)
        state, d_hi, t_hi = chain(state, epochs_hi)
        d_all += d_lo + d_hi
        pot_all += (epochs_lo + epochs_hi) * m * k
        if t_hi <= t_lo or t_lo < 1.2 * lat:
            continue    # jitter-inverted or synchronisation-bound lo chain
        rates.append((d_hi - d_lo) / (t_hi - t_lo))
    if not rates:
        raise AssertionError("no valid pair: chains too short for the "
                             "synchronisation floor")
    return statistics.median(rates), d_all / pot_all


def _timed_transient_chain(state, now_ns, epochs, k, m):
    """One timed chain for a shape that is consumed once (``run_sweeps.py``
    ``_timed_transient_chain``): warm on a copy of ``state``, then time
    ``epochs`` epochs from the intact original, less one
    :func:`scalar_latency`.  Returns ``(decisions/s, fill)``."""
    warm = scan_prefix_epoch(EngineState(*(t.clone() for t in state)),
                             now_ns, m, k, anticipation_ns=0)
    int(state_digest(warm.state))
    del warm
    lat = scalar_latency(state.device)
    t0 = time.perf_counter()
    counts, guards = [], []
    for _ in range(epochs):
        ep = scan_prefix_epoch(state, now_ns, m, k, anticipation_ns=0)
        state = ep.state
        counts.append(ep.count)
        guards.append(ep.guards_ok)
    int(state_digest(state))
    t = time.perf_counter() - t0 - lat
    if not all(bool(g.all()) for g in guards):
        raise AssertionError("rebase guards tripped -- counts are not "
                             "trustworthy")
    total = int(sum(int(c.sum()) for c in counts))
    if t <= 0:
        raise AssertionError(f"timing underflow: {t:.4f}s")
    return total / t, total / (epochs * m * k)


def tpu_km_sweep(n=100_000, grid=FULL["km"]["grid"], *,
                 chain_decisions=1 << 23, lo_decisions=3 << 21, reps=3,
                 device=DEFAULT_DEVICE):
    """The prefix epoch's decisions/s over ``grid``'s ``(k, m, ring
    depth)`` points on ``n`` clients preloaded as deep as the ring: the
    hi chain ``max(2, chain_decisions // (m * k))`` epochs.  Rows
    ``(k, m, dps, fill)``."""
    dev = resolve_device(device)
    rows = []
    for k, m, d in grid:
        hi = max(2, chain_decisions // (m * k))

        def mk(depth=d):
            return _preloaded_state(n, depth, ring=depth, device=dev)

        dps, fill = _timed_prefix_epochs(
            mk, 0, hi, k, m, epochs_lo=lo_epochs(hi, k, m, lo_decisions),
            reps=reps)
        rows.append((k, m, dps, fill))
        print(f"k={k} m={m}: {dps/1e6:.2f} M dec/s (fill {fill:.3f})",
              flush=True)
    return rows


def resv_state(n: int, depth: int, device) -> EngineState:
    """The preloaded backlog with the reservation tags staggered over
    the serve period (2 * resv_inv) by the same Weyl phase as the
    proportion tags."""
    st = _preloaded_state(n, depth, ring=depth, device=device)
    c = np.arange(n)
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    rinv = st.resv_inv.cpu().numpy()
    jit = (phase * 2.0 * rinv).astype(np.int64)
    return st._replace(head_resv=torch.from_numpy(rinv + jit).to(st.device))


def serial_floor(state: EngineState, steps: int):
    """The exact serial engine at ``now = 0``: ``steps`` decisions to
    warm, then ``steps`` timed, less one :func:`scalar_latency`.  Returns
    ``(decisions/s, state, (warm decisions, timed decisions))``."""
    lat = scalar_latency(state.device)

    def run(st):
        return engine_run(st, 0, steps, allow_limit_break=False,
                          anticipation_ns=0, advance_now=False)

    state, _, warm = run(state)
    int(state_digest(state))
    t0 = time.perf_counter()
    state, _, timed = run(state)
    int(state_digest(state))
    t = time.perf_counter() - t0 - lat
    return steps / t, state, (warm, timed)


def tpu_regime_sweep(n=100_000, depth=256, k=49152, m=21, *, epochs=8,
                     lo_decisions=3 << 21, serial_steps=4096, reps=3,
                     device=DEFAULT_DEVICE):
    """Decisions/s by regime on the prefix engine: the pure reservation
    backlog (now far past every reservation tag), a reservation ->
    weight transition mid-run (consumed once: one chain), the weight
    steady state, and the exact serial engine as the floor.  Rows
    ``(scenario, dps, fill)``."""
    dev = resolve_device(device)
    lo = lo_epochs(epochs, k, m, lo_decisions)
    rows = []
    dps, fill = _timed_prefix_epochs(lambda: resv_state(n, depth, dev),
                                     10**15, epochs, k, m, epochs_lo=lo,
                                     reps=reps)
    rows.append(("reservation backlog", dps, fill))
    print(f"reservation: {dps/1e6:.2f} M dec/s fill {fill:.3f}", flush=True)

    st = resv_state(n, depth, dev)
    now = int(st.head_resv.min()) + 2 * 10**7
    dps, fill = _timed_transient_chain(st, now, epochs, k, m)
    del st
    rows.append(("resv->weight transition (transient)", dps, fill))
    print(f"transition: {dps/1e6:.2f} M dec/s fill {fill:.3f}", flush=True)

    dps, fill = _timed_prefix_epochs(
        lambda: _preloaded_state(n, depth, ring=depth, device=dev), 0,
        epochs, k, m, epochs_lo=lo, reps=reps)
    rows.append(("weight steady state", dps, fill))
    print(f"weight: {dps/1e6:.2f} M dec/s fill {fill:.3f}", flush=True)

    dps, _, _ = serial_floor(
        _preloaded_state(n, depth, ring=depth, device=dev), serial_steps)
    rows.append(("exact serial engine", dps, 1.0))
    print(f"serial exact: {dps/1e3:.1f} k dec/s", flush=True)
    return rows


def _bench_sustained(n, k, m, rounds, *, zipf, resv_rate, dt_round_ns,
                     waves=32, ring=128, depth0=64, rounds_lo=0,
                     resv_aligned=False, split_resv=0.0, reps=3,
                     device=DEFAULT_DEVICE) -> dict:
    """``bench.bench_sustained`` at these arguments (its defaults: the
    prefix engine, sort selection, telemetry and provenance on, no SLO
    plane, no latency rounds, two conformance rounds) as
    ``serve.sustained_row``."""
    return sustained_row(
        "cfg3", n, rounds=rounds, rounds_lo=rounds_lo, reps=reps,
        latency_rounds=0, slo=False, device=device,
        shape=dict(k=k, m=m, zipf=zipf, resv_rate=resv_rate,
                   dt_round_ns=dt_round_ns, waves=waves, ring=ring,
                   depth0=depth0, resv_aligned=resv_aligned,
                   split_resv=split_resv, target_resv_share=0.0,
                   select_impl="sort"))


def tpu_sustained_sweep(cases=FULL["sustained"]["cases"], *,
                        device=DEFAULT_DEVICE):
    """Bench's sustained closed loop (Poisson superwave ingest and
    prefix epochs, arrivals in the timed region) at the JAX script's two
    ``bench_sustained`` calls.  Rows ``(name, row)``, the row's keys
    ``dps``, ``fill``, ``resv_phase_frac``, ``mean_depth`` and the rest
    of ``serve.sustained_row``'s."""
    rows = []
    for name, kw in cases:
        r = _bench_sustained(**kw, device=device)
        rows.append((name, r))
        print(f"{name.split(':')[0]}: {r['dps']/1e6:.2f} M dec/s",
              flush=True)
    return rows


def cfg4_calibration_sweep(n=100_000, k=49152, m=21, *, rounds=16,
                           rounds_lo=8, reps=3,
                           cases=FULL["calibration"]["cases"],
                           device=DEFAULT_DEVICE):
    """The cfg4 reservation-rate study on the prefix engine: the
    reservation share and throughput against the reservation rate, for
    the mixed staggered, mixed aligned and split populations.  Rows
    ``(design, rate, row)``."""
    rows = []
    for name, kw, rates in cases:
        for r in rates:
            out = _bench_sustained(n, k, m, rounds, zipf=True, resv_rate=r,
                                   dt_round_ns=50_000_000,
                                   rounds_lo=rounds_lo, reps=reps,
                                   device=device, **kw)
            rows.append((name, r, out))
            print(f"{name} r={r}: resv_phase={out['resv_phase_frac']:.3f} "
                  f"fill={out['fill']:.3f} dps={out['dps']/1e6:.1f}M",
                  flush=True)
    return rows


def device_sim_headline(n=DS.HEADLINE_CLIENTS, *, lo=DS.HEADLINE_LO,
                        hi=DS.HEADLINE_HI, device=DEFAULT_DEVICE) -> dict:
    """The device sim's closed-loop ops per wall second
    (``sim.device_sim.device_sim_headline``): its ``ops_per_sec``,
    ``total_ops``, ``virtual_s`` and ``weight_ratio_3_1`` and the rest."""
    row = DS.device_sim_headline(n, device=device, lo=lo, hi=hi)
    print(f"device_sim closed loop: {row['ops_per_sec']/1e6:.2f} M ops/s "
          f"wall (weight 3:1 ratio {row['weight_ratio_3_1']:.2f}, "
          f"{row['total_ops']} ops, {row['virtual_s']:.1f}s virtual)",
          flush=True)
    return row


def tpu_calendar_sweep(n=100_000, depth=320,
                       points=FULL["calendar"]["points"], *,
                       device=DEFAULT_DEVICE):
    """The calendar engine's serve-only drain over ``(m, steps, epochs)``
    points of the weight steady state (minstop): one warm epoch on a
    fresh state, then one chain of ``epochs`` from another, less one
    :func:`scalar_latency`.  Rows ``(m, steps, dps, decisions)``."""
    dev = resolve_device(device)
    lat = scalar_latency(dev)
    rows = []
    for m, steps, epochs in points:
        st = _preloaded_state(n, depth, ring=depth, device=dev)
        ep = scan_calendar_epoch(st, 0, m, steps=steps, anticipation_ns=0)
        int(state_digest(ep.state))
        del ep
        st = _preloaded_state(n, depth, ring=depth, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        counts = []
        for _ in range(epochs):
            ep = scan_calendar_epoch(st, 0, m, steps=steps,
                                     anticipation_ns=0)
            st = ep.state
            counts.append(ep.count)
        int(state_digest(st))
        wall = time.perf_counter() - t0 - lat
        total = sum(int(c.sum()) for c in counts)
        rows.append((m, steps, total / wall, total))
        print(f"calendar m={m} steps={steps}: {total/wall/1e6:.1f} M dec/s "
              f"({total} decisions, {wall:.2f}s)", flush=True)
    return rows


def limited_state(n: int, depth: int, device) -> EngineState:
    """The preloaded backlog under tight limits: every limit tag already
    past ``now = 0`` (``head_limit`` 10^12 ns, ``limit_inv`` 10^6 ns) and
    no head ready, so AtLimit Wait would park everyone and Allow serves
    each decision by limit-break."""
    st = _preloaded_state(n, depth, ring=depth, device=device)
    dev = st.device
    return st._replace(
        limit_inv=torch.full((n,), 10**6, dtype=torch.int64, device=dev),
        head_limit=torch.full((n,), 10**12, dtype=torch.int64, device=dev),
        head_ready=torch.zeros(n, dtype=torch.bool, device=dev))


def _allow_chain(run, make, epochs: int, lat: float):
    """One warm epoch on ``make()``, then ``epochs`` timed from a fresh
    ``make()`` (each epoch's count read as it lands, as the JAX row
    does).  Returns ``(warm epoch, decisions, wall less lat)``."""
    warm = run(make())
    int(state_digest(warm.state))
    st = make()
    _sync(st.device)
    t0 = time.perf_counter()
    total = 0
    for _ in range(epochs):
        ep = run(st)
        st = ep.state
        total += int(ep.count.sum())
    int(state_digest(st))
    return warm, total, time.perf_counter() - t0 - lat


def tpu_allow_regime_row(n=100_000, depth=256, k=49152, m=21, *,
                         sorted_epochs=3, cal_m=8, cal_steps=8,
                         cal_epochs=6, device=DEFAULT_DEVICE):
    """AtLimit Allow on the fast paths, over :func:`limited_state`: the
    sorted flat epochs (``lb`` read off the warm epoch's
    ``PrefixEpoch.lb``), then one ``calendar_batch``, which must fire a
    limit-break (a classification regression must not let the calendar
    row measure something else), then the calendar epochs.  Rows
    ``(scenario, dps, limit-breaks fired, decisions)``."""
    dev = resolve_device(device)
    lat = scalar_latency(dev)

    def make():
        return limited_state(n, depth, dev)

    rows = []
    warm, total, wall = _allow_chain(
        lambda s: scan_prefix_epoch(s, 0, m, k, anticipation_ns=0,
                                    allow_limit_break=True),
        make, sorted_epochs, lat)
    lb = bool(warm.lb.any())
    del warm
    rows.append(("Allow limit-break (sorted flat epochs)", total / wall, lb,
                 total))
    print(f"allow sorted: {total/wall/1e6:.1f} M dec/s (lb={lb})",
          flush=True)

    b = calendar_batch(make(), 0, steps=cal_steps, anticipation_ns=0,
                       allow_limit_break=True)
    lb_cal = bool(b.lb.sum() > 0)
    del b
    if not lb_cal:
        raise AssertionError("calendar Allow row: no limit-breaks fired")
    _, total, wall = _allow_chain(
        lambda s: scan_calendar_epoch(s, 0, cal_m, steps=cal_steps,
                                      anticipation_ns=0,
                                      allow_limit_break=True),
        make, cal_epochs, lat)
    rows.append(("Allow limit-break (calendar epochs)", total / wall, lb_cal,
                 total))
    print(f"allow calendar: {total/wall/1e6:.1f} M dec/s", flush=True)
    return rows


def platform_label(dev: torch.device) -> str:
    """``platform=cuda (<name>, <power limit>)`` as nvidia-smi prints
    them, or ``platform=cpu``."""
    if dev.type != "cuda":
        return f"platform={dev.type}"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return f"platform=cuda ({smi})"


def _clients(n: int) -> str:
    return f"{n // 1000}k" if n % 1000 == 0 else str(n)


def headings(shapes: dict, plat: str) -> dict:
    """Each section's heading: the JAX script's, with the shape it ran
    at and ``plat`` (the JAX k/m heading's "TPU" goes)."""
    km, rg, cb = shapes["km"], shapes["regime"], shapes["calibration"]
    return {
        "km": f"## Prefix-epoch k/m sweep ({_clients(km['n'])} clients, "
              f"{plat})",
        "regime": f"## Regime coverage (prefix engine, "
                  f"{_clients(rg['n'])} clients, k={rg['k']}, m={rg['m']}, "
                  f"{plat})",
        "sustained": f"## Sustained closed loop, arrivals included "
                     f"(BASELINE configs #3/#4, {plat})",
        "devsim": f"## Device-sim closed loop "
                  f"({_clients(shapes['devsim']['n'])} clients, prefix "
                  f"serve q=4096, random selection, 2-thread servers, one "
                  f"chip, {plat})",
        "calibration": f"## cfg4 reservation calibration "
                       f"({_clients(cb['n'])} clients, Zipf, k={cb['k']} "
                       f"m={cb['m']}, dt=50ms, {plat})",
        "calendar": f"## Calendar engine serve-only drain "
                    f"({_clients(shapes['calendar']['n'])} clients, "
                    f"minstop, {plat})",
        "allow": f"## AtLimit Allow limit-break "
                 f"({_clients(shapes['allow']['n'])} clients, {plat})",
    }


# each section's table header (the first five are the JAX script's)
COLUMNS = {
    "km": ["| k | m | M dec/s | fill |", "|---|---|---|---|"],
    "regime": ["| scenario | M dec/s | fill |", "|---|---|---|"],
    "sustained": ["| workload | M dec/s | fill | resv phase | mean depth |",
                  "|---|---|---|---|---|"],
    "devsim": ["| M ops/s (wall) | total ops | virtual s | weight 3:1 "
               "ratio |", "|---|---|---|---|"],
    "calibration": ["| design | resv rate /s | resv phase | fill | "
                    "M dec/s |", "|---|---|---|---|---|"],
    "calendar": ["| m | steps | M dec/s | decisions |", "|---|---|---|---|"],
    "allow": ["| scenario | M dec/s | limit-breaks fired | decisions |",
              "|---|---|---|---|"],
}
CALIBRATION_NOTE = (
    "The share is monotone in the rate for every design: weight serves' "
    "reservation-debt reduction keeps mixed clients' reservation tags at "
    "the eligibility boundary, so the phases interleave per decision; the "
    "shipped cfg4 is mixed-staggered at the rate whose share is ~0.5 "
    "(bench.CFG4_RESV_RATE).")


def section(kind: str, heading: str, body: list, note: str = "") -> str:
    return "\n".join([heading, "", *COLUMNS[kind], *body, ""]
                     + ([note, ""] if note else []))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the device half of benchmark/run_sweeps.py on the "
                    "port")
    ap.add_argument("--skip-km", action="store_true",
                    help="skip the k/m sweep (the JAX script's --skip-tpu)")
    ap.add_argument("--regimes", action="store_true",
                    help="also run the regime-coverage and sustained rows")
    ap.add_argument("--devsim", action="store_true",
                    help="also run the device-sim closed-loop headline")
    ap.add_argument("--calibrate", action="store_true",
                    help="also run the cfg4 reservation calibration study "
                         "(slow: 9 sustained rows)")
    ap.add_argument("--calendar", action="store_true",
                    help="also run the calendar-engine and Allow rows")
    ap.add_argument("--cut", action="store_true",
                    help="every row at the cut shape (CUT), for the CPU")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of the rows (default cuda; no fallback)")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="write the markdown here (default: standard "
                         "output)")
    return ap


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    dev = resolve_device(a.device)
    shapes = CUT if a.cut else FULL
    head = headings(shapes, platform_label(dev))
    parts = {}
    if not a.skip_km:
        parts["km"] = [f"| {k} | {m} | {dps/1e6:.2f} | {fill:.3f} |"
                       for k, m, dps, fill in tpu_km_sweep(**shapes["km"],
                                                           device=dev)]
    if a.regimes:
        parts["regime"] = [
            f"| {name} | {dps/1e6:.2f} | {fill:.3f} |"
            for name, dps, fill in tpu_regime_sweep(**shapes["regime"],
                                                    device=dev)]
        parts["sustained"] = [
            f"| {name} | {r['dps']/1e6:.2f} | {r['fill']:.3f} | "
            f"{r['resv_phase_frac']:.2f} | {r['mean_depth']:.0f} |"
            for name, r in tpu_sustained_sweep(**shapes["sustained"],
                                               device=dev)]
    if a.calibrate:
        parts["calibration"] = [
            f"| {name} | {r:.0f} | {out['resv_phase_frac']:.3f} | "
            f"{out['fill']:.3f} | {out['dps']/1e6:.1f} |"
            for name, r, out in cfg4_calibration_sweep(
                **shapes["calibration"], device=dev)]
    if a.devsim:
        row = device_sim_headline(**shapes["devsim"], device=dev)
        parts["devsim"] = [
            f"| {row['ops_per_sec']/1e6:.2f} | {row['total_ops']} | "
            f"{row['virtual_s']:.1f} | {row['weight_ratio_3_1']:.2f} |"]
    if a.calendar:
        parts["calendar"] = [
            f"| {m} | {steps} | {dps/1e6:.2f} | {total} |"
            for m, steps, dps, total in tpu_calendar_sweep(
                **shapes["calendar"], device=dev)]
        parts["allow"] = [
            f"| {name} | {dps/1e6:.2f} | {lb} | {total} |"
            for name, dps, lb, total in tpu_allow_regime_row(
                **shapes["allow"], device=dev)]
    doc = ["# Benchmark sweeps", "",
           "Produced by `python scripts/torch_run_sweeps.py` (see its "
           "docstring).", ""]
    for kind in ("km", "regime", "sustained", "devsim", "calibration",
                 "calendar", "allow"):
        if kind in parts:
            doc.append(section(kind, head[kind], parts[kind],
                               CALIBRATION_NOTE if kind == "calibration"
                               else ""))
    if a.out:
        Path(a.out).write_text("\n".join(doc))
        print(f"wrote {a.out}")
    else:
        print("\n".join(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
