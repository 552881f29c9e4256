#!/usr/bin/env python
"""Component profile of the prefix-commit and calendar engines on the
card (PyTorch port): the counterpart of the JAX repo's
``profile_fastpath.py``, the tool behind PROFILE.md.

    python3 scripts/torch_profile_fastpath.py [--n 100000] [--k 49152]
        [--reps 3] [--rows epoch,calendar,component] [--out rows.json]
    python3 scripts/torch_profile_fastpath.py --n 512 --k 256 --reps 1 \\
        --device cpu

Timing: every row is a differenced pair of launch counts, each timed
from its first launch to one read back of a scalar that depends on the
whole chain (``serve.state_digest``, or the component's carry), the best
of ``--reps``; ``(T(hi) - T(lo)) / (hi - lo)`` cancels the fixed cost of
a chain (its read back, ``serve.scalar_latency``, is printed first).

- **epoch rows**: ``scan_prefix_epoch`` at m = 8 against 32 batches of
  ``k`` on the preloaded state (100,000 clients, ring 128 preloaded 128
  deep): sort, radix, tag64 and tag32 on the high-rate state
  (``serve.high_rate_state``), and ``window_m=8`` at m = 16 against 64;
  us a batch and decisions/s at ``k`` a batch;
- **calendar rows**: ``scan_calendar_epoch`` at m = 4 against 12 batches
  of 8 steps on a Zipf-64-skewed backlog (``zipf_state``): minstop,
  bucketed L=4 and L=8, wheel L=8 (K2); us a batch, the marginal
  decisions a batch and decisions/s.  The JAX repo's second wheel row
  (``wheel_kernel`` xla against pallas) has no counterpart: the port's
  wheel always launches K2 on the card, so it prints as such;
- **component rows**, each a step with its carry, 64 against 256 steps:
  the 2-key sort selection with its cummin (the port packs the two keys
  into one int64 and sorts once, where the JAX component sorts five
  int32 arrays on two keys), the radix k-select with its ``[k]`` order
  (``torch.topk``, the port's radix selection, where JAX walks a
  histogram), the dense serve retag (``_chain_serve``), the
  ``ring_window`` prefetch (K1, once an epoch) and the window head select
  (once a batch; a gather in the port, a one-hot select in JAX).  Each
  component computes what the JAX one computes (``tests/
  test_torch_profile_fastpath.py`` holds them equal), not how it is laid
  out.

Each row also prints its ``cost_analysis`` (the cost counter of
``obs/compile_plane.py``: the differenced count of a batch for the epoch
and calendar rows, one step's count for a component) and its achieved
bytes/s against the card's peak (``obs/capacity.device_peaks``).  The
card's name and power limit (``nvidia-smi``) print first, then a line a
row, then one JSON line of every row.  Without ``--device`` it runs on
the card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dmclock_tpu_torch import serve  # noqa: E402
from dmclock_tpu_torch.core.timebase import rate_to_inv_ns  # noqa: E402
from dmclock_tpu_torch.device import resolve_device  # noqa: E402
from dmclock_tpu_torch.engine import fastpath  # noqa: E402
from dmclock_tpu_torch.engine.kernels import as_scalar  # noqa: E402
from dmclock_tpu_torch.obs import capacity as obscap  # noqa: E402
from dmclock_tpu_torch.obs import compile_plane  # noqa: E402

N = 100_000
K = 49152
RING = 128
M_LO, M_HI = 8, 32          # epoch rows: batches a launch
IT_LO, IT_HI = 64, 256      # component rows: steps a chain
WINDOW = 32                 # the prefetch row's window rows
ROWS = ("epoch", "calendar", "component")


# ----------------------------------------------------------------------
# states
# ----------------------------------------------------------------------

def zipf_state(n: int, ring: int, depth: int, device) -> object:
    """The cfg4-like Zipf-64 skew over the preload (the JAX script's
    ``_zipf_state``): weights 1/i^1.1 scaled to the median, clipped to
    [0.5, 64], shuffled by ``default_rng(7)``; each client's head
    proportion tag jittered by its golden-ratio phase."""
    st = serve._preloaded_state(n, depth, ring=ring, device=device)
    w = 1.0 / np.arange(1, n + 1) ** 1.1
    w = np.clip(w / w[n // 2], 0.5, 64.0)
    np.random.default_rng(7).shuffle(w)
    winv = np.asarray([rate_to_inv_ns(x) for x in w], np.int64)
    c = np.arange(n)
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    jitter = (phase * 2.0 * winv).astype(np.int64)
    dev = st.device
    return st._replace(weight_inv=torch.from_numpy(winv).to(dev),
                       head_prop=torch.from_numpy(winv + jitter).to(dev))


# ----------------------------------------------------------------------
# the components: one step each, ``(state, t, ...) -> (t', out)``
# ----------------------------------------------------------------------

def select_sort_step(state, t, k: int):
    """The sort selection with its cummin: keys ``head_prop + prop_delta
    + t`` rebased to their minimum and clipped to int32, ordered on
    (key, creation order) by one stable sort of the packed int64, the
    slots, costs and stand-in re-entry keys (key + 1) gathered to the
    first ``k``, their cumulative minimum against the packed keys; the
    committed count is the first position it fails.  ``t'`` adds the
    first slot."""
    key = state.head_prop + state.prop_delta + t
    k32 = torch.clamp(key - torch.min(key), 0, (1 << 31) - 2)
    pk = (k32 << 32) | (state.order & 0xFFFFFFFF)
    pks, perm = torch.sort(pk, stable=True)
    pks, perm = pks[:k], perm[:k]
    idxs = perm.to(torch.int32)
    _costs = state.head_cost[perm].to(torch.int32)
    rpk = (k32[perm] + 1) << 32
    cm = torch.cummin(rpk, 0).values
    count = torch.argmax((~(cm > pks)).to(torch.int32)).to(torch.int32)
    return t + idxs[0].to(torch.int64) + 1, count


def select_radix_step(state, t, k: int):
    """The radix k-select with its ``[k]`` order: the 28-bit-order
    packed keys, the ``min(k, N)`` smallest in order (``torch.topk``),
    the slots, costs and re-entry keys (packed + 1) gathered, the
    cummin count as in :func:`select_sort_step`."""
    key = state.head_prop + state.prop_delta + t
    krel = torch.clamp(key - torch.min(key), 0, (1 << 31) - 2)
    pk = (krel << 28) | (state.order & ((1 << 28) - 1))
    kk = min(k, pk.shape[0])
    pks, perm = torch.topk(pk, kk, largest=False, sorted=True)
    idxs = perm.to(torch.int32)
    _costs = state.head_cost[perm].to(torch.int32)
    rpk = pk[perm] + 1
    cm = torch.cummin(rpk, 0).values
    count = torch.argmax((~(cm > pks)).to(torch.int32)).to(torch.int32)
    return t + idxs[0].to(torch.int64) + 1, count


def serve_step(state, t, cls, now):
    """The dense serve retag (``_chain_serve``, one pop, no ring access)
    of every client as a weight-class serve, ``prev_prop`` moved by
    ``t``."""
    st = state._replace(prev_prop=state.prev_prop + t)
    sv = fastpath._chain_serve(st, now, [st.head_arrival],
                               [st.head_cost], cls, False, 0)
    return t + sv.head_prop[0] + 1, sv.head_resv[0]


def _moved_heads(state, t, ring: int):
    return state._replace(q_head=torch.remainder(
        state.q_head + t.to(torch.int32), ring).to(torch.int32))


def prefetch_step(state, t, ring: int, wsize: int = WINDOW):
    """The ``ring_window`` prefetch (K1 on the card), ``q_head`` moved by
    ``t``: the first window element of client 0 feeds the carry."""
    win = fastpath.ring_window(_moved_heads(state, t, ring), wsize)
    return t + win.arr[0, 0] + 1, win.cost[0, 0]


def head_select_step(state, t, win, ring: int):
    """The window head select: every client's next element from a
    prefetched window, ``q_head`` moved by ``t``."""
    narr, ncost = fastpath._window_heads(_moved_heads(state, t, ring), win)
    return t + narr[0] + 1, ncost[0]


# ----------------------------------------------------------------------
# timing and counting
# ----------------------------------------------------------------------

def _best(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _cost_delta(hi: dict, lo: dict, units: int) -> dict:
    return {k: (hi.get(k, 0.0) - lo.get(k, 0.0)) / units
            for k in ("flops", "bytes_accessed", "transcendentals")}


def _row(name: str, seconds: float, cost: dict, peaks: dict,
         unit: str, **extra) -> dict:
    bps = cost["bytes_accessed"] / seconds if seconds > 0 else None
    row = dict(name=name, unit=unit, us=seconds * 1e6, cost_analysis=cost,
               achieved_bytes_per_s=bps,
               peak_bytes_per_s=peaks["peak_bytes_per_s"],
               peak_share=None if bps is None
               else bps / peaks["peak_bytes_per_s"], **extra)
    dps = extra.get("decisions_per_s")
    # a differenced pair that is not positive (host jitter) has no rate
    rate = "" if "decisions_per_s" not in extra else \
        (f"  ({extra['decisions_per_batch']:9.1f} dec/batch, "
         + ("-" if dps is None else f"{dps / 1e6:7.2f}") + " M dec/s)")
    share = "-" if row["peak_share"] is None else \
        f"{row['peak_share']:.4f}"
    print(f"{name:58s} {seconds * 1e6:11.1f} us/{unit}{rate}  "
          f"flops {cost['flops']:.4g} bytes {cost['bytes_accessed']:.4g} "
          f"trans {cost['transcendentals']:.4g}; "
          f"{0 if bps is None else bps:.4g} B/s = {share} of peak",
          flush=True)
    return row


def measure_epoch(name, state, peaks, *, k, reps, m_lo=M_LO, m_hi=M_HI,
                  **kw) -> dict:
    """``scan_prefix_epoch`` at ``m_lo`` against ``m_hi`` batches of
    ``k``; ``kw`` is the row's knob (``select_impl``, ``tag_width``,
    ``window_m``)."""
    def run(m):
        return fastpath.scan_prefix_epoch(state, 0, m, k, anticipation_ns=0,
                                          **kw)

    def chain(m):
        return lambda: int(serve.state_digest(run(m).state))

    chain(m_lo)()
    chain(m_hi)()
    t = (_best(chain(m_hi), reps) - _best(chain(m_lo), reps)) / (m_hi - m_lo)
    cost = _cost_delta(compile_plane.count_launch(lambda: run(m_hi)),
                       compile_plane.count_launch(lambda: run(m_lo)),
                       m_hi - m_lo)
    return _row(name, t, cost, peaks, "batch", decisions_per_batch=k,
                decisions_per_s=k / t if t > 0 else None)


def measure_calendar(name, state, peaks, *, impl, levels, reps, m_lo=4,
                     m_hi=12, steps=8) -> dict:
    """``scan_calendar_epoch`` at ``m_lo`` against ``m_hi`` batches: the
    marginal batch time and the marginal decisions a batch (the schemes
    commit different amounts a batch, so decisions/s is the
    comparison)."""
    def run(m):
        return fastpath.scan_calendar_epoch(
            state, 0, m, steps=steps, anticipation_ns=0,
            calendar_impl=impl, ladder_levels=levels)

    def chain(m):
        return lambda: int(serve.state_digest(run(m).state))

    chain(m_lo)()
    ep_hi = run(m_hi)
    d = float(ep_hi.count[m_lo:].sum()) / (m_hi - m_lo)
    del ep_hi
    t = (_best(chain(m_hi), reps) - _best(chain(m_lo), reps)) / (m_hi - m_lo)
    cost = _cost_delta(compile_plane.count_launch(lambda: run(m_hi)),
                       compile_plane.count_launch(lambda: run(m_lo)),
                       m_hi - m_lo)
    return _row(name, t, cost, peaks, "batch", decisions_per_batch=d,
                decisions_per_s=d / t if t > 0 else None)


def measure_steps(name, step, peaks, *, reps, it_lo=IT_LO,
                  it_hi=IT_HI) -> dict:
    """A component's ``step(t) -> (t', out)`` chained ``it_lo`` against
    ``it_hi`` times; the chain's read back is the final carry plus the
    first step's output, so every step is waited for."""
    dev = step.device

    def chain(iters):
        def go():
            t = torch.zeros((), dtype=torch.int64, device=dev)
            first = None
            for _ in range(iters):
                t, out = step(t)
                if first is None:
                    first = out
            return int(t + first.to(torch.int64))
        return go

    chain(it_lo)()
    chain(it_hi)()
    t = (_best(chain(it_hi), reps) - _best(chain(it_lo), reps)) \
        / (it_hi - it_lo)
    t0 = torch.zeros((), dtype=torch.int64, device=dev)
    cost = compile_plane.count_launch(lambda: step(t0))
    return _row(name, t, cost, peaks, "iter")


class _Step:
    """A component bound to its state and arguments: ``step(t)``."""

    def __init__(self, fn, state, *args):
        self.fn, self.state, self.args = fn, state, args
        self.device = state.device

    def __call__(self, t):
        return self.fn(self.state, t, *self.args)


def component_steps(state, k: int, ring: int = RING) -> list:
    """``[(row name, step)]`` of the five components on ``state``."""
    dev = state.device
    cls = torch.full((state.capacity,), fastpath.CLS_WEIGHT,
                     dtype=torch.int32, device=dev)
    win = fastpath.ring_window(state, WINDOW)
    return [
        ("selection: 2-key sort (one int64 pack) + cummin",
         _Step(select_sort_step, state, k)),
        ("selection: radix k-select (topk) + [k] order",
         _Step(select_radix_step, state, k)),
        ("serve: dense elementwise retag",
         _Step(serve_step, state, cls, as_scalar(1 << 60, dev))),
        ("ring_window prefetch (K1, per EPOCH)",
         _Step(prefetch_step, state, ring)),
        ("window head select (gather, per batch)",
         _Step(head_select_step, state, win, ring)),
    ]


# ----------------------------------------------------------------------
# the rows
# ----------------------------------------------------------------------

def epoch_rows(n: int, k: int, dev, peaks, reps: int) -> list:
    state = serve._preloaded_state(n, RING, ring=RING, device=dev)
    rows = [
        measure_epoch(f"scan_prefix_epoch (k={k}, ring={RING})", state,
                      peaks, k=k, reps=reps),
        measure_epoch(f"scan_prefix_epoch radix (k={k})", state, peaks,
                      k=k, reps=reps, select_impl="radix")]
    hi = serve.high_rate_state(n, RING, device=dev)
    rows += [
        measure_epoch(f"scan_prefix_epoch tag64 (high-rate, k={k})", hi,
                      peaks, k=k, reps=reps),
        measure_epoch(f"scan_prefix_epoch tag32 (high-rate, k={k})", hi,
                      peaks, k=k, reps=reps, tag_width=32)]
    del hi
    rows.append(measure_epoch(f"scan_prefix_epoch m=64 window_m=8 (k={k})",
                              state, peaks, k=k, reps=reps, m_lo=16,
                              m_hi=64, window_m=8))
    return rows


def calendar_rows(n: int, dev, peaks, reps: int) -> list:
    zs = zipf_state(n, RING, 96, dev)
    rows = [measure_calendar(f"scan_calendar_epoch {label} (steps=8)", zs,
                             peaks, impl=impl, levels=levels, reps=reps)
            for label, impl, levels in (("minstop", "minstop", 1),
                                        ("bucketed L=4", "bucketed", 4),
                                        ("bucketed L=8", "bucketed", 8),
                                        ("wheel L=8", "wheel", 8))]
    name = "scan_calendar_epoch wheel L=8 kernel=pallas"
    why = ("no counterpart: the port's wheel always launches K2 on the "
           "card (no xla/pallas switch); the wheel L=8 row is it")
    print(f"{name:58s} {why}", flush=True)
    rows.append(dict(name=name, no_counterpart=why))
    return rows


def component_rows(n: int, k: int, dev, peaks, reps: int) -> list:
    state = serve._preloaded_state(n, RING, ring=RING, device=dev)
    return [measure_steps(name, step, peaks, reps=reps)
            for name, step in component_steps(state, k)]


def card_line(dev) -> str:
    """``nvidia-smi``'s name and power limit on the card, ``cpu`` on the
    CPU."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="which groups of rows: " + ",".join(ROWS))
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    groups = [g for g in a.rows.split(",") if g]
    bad = set(groups) - set(ROWS)
    if bad:
        ap.error(f"unknown row groups {sorted(bad)}")
    print(card_line(dev), flush=True)
    peaks = obscap.device_peaks(dev)
    print(f"# peaks {json.dumps(peaks)}; scalar read back "
          f"{serve.scalar_latency(dev) * 1e3:.3f} ms", flush=True)
    rows = []
    if "epoch" in groups:
        rows += epoch_rows(a.n, a.k, dev, peaks, a.reps)
    if "calendar" in groups:
        rows += calendar_rows(a.n, dev, peaks, a.reps)
    if "component" in groups:
        rows += component_rows(a.n, a.k, dev, peaks, a.reps)
    line = json.dumps({"device": card_line(dev), "n": a.n, "k": a.k,
                       "reps": a.reps, "rows": rows})
    if a.out:
        Path(a.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
