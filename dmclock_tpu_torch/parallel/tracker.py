"""Device-side distributed ServiceTracker (the delta/rho protocol on
tensors).

Counterpart of ``dmclock_tpu/parallel/tracker.py``: the vectorized
equivalent of the host ``core.tracker.ServiceTracker`` with
``OrigTracker`` accounting (reference ``dmclock_client.h:39-84``,
``:157-287``).  State is per-(server, client): one server's shard is a
set of ``[C]`` tensors, a cluster on one card stacks them on a leading
server axis (``[S, C]``), and the client's *global* completion counters
-- which the host tracker keeps as plain ints -- are a sum of the
per-server counters over that axis (the JAX package's ``psum`` over the
mesh's ``servers`` axis).  Every function here is elementwise or
row-wise, so it takes a ``[C]`` shard and an ``[S, C]`` stack alike.

Per (server s, client c), mirroring OrigTracker's fields:
  ``last_mark``  = global counter value at c's previous request to s
                   (``delta_prev_req``/``rho_prev_req``)
  ``own_since``  = c's completions AT s since that request
                   (``my_delta``/``my_rho``)
so a request from c to s carries
  ``delta_out = global_delta[c] - last_mark[s,c] - own_since[s,c]``
(reference ``prepare_req``, dmclock_client.h:59-67).

Counters start at 1, matching ``GlobalCounters`` (dmclock_client.h:191-198).
The JAX scatter ``.at[idx].add`` with repeated slots is ``scatter_add``
along the client axis: integer adds are exact in any order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device


class TrackerState(NamedTuple):
    """The distributed tracker: ``[C]`` tensors for one server, or
    ``[S, C]`` for a stack of servers."""

    completed_delta: torch.Tensor  # int64 completions served here, by client
    completed_rho: torch.Tensor    # int64 reservation-phase subset
    last_mark_delta: torch.Tensor  # int64 global delta at last request here
    last_mark_rho: torch.Tensor    # int64
    seen: torch.Tensor             # bool client has contacted this server


TRACKER_DTYPES = dict(completed_delta=torch.int64,
                      completed_rho=torch.int64,
                      last_mark_delta=torch.int64,
                      last_mark_rho=torch.int64, seen=torch.bool)


def _shape(n_clients: int, n_servers: Optional[int]) -> tuple:
    return (n_clients,) if n_servers is None else (n_servers, n_clients)


def init_tracker(n_clients: int, *, n_servers: Optional[int] = None,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> TrackerState:
    """Fresh tracker: ``[C]``, or ``[S, C]`` with ``n_servers``."""
    dev = resolve_device(device)
    shape = _shape(n_clients, n_servers)

    def z():
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    return TrackerState(
        completed_delta=z(), completed_rho=z(),
        last_mark_delta=z(), last_mark_rho=z(),
        seen=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


def server_sum(x: torch.Tensor) -> torch.Tensor:
    """The reduction over the server axis of an ``[S, C]`` stack (the
    JAX package's ``psum`` over ``servers``, on one card)."""
    return x.sum(dim=0)


def global_counters(tracker: TrackerState, psum=server_sum):
    """The client-global counters: the sum of per-server completions
    over the server axis, plus the reference's start-at-1 offset.
    ``psum`` is the reduction to use (the sum over dim 0 of an
    ``[S, C]`` stack by default)."""
    return 1 + psum(tracker.completed_delta), \
        1 + psum(tracker.completed_rho)


def tracker_track(tracker: TrackerState, slots: torch.Tensor,
                  costs: torch.Tensor, phases: torch.Tensor,
                  served: torch.Tensor) -> TrackerState:
    """Fold a batch of completions into the counters (reference
    resp_update, dmclock_client.h:69-79): delta always, rho only for
    reservation-phase service.

    slots/costs/phases/served are the decision-stream tensors from
    ``engine_run`` (phase 0 = reservation): ``[q]`` for a ``[C]``
    tracker, ``[S, q]`` for an ``[S, C]`` one.  Unserved rows add 0 at
    slot 0."""
    idx = torch.where(served, slots.to(torch.int64), 0)
    add = torch.where(served, costs, 0).to(torch.int64)
    add_rho = torch.where(served & (phases == 0), costs, 0) \
        .to(torch.int64)
    return tracker._replace(
        completed_delta=tracker.completed_delta.scatter_add(-1, idx, add),
        completed_rho=tracker.completed_rho.scatter_add(-1, idx, add_rho),
    )


def tracker_track_counts(tracker: TrackerState, served: torch.Tensor,
                         served_resv: torch.Tensor,
                         cost: torch.Tensor) -> TrackerState:
    """Counts form of :func:`tracker_track` for engines that emit
    per-client completion totals instead of an ordered decision stream
    (the calendar engine's ``served``/``served_resv`` vectors):
    ``delta += served * cost``, ``rho += served_resv * cost`` -- the
    exact sums the per-decision fold computes when every request of a
    client carries the same cost (``cost`` the per-client request
    cost).  Dense adds, no scatter."""
    return tracker._replace(
        completed_delta=tracker.completed_delta
        + served.to(torch.int64) * cost,
        completed_rho=tracker.completed_rho
        + served_resv.to(torch.int64) * cost,
    )


def tracker_prepare(tracker: TrackerState, requesting: torch.Tensor,
                    global_delta: torch.Tensor, global_rho: torch.Tensor):
    """ReqParams for every client in ``requesting`` (bool) sending its
    next request to this server (reference prepare_req + the first-
    contact ReqParams(1,1) case, dmclock_client.h:241-251).

    Returns (new_tracker, delta_out, rho_out) with outputs valid where
    ``requesting``.  ``global_*`` are ``[C]`` and broadcast against an
    ``[S, C]`` tracker."""
    # OrigTracker's algebra: delta_out = (global movement since the
    # previous request here) - (own completions here since then), i.e.
    #   delta_out = (global - global_mark) - (own - own_mark).
    # One stored field suffices: last_mark_delta keeps
    # ``global_mark - own_mark``, so
    #   delta_out = global - completed - last_mark_delta
    # and re-marking stores ``global - completed`` again.
    mark = tracker.last_mark_delta
    mark_rho = tracker.last_mark_rho
    delta_out = torch.where(
        tracker.seen, global_delta - tracker.completed_delta - mark, 1)
    rho_out = torch.where(
        tracker.seen, global_rho - tracker.completed_rho - mark_rho, 1)
    new_mark = torch.where(requesting,
                           global_delta - tracker.completed_delta, mark)
    new_mark_rho = torch.where(requesting,
                               global_rho - tracker.completed_rho,
                               mark_rho)
    tracker = tracker._replace(
        last_mark_delta=new_mark,
        last_mark_rho=new_mark_rho,
        seen=tracker.seen | requesting,
    )
    return tracker, delta_out, rho_out


def global_counters_from(completed_delta: torch.Tensor,
                         completed_rho: torch.Tensor, psum=server_sum):
    """:func:`global_counters` over raw per-client completion-count
    tensors (a serving plane that keeps only the completions half of
    the protocol).  Same start-at-1 origin, same reduction."""
    return 1 + psum(completed_delta), 1 + psum(completed_rho)


def counter_view_bytes(n_clients: int) -> int:
    """Wire bytes of ONE counter-view exchange: the [C]-sized
    delta + rho int64 reduction -- the paper's per-request four-scalar
    piggyback contract, batched into one collective."""
    return 2 * 8 * int(n_clients)


def exchange_schedule(epochs: int, counter_sync_every: int,
                      start: int = 0) -> dict:
    """Host-side accounting of a batched counter exchange over the
    ``epochs`` boundaries starting at GLOBAL epoch ``start`` with the
    ``counter_sync_every`` staleness knob (syncs fall on ``epoch % K ==
    0``, so epoch 0 always syncs): sync count and cadence -- multiply
    by :func:`counter_view_bytes` for the wire totals."""
    every = max(int(counter_sync_every), 1)
    e0 = int(start)
    n = max(int(epochs), 0)
    first = -(-e0 // every) * every       # first sync epoch >= e0
    syncs = len(range(first, e0 + n, every))
    return {"epochs": n, "counter_sync_every": every,
            "start": e0, "syncs": syncs,
            "sync_frac": syncs / max(n, 1)}


# ----------------------------------------------------------------------
# observability (obs.registry wiring)
# ----------------------------------------------------------------------

def tracker_snapshot(tracker) -> dict:
    """Aggregate stats of a tracker as host scalars (both
    ``TrackerState`` and ``BorrowTrackerState``).  One read back per
    field -- drain time only, never per request."""
    out = {
        "completed_delta_total": int(tracker.completed_delta.sum()),
        "completed_rho_total": int(tracker.completed_rho.sum()),
        "clients_seen": int(tracker.seen.sum()),
    }
    if hasattr(tracker, "borrow_delta"):
        out["borrow_delta_outstanding"] = int(tracker.borrow_delta.sum())
        out["borrow_rho_outstanding"] = int(tracker.borrow_rho.sum())
    return out


def register_tracker_metrics(registry, get_tracker, labels=None) -> None:
    """Register callback gauges over a tracker.  ``get_tracker`` returns
    the CURRENT state (tracker states are immutable NamedTuples that
    callers rebind, so a getter is the only stable handle)."""
    def gauge_fn(key):
        return lambda: tracker_snapshot(get_tracker()).get(key, 0)

    for key in ("completed_delta_total", "completed_rho_total",
                "clients_seen"):
        registry.gauge(f"dmclock_tracker_{key}",
                       "distributed ServiceTracker shard stat",
                       labels=labels).set_function(gauge_fn(key))


# ----------------------------------------------------------------------
# BorrowingTracker variant (reference dmclock_client.h:90-154)
# ----------------------------------------------------------------------

class BorrowTrackerState(NamedTuple):
    """The distributed BorrowingTracker: guarantees delta/rho >= 1 by
    borrowing future replies (reference calc_with_borrow,
    dmclock_client.h:110-129)."""

    completed_delta: torch.Tensor  # int64 completions served here
    completed_rho: torch.Tensor    # int64 reservation-phase subset
    prev_delta: torch.Tensor       # int64 global delta at last request here
    prev_rho: torch.Tensor         # int64
    borrow_delta: torch.Tensor     # int64 outstanding borrow
    borrow_rho: torch.Tensor       # int64
    seen: torch.Tensor             # bool


def init_borrow_tracker(n_clients: int, *, n_servers: Optional[int] = None,
                        device: str | torch.device = DEFAULT_DEVICE
                        ) -> BorrowTrackerState:
    dev = resolve_device(device)
    shape = _shape(n_clients, n_servers)

    def z():
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    return BorrowTrackerState(
        completed_delta=z(), completed_rho=z(),
        prev_delta=z(), prev_rho=z(),
        borrow_delta=z(), borrow_rho=z(),
        seen=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


def borrow_tracker_track(tracker: BorrowTrackerState, slots, costs,
                         phases, served) -> BorrowTrackerState:
    """Fold a batch of completions (reference
    BorrowingTracker::resp_update, dmclock_client.h:131-141: only the
    global counters move -- the reduction's source here).  The fold is
    the same scatter-add as OrigTracker's."""
    return tracker_track(tracker, slots, costs, phases, served)


def _calc_with_borrow(global_c, prev, borrow):
    """Vector form of calc_with_borrow (dmclock_client.h:110-129)."""
    result = global_c - prev
    out = torch.where(result == 0, 1,
                      torch.where(result > borrow, result - borrow, 1))
    new_borrow = torch.where(result == 0, borrow + 1,
                             torch.where(result > borrow, 0,
                                         borrow - result + 1))
    return out, new_borrow


def borrow_tracker_prepare(tracker: BorrowTrackerState, requesting,
                           global_delta, global_rho):
    """ReqParams for every client in ``requesting`` sending its next
    request to this server (reference prepare_req,
    dmclock_client.h:131-137; first contact returns ReqParams(1,1) and
    installs the marks, :241-251)."""
    d_out, nbd = _calc_with_borrow(global_delta, tracker.prev_delta,
                                   tracker.borrow_delta)
    r_out, nbr = _calc_with_borrow(global_rho, tracker.prev_rho,
                                   tracker.borrow_rho)
    d_out = torch.where(tracker.seen, d_out, 1)
    r_out = torch.where(tracker.seen, r_out, 1)
    upd = requesting
    first = upd & ~tracker.seen
    tracker = tracker._replace(
        prev_delta=torch.where(upd, global_delta, tracker.prev_delta),
        prev_rho=torch.where(upd, global_rho, tracker.prev_rho),
        borrow_delta=torch.where(first, 0,
                                 torch.where(upd, nbd,
                                             tracker.borrow_delta)),
        borrow_rho=torch.where(first, 0,
                               torch.where(upd, nbr, tracker.borrow_rho)),
        seen=tracker.seen | requesting,
    )
    return tracker, d_out, r_out
