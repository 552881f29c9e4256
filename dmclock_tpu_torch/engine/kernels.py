"""dmClock tag algebra and the exact serial engine, on tensors.

Counterpart of ``dmclock_tpu/engine/kernels.py`` (tag algebra and
``engine_step``/``engine_run``):

- ``_make_tag``   = RequestTag recurrence / ``tag_calc``
                    (dmclock_server.h:145-183, :246-259)
- ``engine_step`` = ``do_next_request`` (:1115-1186) +
                    ``pop_process_request``/``update_next_tag``
                    (:1021-1073) + ``reduce_reservation_tags``
                    (:1077-1111): the three heap tops are masked
                    lexicographic argmins over (tag, creation order).
- ``engine_run``  = ``steps`` decisions; the JAX ``lax.scan`` is a
                    Python loop here.
- ``rebase32``/``restore64``: the int32 epoch tag rebase of the
  ``tag_width=32`` carry;
- ``radix_kth_key``/``radix_quantile_ladder``: exact order statistics
  of an int64 key vector (one sort and one gather);
- the timer-wheel primitives (``wheel_slot``, ``wheel_scatter``,
  ``wheel_nearest``) and ``wheel_scan``, the wrapper of kernel K2
  (``csrc/wheel_scan.cu``);
- ``ingest`` (``IngestOps`` rows of creates and adds in one
  fixed-shape dense pass) and ``ingest_scan``, the wrapper of kernel K3
  (``csrc/ingest_scan.cu``, its reactivation recurrence),
  ``ingest_wave`` (one arrival per client) and ``ingest_superwave`` (W
  waves in one ring pass);
- ``mark_idle``/``deactivate``, the queue's GC scatters.

All arithmetic is int64 ns.  The serial engine is the exactness
reference the prefix-commit fast path is held against.  Scalars stay
0-d device tensors (reads and writes at the winner go through
``index_select``/``index_copy``), so no step waits on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.timebase import (LOWEST_PROP_TAG_TRIGGER, MAX_CHARGE_UNITS,
                             MAX_TAG, MIN_TAG, ORGANIC_TAG_CAP, TIME_MAX)
from ..obs import compile_plane
from ..obs import device as obsdev
from . import _ext
from .state import EngineState

# Masking sentinel for argmin keys: strictly above every legal key.
KEY_INF = (1 << 63) - 1

# Decision type codes (== core.scheduler.NextReqType values)
RETURNING = 0
FUTURE = 1
NONE = 2


class Decision(NamedTuple):
    """One scheduling decision (or a stack of them)."""

    type: torch.Tensor         # int32: RETURNING/FUTURE/NONE
    slot: torch.Tensor         # int32: winning client slot (-1 if none)
    phase: torch.Tensor        # int32: 0 reservation, 1 priority
    cost: torch.Tensor         # int64: served request cost
    when: torch.Tensor         # int64: FUTURE wake-up time (ns)
    limit_break: torch.Tensor  # bool: served via AtLimit::Allow


def as_scalar(now, device: torch.device) -> torch.Tensor:
    """``now`` (int or tensor) as a 0-d int64 tensor on ``device``; an
    int is written with a fill, not copied from the host."""
    if torch.is_tensor(now):
        return now.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(now), dtype=torch.int64, device=device)


# ----------------------------------------------------------------------
# tag algebra
# ----------------------------------------------------------------------

def _tag_axis(time_ns, prev, inv, dist, extreme_is_high: bool, cost):
    """One tag axis (reference tag_calc, dmclock_server.h:246-259)."""
    units = torch.clamp(dist + cost, max=MAX_CHARGE_UNITS)
    organic = torch.clamp(torch.maximum(time_ns, prev + inv * units),
                          max=ORGANIC_TAG_CAP)
    sentinel = MAX_TAG if extreme_is_high else MIN_TAG
    return torch.where(inv == 0, sentinel, organic)


def _make_tag(prev_r, prev_p, prev_l, prev_arrival,
              r_inv, w_inv, l_inv, delta, rho, time_ns, cost,
              anticipation_ns: int):
    """The RequestTag recurrence (reference :145-183): reservation uses
    rho, proportion/limit use delta; anticipation backdates arrivals
    within the window of the previous arrival (:159-161)."""
    backdate = (time_ns - anticipation_ns) < prev_arrival
    max_time = torch.where(backdate, time_ns - anticipation_ns, time_ns)
    r = _tag_axis(max_time, prev_r, r_inv, rho, True, cost)
    p = _tag_axis(max_time, prev_p, w_inv, delta, True, cost)
    l = _tag_axis(max_time, prev_l, l_inv, delta, False, cost)
    return r, p, l


def _fold_prev(prev, tag):
    """prev_tag update skips pinned sentinels (reference :399-412)."""
    pinned = (tag == MAX_TAG) | (tag == MIN_TAG)
    return torch.where(pinned, prev, tag)


def _min_not_0(current, possible):
    """min where 0 means "no time" (reference :1192-1195)."""
    return torch.where(possible == 0, current,
                       torch.minimum(current, possible))


# ----------------------------------------------------------------------
# int32 epoch tag rebase
# ----------------------------------------------------------------------
#
# Within one epoch the organic values of each tag field move a few ms
# of virtual time, so they fit an int32 offset from a per-field origin.
# Sentinels (MAX_TAG/MIN_TAG) map to reserved int32 codes; an organic
# value outside the window fails the check and the conversion must be
# discarded.

I32_MAX_TAG = (1 << 31) - 1     # reserved code for MAX_TAG
I32_MIN_TAG = -(1 << 31)        # reserved code for MIN_TAG
# organic window: strictly inside the reserved codes, with a margin so
# clamped garbage never aliases a sentinel
_I32_WINDOW = (1 << 31) - 8


def rebase32(vals, origin):
    """Rebase int64 tags to int32 around ``origin`` (a 0-d tensor or an
    int).  Returns ``(vals32, ok)`` with ``ok`` a 0-d bool tensor, False
    when any organic value lies outside +-(2^31 - 8) of ``origin``."""
    is_max = vals == MAX_TAG
    is_min = vals == MIN_TAG
    rel = vals - origin
    in_win = (rel > -_I32_WINDOW) & (rel < _I32_WINDOW)
    ok = torch.all(is_max | is_min | in_win)
    v32 = torch.where(is_max, I32_MAX_TAG,
                      torch.where(is_min, I32_MIN_TAG,
                                  torch.clamp(rel, -_I32_WINDOW,
                                              _I32_WINDOW)))
    return v32.to(torch.int32), ok


def restore64(vals32, origin):
    """Exact inverse of :func:`rebase32` for in-window conversions."""
    v = vals32.to(torch.int64)
    return torch.where(vals32 == I32_MAX_TAG, MAX_TAG,
                       torch.where(vals32 == I32_MIN_TAG, MIN_TAG,
                                   v + origin))


# ----------------------------------------------------------------------
# order statistics of a key vector
# ----------------------------------------------------------------------
#
# The JAX package finds the kk-th smallest int64 key without a sort (16
# rounds of 4-bit dense histograms, masked reductions only).  Here one
# sort (a radix sort on the card) and one gather give the same exact
# values, every rank at once, in two calls instead of about a hundred
# small ones; the ranks stay on the device.


def radix_kth_key(pk, kk):
    """Exact value of the ``kk``-th smallest element of the int64 vector
    ``pk`` (1-indexed, duplicates counted).  ``kk`` is an int or an
    integer tensor of any shape, one rank per element; ranks outside
    [1, N] clamp to it.  Returns int64 of ``kk``'s shape."""
    ranks = torch.as_tensor(kk, device=pk.device).to(torch.int64)
    return torch.sort(pk).values[torch.clamp(ranks - 1, 0,
                                             pk.shape[0] - 1)]


def radix_quantile_ladder(pk, levels: int):
    """CDF quantile ladder of the finite entries of ``pk``: boundary i
    (1-indexed) is the ``ceil(i * C / levels)``-th smallest key, C the
    count of entries below KEY_INF.  Returns a nondecreasing
    int64[levels] (all KEY_INF when nothing is finite)."""
    fin = torch.sum(pk < KEY_INF, dtype=torch.int32)
    lv = torch.arange(1, levels + 1, dtype=torch.int32, device=pk.device)
    ranks = torch.clamp((lv * fin + levels - 1) // levels, min=1)
    return radix_kth_key(pk, ranks)


# ----------------------------------------------------------------------
# timer wheel (kernel K2)
# ----------------------------------------------------------------------
#
# Keys scatter into a fixed grid of buckets (count + exact per-bucket
# minimum); the nearest deadline is the first occupied bucket's stored
# minimum.  ``wheel_slot`` is monotone nondecreasing in the key for any
# origin and shift (out-of-span keys clamp to the edge buckets), so the
# first occupied bucket holds the global masked minimum, and its stored
# min -- a scatter-min of the actual keys -- IS that minimum, bit for
# bit.  Geometry only decides how many keys share a bucket.

# the kernel's cap: 12 bytes of shared memory per bucket per block, and
# the size of its per-device workspace
WHEEL_MAX_BUCKETS = 2048


def wheel_slot(key, origin, shift: int, nb: int):
    """Bucket index of ``key`` on a wheel of ``nb`` buckets of width
    ``2**shift`` ns starting at ``origin``; out-of-span keys clamp to
    the edge buckets."""
    return torch.clamp((key - origin) >> shift, 0, nb - 1).to(torch.int32)


def wheel_scatter(keys, slot, nb: int):
    """Per-bucket occupancy count and exact minimum key of ``keys``
    scattered by ``slot`` (int32, in ``[0, nb]``); ``slot == nb`` masks
    a lane out: both scatters write ``nb + 1`` buckets and the last is
    cut off.  Returns ``(cnt int32[nb], bmin int64[nb])``, KEY_INF in
    empty buckets."""
    idx = slot.to(torch.int64)
    cnt = torch.zeros((nb + 1,), dtype=torch.int32, device=keys.device)
    cnt.index_add_(0, idx, torch.ones_like(slot))
    bmin = torch.full((nb + 1,), KEY_INF, dtype=torch.int64,
                      device=keys.device)
    bmin.scatter_reduce_(0, idx, keys, "amin")
    return cnt[:nb], bmin[:nb]


def wheel_nearest(cnt, bmin):
    """The first occupied bucket along the last axis and its stored
    minimum: ``(val, b0, found)`` with ``val = KEY_INF`` and ``b0 = nb``
    where every bucket is empty.  The JAX package finds the bucket by a
    grouped occupancy scan and a dynamic slice; here it is the minimum
    of the occupied bucket indices, the same number, with no read back
    to the host."""
    nb = cnt.shape[-1]
    idx = torch.arange(nb, dtype=torch.int32, device=cnt.device)
    b0 = torch.min(torch.where(cnt > 0, idx, nb), dim=-1).values
    found = b0 < nb
    at = torch.clamp(b0, max=nb - 1).to(torch.int64).unsqueeze(-1)
    val = torch.where(found, torch.gather(bmin, -1, at).squeeze(-1),
                      KEY_INF)
    return val, b0, found


def _wheel_scan_torch(keys, slot, nb: int):
    """Plain version of K2: ``wheel_scatter`` then ``wheel_nearest``."""
    cnt, bmin = wheel_scatter(keys, slot, nb)
    val, _b0, found = wheel_nearest(cnt, bmin)
    return cnt, bmin, val, found


# K2's merge workspace on each CUDA device (index -> (counts, minima)):
# WHEEL_MAX_BUCKETS + 1 int32 counts, the last word the kernel's block
# ticket, and WHEEL_MAX_BUCKETS int64 minima.  Clean between calls (0,
# KEY_INF, ticket 0): the kernel's last block resets what it used.
_WHEEL_WORKSPACE: dict = {}


def _wheel_workspace(dev: torch.device):
    """K2's workspace on ``dev``, allocated and filled at first use.  A
    first use under CUDA-graph capture raises: the buffer must not come
    from a graph's private pool, which the graph may free."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    ws = _WHEEL_WORKSPACE.get(index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("wheel_scan: the first call on a device "
                               "must come before any CUDA-graph capture")
        dev = torch.device("cuda", index)
        ws = (torch.zeros((WHEEL_MAX_BUCKETS + 1,), dtype=torch.int32,
                          device=dev),
              torch.full((WHEEL_MAX_BUCKETS,), KEY_INF, dtype=torch.int64,
                         device=dev))
        _WHEEL_WORKSPACE[index] = ws
    return ws


def wheel_scan_cost(n: int, nb: int) -> dict:
    """K2's cost at ``n`` lanes and ``nb`` buckets: each key (int64) and
    slot (int32) read once, the counts (int32) and minima (int64) written
    once, with the value (8 bytes) and the flag (1); one op a lane and
    one a bucket.  The bound in ``chip_smoke.py`` and the cost counter
    (``obs/compile_plane.py``) both read it."""
    return {"flops": n + nb, "bytes_accessed": 12 * n + 12 * nb + 9,
            "transcendentals": 0}


def wheel_scan(keys, slot, nb: int):
    """K2's wrapper: scatter int64 ``keys[N]`` by int32 ``slot[N]`` into
    ``nb`` buckets (``slot == nb`` masks a lane out) and find the first
    occupied bucket.  Returns ``(cnt int32[nb], bmin int64[nb], val
    int64, found bool)``, equal to the JAX package's ``wheel_scan``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (building it at first use) or raises -- there is no
    fallback.  Checks dtypes, shapes, contiguity, device and
    ``0 < nb <= WHEEL_MAX_BUCKETS``.

    On the card a call is one launch and nothing else: the kernel merges
    into a per-device workspace that it leaves clean, so calls on one
    device must be ordered on one stream, as the whole port's are.  The
    first call on a device allocates the workspace and must not be
    inside a CUDA-graph capture; later calls may be captured.  Under a
    cost counter the call counts as :func:`wheel_scan_cost`, on either
    device."""
    if keys.dtype != torch.int64 or slot.dtype != torch.int32:
        raise TypeError(f"wheel_scan: keys must be int64 and slot int32, "
                        f"got {keys.dtype}/{slot.dtype}")
    if keys.dim() != 1 or slot.shape != keys.shape:
        raise ValueError(f"wheel_scan: shapes {tuple(keys.shape)}, "
                         f"{tuple(slot.shape)} are not [N], [N]")
    if not 0 < nb <= WHEEL_MAX_BUCKETS:
        raise ValueError(f"wheel_scan: {nb} buckets not in "
                         f"(0, {WHEEL_MAX_BUCKETS}]")
    dev = keys.device
    if slot.device != dev:
        raise ValueError("wheel_scan: tensors on different devices")
    with compile_plane.kernel_region(
            "wheel_scan", lambda: wheel_scan_cost(keys.shape[0], nb)):
        return _wheel_scan_launch(keys, slot, nb, dev)


def _wheel_scan_launch(keys, slot, nb: int, dev):
    if dev.type == "cpu":
        return _wheel_scan_torch(keys, slot, nb)
    if dev.type != "cuda":
        raise ValueError(f"wheel_scan: unsupported device {dev}")
    if not (keys.is_contiguous() and slot.is_contiguous()):
        raise ValueError("wheel_scan: inputs must be contiguous")
    launch = _ext.kernel("wheel_scan")
    ws_cnt, ws_min = _wheel_workspace(dev)
    cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    bmin = torch.empty((nb,), dtype=torch.int64, device=dev)
    val = torch.empty((), dtype=torch.int64, device=dev)
    found = torch.empty((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(keys.data_ptr(), slot.data_ptr(), ws_cnt.data_ptr(),
                     ws_min.data_ptr(), cnt.data_ptr(), bmin.data_ptr(),
                     val.data_ptr(), found.data_ptr(), keys.shape[0], nb,
                     stream)
    if err != 0:
        raise RuntimeError(f"wheel_scan kernel launch failed: CUDA error "
                           f"{err}")
    _ext.LAUNCHES["wheel_scan"] += 1
    return cnt, bmin, val, found


# ----------------------------------------------------------------------
# selection: masked lexicographic argmin = a heap top
# ----------------------------------------------------------------------

def _masked_argmin(mask, key, order):
    """Top of a 'heap' ordered by (mask desc, key asc, order asc).

    Returns (valid, index, min_key) as 0-d tensors; ``index`` is int64
    (a gather index).  ``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does, so creation-order ties resolve identically."""
    k = torch.where(mask, key, KEY_INF)
    min_key = torch.min(k)
    tie = k == min_key
    idx = torch.argmin(torch.where(tie, order, KEY_INF))
    return torch.any(mask), idx, min_key


def _at(arr, w):
    """``arr[w]`` for a 0-d index tensor, as a device gather (indexing
    with a 0-d tensor would read it back to the host)."""
    return arr.index_select(0, w.reshape(1)).reshape(arr.shape[1:])


def _set(arr, w, value):
    """``arr`` with row ``w`` replaced by ``value`` (out of place)."""
    return arr.index_copy(0, w.reshape(1),
                          value.to(arr.dtype).reshape(1))


# ----------------------------------------------------------------------
# one scheduling decision (fused select + pop + retag)
# ----------------------------------------------------------------------

def engine_step(state: EngineState, now, *, allow_limit_break: bool,
                anticipation_ns: int):
    """One ``do_next_request`` + serve.  Mirrors the oracle's decision
    order exactly: reservation phase, ready promotion, weight phase,
    optional Allow limit-break, else future/none (reference
    :1115-1186)."""
    now = as_scalar(now, state.device)
    has_req = state.active & (state.depth > 0)
    eff_prop = state.head_prop + state.prop_delta

    # reservation heap top; constraint phase (:1124-1128)
    resv_valid, resv_idx, resv_min = _masked_argmin(
        has_req, state.head_resv, state.order)
    serve_resv = resv_valid & (resv_min <= now)

    # promote newly within-limit heads to ready (:1135-1144), only when
    # the reservation phase does not serve (the oracle returns first)
    head_ready = torch.where(
        serve_resv, state.head_ready,
        state.head_ready | (has_req & ~state.head_ready &
                            (state.head_limit <= now)))

    # ready heap top; weight phase (:1146-1151)
    ready_mask = has_req & head_ready
    rdy_valid, rdy_idx, _ = _masked_argmin(ready_mask, eff_prop,
                                           state.order)
    serve_ready = (~serve_resv) & rdy_valid & \
        (_at(state.head_prop, rdy_idx) < MAX_TAG)

    # overall ready-heap top (ready before non-ready), for Allow
    nonready_mask = has_req & ~head_ready
    nr_valid, nr_idx, _ = _masked_argmin(nonready_mask, eff_prop,
                                         state.order)
    overall_idx = torch.where(rdy_valid, rdy_idx, nr_idx)
    overall_valid = rdy_valid | nr_valid
    if allow_limit_break:
        undecided = ~serve_resv & ~serve_ready
        lb_ready_ok = overall_valid & \
            (_at(state.head_prop, overall_idx) < MAX_TAG)
        lb_serve_ready = undecided & lb_ready_ok
        lb_serve_resv = undecided & ~lb_ready_ok & resv_valid & \
            (resv_min < MAX_TAG)
    else:
        lb_serve_ready = torch.zeros_like(serve_resv)
        lb_serve_resv = torch.zeros_like(serve_resv)

    # nothing eligible: earliest future time (:1170-1185); the limit
    # heap top orders non-ready before ready
    l_nr_valid, l_nr_idx, _ = _masked_argmin(
        nonready_mask, state.head_limit, state.order)
    l_r_valid, l_r_idx, _ = _masked_argmin(
        ready_mask, state.head_limit, state.order)
    lim_idx = torch.where(l_nr_valid, l_nr_idx, l_r_idx)
    lim_valid = l_nr_valid | l_r_valid
    next_call = torch.full_like(now, TIME_MAX)
    next_call = torch.where(resv_valid, _min_not_0(next_call, resv_min),
                            next_call)
    next_call = torch.where(
        lim_valid, _min_not_0(next_call, _at(state.head_limit, lim_idx)),
        next_call)

    serving = serve_resv | serve_ready | lb_serve_ready | lb_serve_resv
    phase_is_ready = serve_ready | lb_serve_ready
    w = torch.where(serve_resv | lb_serve_resv, resv_idx, overall_idx)
    limit_break = lb_serve_ready | lb_serve_resv

    # serve winner w (pop_process_request :1046-1073 + update_next_tag
    # :1021-1036 + reduce_reservation_tags :1077-1111)
    served_r = _at(state.head_resv, w)
    served_p = _at(state.head_prop, w)
    served_l = _at(state.head_limit, w)
    served_arr = _at(state.head_arrival, w)
    served_cost = _at(state.head_cost, w)
    served_rho = _at(state.head_rho, w)

    new_depth = _at(state.depth, w) - 1
    has_more = new_depth > 0

    # pop the oldest tail element as the new head
    rq = _at(state.q_head, w)
    flat = w * state.ring_capacity + rq.to(torch.int64)
    narr = _at(state.q_arrival.reshape(-1), flat)
    ncost = _at(state.q_cost.reshape(-1), flat)

    resv_inv_w = _at(state.resv_inv, w)
    cur_rho_w = _at(state.cur_rho, w)
    nr_tag, np_tag, nl_tag = _make_tag(
        served_r, served_p, served_l, served_arr,
        resv_inv_w, _at(state.weight_inv, w), _at(state.limit_inv, w),
        _at(state.cur_delta, w), cur_rho_w, narr, ncost,
        anticipation_ns)

    # weight-phase service pays reservation debt (:1077-1111)
    offset = torch.where(phase_is_ready,
                         resv_inv_w * (served_cost + served_rho),
                         torch.zeros_like(served_cost))

    # prev_tag folds in the new head tag, then the reservation offset
    prev_r_w = _at(state.prev_resv, w)
    prev_p_w = _at(state.prev_prop, w)
    prev_l_w = _at(state.prev_limit, w)
    new_prev_r = torch.where(has_more, _fold_prev(prev_r_w, nr_tag),
                             prev_r_w) - offset
    new_prev_p = torch.where(has_more, _fold_prev(prev_p_w, np_tag),
                             prev_p_w)
    new_prev_l = torch.where(has_more, _fold_prev(prev_l_w, nl_tag),
                             prev_l_w)
    new_prev_arr = torch.where(has_more, narr,
                               _at(state.prev_arrival, w))

    def upd(arr, value, pred):
        return _set(arr, w, torch.where(serving & pred,
                                        value.to(arr.dtype), _at(arr, w)))

    true1 = torch.ones_like(serving)
    state = state._replace(
        depth=upd(state.depth, new_depth, true1),
        q_head=upd(state.q_head, (rq + 1) % state.ring_capacity,
                   has_more),
        head_resv=upd(state.head_resv, nr_tag - offset, has_more),
        head_prop=upd(state.head_prop, np_tag, has_more),
        head_limit=upd(state.head_limit, nl_tag, has_more),
        head_arrival=upd(state.head_arrival, narr, has_more),
        head_cost=upd(state.head_cost, ncost, has_more),
        head_rho=upd(state.head_rho, cur_rho_w, has_more),
        head_ready=_set(head_ready, w, torch.where(
            serving, torch.zeros_like(serving), _at(head_ready, w))),
        prev_resv=upd(state.prev_resv, new_prev_r, true1),
        prev_prop=upd(state.prev_prop, new_prev_p, true1),
        prev_limit=upd(state.prev_limit, new_prev_l, true1),
        prev_arrival=upd(state.prev_arrival, new_prev_arr, true1),
    )

    decision = Decision(
        type=torch.where(serving, RETURNING,
                         torch.where(next_call < TIME_MAX, FUTURE, NONE)
                         ).to(torch.int32),
        slot=torch.where(serving, w, -1).to(torch.int32),
        phase=phase_is_ready.to(torch.int32),
        cost=torch.where(serving, served_cost, 0),
        when=next_call,
        limit_break=limit_break,
    )
    return state, decision


def _tag_horizon(st: EngineState, t):
    """The earliest reservation or non-ready limit tag strictly past
    ``t`` among the queued heads (TIME_MAX when there is none)."""
    has_req = st.active & (st.depth > 0)
    hr = torch.min(torch.where(has_req & (st.head_resv > t),
                               st.head_resv, TIME_MAX))
    nonready = has_req & ~st.head_ready & (st.head_limit > t)
    hl = torch.min(torch.where(nonready, st.head_limit, TIME_MAX))
    return torch.minimum(hr, hl)


def engine_run(state: EngineState, now, steps: int, *,
               allow_limit_break: bool, anticipation_ns: int,
               advance_now: bool = False, with_horizon: bool = False,
               with_metrics: bool = False):
    """``steps`` scheduling decisions.

    With a fixed ``now`` this equals ``steps`` successive pulls at the
    same instant.  With ``advance_now`` the virtual clock jumps to each
    FUTURE's wake-up time (an infinitely fast server).  Returns
    ``(state, now, decisions)`` with ``decisions`` a ``Decision`` of
    ``[steps]`` tensors.

    ``with_horizon`` appends the earliest reservation or non-ready
    limit tag strictly past ``now`` in any intermediate state of the run
    (a 0-d int64 tensor): decisions depend on ``now`` only through the
    tests ``resv <= now`` and ``limit <= now``, so pulls at any t in
    [now, horizon) would make this same sequence.  ``with_metrics``
    appends the ``obs.device`` metrics vector.  Neither touches the
    decision stream or the state."""
    dev = state.device
    t = as_scalar(now, dev)
    met = obsdev.metrics_zero(dev)
    h = _tag_horizon(state, t) if with_horizon else None
    decs = []
    for _ in range(steps):
        state, dec = engine_step(state, t,
                                 allow_limit_break=allow_limit_break,
                                 anticipation_ns=anticipation_ns)
        if with_horizon:
            # the served client's fresh head tags are the only tags not
            # in the previous state; fold them in (a 0-d gather index)
            w = torch.clamp(dec.slot, min=0).to(torch.int64)
            nr = _at(state.head_resv, w)
            nl = _at(state.head_limit, w)
            served = dec.slot >= 0
            h = torch.where(served & (nr > t), torch.minimum(h, nr), h)
            h = torch.where(served & ~_at(state.head_ready, w) & (nl > t),
                            torch.minimum(h, nl), h)
        if with_metrics:
            served1 = (dec.type == RETURNING).to(torch.int64)
            is_resv = served1 * (dec.phase == 0)
            met = obsdev.metrics_combine(met, obsdev.metrics_delta(
                device=dev, decisions=served1, resv=is_resv,
                prop=served1 - is_resv,
                limit_break=dec.limit_break.to(torch.int64),
                stalls=(dec.type == FUTURE).to(torch.int64),
                ring_hwm=torch.max(state.depth).to(torch.int64)))
        if advance_now:
            t = torch.where(dec.type == FUTURE, dec.when, t)
        decs.append(dec)
    if decs:
        decisions = Decision(*(torch.stack(col) for col in zip(*decs)))
    else:
        decisions = Decision(
            *(torch.zeros((0,), dtype=d, device=dev) for d in
              (torch.int32, torch.int32, torch.int32, torch.int64,
               torch.int64, torch.bool)))
    out = (state, t, decisions)
    if with_horizon:
        out = out + (h,)
    if with_metrics:
        out = out + (met,)
    return out


# serial steps a captured block holds (``serial_program``): one
# ``engine_step`` is about 240 launches, so a block stays near 15,000
# graph nodes
SERIAL_BLOCK = 64


def _serial_block(carry, t, *, steps: int, allow_limit_break: bool,
                  anticipation_ns: int, advance_now: bool,
                  with_horizon: bool, with_metrics: bool):
    """``engine_run`` of ``steps`` on the carry ``(state, horizon,
    metrics)``: the block's horizon folds into the carried minimum and
    its metrics vector into the carried one (counters add, high-water
    rows max), so a chain of blocks gives one run's.  The horizon
    composes because every tag past ``t`` in a block's first state was
    already folded by the block before it."""
    st, h, met = carry
    out = engine_run(st, t, steps, allow_limit_break=allow_limit_break,
                     anticipation_ns=anticipation_ns,
                     advance_now=advance_now, with_horizon=with_horizon,
                     with_metrics=with_metrics)
    st, t, dec = out[:3]
    rest = list(out[3:])
    if with_horizon:
        h = torch.minimum(h, rest.pop(0))
    if with_metrics:
        met = obsdev.metrics_combine(met, rest.pop(0))
    return (st, h, met), t, dec


def serial_program(steps: int, *, allow_limit_break: bool,
                   anticipation_ns: int, cache: str, entry,
                   advance_now: bool = False, with_horizon: bool = False,
                   with_metrics: bool = False, record: bool = True):
    """``engine_run(state, now, steps, ...)`` as a captured program
    (``obs/compile_plane.py`` ``SerialJit``): blocks of
    :data:`SERIAL_BLOCK` steps and a remainder, ``(state, now) ->``
    ``engine_run``'s tuple, the decision stream, the clock, the horizon
    and the metrics equal to one ``engine_run``'s for any ``steps``.
    With ``advance_now`` the clock each block returns starts the next;
    the horizon is carried as a minimum and the metrics vector as a
    running merge from one block to the next.  The JAX package's serial
    programs run the step under ``lax.scan``, one small program; here it
    is a loop, so one graph of every step would grow with ``steps``."""
    kw = dict(allow_limit_break=allow_limit_break,
              anticipation_ns=anticipation_ns, advance_now=advance_now)
    if not (with_horizon or with_metrics):
        def body(n: int):
            return functools.partial(engine_run, steps=n, **kw)

        return compile_plane.SerialJit(body, steps=steps,
                                       block=SERIAL_BLOCK, cache=cache,
                                       entry=entry, record=record)

    def body(n: int):
        return functools.partial(_serial_block, steps=n,
                                 with_horizon=with_horizon,
                                 with_metrics=with_metrics, **kw)

    def start(st, t):
        dev = st.device
        return (st, torch.full((), TIME_MAX, dtype=torch.int64, device=dev)
                if with_horizon else None,
                obsdev.metrics_zero(dev) if with_metrics else None)

    def finish(carry, t, dec):
        st, h, met = carry
        return (st, t, dec) + ((h,) if with_horizon else ()) + \
            ((met,) if with_metrics else ())

    return compile_plane.SerialJit(body, steps=steps, block=SERIAL_BLOCK,
                                   cache=cache, entry=entry, record=record,
                                   start=start, finish=finish)


# the serial legs of the staged programs (``serial_leg``), by
# configuration
_SERIAL_LEGS: dict = {}


def serial_leg(steps: int, *, allow_limit_break: bool, anticipation_ns: int,
               advance_now: bool = False, with_horizon: bool = False,
               with_metrics: bool = False):
    """The serial program a staged program (``compile_plane.StagedJit``)
    runs ``engine_run`` through: one ``serial_program`` of each
    configuration outside the plane's records (cache ``serial.leg``),
    shared by every entry, queue and server that runs it, so the 8 or
    100 queues of a simulation and the servers of a cluster replay one
    capture a shape.  ``steps=0`` is ``engine_run`` itself (nothing to
    capture)."""
    key = (int(steps), bool(allow_limit_break), int(anticipation_ns),
           bool(advance_now), bool(with_horizon), bool(with_metrics))
    if key not in _SERIAL_LEGS:
        kw = dict(allow_limit_break=key[1], anticipation_ns=key[2],
                  advance_now=key[3], with_horizon=key[4],
                  with_metrics=key[5])
        _SERIAL_LEGS[key] = serial_program(
            key[0], cache="serial.leg", entry=key, record=False, **kw) \
            if key[0] else functools.partial(engine_run, steps=0, **kw)
    return _SERIAL_LEGS[key]


# ----------------------------------------------------------------------
# ingest
# ----------------------------------------------------------------------

def ingest_superwave(state: EngineState, counts, wave_times, cost, rho,
                     delta, *, anticipation_ns: int) -> EngineState:
    """W consecutive ingest waves fused into ONE ring pass (reference
    ``add_request``, dmclock_server.h:913-1018, once per arrival).

    Client ``i`` receives ``counts[i]`` (int32, ``0 <= counts <= W``)
    arrivals at times ``wave_times[0 .. counts[i]-1]`` (int64[W],
    ascending), each with the client's ``cost``/``rho``/``delta``
    (int64[N]).  Equal to W sequential single-arrival waves with
    ``requesting_w = counts > w``: idle reactivation can fire only at
    wave 0, against the pre-superwave state (the batch-synchronous
    semantics of the JAX package's ``ingest_wave``), the wave-0 arrival
    becomes the head of an empty queue, and the rest land in
    consecutive ring slots.

    Caller contract: ``depth + counts <= ring capacity``."""
    st = state
    n = st.capacity
    q = st.ring_capacity
    w_waves = wave_times.shape[0]
    requesting = counts > 0
    t0 = wave_times[0].expand(n)

    # idle reactivation at wave 0, against the pre-superwave state
    others = st.active & ~st.idle
    eff = torch.where(st.depth > 0, st.head_prop, st.prev_prop) \
        + st.prop_delta
    lowest = torch.min(torch.where(others, eff, KEY_INF))
    do_shift = requesting & st.idle & torch.any(others) & \
        (lowest < LOWEST_PROP_TAG_TRIGGER)
    prop_delta = torch.where(do_shift, lowest - t0, st.prop_delta)
    idle = st.idle & ~requesting

    # the wave-0 arrival becomes the head of an empty queue
    empty = st.depth == 0
    tag_it = requesting & empty
    r, p, l = _make_tag(
        st.prev_resv, st.prev_prop, st.prev_limit, st.prev_arrival,
        st.resv_inv, st.weight_inv, st.limit_inv,
        delta, rho, t0, cost, anticipation_ns)

    def hset(new, old, pred=tag_it):
        return torch.where(pred, new, old)

    # ring multi-append: arrivals h .. counts-1 land at consecutive ring
    # positions from base (h = 1 when the head took wave 0).  For ring
    # column c the wave index is (c - base) mod Q + h, written when
    # below counts.  base is floor-mod: q_head + depth + h - 1 is -1 for
    # an empty client that receives nothing.
    h = tag_it.to(torch.int32)
    ring_count = torch.clamp(counts.to(torch.int32) - h, min=0)
    base = torch.remainder(st.q_head + st.depth + h - 1, q)
    col = torch.arange(q, dtype=torch.int32, device=st.device)
    jrel = torch.remainder(col[None, :] - base[:, None], q)
    writem = jrel < ring_count[:, None]
    widx = jrel + h[:, None]
    # one gather in place of the JAX package's W-1 unrolled selects:
    # under ``writem`` the wave index is below counts <= W, so the
    # clamp changes only lanes the mask discards
    val = wave_times[torch.clamp(widx, max=w_waves - 1).to(torch.int64)]
    q_arrival = torch.where(writem, val, st.q_arrival)
    q_cost = torch.where(writem, cost[:, None], st.q_cost)

    return st._replace(
        idle=idle,
        prop_delta=prop_delta,
        head_resv=hset(r, st.head_resv),
        head_prop=hset(p, st.head_prop),
        head_limit=hset(l, st.head_limit),
        head_arrival=hset(t0, st.head_arrival),
        head_cost=hset(cost, st.head_cost),
        head_rho=hset(rho, st.head_rho),
        head_ready=st.head_ready & ~tag_it,
        prev_resv=hset(_fold_prev(st.prev_resv, r), st.prev_resv),
        prev_prop=hset(_fold_prev(st.prev_prop, p), st.prev_prop),
        prev_limit=hset(_fold_prev(st.prev_limit, l), st.prev_limit),
        prev_arrival=hset(t0, st.prev_arrival),
        q_arrival=q_arrival,
        q_cost=q_cost,
        depth=(st.depth + counts.to(torch.int32)),
        cur_rho=hset(rho, st.cur_rho, requesting),
        cur_delta=hset(delta, st.cur_delta, requesting),
    )


# ----------------------------------------------------------------------
# ingest: batched add_request (+ client creation)
# ----------------------------------------------------------------------

OP_NOP = 0
OP_ADD = 1
OP_CREATE = 2


class IngestOps(NamedTuple):
    """A batch of queue mutations, one row per op, applied in row order.
    Every field is a 1-d numpy array or tensor of the batch length."""

    kind: object        # OP_NOP / OP_ADD / OP_CREATE
    slot: object
    time: object        # arrival ns (ADD)
    cost: object
    rho: object
    delta: object
    resv_inv: object    # ns per unit cost (CREATE)
    weight_inv: object
    limit_inv: object
    order: object       # creation index (CREATE)


def _wrap64(x: int) -> int:
    """A Python int reduced to int64, wrapping as the device does."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def ingest_segments(kind: np.ndarray, slot: np.ndarray) -> list:
    """A host count of a batch's segments (the queue's
    ``ingest_segments`` counter; :func:`ingest` needs none of it): row
    ranges ``[lo, hi)`` within which every slot has at most one CREATE,
    ahead of its other rows, so a new segment starts at a CREATE whose
    slot already has a row in the current one (a slot re-created in the
    same batch).  NOP rows are skipped; an all-NOP batch has no
    segment."""
    live = np.flatnonzero(kind != OP_NOP)
    if live.size == 0:
        return []
    _, first = np.unique(slot[live], return_index=True)
    repeat = np.ones(live.size, dtype=bool)
    repeat[first] = False
    if not np.any(repeat & (kind[live] == OP_CREATE)):
        return [(0, len(kind))]
    segs, lo, seen = [], 0, set()
    for i in live.tolist():
        s = int(slot[i])
        if kind[i] == OP_CREATE and s in seen:
            segs.append((lo, i))
            lo, seen = i, set()
        seen.add(s)
    segs.append((lo, len(kind)))
    return segs


def upload_ops(rows: np.ndarray, device) -> torch.Tensor:
    """A packed int64 ``[10, B]`` op batch (``IngestOps`` rows in field
    order) as one device tensor, copied once: a program's input, as the
    JAX package's packed upload is."""
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)) \
        .to(device)


def ingest(state: EngineState, ops, *, anticipation_ns: int
           ) -> EngineState:
    """Apply a batch of creates and adds in row order, equal to the JAX
    package's ``ingest`` scan (the oracle's ``_do_add_request`` per row,
    reference :913-1018) bit for bit, as one fixed-shape device pass
    (:func:`_ingest_dense`): every intermediate is sized by the batch,
    the capacity or the ring and masked, nothing is read back, so the
    pass can be captured whole, and one pass takes any batch, slots
    re-created in it included.

    ``ops``: a packed int64 ``[10, B]`` tensor (:func:`upload_ops`) or an
    ``IngestOps`` of tensors or numpy arrays (uploaded in one copy; a
    host batch of NOP rows only returns ``state`` itself).  Caller
    contract, as for the other ingest paths: no queue grows past the
    ring capacity.  Out of place: ``state`` is
    never written."""
    dev = state.device
    if not torch.is_tensor(ops):
        if any(torch.is_tensor(c) for c in ops):
            ops = torch.stack([torch.as_tensor(c).to(
                device=dev, dtype=torch.int64).reshape(-1) for c in ops])
        else:
            rows = np.stack([np.asarray(c, dtype=np.int64).reshape(-1)
                             for c in ops])
            if not np.any(rows[0] != OP_NOP):
                return state
            ops = torch.from_numpy(rows).to(dev)
    return _ingest_dense(state, ops.to(device=dev, dtype=torch.int64),
                         anticipation_ns)


def _rev_cummin(x):
    """The minimum of ``x[j:]`` at each ``j``."""
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _rev_cummax(x):
    """The maximum of ``x[j:]`` at each ``j``."""
    return torch.flip(torch.cummax(torch.flip(x, (0,)), 0).values, (0,))


def _after(x, fill: int):
    """``x`` shifted one place left: position ``j`` holds ``x[j + 1]``,
    the last ``fill``."""
    return torch.cat([x[1:], x.new_full((1,), fill)])


def _cover_min(lo, hi, val, ok, b: int):
    """For each position ``x`` in ``[0, b)``: the least ``val`` and the
    number of the intervals ``[lo, hi]`` (inclusive, masked by ``ok``,
    non-empty where ``ok``) that hold ``x``.  The minimum is a sparse
    table run backwards: each interval writes its value (a scatter-min,
    so the order of the writes does not matter) at the two blocks of
    ``2^k`` positions that cover it, ``2^k`` the largest power of two
    within its length, and each level then pushes its minima down to
    the two halves of its blocks.  The count is a difference array.
    Returns ``(int64[b] minima, KEY_INF where none; int64[b] counts)``."""
    dev = lo.device
    levels = max(1, b.bit_length())
    length = hi - lo + 1
    k = torch.zeros_like(length)
    for i in range(1, levels):
        k += (length >= (1 << i)).to(torch.int64)
    span = torch.ones_like(k) << k
    scratch = levels * b
    idx = torch.cat([torch.where(ok, k * b + lo, scratch),
                     torch.where(ok, k * b + hi - span + 1, scratch)])
    table = torch.full((scratch + 1,), KEY_INF, dtype=torch.int64,
                       device=dev)
    table.scatter_reduce_(0, idx, torch.cat([val, val]), "amin")
    t = table[:scratch].view(levels, b)
    for lv in range(levels - 1, 0, -1):
        h = 1 << (lv - 1)
        t[lv - 1] = torch.minimum(t[lv - 1], t[lv])
        t[lv - 1, h:] = torch.minimum(t[lv - 1, h:], t[lv, :b - h])
    one = torch.ones_like(lo)
    diff = torch.zeros((b + 2,), dtype=torch.int64, device=dev)
    diff.index_add_(0, torch.where(ok, lo, b + 1), one)
    diff.index_add_(0, torch.where(ok, hi + 1, b + 1), -one)
    return t[0], torch.cumsum(diff[:b], 0)


# the per-slot fields the ingest writes, in the order of its stack
_SLOT_FIELDS = ("active", "idle", "order", "resv_inv", "weight_inv",
                "limit_inv", "prop_delta", "prev_resv", "prev_prop",
                "prev_limit", "prev_arrival", "cur_rho", "cur_delta",
                "head_resv", "head_prop", "head_limit", "head_arrival",
                "head_cost", "head_rho", "head_ready", "depth", "q_head")


def _ingest_dense(st: EngineState, packed: torch.Tensor,
                  anticipation_ns: int) -> EngineState:
    """:func:`ingest` of a packed ``[10, B]`` batch in one pass.

    The rows sort by (slot, row), NOP rows last, so each slot's rows
    are one group in row order.  A CREATE starts an epoch of its slot
    (the rows before the first CREATE are epoch 0, against the entry
    state): it resets the slot's scheduling fields, so only the last
    epoch's rows decide them, and within an epoch the first ADD tags the
    head when the queue is empty and every later ADD appends to the
    ring at ``q_head + depth + rank - 1``.  Ring cells are never reset:
    a push survives unless a later epoch of its slot writes the cell
    again, and every write lands on a distinct cell or a scratch one.
    Each slot's fields are written once, from its group's last lane.

    The scan's coupling across slots is idle reactivation: an ADD to an
    idle client shifts its ``prop_delta`` by the least effective
    proportion tag among the clients scheduling at that row.  A client
    is in that set from its entry state until its first event (a CREATE
    takes it out; the first ADD of an epoch puts it back with its new
    tag, if active), so the set is a family of row intervals.  Those
    whose tag is known without the recurrence (the entry state and the
    first ADDs to clients not idle) reduce by a sparse table
    (:func:`_cover_min`); the reactivating rows' own tags join in row
    order, which kernel K3 (:func:`ingest_scan`) walks."""
    n, q, dev = st.capacity, st.ring_capacity, st.device
    b = packed.shape[1]
    if b == 0:
        return st
    i64 = torch.int64
    pos = torch.arange(b, dtype=i64, device=dev)
    live_r = (packed[0] == OP_ADD) | (packed[0] == OP_CREATE)
    key, row = torch.sort(torch.where(live_r, packed[1], n) * b + pos)
    cols = packed.index_select(1, row)
    kind, time, cost, rho, delta = cols[0], cols[2], cols[3], cols[4], \
        cols[5]
    slot = key // b                      # n on a NOP row
    live = slot < n
    sl = torch.clamp(slot, max=n - 1)    # a gather index
    is_add = live & (kind == OP_ADD)
    is_cr = live & (kind == OP_CREATE)
    first = live & (slot != torch.cat([slot.new_full((1,), -1),
                                       slot[:-1]]))
    last = live & (slot != _after(slot, -1))

    def entry(field):
        return getattr(st, field)[sl]

    # epochs: the start of each row's epoch, created when it is a CREATE
    es = torch.cummax(torch.where(first | is_cr, pos, 0), 0).values
    created = is_cr[es]
    ces = cols.index_select(1, es)       # the epoch's CREATE row
    a_in = torch.cumsum(is_add.to(i64), 0)
    a_ex = a_in - is_add.to(i64)
    rank = a_ex - a_ex[es]               # the ADD's rank in its epoch
    nxt_cr = _after(_rev_cummin(torch.where(is_cr, pos, b)), b)
    grp_last = _rev_cummin(torch.where(last, pos, b))
    ee = torch.clamp(torch.minimum(nxt_cr - 1, grp_last), 0, b - 1)
    cnt = a_in[ee] - a_ex[es]            # ADDs in the row's epoch

    # the epoch's base: a fresh client after a CREATE, else the entry
    def base(field, fresh):
        return torch.where(created, fresh, entry(field))

    depth_e = base("depth", 0).to(i64)
    qh_e = base("q_head", 0).to(i64)
    prev_r, prev_p = base("prev_resv", 0), base("prev_prop", 0)
    prev_l, prev_a = base("prev_limit", 0), base("prev_arrival", 0)
    r_inv = torch.where(created, ces[6], entry("resv_inv"))
    w_inv = torch.where(created, ces[7], entry("weight_inv"))
    l_inv = torch.where(created, ces[8], entry("limit_inv"))
    pd_e = base("prop_delta", 0)
    act_e = created | entry("active")
    idle_e = created | entry("idle")

    # each epoch's first ADD: tagged at the head of an empty queue
    fa = is_add & (rank == 0)
    tag = fa & (depth_e == 0)
    r, p, l = _make_tag(prev_r, prev_p, prev_l, prev_a, r_inv, w_inv,
                        l_inv, delta, rho, time, cost, anticipation_ns)

    # ring: a later epoch of the slot (after a re-CREATE) writes cells
    # [0, its ADDs - 1); the largest such count after each row, within
    # its group (a group's id scales a key that later groups cannot win)
    push = is_add & ((rank > 0) | (depth_e > 0))
    cell = torch.remainder(qh_e + depth_e + rank - 1, q)
    gid = torch.cumsum(first.to(i64), 0) * (q + 2)
    later = _after(_rev_cummax(torch.where(is_cr, cnt, 0) - gid),
                   -(1 << 62)) + gid
    write = push & (cell >= torch.clamp(later - 1, min=0))
    flat = torch.where(write, sl * q + cell, n * q)

    def ring(arr, v):
        pad = torch.cat([arr.reshape(-1), arr.new_zeros((1,))])
        return pad.index_put((flat,), v)[:n * q].reshape(n, q)

    # idle reactivation.  Intervals of rows (lo..hi) in which a client
    # is scheduling with a tag known up front: each client's entry
    # state until its first row, and a first ADD to a client not idle
    # from its row to its slot's next CREATE (the next row of the slot
    # that changes it)
    first_row = torch.full((n + 1,), b, dtype=i64, device=dev).index_put(
        (torch.where(first, sl, n),), row)[:n]
    nxt_in = nxt_cr <= grp_last
    end_row = torch.where(nxt_in, row[torch.clamp(nxt_cr, max=b - 1)], b)
    base_p = torch.where(tag, p, entry("head_prop"))
    eff0 = torch.where(st.depth > 0, st.head_prop, st.prev_prop) \
        + st.prop_delta
    lo = torch.cat([torch.zeros((n,), dtype=i64, device=dev), row + 1])
    hi = torch.cat([first_row - 1, end_row - 1])
    ok = torch.cat([st.active & ~st.idle, fa & ~idle_e & act_e]) & \
        (lo <= hi)
    m_row, c_row = _cover_min(lo, hi, torch.cat([eff0, base_p + pd_e]),
                              ok, b)
    # the reactivating rows in row order, for K3
    react = fa & idle_e
    rflag = torch.zeros((b,), dtype=i64, device=dev).index_put(
        (row,), react.to(i64))
    rcum = torch.cumsum(rflag, 0)
    k_of = torch.clamp(rcum[row] - 1, min=0)
    before = torch.cat([rcum.new_zeros((1,)), rcum])  # react rows < x
    k3 = torch.stack([m_row[row], (c_row[row] > 0).to(i64), base_p, pd_e,
                      act_e.to(i64), time, before[end_row]])
    k3 = torch.zeros((7, b + 1), dtype=i64, device=dev).index_copy(
        1, torch.where(react, k_of, b), k3)[:, :b].contiguous()
    pd_k = ingest_scan(k3, rcum[-1])
    pd_fa = torch.where(react, pd_k[k_of], pd_e)

    # each slot's fields, from its group's last lane (its last epoch);
    # a CREATE leaves the head tag fields as they were, so they come from
    # the slot's last tagging ADD in any epoch
    fa_at = torch.clamp(es + created.to(i64), max=b - 1)
    has_add = cnt > 0
    tag_l = has_add & tag[fa_at]
    last_tag = torch.cummax(torch.where(tag, pos, -1), 0).values
    g_start = torch.cummax(torch.where(first, pos, 0), 0).values
    head_t = last_tag >= g_start
    lt_at = torch.clamp(last_tag, min=0)

    def at_tag(new, old):
        return torch.where(tag_l, new[fa_at], old)

    def head(new, field):
        return torch.where(head_t, new[lt_at], entry(field))

    vals = {
        "active": act_e,
        "idle": idle_e & ~has_add,
        "order": torch.where(created, ces[9], entry("order")),
        "resv_inv": r_inv, "weight_inv": w_inv, "limit_inv": l_inv,
        "prop_delta": torch.where(has_add, pd_fa[fa_at], pd_e),
        "prev_resv": at_tag(_fold_prev(prev_r, r), prev_r),
        "prev_prop": at_tag(_fold_prev(prev_p, p), prev_p),
        "prev_limit": at_tag(_fold_prev(prev_l, l), prev_l),
        "prev_arrival": at_tag(time, prev_a),
        "cur_rho": torch.where(has_add, rho, base("cur_rho", 1)),
        "cur_delta": torch.where(has_add, delta, base("cur_delta", 1)),
        "head_resv": head(r, "head_resv"),
        "head_prop": head(p, "head_prop"),
        "head_limit": head(l, "head_limit"),
        "head_arrival": head(time, "head_arrival"),
        "head_cost": head(cost, "head_cost"),
        "head_rho": head(rho, "head_rho"),
        "head_ready": base("head_ready", False) & ~tag_l,
        "depth": depth_e + cnt,
        "q_head": qh_e,
    }
    old = torch.stack([getattr(st, f).to(i64) for f in _SLOT_FIELDS])
    new = torch.cat([old, old.new_zeros((len(_SLOT_FIELDS), 1))], 1) \
        .index_copy(1, torch.where(last, sl, n),
                    torch.stack([vals[f].to(i64) for f in _SLOT_FIELDS]))
    out = {f: new[i, :n].to(getattr(st, f).dtype)
           for i, f in enumerate(_SLOT_FIELDS)}
    return st._replace(q_arrival=ring(st.q_arrival, time),
                       q_cost=ring(st.q_cost, cost), **out)


# ----------------------------------------------------------------------
# kernel K3: the reactivation recurrence
# ----------------------------------------------------------------------

# K3's rows: the fields of ``ingest_scan``'s input, in order
SCAN_FIELDS = ("m", "any0", "base", "pd0", "act", "t", "end")


def ingest_scan_cost(n: int) -> dict:
    """K3's cost at ``n`` rows: the seven int64 inputs read once and the
    output written once (64 bytes a row), with the count; about six
    integer ops a row.  The bound in ``chip_smoke.py`` and the cost
    counter both read it."""
    return {"flops": 6 * n, "bytes_accessed": 64 * n + 8,
            "transcendentals": 0}


def _ingest_scan_torch(rows, count):
    """Plain version of K3: the same walk in Python over CPU tensors."""
    b = rows.shape[1]
    n = max(0, min(int(count), b))
    out = torch.zeros((b,), dtype=torch.int64)
    low_p, any_p, leaving, res = KEY_INF, False, [], []
    for k, (m, a0, base_p, pd, act, t, end) in enumerate(
            zip(*rows[:, :n].tolist())):
        leaving = [(v, e) for v, e in leaving if e > k]
        low = min([m, low_p] + [v for v, _ in leaving])
        if (a0 or any_p or leaving) and low < LOWEST_PROP_TAG_TRIGGER:
            pd = _wrap64(low - t)
        res.append(pd)
        if act:
            v = _wrap64(base_p + pd)
            if end >= n:
                low_p, any_p = min(low_p, v), True
            elif end > k + 1:
                leaving.append((v, end))
    out[:n] = torch.tensor(res, dtype=torch.int64)
    return out


def ingest_scan(rows, count):
    """K3's wrapper: the idle-reactivation recurrence of
    :func:`_ingest_dense` over ``rows`` (int64 ``[7, B]``, fields
    :data:`SCAN_FIELDS`, one column a reactivating row in row order) for
    the first ``count`` columns (a 0-d int64 tensor on the same device,
    read there).  Returns the int64 ``[B]`` prop_delta of each row
    (those past ``count`` unspecified).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (building it at first use) or raises -- there is no fallback.
    One launch, no read back: the count stays on the device.  Under a
    cost counter the call counts as :func:`ingest_scan_cost` of ``B``."""
    if rows.dtype != torch.int64 or count.dtype != torch.int64:
        raise TypeError(f"ingest_scan: rows and count must be int64, got "
                        f"{rows.dtype}/{count.dtype}")
    if rows.dim() != 2 or rows.shape[0] != len(SCAN_FIELDS) or \
            count.dim() != 0:
        raise ValueError(f"ingest_scan: shapes {tuple(rows.shape)}, "
                         f"{tuple(count.shape)} are not [7, B], []")
    dev = rows.device
    if count.device != dev:
        raise ValueError("ingest_scan: tensors on different devices")
    with compile_plane.kernel_region(
            "ingest_scan", lambda: ingest_scan_cost(rows.shape[1])):
        return _ingest_scan_launch(rows, count, dev)


def _ingest_scan_launch(rows, count, dev):
    if dev.type == "cpu":
        return _ingest_scan_torch(rows, count)
    if dev.type != "cuda":
        raise ValueError(f"ingest_scan: unsupported device {dev}")
    if not rows.is_contiguous():
        raise ValueError("ingest_scan: rows must be contiguous")
    launch = _ext.kernel("ingest_scan")
    b = rows.shape[1]
    out = torch.empty((b,), dtype=torch.int64, device=dev)
    ws = torch.empty((2, max(b, 1)), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(rows.data_ptr(), count.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), b, stream)
    if err != 0:
        raise RuntimeError(f"ingest_scan kernel launch failed: CUDA error "
                           f"{err}")
    _ext.LAUNCHES["ingest_scan"] += 1
    return out


def ingest_wave(state: EngineState, requesting, time_ns, cost, rho,
                delta, *, anticipation_ns: int) -> EngineState:
    """One arrival for each ``requesting`` client (bool[N]), all applied
    in one dense pass (the JAX package's ``ingest_wave``): ``time_ns``
    an int, a 0-d or an int64[N] tensor; ``cost``/``rho``/``delta``
    int64[N].  Idle reactivation reads the pre-wave state for every
    reactivating client (the batch-synchronous model), so it equals the
    sequential ``ingest`` when each wave's reactivator, if any, is its
    lowest slot.  The ring append is a ``where`` over [N, Q]."""
    st = state
    n = st.capacity
    if torch.is_tensor(time_ns) and time_ns.dim() == 1:
        t_arr = time_ns
    else:
        t_arr = as_scalar(time_ns, st.device).expand(n)

    others = st.active & ~st.idle
    eff = torch.where(st.depth > 0, st.head_prop, st.prev_prop) \
        + st.prop_delta
    lowest = torch.min(torch.where(others, eff, KEY_INF))
    do_shift = requesting & st.idle & torch.any(others) & \
        (lowest < LOWEST_PROP_TAG_TRIGGER)
    prop_delta = torch.where(do_shift, lowest - t_arr, st.prop_delta)

    empty = st.depth == 0
    tag_it = requesting & empty
    r, p, l = _make_tag(
        st.prev_resv, st.prev_prop, st.prev_limit, st.prev_arrival,
        st.resv_inv, st.weight_inv, st.limit_inv,
        delta, rho, t_arr, cost, anticipation_ns)

    def hset(new, old, pred=tag_it):
        return torch.where(pred, new, old)

    push_it = requesting & ~empty
    wpos = torch.remainder(st.q_head + st.depth - 1, st.ring_capacity)
    col = torch.arange(st.ring_capacity, dtype=torch.int32,
                       device=st.device)
    write = push_it[:, None] & (col[None, :] == wpos[:, None])
    return st._replace(
        idle=st.idle & ~requesting,
        prop_delta=prop_delta,
        head_resv=hset(r, st.head_resv),
        head_prop=hset(p, st.head_prop),
        head_limit=hset(l, st.head_limit),
        head_arrival=hset(t_arr, st.head_arrival),
        head_cost=hset(cost, st.head_cost),
        head_rho=hset(rho, st.head_rho),
        head_ready=st.head_ready & ~tag_it,
        prev_resv=hset(_fold_prev(st.prev_resv, r), st.prev_resv),
        prev_prop=hset(_fold_prev(st.prev_prop, p), st.prev_prop),
        prev_limit=hset(_fold_prev(st.prev_limit, l), st.prev_limit),
        prev_arrival=hset(t_arr, st.prev_arrival),
        q_arrival=torch.where(write, t_arr[:, None], st.q_arrival),
        q_cost=torch.where(write, cost[:, None], st.q_cost),
        depth=torch.where(requesting, st.depth + 1, st.depth),
        cur_rho=hset(rho, st.cur_rho, requesting),
        cur_delta=hset(delta, st.cur_delta, requesting),
    )


# ----------------------------------------------------------------------
# GC scatters (host-driven do_clean)
# ----------------------------------------------------------------------

def _slot_index(slots, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(slots, dtype=np.int64)
                           if not torch.is_tensor(slots) else slots,
                           device=device).to(torch.int64)


def mark_idle(state: EngineState, slots) -> EngineState:
    """Mark ``slots`` idle (oracle do_clean's idle branch; reference
    :1206-1255).  Out of place."""
    idx = _slot_index(slots, state.device)
    return state._replace(idle=state.idle.index_put(
        (idx,), torch.ones((), dtype=torch.bool, device=state.device)))


def deactivate(state: EngineState, slots) -> EngineState:
    """Erase the clients at ``slots`` (the host recycles the slots).
    Out of place."""
    idx = _slot_index(slots, state.device)
    return state._replace(
        active=state.active.index_put(
            (idx,), torch.zeros((), dtype=torch.bool,
                                device=state.device)),
        depth=state.depth.index_put(
            (idx,), torch.zeros((), dtype=torch.int32,
                                device=state.device)))
