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
- ``ingest`` (``IngestOps`` rows of creates and adds, applied in
  segments of dense passes), ``ingest_wave`` (one arrival per client)
  and ``ingest_superwave`` (W waves in one ring pass);
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


def serial_program(steps: int, *, allow_limit_break: bool,
                   anticipation_ns: int, cache: str, entry):
    """``engine_run(state, now, steps, advance_now=False)`` as a captured
    program (``obs/compile_plane.py`` ``SerialJit``): blocks of
    :data:`SERIAL_BLOCK` steps and a remainder, the decision stream
    equal to ``engine_run``'s.  The JAX package's serial programs run
    the step under ``lax.scan``, one small program; here it is a loop,
    so one graph of every step would grow with ``steps``."""

    def body(n: int):
        return functools.partial(engine_run, steps=n,
                                 allow_limit_break=allow_limit_break,
                                 anticipation_ns=anticipation_ns,
                                 advance_now=False)

    return compile_plane.SerialJit(body, steps=steps, block=SERIAL_BLOCK,
                                   cache=cache, entry=entry)


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
    """Row ranges ``[lo, hi)`` that ``ingest`` applies one dense pass
    each: within a segment every slot has at most one CREATE, ahead of
    its other rows, so a new segment starts at a CREATE whose slot
    already has a row in the current one (a slot re-created in the same
    batch).  NOP rows are skipped; an all-NOP batch has no segment."""
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


def ingest(state: EngineState, ops: IngestOps, *, anticipation_ns: int,
           idle=None) -> EngineState:
    """Apply a batch of creates and adds in row order, equal to the JAX
    package's ``ingest`` scan (the oracle's ``_do_add_request`` per row,
    reference :913-1018) bit for bit.

    The scan's rows are coupled in two ways: several rows may touch one
    slot, and an ADD to an idle slot (idle reactivation, :937-985) reads
    every other client's effective proportion tag at its moment.  Here
    the batch splits on the host into segments (``ingest_segments``),
    each applied as one set of dense passes over the slots it touches:
    the creates scatter first; each slot's first ADD tags an empty head,
    its later ADDs append to consecutive ring positions; depth, idle and
    cur rho/delta are written once per slot.  Tags never depend on
    ``prop_delta``, so only the reactivations remain: their ``lowest``
    is a scalar recurrence along the segment's reactivating rows (each
    one joins the set the next one scans).  The device computes, for
    every reactivating row, the minimum over the clients that were
    already scheduling at segment entry as it stands at that row (prefix
    and suffix minima over the rows that change one of them); the host
    runs the recurrence on those values -- one read back of
    ``[5, reactivations]`` int64 -- and the shifts scatter back.  A
    segment without a reactivation reads nothing back.

    ``ops``: numpy arrays are uploaded in one copy per segment; tensors
    are read to the host first.  ``idle``: an optional host bool[N]
    equal to ``state.idle`` (the caller's mirror); without it ``idle``
    is read back once.  Caller contract, as for the other ingest paths:
    no queue grows past the ring capacity.  Out of place: ``state`` is
    never written."""
    rows = np.stack([(c.detach().cpu().numpy() if torch.is_tensor(c)
                      else np.asarray(c)).astype(np.int64).reshape(-1)
                     for c in ops])
    segs = ingest_segments(rows[0], rows[1])
    if not segs:
        return state
    idle = (state.idle.cpu().numpy() if idle is None
            else np.asarray(idle, dtype=bool)).copy()
    for lo, hi in segs:
        state = _ingest_segment(state, rows[:, lo:hi], idle,
                                anticipation_ns)
    return state


def _ingest_segment(st: EngineState, rows: np.ndarray, idle: np.ndarray,
                    anticipation_ns: int) -> EngineState:
    """One segment of ``ingest``; ``idle`` (host mirror of ``st.idle``)
    is updated in place to the segment's exit value."""
    kind, slot, time, cost, rho, delta, rinv, winv, linv, order = rows
    n, q, dev = st.capacity, st.ring_capacity, st.device

    # host: creates; adds grouped by slot in row order (rank = the add's
    # index among its slot's adds); each slot's first and last add
    cr = np.flatnonzero(kind == OP_CREATE)
    ar = np.flatnonzero(kind == OP_ADD)
    srt = ar[np.argsort(slot[ar], kind="stable")]
    ss = slot[srt]
    starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]]) \
        if srt.size else np.zeros(0, dtype=np.int64)
    count = np.diff(np.r_[starts, srt.size])
    rank = np.arange(srt.size) - np.repeat(starts, count)
    first = srt[starts]
    last = srt[starts + count - 1]
    created = np.zeros(n, dtype=bool)
    created[slot[cr]] = True
    # reactivating rows: first adds to a slot idle at that moment (created
    # in this segment, or idle at entry), in row order
    react = np.flatnonzero(created[slot[first]] | idle[slot[first]])
    react = react[np.argsort(first[react])]
    # rows that may change a scheduling client's effective tag: creates
    # and the first adds of slots not created here, in row order
    keep = ~created[slot[first]]
    cand_rows = np.r_[cr, first[keep]]
    cand_fi = np.r_[np.full(cr.size, -1), np.flatnonzero(keep)]
    co = np.argsort(cand_rows, kind="stable")
    cand_rows, cand_fi = cand_rows[co], cand_fi[co]
    nbefore = np.searchsorted(cand_rows, first[react])

    parts = [slot[cr], order[cr], rinv[cr], winv[cr], linv[cr],
             slot[first], time[first], cost[first], rho[first],
             delta[first], rho[last], delta[last], count,
             ss, rank, time[srt], cost[srt],
             react, nbefore, slot[cand_rows], cand_fi]
    buf = torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(dev)
    (c_slot, c_order, c_r, c_w, c_l, f_slot, f_time, f_cost, f_rho,
     f_delta, l_rho, l_delta, f_count, a_slot, a_rank, a_time, a_cost,
     r_idx, r_nb, k_slot, k_fi) = torch.split(buf, [p.size for p in parts])

    def full(v, dtype):
        return torch.full((), v, dtype=dtype, device=dev)

    st0 = st
    if cr.size:
        def cset(arr, v):
            if not torch.is_tensor(v):
                v = full(v, arr.dtype)
            return arr.index_put((c_slot,), v.to(arr.dtype))

        st = st._replace(
            active=cset(st.active, True), idle=cset(st.idle, True),
            order=cset(st.order, c_order), resv_inv=cset(st.resv_inv, c_r),
            weight_inv=cset(st.weight_inv, c_w),
            limit_inv=cset(st.limit_inv, c_l),
            prop_delta=cset(st.prop_delta, 0),
            prev_resv=cset(st.prev_resv, 0), prev_prop=cset(st.prev_prop, 0),
            prev_limit=cset(st.prev_limit, 0),
            prev_arrival=cset(st.prev_arrival, 0),
            cur_rho=cset(st.cur_rho, 1), cur_delta=cset(st.cur_delta, 1),
            depth=cset(st.depth, 0), q_head=cset(st.q_head, 0),
            head_ready=cset(st.head_ready, False))
    if not srt.size:
        idle[slot[cr]] = True
        return st

    # each slot's first add, against the post-create state: a real tag
    # only when it lands at the head of an empty queue (:878-893)
    g = {f: getattr(st, f)[f_slot] for f in (
        "active", "depth", "q_head", "prop_delta", "resv_inv",
        "weight_inv", "limit_inv", "prev_resv", "prev_prop", "prev_limit",
        "prev_arrival", "head_resv", "head_prop", "head_limit",
        "head_arrival", "head_cost", "head_rho", "head_ready")}
    tag = g["depth"] == 0
    r, p, l = _make_tag(g["prev_resv"], g["prev_prop"], g["prev_limit"],
                        g["prev_arrival"], g["resv_inv"], g["weight_inv"],
                        g["limit_inv"], f_delta, f_rho, f_time, f_cost,
                        anticipation_ns)

    # ring: add of rank j lands at q_head + depth + j - 1 (the head takes
    # rank 0 of an empty queue; its lane rewrites the value it reads)
    d0 = st.depth[a_slot].to(torch.int64)
    pos = torch.remainder(st.q_head[a_slot].to(torch.int64) + d0 + a_rank
                          - 1, q)
    push = (a_rank > 0) | (d0 > 0)
    flat = a_slot * q + pos

    def ring(arr, v):
        a = arr.reshape(-1)
        return a.index_put((flat,), torch.where(push, v, a[flat])
                           ).reshape(n, q)

    def fset(arr, v):
        return arr.index_put((f_slot,), v.to(arr.dtype))

    def on_tag(new, old):
        return fset(getattr(st, old), torch.where(tag, new, g[old]))

    prop_delta = st.prop_delta
    if react.size:
        prop_delta = prop_delta.index_put(
            (f_slot[r_idx],), _reactivation_shifts(
                st0, g, tag, p, r_idx, r_nb, k_slot, k_fi,
                time[first[react]]))
    idle[slot[cr]] = True
    idle[slot[first]] = False
    return st._replace(
        idle=fset(st.idle, torch.zeros_like(tag)),
        prop_delta=prop_delta,
        head_resv=on_tag(r, "head_resv"),
        head_prop=on_tag(p, "head_prop"),
        head_limit=on_tag(l, "head_limit"),
        head_arrival=on_tag(f_time, "head_arrival"),
        head_cost=on_tag(f_cost, "head_cost"),
        head_rho=on_tag(f_rho, "head_rho"),
        head_ready=fset(st.head_ready, g["head_ready"] & ~tag),
        prev_resv=on_tag(_fold_prev(g["prev_resv"], r), "prev_resv"),
        prev_prop=on_tag(_fold_prev(g["prev_prop"], p), "prev_prop"),
        prev_limit=on_tag(_fold_prev(g["prev_limit"], l), "prev_limit"),
        prev_arrival=on_tag(f_time, "prev_arrival"),
        q_arrival=ring(st.q_arrival, a_time),
        q_cost=ring(st.q_cost, a_cost),
        depth=fset(st.depth, g["depth"] + f_count),
        cur_rho=fset(st.cur_rho, l_rho),
        cur_delta=fset(st.cur_delta, l_delta),
    )


def _reactivation_shifts(st0, g, tag, p, r_idx, r_nb, k_slot, k_fi,
                         r_time: np.ndarray) -> torch.Tensor:
    """``prop_delta`` of each reactivating row (in row order).

    Its ``lowest`` is the minimum effective proportion tag over the
    clients scheduling (active, not idle) just before it: (a) those
    scheduling at segment entry, whose tag changes at most once in the
    segment -- a CREATE drops it, a first add to an empty queue retags
    it -- so at row r it is the entry value before that row and the new
    one after (``k_*``: those rows in row order; ``r_nb``: how many come
    before each reactivating row); and (b) the earlier reactivating
    rows' own clients, whose tag is fixed once they join.  (a) is
    vectorized here; (b) is the recurrence, run on the host."""
    dev = st0.device
    inf1 = torch.full((1,), KEY_INF, dtype=torch.int64, device=dev)
    others0 = st0.active & ~st0.idle
    eff0 = torch.where(st0.depth > 0, st0.head_prop, st0.prev_prop) \
        + st0.prop_delta
    in0 = others0[k_slot]
    e_k = eff0[k_slot]
    fi = torch.clamp(k_fi, min=0)
    is_cr = k_fi < 0
    old = torch.where(in0, e_k, KEY_INF)
    new = torch.where(in0 & ~is_cr,
                      torch.where(tag[fi], p[fi] + st0.prop_delta[k_slot],
                                  e_k), KEY_INF)
    moving = torch.zeros_like(others0).index_put(
        (k_slot,), torch.ones((), dtype=torch.bool, device=dev))
    still = torch.min(torch.where(others0 & ~moving, eff0, KEY_INF))
    after = torch.cat([torch.flip(torch.cummin(torch.flip(old, (0,)), 0)
                                  .values, (0,)), inf1])
    before = torch.cat([inf1, torch.cummin(new, 0).values])
    gone = torch.cat([torch.zeros_like(inf1), torch.cumsum(
        (is_cr & in0).to(torch.int64), 0)])
    m = torch.minimum(still, torch.minimum(after[r_nb], before[r_nb]))
    any0 = others0.sum() - gone[r_nb] > 0
    base = torch.where(tag[r_idx], p[r_idx], g["head_prop"][r_idx])
    vals = torch.stack([m, any0.to(torch.int64), base,
                        g["prop_delta"][r_idx],
                        g["active"][r_idx].to(torch.int64)]).cpu()
    low_p, any_r, out = KEY_INF, False, []
    for (mk, a0, b, pd, act), t in zip(vals.T.tolist(), r_time.tolist()):
        low = min(mk, low_p)
        if (a0 or any_r) and low < LOWEST_PROP_TAG_TRIGGER:
            pd = _wrap64(low - t)
        out.append(pd)
        if act:
            low_p = min(low_p, _wrap64(b + pd))
            any_r = True
    return torch.tensor(out, dtype=torch.int64).to(dev)


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
