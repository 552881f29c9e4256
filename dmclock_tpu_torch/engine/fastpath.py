"""Speculative serving: thousands of decisions per O(N) pass, on
tensors.

Counterpart of ``dmclock_tpu/engine/fastpath.py``: the prefix path
(ring window, classification, serve chains, sort or radix selection,
``speculate_prefix_batch``, ``speculate_chain_batch``,
``scan_prefix_epoch``, ``scan_chain_epoch``, ``make_prefix_runner``),
the calendar engine (``calendar_batch``, the bucketed ladder, the timer
wheel, ``calendar_stop_ladder``, ``scan_calendar_epoch``), the int32
tag carry the three epoch scans share (``tag_width=32``) and the
epoch-engine registry (``epoch_scan_fn``, ``epoch_scan_kwargs``).  The
exactness arguments are the JAX module's: at a fixed ``now`` the
serial engine serves the minimum of one unified (class, key, creation
order) key space; the prefix path sorts the packed keys and commits the
longest prefix whose served clients re-enter strictly after it, and the
calendar path follows every client through its own serves and commits
those below the first stop.

The ring window is kernel K1 (``csrc/ring_window.cu``) and the wheel's
bucket scan kernel K2 (``csrc/wheel_scan.cu``) on a CUDA state, and
their plain PyTorch versions on a CPU state.  Everything else is
PyTorch.  Epochs are Python loops over batches; counts, guards and
metrics stay on the device and are stacked once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.timebase import MAX_TAG, MIN_TAG
from ..obs import compile_plane
from ..obs import device as obsdev
from ..obs import flight as obsflight
from ..obs import histograms as obshist
from ..obs import provenance as obsprov
from ..obs import slo as obsslo
from . import _ext
from .kernels import (KEY_INF, NONE, RETURNING, Decision, _fold_prev,
                      _make_tag, as_scalar, engine_run,
                      radix_quantile_ladder, rebase32, restore64,
                      wheel_nearest, wheel_scan, wheel_slot)
from .state import TAG_I64_FIELDS, EngineState

# Packed unified key: 2 class bits | 32-bit rebased tag | 28-bit
# rebased creation order (see the JAX module for the window argument).
_KEY_CLAMP = (1 << 32) - 2   # in-window ceiling for real entry keys
_KEY_HI = (1 << 32) - 1      # above-window exit-key clamp
_EXIT_BIAS = 1 << 30         # window low end reserved for exits below
#                              their class origin (~1.07 s)
_ORDER_LIMIT = 1 << 28
_O_MASK = (1 << 28) - 1

CLS_RESV = 0      # reservation-eligible: constraint phase
CLS_WEIGHT = 1    # effective-ready: weight phase
CLS_LB = 2        # AtLimit::Allow limit-break: weight phase + flag
CLS_NONE = 3      # non-candidate sentinel (sorts after every class)


def _ready_now(state: EngineState, now):
    """Effective readiness under monotonic now: stored flag OR limit
    passed (the promote loop marks exactly {limit <= now})."""
    return state.head_ready | (state.head_limit <= now)


# ----------------------------------------------------------------------
# ring window (kernel K1)
# ----------------------------------------------------------------------

class RingWindow(NamedTuple):
    """Per-epoch prefetch of the tail rings: rows ``q_head0 ..
    q_head0 + w - 1`` of every client, transposed to [w, N]."""

    arr: torch.Tensor    # int64[w, N] arrivals at q_head0 + j
    cost: torch.Tensor   # int64[w, N]
    q0: torch.Tensor     # int32[N] q_head at prefetch time


def _ring_window_torch(ring, q0, wsize: int):
    """Plain version of K1: ``out[w, i] = ring[i, (q0[i] + w) % Q]``
    for ``w < wsize``, as a gather on floor-mod indices."""
    q = ring.shape[1]
    idx = torch.remainder(
        q0.to(torch.int64)[:, None]
        + torch.arange(wsize, dtype=torch.int64, device=ring.device), q)
    return torch.gather(ring, 1, idx).T.contiguous()


def ring_window_cost(n: int, wsize: int) -> dict:
    """K1's cost at ``n`` clients and a ``wsize``-row window: each
    window element of both rings read once and written once (int64),
    ``q_head`` read once (int32); one op an output element.  The bound in
    ``chip_smoke.py`` and the cost counter (``obs/compile_plane.py``)
    both read it."""
    return {"flops": 2 * n * wsize,
            "bytes_accessed": 2 * (2 * n * wsize * 8) + 4 * n,
            "transcendentals": 0}


def ring_window_rows(q_arrival, q_cost, q0, wsize: int):
    """K1's wrapper: the [wsize, N] windows of both tail rings.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (building it at first use) or raises -- there is no
    fallback.  Checks dtypes (int64 rings, int32 ``q0``), shapes,
    contiguity and device.  Under a cost counter the call counts as
    :func:`ring_window_cost`, on either device."""
    if q_arrival.dtype != torch.int64 or q_cost.dtype != torch.int64:
        raise TypeError("ring_window: rings must be int64, got "
                        f"{q_arrival.dtype}/{q_cost.dtype}")
    if q0.dtype != torch.int32:
        raise TypeError(f"ring_window: q_head must be int32, got "
                        f"{q0.dtype}")
    if q_arrival.dim() != 2 or q_arrival.shape != q_cost.shape or \
            q0.shape != (q_arrival.shape[0],):
        raise ValueError(
            f"ring_window: shapes {tuple(q_arrival.shape)}, "
            f"{tuple(q_cost.shape)}, {tuple(q0.shape)} are not "
            "[N, Q], [N, Q], [N]")
    n, q = q_arrival.shape
    if not 0 < wsize <= q:
        raise ValueError(f"ring_window: window {wsize} not in (0, {q}]")
    dev = q_arrival.device
    if q_cost.device != dev or q0.device != dev:
        raise ValueError("ring_window: tensors on different devices")
    with compile_plane.kernel_region(
            "ring_window", lambda: ring_window_cost(n, wsize)):
        return _ring_window_launch(q_arrival, q_cost, q0, wsize, dev)


def _ring_window_launch(q_arrival, q_cost, q0, wsize: int, dev):
    n, q = q_arrival.shape
    if dev.type == "cpu":
        return (_ring_window_torch(q_arrival, q0, wsize),
                _ring_window_torch(q_cost, q0, wsize))
    if dev.type != "cuda":
        raise ValueError(f"ring_window: unsupported device {dev}")
    if not (q_arrival.is_contiguous() and q_cost.is_contiguous()
            and q0.is_contiguous()):
        raise ValueError("ring_window: inputs must be contiguous")
    launch = _ext.kernel("ring_window")
    out_arr = torch.empty((wsize, n), dtype=torch.int64, device=dev)
    out_cost = torch.empty((wsize, n), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q_arrival.data_ptr(), q_cost.data_ptr(),
                     q0.data_ptr(), out_arr.data_ptr(),
                     out_cost.data_ptr(), n, q, wsize, stream)
    if err != 0:
        raise RuntimeError(f"ring_window kernel launch failed: CUDA "
                           f"error {err}")
    _ext.LAUNCHES["ring_window"] += 1
    return out_arr, out_cost


def ring_window(state: EngineState, m: int) -> RingWindow:
    """Prefetch the next ``min(m, Q)`` ring elements of every client,
    transposed to [w, N].  Window rows past a client's queued tail hold
    stale ring values; they are read only after the client drained and
    are masked at commit."""
    wsize = min(m, state.ring_capacity)
    arr, cost = ring_window_rows(state.q_arrival, state.q_cost,
                                 state.q_head, wsize)
    return RingWindow(arr=arr, cost=cost, q0=state.q_head)


def _window_rows(state: EngineState, window: RingWindow, depth: int):
    """Rows ``off .. off+depth-1`` of the prefetched window for every
    client, where ``off = (q_head - q0) mod Q`` is how many rows the
    client consumed since the prefetch.  Row ``d`` is window row
    ``off + d`` when that lies inside the window, else row
    ``min(d, w-1)`` (the JAX module's one-hot select chain computes the
    same function; here it is one gather per row)."""
    wsize = window.arr.shape[0]
    off = torch.remainder(state.q_head - window.q0,
                          state.ring_capacity).to(torch.int64)
    arr_rows, cost_rows = [], []
    for d in range(depth):
        j = off + d
        idx = torch.where(j < wsize, j, min(d, wsize - 1))[None, :]
        arr_rows.append(torch.gather(window.arr, 0, idx)[0])
        cost_rows.append(torch.gather(window.cost, 0, idx)[0])
    return arr_rows, cost_rows


def _window_heads(state: EngineState, window: RingWindow):
    """Every client's next tail element (new head after a pop)."""
    arr_rows, cost_rows = _window_rows(state, window, 1)
    return arr_rows[0], cost_rows[0]


def _heads_rows(heads, depth: int):
    """Normalize a ``heads`` argument to per-step row lists: the
    single-pop pair (narr[N], ncost[N]) for depth 1, or stacked [w, N]
    tensors with w >= depth for chained pops."""
    arr, cost = heads
    if arr.dim() == 1:
        if depth != 1:
            raise ValueError("single-row heads need chain depth 1")
        return [arr], [cost]
    if arr.shape[0] < depth:
        raise ValueError(f"heads window {arr.shape[0]} rows < chain "
                         f"depth {depth}")
    return [arr[j] for j in range(depth)], [cost[j] for j in range(depth)]


# ----------------------------------------------------------------------
# unified candidate classification
# ----------------------------------------------------------------------

def _unified_class(now, has, resv, ready, prop, eff, allow: bool):
    """(class, key) in the unified candidate order the serial engine
    serves (reference do_next_request :1115-1186): class 0 by
    reservation tag, class 1 (ready weight) by effective proportion,
    class 2 (Allow limit-break) by effective proportion.
    Non-candidates get (CLS_NONE, KEY_INF)."""
    prop_ok = prop < MAX_TAG
    c0 = has & (resv <= now)
    c1 = has & ~c0 & ready & prop_ok
    cls = torch.where(c0, CLS_RESV, torch.where(c1, CLS_WEIGHT, CLS_NONE))
    key = torch.where(c0, resv, torch.where(c1, eff, KEY_INF))
    if allow:
        c2 = has & ~c0 & ~c1 & prop_ok
        cls = torch.where(c2, CLS_LB, cls)
        key = torch.where(c2, eff, key)
    return cls.to(torch.int32), key


def _classify(state: EngineState, now, allow: bool):
    """Entry (class, key) per client (see ``_unified_class``)."""
    has_req = state.active & (state.depth > 0)
    return _unified_class(
        now, has_req, state.head_resv, _ready_now(state, now),
        state.head_prop, state.head_prop + state.prop_delta, allow)


# ----------------------------------------------------------------------
# dense serve chains
# ----------------------------------------------------------------------

class ChainServe(NamedTuple):
    """Elementwise ([N]) serve-chain result: what every client's state
    would become after serving its full chain this batch.  Rows outside
    the committed set are garbage and masked at commit."""

    depth: torch.Tensor        # int32[N] after the chain
    qadv: torch.Tensor         # int32[N] ring pops performed
    length: torch.Tensor       # int32[N] serves in the chain
    head_resv: torch.Tensor    # int64[N] final head tag
    head_prop: torch.Tensor
    head_limit: torch.Tensor
    head_arrival: torch.Tensor
    head_cost: torch.Tensor
    head_rho: torch.Tensor
    prev_resv: torch.Tensor
    prev_prop: torch.Tensor
    prev_limit: torch.Tensor
    prev_arrival: torch.Tensor
    exit_cls: torch.Tensor     # int32[N] unified class after the chain
    exit_key: torch.Tensor     # int64[N] unified key after the chain
    cost_acc: torch.Tensor     # int64[N] summed cost of the chain


def _chain_serve(state: EngineState, now, arr_rows, cost_rows,
                 cls, allow: bool, anticipation_ns: int) -> ChainServe:
    """The vectorized pop+retag (reference :1021-1111) iterated
    ``len(arr_rows)`` times for every client.  Step 0 serves the entry
    head in its class's phase (weight phase pays the reservation debt);
    steps >= 1 are the induced constraint serves of weight/limit-break
    entries whose fresh reservation tag fell to ``now`` or below.  The
    exit (class, key) is the client's re-entry position (KEY_INF when
    it leaves)."""
    depth_cap = len(arr_rows)
    is_cand = cls != CLS_NONE
    chains = (cls == CLS_WEIGHT) | (cls == CLS_LB)
    phase1 = chains                       # weight-phase entry serve

    h_resv, h_prop, h_limit = (state.head_resv, state.head_prop,
                               state.head_limit)
    h_arr, h_cost, h_rho = (state.head_arrival, state.head_cost,
                            state.head_rho)
    p_resv, p_prop, p_limit, p_arr = (state.prev_resv, state.prev_prop,
                                      state.prev_limit,
                                      state.prev_arrival)
    depth = state.depth
    qadv = torch.zeros_like(state.q_head)
    length = torch.zeros_like(state.q_head)
    cost_acc = torch.zeros_like(h_resv)
    cont = is_cand

    for j in range(depth_cap):
        narr, ncost = arr_rows[j], cost_rows[j]
        nr, np_, nl = _make_tag(
            h_resv, h_prop, h_limit, h_arr,
            state.resv_inv, state.weight_inv, state.limit_inv,
            state.cur_delta, state.cur_rho, narr, ncost,
            anticipation_ns)
        if j == 0:
            off = torch.where(phase1, state.resv_inv * (h_cost + h_rho),
                              0)
        else:
            off = torch.zeros_like(h_resv)

        new_depth = depth - 1
        has_more = new_depth > 0
        upd = cont
        updh = cont & has_more
        cost_acc = cost_acc + torch.where(upd, h_cost, 0)

        new_h_resv = nr - off
        pr = torch.where(has_more, _fold_prev(p_resv, nr), p_resv) - off
        pp = torch.where(has_more, _fold_prev(p_prop, np_), p_prop)
        pl_ = torch.where(has_more, _fold_prev(p_limit, nl), p_limit)

        h_resv = torch.where(updh, new_h_resv, h_resv)
        h_prop = torch.where(updh, np_, h_prop)
        h_limit = torch.where(updh, nl, h_limit)
        h_arr = torch.where(updh, narr, h_arr)
        h_cost = torch.where(updh, ncost, h_cost)
        h_rho = torch.where(updh, state.cur_rho, h_rho)
        p_resv = torch.where(upd, pr, p_resv)
        p_prop = torch.where(upd, pp, p_prop)
        p_limit = torch.where(upd, pl_, p_limit)
        p_arr = torch.where(updh, narr, p_arr)
        depth = torch.where(upd, new_depth, depth).to(torch.int32)
        qadv = (qadv + updh).to(torch.int32)
        length = (length + upd).to(torch.int32)

        cont = cont & chains & has_more & (new_h_resv <= now)

    # exit classification on the final head; a freshly popped head's
    # stored ready flag is False, so readiness is exactly limit <= now
    has = state.active & (depth > 0)
    exit_cls, exit_key = _unified_class(
        now, has, h_resv, h_limit <= now, h_prop,
        h_prop + state.prop_delta, allow)

    return ChainServe(
        depth=depth, qadv=qadv, length=length,
        head_resv=h_resv, head_prop=h_prop, head_limit=h_limit,
        head_arrival=h_arr, head_cost=h_cost, head_rho=h_rho,
        prev_resv=p_resv, prev_prop=p_prop, prev_limit=p_limit,
        prev_arrival=p_arr, exit_cls=exit_cls, exit_key=exit_key,
        cost_acc=cost_acc)


def _commit_chains(state: EngineState, sel,
                   chain: ChainServe) -> EngineState:
    """Apply the dense chain result to the rows in ``sel``: elementwise
    selects, no scatters."""
    pick = torch.where
    popped = sel & (chain.qadv > 0)
    return state._replace(
        depth=pick(sel, chain.depth, state.depth),
        q_head=pick(popped,
                    (state.q_head + chain.qadv) % state.ring_capacity,
                    state.q_head).to(torch.int32),
        head_resv=pick(popped, chain.head_resv, state.head_resv),
        head_prop=pick(popped, chain.head_prop, state.head_prop),
        head_limit=pick(popped, chain.head_limit, state.head_limit),
        head_arrival=pick(popped, chain.head_arrival,
                          state.head_arrival),
        head_cost=pick(popped, chain.head_cost, state.head_cost),
        head_rho=pick(popped, chain.head_rho, state.head_rho),
        head_ready=state.head_ready & ~sel,
        prev_resv=pick(sel, chain.prev_resv, state.prev_resv),
        prev_prop=pick(sel, chain.prev_prop, state.prev_prop),
        prev_limit=pick(sel, chain.prev_limit, state.prev_limit),
        prev_arrival=pick(popped, chain.prev_arrival,
                          state.prev_arrival),
    )


# ----------------------------------------------------------------------
# unified prefix selection
# ----------------------------------------------------------------------

def _pack(cls, krel, o):
    """Lexicographic (class, key, order) as one int64: 2 class bits |
    32 key bits | 28 order bits."""
    return ((cls.to(torch.int64) << 60) | (krel << 28) | (o & _O_MASK))


_SELECT_IMPLS = ("sort", "radix")


class _Selection(NamedTuple):
    """Everything a caller needs to commit + emit a unified prefix."""

    idxs: torch.Tensor        # int32[k] sorted candidate slots
    cls_s: torch.Tensor       # int32[k] sorted entry classes
    cost_s: torch.Tensor      # int32[k] sorted entry (head) costs
    len_s: torch.Tensor       # int32[k] sorted chain lengths
    count_units: torch.Tensor  # int32 committed sort units
    count: torch.Tensor       # int32 committed DECISIONS
    guards_ok: torch.Tensor   # bool
    state: EngineState        # after the committed prefix
    last_client: torch.Tensor  # int32 slot of the final committed unit
    cost_pc: torch.Tensor     # int64[N] delivered cost per client
    margin_s: torch.Tensor    # int64[k] winner margin over the
    #                           runner-up per committed unit (-1 none)
    entry_cls: torch.Tensor   # int32[N] batch-entry class per client
    entry_key: torch.Tensor   # int64[N] batch-entry unified key


def _unified_prefix(state: EngineState, now, k: int, *,
                    chain_depth: int, anticipation_ns: int,
                    allow: bool, heads, max_count,
                    select_impl: str = "sort") -> _Selection:
    """Classify, chain, select (full sort or k-selection,
    ``select_impl``), and commit the longest exact prefix."""
    if select_impl not in _SELECT_IMPLS:
        raise ValueError(f"select_impl {select_impl!r} not in "
                         f"{_SELECT_IMPLS}")
    dev = state.device
    now = as_scalar(now, dev)
    if heads is None:
        heads = ring_window(state, chain_depth)
        heads = (heads.arr, heads.cost)
    arr_rows, cost_rows = _heads_rows(heads, chain_depth)

    cls, key = _classify(state, now, allow)
    chain = _chain_serve(state, now, arr_rows, cost_rows, cls, allow,
                         anticipation_ns)

    is_cand = cls != CLS_NONE

    # per-class rebase origins: each class's minimum entry rebases to
    # the bias, so position 0 is always in-window (guaranteed progress)
    def class_min(m):
        return torch.min(torch.where(m, key, KEY_INF))

    kresv = class_min(cls == CLS_RESV)
    kprop1 = class_min(cls == CLS_WEIGHT)
    kprop2 = class_min(cls == CLS_LB)

    def origin_of(c):
        return torch.where(c == CLS_RESV, kresv,
                           torch.where(c == CLS_WEIGHT, kprop1, kprop2))

    krel = torch.clamp(key - origin_of(cls) + _EXIT_BIAS, 0, _KEY_CLAMP)

    # order rebased like the keys (28-bit pack of the spread)
    omin = torch.min(torch.where(is_cand, state.order, 1 << 62))
    o64 = state.order - omin
    omax = torch.max(torch.where(is_cand, state.order, omin))
    # the cost guard masks to real candidates
    cost_ok = torch.max(torch.where(is_cand, state.head_cost, 0)) \
        < (1 << 31)
    guards_ok = ((omax - omin) < _ORDER_LIMIT) & cost_ok

    pk_dense = torch.where(is_cand, _pack(cls, krel, o64), KEY_INF)

    # exit keys in the same packed space (low clamp shortens the
    # prefix; high clamp keeps exit > every committable boundary)
    ekrel = torch.clamp(chain.exit_key - origin_of(chain.exit_cls)
                        + _EXIT_BIAS, 0, _KEY_HI)
    epk = torch.where(chain.exit_cls == CLS_NONE, KEY_INF,
                      _pack(chain.exit_cls, ekrel, o64))

    n = key.shape[0]
    kk = min(k, n)

    def trim(a, fill):
        a = a[:kk]
        if kk < k:      # k beyond the population: sentinel padding
            a = torch.cat([a, torch.full((k - kk,), fill, dtype=a.dtype,
                                         device=dev)])
        return a

    # the kk smallest packed keys in order.  While the guards hold they
    # are unique among candidates (creation order is in them); ties exist
    # only among KEY_INF sentinel rows and, past a guard trip, among
    # wrapped orders -- lanes that every reader masks (count 0 on a trip)
    if select_impl == "radix":
        # k-selection without ordering the other N - kk keys (the JAX
        # package's histogram walk; on the card torch.topk is a radix
        # select)
        pks, perm = torch.topk(pk_dense, kk, largest=False, sorted=True)
    else:
        pks, perm = torch.sort(pk_dense, stable=True)
        pks, perm = pks[:kk], perm[:kk]
    idxs = perm.to(torch.int32)
    rpk = epk[perm]
    costs = state.head_cost[perm].to(torch.int32)
    if chain_depth == 1:
        lens = torch.ones((k,), dtype=torch.int32, device=dev)
    else:
        lens = trim(chain.length[perm], 0)
    pks, idxs = trim(pks, KEY_INF), trim(idxs, -1)
    rpk, costs = trim(rpk, KEY_INF), trim(costs, 0)

    # exclusive cumulative min of exit keys over the sorted order
    cm = torch.cummin(rpk, 0).values
    cm_excl = torch.cat([torch.full((1,), KEY_INF, dtype=torch.int64,
                                    device=dev), cm[:-1]])

    in_window = ((pks >> 60) < CLS_NONE) & \
        (((pks >> 28) & _KEY_HI) < _KEY_CLAMP)
    ok_q = in_window & (cm_excl > pks)
    # first failing position (argmax of the first True; torch.argmax
    # takes no bool tensors)
    first_bad = torch.argmax((~ok_q).to(torch.int32))
    count_units = torch.where(torch.all(ok_q), k, first_bad)
    count_units = torch.where(guards_ok, count_units, 0).to(torch.int32)
    if max_count is not None:
        if chain_depth != 1:
            raise ValueError("max_count caps decisions; only supported "
                             "at chain_depth=1")
        count_units = torch.minimum(
            count_units, as_scalar(max_count, dev).to(torch.int32))

    j = torch.arange(k, dtype=torch.int32, device=dev)
    served = j < count_units
    cls_s = (pks >> 60).to(torch.int32)   # >= CLS_NONE on sentinels

    # provenance margins: the exact runner-up when unit j commits is
    # min(pks[j+1], cm_excl[j]); >> 28 strips the order bits
    nxt = torch.cat([pks[1:], torch.full((1,), KEY_INF,
                                         dtype=torch.int64, device=dev)])
    runner = torch.minimum(nxt, cm_excl)
    margin_s = torch.where(served & (runner < KEY_INF),
                           (runner - pks) >> 28, -1)
    if chain_depth == 1:
        count = count_units
    else:
        count = torch.sum(torch.where(served, lens, 0)).to(torch.int32)

    # commit: dense membership is packed(key) <= packed boundary
    boundary = torch.max(torch.where(served, pks, -1))
    sel = pk_dense <= boundary
    new_state = _commit_chains(state, sel, chain)

    # stored-flag parity (promote loop, reference :1135-1144): if the
    # last committed unit is a weight-phase one, its promote pass marks
    # every current head with limit <= now except the head its own
    # chain popped into place
    sel_last = j == count_units - 1
    cls_last = torch.max(torch.where(sel_last, cls_s, -1))
    last_client = torch.max(torch.where(sel_last, idxs, -1))
    do_promote = (count_units > 0) & (cls_last >= CLS_WEIGHT)
    has_req_after = new_state.active & (new_state.depth > 0)
    promoted = new_state.head_ready | \
        (has_req_after & (new_state.head_limit <= now))
    promoted = promoted & (
        torch.arange(state.capacity, dtype=torch.int32, device=dev)
        != last_client)
    new_state = new_state._replace(head_ready=torch.where(
        do_promote, promoted, new_state.head_ready))

    return _Selection(idxs=idxs, cls_s=cls_s, cost_s=costs, len_s=lens,
                      count_units=count_units, count=count,
                      guards_ok=guards_ok, state=new_state,
                      last_client=last_client,
                      cost_pc=torch.where(sel, chain.cost_acc, 0),
                      margin_s=margin_s, entry_cls=cls, entry_key=key)


# ----------------------------------------------------------------------
# flat (chain_depth=1) batches: one decision per sort unit
# ----------------------------------------------------------------------

class PrefixBatch(NamedTuple):
    """Result of one prefix-commit attempt."""

    state: EngineState
    count: torch.Tensor      # int32: decisions committed
    guards_ok: torch.Tensor  # bool: rebase-window guards held; when
    #                          False count is 0 and the caller must use
    #                          the serial engine for this batch
    decisions: Decision      # [k]; slots -1 / type NONE past `count`
    cost_pc: torch.Tensor    # int64[N] delivered cost per client
    margins: torch.Tensor    # int64[k] per-decision winner margin, ns


def speculate_prefix_batch(state: EngineState, now, k: int, *,
                           anticipation_ns: int, heads=None,
                           max_count=None,
                           allow_limit_break: bool = False,
                           select_impl: str = "sort") -> PrefixBatch:
    """One prefix-commit batch over the unified candidate order.
    ``max_count`` (int or int32 0-d tensor) caps the committed prefix;
    a shorter prefix of an exact prefix is still exact."""
    return _prefix_batch(state, now, k, anticipation_ns=anticipation_ns,
                         heads=heads, max_count=max_count,
                         allow_limit_break=allow_limit_break,
                         select_impl=select_impl)[0]


def _prefix_batch(state: EngineState, now, k: int, *, anticipation_ns: int,
                  heads=None, max_count=None,
                  allow_limit_break: bool = False,
                  select_impl: str = "sort"):
    """:func:`speculate_prefix_batch` and its selection (whose batch-entry
    classification the telemetry reuses): ``(PrefixBatch,
    _Selection)``."""
    s = _unified_prefix(state, now, k, chain_depth=1,
                        anticipation_ns=anticipation_ns,
                        allow=allow_limit_break, heads=heads,
                        max_count=max_count, select_impl=select_impl)
    dev = state.device
    j = torch.arange(k, dtype=torch.int32, device=dev)
    served = j < s.count_units
    phase = torch.where(s.cls_s >= CLS_WEIGHT, 1, 0).to(torch.int32)
    decisions = Decision(
        type=torch.where(served, RETURNING, NONE).to(torch.int32),
        slot=torch.where(served, s.idxs, -1).to(torch.int32),
        phase=torch.where(served, phase, 0),
        cost=torch.where(served, s.cost_s.to(torch.int64), 0),
        when=torch.zeros((k,), dtype=torch.int64, device=dev),
        limit_break=served & (s.cls_s >= CLS_LB),
    )
    return PrefixBatch(state=s.state, count=s.count,
                       guards_ok=s.guards_ok, decisions=decisions,
                       cost_pc=s.cost_pc, margins=s.margin_s), s


# ----------------------------------------------------------------------
# chained batches: one sort unit = up to chain_depth decisions
# ----------------------------------------------------------------------

class ChainBatch(NamedTuple):
    """Result of one chained prefix-commit attempt, in unit form: the
    decision stream is ``slot[q]`` repeated ``length[q]`` times for each
    committed unit q in order, the first serve in the unit's entry phase
    (class >= 1: weight) and the rest constraint serves
    (``expand_units``)."""

    state: EngineState
    count: torch.Tensor       # int32 committed DECISIONS
    unit_count: torch.Tensor  # int32 committed sort units
    guards_ok: torch.Tensor   # bool
    slot: torch.Tensor        # int32[k] unit client (-1 pad)
    cls: torch.Tensor         # int32[k] unit entry class (CLS_NONE pad)
    length: torch.Tensor      # int32[k] unit decisions (0 pad)
    cost_pc: torch.Tensor     # int64[N] delivered cost per client
    margins: torch.Tensor     # int64[k] per-unit winner margin, ns


def speculate_chain_batch(state: EngineState, now, k: int, *,
                          chain_depth: int, anticipation_ns: int,
                          heads=None, allow_limit_break: bool = False,
                          select_impl: str = "sort") -> ChainBatch:
    """One prefix-commit batch with serve chains: each sort unit serves
    a client up to ``chain_depth`` times -- a weight serve plus the
    constraint serves its reservation-debt reduction induces -- so
    streams whose phase flips every few decisions commit long
    prefixes.  ``heads`` is a ``(arr, cost)`` pair of [w, N] window rows
    with w >= ``chain_depth`` (None: prefetch them here)."""
    return _chain_batch(state, now, k, chain_depth=chain_depth,
                        anticipation_ns=anticipation_ns, heads=heads,
                        allow_limit_break=allow_limit_break,
                        select_impl=select_impl)[0]


def _chain_batch(state: EngineState, now, k: int, *, chain_depth: int,
                 anticipation_ns: int, heads=None,
                 allow_limit_break: bool = False,
                 select_impl: str = "sort"):
    """:func:`speculate_chain_batch` and its selection: ``(ChainBatch,
    _Selection)``."""
    s = _unified_prefix(state, now, k, chain_depth=chain_depth,
                        anticipation_ns=anticipation_ns,
                        allow=allow_limit_break, heads=heads,
                        max_count=None, select_impl=select_impl)
    j = torch.arange(k, dtype=torch.int32, device=state.device)
    served = j < s.count_units
    return ChainBatch(
        state=s.state, count=s.count, unit_count=s.count_units,
        guards_ok=s.guards_ok,
        slot=torch.where(served, s.idxs, -1).to(torch.int32),
        cls=torch.where(served, s.cls_s, CLS_NONE).to(torch.int32),
        length=torch.where(served, s.len_s, 0).to(torch.int32),
        cost_pc=s.cost_pc, margins=s.margin_s), s


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def expand_units(slot, cls, length, pre_state, *,
                 limit_break: bool = False):
    """Host-side expansion of committed units into the flat serial
    decision stream ``(slots, phases, costs, limit_breaks)`` (numpy),
    for differential checks.  ``pre_state`` is the state BEFORE the
    batch -- a port ``EngineState`` or a dict of numpy arrays
    (``bridge.state_to_numpy``); its rings give the induced serves'
    costs.  ``slot``/``cls``/``length`` may be any prefix of a batch's
    units."""
    def field(name):
        v = pre_state[name] if isinstance(pre_state, dict) \
            else getattr(pre_state, name)
        return _host(v)

    slot, cls, length = _host(slot), _host(cls), _host(length)
    head_cost = field("head_cost")
    q_head = field("q_head")
    q_cost = field("q_cost")
    ring = q_cost.shape[1]
    slots, phases, costs, lbs = [], [], [], []
    for u in range(slot.shape[0]):
        c = int(slot[u])
        if c < 0 or length[u] == 0:
            continue
        for step in range(int(length[u])):
            slots.append(c)
            phases.append(1 if (step == 0 and cls[u] >= CLS_WEIGHT)
                          else 0)
            lbs.append(bool(limit_break and step == 0
                            and cls[u] >= CLS_LB))
            if step == 0:
                costs.append(int(head_cost[c]))
            else:
                costs.append(int(q_cost[c, (q_head[c] + step - 1)
                                        % ring]))
    return (np.asarray(slots, np.int32), np.asarray(phases, np.int32),
            np.asarray(costs, np.int64), np.asarray(lbs, bool))


# ----------------------------------------------------------------------
# epochs
# ----------------------------------------------------------------------

class PrefixEpoch(NamedTuple):
    """M flat prefix batches' output, compact for one readback."""

    state: EngineState     # after ALL committed prefixes
    count: torch.Tensor    # int32[M] decisions committed per batch
    guards_ok: torch.Tensor  # bool[M]
    slot: torch.Tensor     # int32[M, k] serial-order winners (-1 pad)
    phase: torch.Tensor    # int8[M, k]  0 reservation / 1 weight
    cost: torch.Tensor     # int32[M, k]
    lb: torch.Tensor       # bool[M, k]  limit-break serves (Allow)
    metrics: torch.Tensor  # int64[NUM_METRICS] (zeros unless
    #                        with_metrics)
    # the telemetry accumulators (None unless the caller passed one)
    hists: object = None   # int64[NUM_HISTS, NUM_BUCKETS + 1]
    ledger: object = None  # int64[N, LED_COLS]
    flight: object = None  # obs.flight.FlightState
    slo: object = None     # int64[N, W_FIELDS] window block
    prov: object = None    # obs.provenance.ProvBlock


# State fields no epoch writes: rings are popped through q_head only,
# and QoS, identity and ingest-time fields change only at ingest, which
# cannot run mid-epoch.  The epochs return these tensors untouched.
_EPOCH_INVARIANT = ("active", "idle", "order", "resv_inv", "weight_inv",
                    "limit_inv", "prop_delta", "cur_rho", "cur_delta",
                    "q_arrival", "q_cost")
_EPOCH_MUTABLE = tuple(f for f in EngineState._fields
                       if f not in _EPOCH_INVARIANT)


# ----------------------------------------------------------------------
# int32 epoch tag carry (tag_width=32)
#
# The 10 int64 tag/arrival/cost fields the epochs carry
# (state.TAG_I64_FIELDS) are held between batches as int32 offsets from
# per-field epoch origins (kernels.rebase32).  Batches still compute in
# int64, so decisions equal tag_width=64 whenever the window holds.  A
# batch whose post-state no longer fits the +-2^31 ns window commits
# NOTHING: its outputs are zeroed, the carry keeps the last good state,
# and the rebase_fallbacks metric bumps once; every later batch of the
# epoch is dead the same way.  The caller reruns the remaining batches
# at tag_width=64 from the returned state, as after a sort-key guard
# trip.  Dead batches still run (from the frozen carry, their outputs
# zeroed on the device): the epoch never reads a flag back to the host.
# ----------------------------------------------------------------------

class _TagCarry32:
    """The int32 tag carry shared by the three epoch scans: per-field
    origins, narrowing, widening, the per-batch gate and the exit
    restore (the JAX package's ``_TagCarry32``).

    Origins are the centre of each field's organic (non-sentinel) span
    at epoch entry over the LIVE lanes only (active with work queued).
    Lanes that cannot serve this epoch are carried as zero offsets:
    every read of their tag fields is masked by candidacy, and the exit
    restore puts their exact entry values back, so one stale idle lane
    with an ancient tag cannot disable the carry."""

    def __init__(self, state: EngineState):
        self.live0 = state.active & (state.depth > 0)

        def organic_center(v):
            fin = self.live0 & (v > MIN_TAG) & (v < MAX_TAG)
            lo = torch.min(torch.where(fin, v, MAX_TAG))
            hi = torch.max(torch.where(fin, v, MIN_TAG))
            # both branches are computed: with no organic lane hi - lo
            # is MIN_TAG - MAX_TAG, and that branch is discarded
            return torch.where(lo > hi, 0, lo + (hi - lo) // 2)

        self.origins = {f: organic_center(getattr(state, f))
                        for f in TAG_I64_FIELDS}

    def narrow(self, mut: dict):
        """The int64 fields of a mutable-field dict as int32 offsets;
        returns ``(narrowed dict, every window held)``.  Dead lanes
        narrow as zero offsets and never affect the fit."""
        ok = None
        out = dict(mut)
        for f in TAG_I64_FIELDS:
            v = torch.where(self.live0, mut[f], self.origins[f])
            out[f], o = rebase32(v, self.origins[f])
            ok = o if ok is None else ok & o
        return out, ok

    def widen(self, mut32: dict) -> dict:
        """Inverse of :meth:`narrow` for live lanes; dead lanes widen to
        their origin (masked by every consumer, put back by
        :meth:`restore`)."""
        out = dict(mut32)
        for f in TAG_I64_FIELDS:
            out[f] = restore64(mut32[f], self.origins[f])
        return out

    def gate(self, dead, mut: dict, new_mut: dict, outs):
        """The per-batch gate: narrow the post-batch fields; when they do
        not fit (or an earlier batch tripped) zero the batch's outputs
        and keep the carry.  ``outs`` is a sequence of ``(value, fill)``
        pairs; returns ``(mut, dead, good, trip, gated values)``, all on
        the device."""
        new32, fit = self.narrow(new_mut)
        good = ~dead & fit
        trip = ~dead & ~fit
        vals = tuple(_gated(good, v, f) for v, f in outs)
        mut = {f: torch.where(good, new32[f], mut[f]) for f in new32}
        return mut, dead | ~fit, good, trip, vals

    def restore(self, mut32: dict, mut0_64: dict, ok0) -> dict:
        """Exit fields: widened live lanes, the exact entry values of
        dead lanes, and the whole entry state when it did not narrow."""
        out = self.widen(mut32)
        for f in out:
            keep = (self.live0 & ok0) if f in TAG_I64_FIELDS else ok0
            out[f] = torch.where(keep, out[f], mut0_64[f])
        return out


def _gated(good, v, fill):
    """``v`` where ``good``, else ``fill``.  A Python int ``v`` is a
    row the batch's scheme does not write (0, its own fill)."""
    return torch.where(good, v, fill) if torch.is_tensor(v) else v


class _EpochCarry:
    """What an epoch carries from batch to batch: the state itself at
    ``tag_width=64``, the narrowed mutable fields at ``tag_width=32``.
    At 64 nothing is gated, and ``good``/``trip`` are the Python
    constants True/False, so the int64 epochs run no extra op."""

    def __init__(self, state: EngineState, tag_width: int):
        if tag_width not in (32, 64):
            raise ValueError(f"tag_width {tag_width} not in (32, 64)")
        self.st = state
        self.tc = None
        if tag_width == 32:
            self.invariant = {f: getattr(state, f)
                              for f in _EPOCH_INVARIANT}
            self.mut0 = {f: getattr(state, f) for f in _EPOCH_MUTABLE}
            self.tc = _TagCarry32(state)
            self.mut, self.ok0 = self.tc.narrow(self.mut0)
            self.dead = ~self.ok0

    def metrics0(self, with_metrics: bool):
        """The epoch's starting metrics vector: zeros, plus the entry
        misfit's ``rebase_fallbacks`` bump at ``tag_width=32`` when
        metrics are on."""
        met = obsdev.metrics_zero(self.st.device)
        if self.tc is None or not with_metrics:
            return met
        return obsdev.metrics_combine(met, obsdev.metrics_delta(
            device=met.device,
            rebase_fallbacks=(~self.ok0).to(torch.int64)))

    def state(self) -> EngineState:
        """The state the next batch starts from."""
        if self.tc is None:
            return self.st
        return EngineState(**self.invariant, **self.tc.widen(self.mut))

    def commit(self, new_state: EngineState, outs):
        """Take a batch's post-state; ``outs`` is a sequence of
        ``(value, fill)`` pairs.  Returns ``(values, good, trip)``."""
        if self.tc is None:
            self.st = new_state
            return tuple(v for v, _ in outs), True, False
        new_mut = {f: getattr(new_state, f) for f in _EPOCH_MUTABLE}
        self.mut, self.dead, good, trip, vals = self.tc.gate(
            self.dead, self.mut, new_mut, outs)
        return vals, good, trip

    def final(self) -> EngineState:
        if self.tc is None:
            return self.st
        return EngineState(**self.invariant, **self.tc.restore(
            self.mut, self.mut0, self.ok0))


def _batch_metrics(met, st: EngineState, *, count, resv, prop, lb,
                   guards_ok, rebase_fallback=False, live=True,
                   ladder_levels_used=0, ladder_base_decisions=0,
                   ladder_fallbacks=0, wheel_occ_hwm=0, wheel_reslots=0):
    """Fold one batch's contribution into the epoch metrics vector.  A
    stall is a batch that committed nothing while work sat queued.  The
    ladder and wheel rows are 0-d tensors or ints, added as they are.
    ``rebase_fallback`` marks an int32 tag-carry window trip;
    ``live`` is False for the dead batches after it: their forced-zero
    counts are no stall, their discarded state feeds no high-water mark
    and their guards trip nothing.  Both are 0-d tensors under
    ``tag_width=32`` and the constants False/True otherwise, which add
    no op.  The ``wheel_pallas_fallbacks`` row stays 0: the device picks
    the route, so there is no kernel fallback."""
    queued = torch.any(st.active & (st.depth > 0))
    stall = (count == 0) & queued
    hwm = torch.max(st.depth)
    trips = ~guards_ok
    if live is not True:
        stall = stall & live
        hwm = torch.where(live, hwm, 0)
        trips = trips & live
    fallback = rebase_fallback.to(torch.int64) \
        if torch.is_tensor(rebase_fallback) else int(rebase_fallback)
    return obsdev.metrics_combine(met, obsdev.metrics_delta(
        device=st.device,
        decisions=count.to(torch.int64), resv=resv.to(torch.int64),
        prop=prop.to(torch.int64), limit_break=lb.to(torch.int64),
        stalls=stall.to(torch.int64),
        ring_hwm=hwm.to(torch.int64),
        guard_trips=trips.to(torch.int64),
        rebase_fallbacks=fallback,
        cal_ladder_levels_used=ladder_levels_used,
        cal_ladder_base_decisions=ladder_base_decisions,
        cal_ladder_fallbacks=ladder_fallbacks,
        wheel_occ_hwm=wheel_occ_hwm, wheel_reslots=wheel_reslots))


# ----------------------------------------------------------------------
# the telemetry accumulators (obs.histograms / flight / slo / provenance)
#
# The JAX package's helpers of the same names: pure reductions over the
# batch-entry classification and the committed counts, folded per batch
# (per ladder level for the calendar engine) gated on the tag32
# liveness ``good`` -- a 0-d tensor under tag_width=32, the constant
# True otherwise, which adds no op.  The accumulators ride a dict keyed
# "h" (histograms), "l" (ledger), "f" (flight), "s" (SLO window block)
# and "p" (provenance); a key's presence is the on-flag.
# ----------------------------------------------------------------------

def _telemetry_delta(st_post: EngineState, now, cls, key, served_pc,
                     resv_pc, lb_pc, count, with_hists: bool,
                     with_ledger: bool, cost_pc=None,
                     with_slo: bool = False):
    """One batch/level's telemetry contribution: ``(hist delta | None,
    ledger delta | None, window delta | None)``.  Tardiness and latency
    are entry-head observations ``max(now - key, 0)`` against the
    committed unit's entry key; the stall observation is the time until
    the earliest queued head of the post-batch state becomes
    eligible."""
    m = served_pc > 0
    tard = torch.clamp(now - key, min=0)
    resv_entry = m & (cls == CLS_RESV)
    hd = ld = sd = None
    if with_hists:
        w_entry = m & (cls >= CLS_WEIGHT) & (cls < CLS_NONE)
        queued = st_post.active & (st_post.depth > 0)
        stalled = (count == 0) & torch.any(queued)
        next_elig = torch.min(torch.where(
            queued, torch.minimum(st_post.head_resv, st_post.head_limit),
            MAX_TAG))
        hd = torch.stack([
            obshist._hist_row(tard, w_entry),
            obshist._hist_row(tard, resv_entry),
            obshist._scalar_row(torch.clamp(next_elig - now, min=0),
                                stalled),
            obshist._scalar_row(count.to(torch.int64), 1)])
    if with_ledger or with_slo:
        t = torch.where(resv_entry, tard, 0)
    if with_ledger:
        ld = torch.stack([served_pc.to(torch.int64),
                          resv_pc.to(torch.int64), lb_pc.to(torch.int64),
                          t, t], dim=1)
    if with_slo:
        if cost_pc is None:
            raise ValueError("the SLO window block needs the per-client "
                             "delivered cost")
        sd = obsslo.window_delta(served_pc, cost_pc, resv_pc,
                                 resv_entry & (tard > 0), lb_pc, t)
    return hd, ld, sd


def _tele_init(state: EngineState, hists, ledger, flight, slo=None,
               prov=None) -> dict:
    """The optional accumulators as the telemetry dict, shapes and
    devices checked."""
    tele = {}
    n = state.capacity
    dev = state.device
    for key, val, shape in (
            ("h", hists, (obshist.NUM_HISTS, obshist.NUM_BUCKETS + 1)),
            ("l", ledger, (n, obshist.LED_COLS)),
            ("s", slo, (n, obsslo.W_FIELDS))):
        if val is None:
            continue
        if not torch.is_tensor(val) or val.dtype != torch.int64 or \
                tuple(val.shape) != shape or val.device != dev:
            raise ValueError(f"telemetry accumulator {key!r} must be an "
                             f"int64 {shape} tensor on {dev}")
        tele[key] = val
    if flight is not None:
        if not isinstance(flight, obsflight.FlightState) or \
                flight.buf.device != dev:
            raise ValueError(f"telemetry accumulator 'f' must be a "
                             f"FlightState on {dev}")
        tele["f"] = flight
    if prov is not None:
        if not isinstance(prov, obsprov.ProvBlock) or \
                tuple(prov.last_served.shape) != (n,) or \
                prov.last_served.device != dev:
            raise ValueError(f"telemetry accumulator 'p' must be a "
                             f"ProvBlock over [{n}] clients on {dev}")
        tele["p"] = prov
    return tele


def _tele_fold(tele: dict, hd, ld, live, sd=None) -> dict:
    """Fold one batch's histogram/ledger/window deltas, gated on
    liveness."""
    out = dict(tele)
    if "h" in tele:
        out["h"] = obshist.hist_fold(tele["h"], hd, live)
    if "l" in tele:
        out["l"] = obshist.ledger_fold(tele["l"], ld, live)
    if "s" in tele:
        out["s"] = obsslo.window_fold(tele["s"], sd, live)
    return out


def _entry_gate(st: EngineState, cls_e):
    """The batch entry's candidates and its queued-but-limit-blocked
    clients: ``(elig, gated)`` bool masks."""
    elig = cls_e != CLS_NONE
    return elig, st.active & (st.depth > 0) & ~elig


def _prov_observe(prov, now, cls_e, elig, gated, served_pc, margins):
    return obsprov.prov_observe(
        prov, now=now, elig=elig, gated=gated,
        win_cls=torch.min(torch.where(elig, cls_e, CLS_NONE)),
        served_pc=served_pc, margins=margins)


def _tele_entry_fold(tele: dict, st: EngineState, batch, sel, now, live):
    """The shared prefix/chain fold: depth-delta served counts, the
    entry-head reservation/limit-break derivation and the gated
    histogram/ledger/window/provenance fold.  ``batch`` is the
    speculated batch (its count, delivered cost and margins are reused,
    as is the entry classification of its selection ``sel``).  Returns
    ``(tele, gate_n)``."""
    cls_e = sel.entry_cls
    served_pc = (st.depth - batch.state.depth).to(torch.int32)
    srv = served_pc > 0
    w_entry = srv & (cls_e >= CLS_WEIGHT) & (cls_e < CLS_NONE)
    hd, ld, sd = _telemetry_delta(
        batch.state, now, cls_e, sel.entry_key, served_pc,
        served_pc - w_entry.to(torch.int32),
        (srv & (cls_e == CLS_LB)).to(torch.int32), batch.count,
        "h" in tele, "l" in tele, cost_pc=batch.cost_pc,
        with_slo="s" in tele)
    out = _tele_fold(tele, hd, ld, live, sd)
    elig, gated = _entry_gate(st, cls_e)
    if "p" in tele:
        newp = _prov_observe(tele["p"], now, cls_e, elig, gated, served_pc,
                             batch.margins)
        out["p"] = obsprov.prov_select(live, newp, tele["p"])
    return out, torch.sum(gated, dtype=torch.int64)


def _tele_flight(tele: dict, slot, cls, tag, cost, live, margin=None,
                 gate=None) -> dict:
    if "f" not in tele:
        return tele
    out = dict(tele)
    out["f"] = obsflight.flight_record(tele["f"], slot, cls, tag, cost,
                                       live=live, margin=margin,
                                       gate=gate)
    return out


def _tele_result(tele: dict) -> dict:
    return dict(hists=tele.get("h"), ledger=tele.get("l"),
                flight=tele.get("f"), slo=tele.get("s"),
                prov=tele.get("p"))


def scan_prefix_epoch(state: EngineState, now, m: int, k: int, *,
                      anticipation_ns: int,
                      allow_limit_break: bool = False,
                      with_metrics: bool = False,
                      select_impl: str = "sort",
                      tag_width: int = 64,
                      window_m: int | None = None,
                      hists=None, ledger=None, flight=None, slo=None,
                      prov=None) -> PrefixEpoch:
    """Run m flat prefix-commit batches of up to k decisions.

    Every batch commits its own exact prefix, so the concatenated
    per-batch prefixes are the serial decision stream at ``now``.
    Callers must check ``guards_ok``: a guard failure zeroes that
    batch without committing (rerun from the returned state through
    ``make_prefix_runner``'s serial path).  ``window_m`` (must divide
    m) refreshes the ring window every ``window_m`` batches; None = one
    m-row window.  ``with_metrics`` accumulates the ``obs.device``
    vector; decisions and state are identical either way.

    ``select_impl`` picks the selection backend: "sort" (one full
    stable sort) or "radix" (a k-selection, ``torch.topk``); the
    two give identical decision streams and states.  ``tag_width=32``
    carries the tag fields as int32 epoch offsets between batches; a
    window trip makes that batch and every later one commit 0 with
    ``guards_ok`` False and bumps ``rebase_fallbacks`` once -- the same
    caller contract as the sort-key guard.

    ``hists`` / ``ledger`` / ``flight`` / ``slo`` / ``prov`` (each None
    = off) are initial telemetry accumulators
    (``obs.histograms.hist_zero()``, ``ledger_zero(N)``,
    ``obs.flight.flight_init(R)``, ``obs.slo.window_zero(N)``,
    ``obs.provenance.prov_init(N)``, or the previous epoch's outputs);
    they come back as the result's fields of the same names.  Flight
    records are one per decision.  Decisions, state and metrics are
    identical with telemetry on or off."""
    w = m if window_m is None else min(int(window_m), m)
    if not (w > 0 and m % w == 0):
        raise ValueError("window_m must divide m")
    dev = state.device
    now = as_scalar(now, dev)
    carry = _EpochCarry(state, tag_width)
    met = carry.metrics0(with_metrics)
    tele = _tele_init(state, hists, ledger, flight, slo, prov)
    outs = []
    for _chunk in range(m // w):
        st = carry.state()
        window = ring_window(st, w)
        for j in range(w):
            if j:
                st = carry.state()
            batch, sel = _prefix_batch(
                st, now, k, anticipation_ns=anticipation_ns,
                heads=_window_heads(st, window),
                allow_limit_break=allow_limit_break,
                select_impl=select_impl)
            dec = batch.decisions
            (count, guards, slot, phase, cost, lb), good, trip = \
                carry.commit(batch.state, [
                    (batch.count, 0), (batch.guards_ok, False),
                    (dec.slot, -1), (dec.phase.to(torch.int8), 0),
                    (dec.cost.to(torch.int32), 0),
                    (dec.limit_break, False)])
            outs.append((count, guards, slot, phase, cost, lb))
            if with_metrics:
                resv = torch.sum((slot >= 0) & (phase == 0))
                met = _batch_metrics(
                    met, batch.state, count=count, resv=resv,
                    prop=count - resv, lb=torch.sum(lb),
                    guards_ok=batch.guards_ok, rebase_fallback=trip,
                    live=good)
            if tele:
                tele, gate_n = _tele_entry_fold(tele, st, batch, sel, now,
                                                good)
                tele = _tele_flight(
                    tele, slot, phase.to(torch.int64) + lb,
                    sel.entry_key[torch.clamp(slot, min=0)], cost, good,
                    margin=batch.margins, gate=gate_n)
    count, guards, slot, phase, cost, lb = (torch.stack(c)
                                            for c in zip(*outs))
    return PrefixEpoch(state=carry.final(), count=count, guards_ok=guards,
                       slot=slot, phase=phase, cost=cost, lb=lb,
                       metrics=met, **_tele_result(tele))


class ChainEpoch(NamedTuple):
    """M chained prefix batches' output, compact for one readback."""

    state: EngineState
    count: torch.Tensor       # int32[M] decisions committed per batch
    unit_count: torch.Tensor  # int32[M]
    guards_ok: torch.Tensor   # bool[M]
    slot: torch.Tensor        # int32[M, k] unit clients (-1 pad)
    cls: torch.Tensor         # int8[M, k]  unit entry class
    length: torch.Tensor      # int8[M, k]  unit decisions
    metrics: torch.Tensor     # int64[NUM_METRICS] (zeros unless
    #                           with_metrics)
    hists: object = None      # telemetry accumulators, as PrefixEpoch
    ledger: object = None
    flight: object = None
    slo: object = None
    prov: object = None


def scan_chain_epoch(state: EngineState, now, m: int, k: int, *,
                     chain_depth: int, anticipation_ns: int,
                     allow_limit_break: bool = False,
                     with_metrics: bool = False,
                     select_impl: str = "sort",
                     tag_width: int = 64,
                     hists=None, ledger=None, flight=None, slo=None,
                     prov=None) -> ChainEpoch:
    """Run m chained prefix batches.  Each batch prefetches its own
    ``chain_depth``-row ring window (one K1 launch per batch on the
    card).  ``select_impl``, ``tag_width`` and ``with_metrics`` as in
    :func:`scan_prefix_epoch`, and so are the telemetry accumulators
    (flight records are one per unit, the cost column carrying the
    unit's decision count).  The JAX package's ``use_pallas`` switch
    has no counterpart: the device picks K1's route."""
    if not 0 < chain_depth <= state.ring_capacity:
        raise ValueError(f"chain_depth {chain_depth} not in (0, ring "
                         f"capacity {state.ring_capacity}]")
    dev = state.device
    now = as_scalar(now, dev)
    carry = _EpochCarry(state, tag_width)
    met = carry.metrics0(with_metrics)
    tele = _tele_init(state, hists, ledger, flight, slo, prov)
    outs = []
    for _ in range(m):
        st = carry.state()
        win = ring_window(st, chain_depth)
        batch, sel = _chain_batch(
            st, now, k, chain_depth=chain_depth,
            anticipation_ns=anticipation_ns, heads=(win.arr, win.cost),
            allow_limit_break=allow_limit_break, select_impl=select_impl)
        vals, good, trip = carry.commit(batch.state, [
            (batch.count, 0), (batch.unit_count, 0),
            (batch.guards_ok, False), (batch.slot, -1),
            (batch.cls.to(torch.int8), CLS_NONE),
            (batch.length.to(torch.int8), 0)])
        outs.append(vals)
        count, _u, _g, slot, cls, length = vals
        if with_metrics:
            units = slot >= 0
            # a unit's entry serve is weight-phase iff class >= 1; its
            # induced serves are all constraint-phase
            prop = torch.sum(units & (cls >= CLS_WEIGHT), dtype=torch.int64)
            met = _batch_metrics(
                met, batch.state, count=count,
                resv=count.to(torch.int64) - prop, prop=prop,
                lb=torch.sum(units & (cls >= CLS_LB)),
                guards_ok=batch.guards_ok, rebase_fallback=trip,
                live=good)
        if tele:
            tele, gate_n = _tele_entry_fold(tele, st, batch, sel, now, good)
            tele = _tele_flight(
                tele, slot, cls, sel.entry_key[torch.clamp(slot, min=0)],
                length, good, margin=batch.margins, gate=gate_n)
    count, units, guards, slot, cls, length = (torch.stack(c)
                                               for c in zip(*outs))
    return ChainEpoch(state=carry.final(), count=count, unit_count=units,
                      guards_ok=guards, slot=slot, cls=cls, length=length,
                      metrics=met, **_tele_result(tele))


def make_prefix_runner(k: int, *, anticipation_ns: int = 0,
                       allow_limit_break: bool = False,
                       select_impl: str = "sort"):
    """Host-orchestrated prefix runner: ``(state, now) -> (state,
    decisions, n_committed)``.  One host read of ``guards_ok`` per call
    is its contract: when the global rebase guards fail
    (creation-order spread or a served cost past 2^31) the batch is
    rerun by the serial engine (``engine_run``, k steps at ``now``);
    a zero count with the guards intact means nothing is eligible at
    ``now``.  Both paths run on the state's device: the serial path is
    the JAX package's semantics, not a device fallback."""

    def run(state: EngineState, now):
        batch = speculate_prefix_batch(
            state, now, k, anticipation_ns=anticipation_ns,
            allow_limit_break=allow_limit_break, select_impl=select_impl)
        if not bool(batch.guards_ok):
            st, _, decs = engine_run(
                state, now, k, allow_limit_break=allow_limit_break,
                anticipation_ns=anticipation_ns, advance_now=False)
            return st, decs, int((decs.type == RETURNING).sum())
        return batch.state, batch.decisions, int(batch.count)

    return run


# ----------------------------------------------------------------------
# calendar commits (the cfg4 engine): no sort, per-client counts
# ----------------------------------------------------------------------
#
# The JAX module's calendar section gives the exactness argument: at a
# fixed ``now`` each client is followed through its own serve sequence
# (up to ``steps`` serves) while its unit entry packs increase; a client
# that cannot be followed further contributes its first unfollowable
# entry pack as a STOP, and every serve whose unit entry pack lies
# strictly below B_eff = min(stops) is exactly the serial engine's.  Two
# dense passes (measure the stops, then commit below B_eff) give the
# committed SET plus the final state; the batch emits per-client counts,
# not an ordered stream.  Packs are 2 class bits | a 58-bit per-class
# rebased key (clamping is monotone, hence only conservative).

_CAL_BIAS = 1 << 57
_CAL_MASK = (1 << 58) - 1
_CAL_IMPLS = ("minstop", "bucketed", "wheel")


class CalendarBatch(NamedTuple):
    """Result of one calendar-commit batch."""

    state: EngineState
    count: torch.Tensor        # int32 committed decisions
    resv_count: torch.Tensor   # int32 constraint-phase decisions
    units: torch.Tensor        # int32[N] committed units per client
    served: torch.Tensor       # int32[N] committed decisions per client
    served_resv: torch.Tensor  # int32[N] constraint decisions
    lb: torch.Tensor           # int32[N] limit-break entries (Allow)
    progress_ok: torch.Tensor  # bool: count > 0 or no candidate existed
    served_cost: torch.Tensor  # int64[N] delivered cost per client
    margin: torch.Tensor       # int64[N] B_eff minus the client's last
    #                            unit-entry pack (-1: not served or no
    #                            finite boundary)


def _check_steps(state: EngineState, steps: int) -> None:
    if not 0 < steps <= state.ring_capacity:
        raise ValueError(f"calendar steps {steps} not in (0, ring "
                         f"capacity {state.ring_capacity}]")


def _cal_pack(cls, key, kresv, kprop1, kprop2):
    """(class, key) as one pack rebased on the class origin.  ``key -
    origin`` is computed in every branch, also where the origin is
    KEY_INF; int64 wraps there and the branch is discarded (the JAX
    module does the same), so no branch waits on the host."""
    origin = torch.where(cls == CLS_RESV, kresv,
                         torch.where(cls == CLS_WEIGHT, kprop1, kprop2))
    rel = torch.clamp(key - origin + _CAL_BIAS, 0, _CAL_MASK)
    return torch.where(cls == CLS_NONE, KEY_INF,
                       (cls.to(torch.int64) << 58) | rel)


def _calendar_pass(state: EngineState, now, arr_rows, cost_rows,
                   allow: bool, anticipation_ns: int,
                   kresv, kprop1, kprop2, b_eff):
    """One dense pass of per-client serve iteration over the window rows
    (the JAX ``lax.scan`` over steps is a Python loop here).

    With ``b_eff`` None: measure mode -- serve everything followable and
    return the per-client STOP pack (KEY_INF when the client ran out of
    work).  With ``b_eff`` a 0-d tensor: commit mode -- serves gate on
    the unit entry pack being strictly below it; returns the final dense
    state fields and the per-client counters.

    Readiness is ``limit <= now`` at every step: under monotonic now a
    stored ready flag implies it, so the stored bit adds nothing."""
    n = state.capacity
    dev = state.device
    measure = b_eff is None
    i32 = dict(dtype=torch.int32, device=dev)

    h_resv, h_prop, h_limit = (state.head_resv, state.head_prop,
                               state.head_limit)
    h_arr, h_cost, h_rho = (state.head_arrival, state.head_cost,
                            state.head_rho)
    p_resv, p_prop, p_limit, p_arr = (state.prev_resv, state.prev_prop,
                                      state.prev_limit,
                                      state.prev_arrival)
    depth = state.depth
    qadv = torch.zeros((n,), **i32)
    cost = torch.zeros_like(h_cost)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    in_unit = torch.zeros((n,), dtype=torch.bool, device=dev)
    stop_pk = torch.full((n,), KEY_INF, dtype=torch.int64, device=dev)
    prev_pk = torch.full((n,), -1, dtype=torch.int64, device=dev)
    unit_cls = torch.zeros((n,), **i32)
    units = torch.zeros((n,), **i32)
    served = torch.zeros((n,), **i32)
    served_resv = torch.zeros((n,), **i32)
    lb = torch.zeros((n,), **i32)

    for narr, ncost in zip(arr_rows, cost_rows):
        has = state.active & (depth > 0)
        cls, key = _unified_class(now, has, h_resv, h_limit <= now,
                                  h_prop, h_prop + state.prop_delta, allow)
        pk = _cal_pack(cls, key, kresv, kprop1, kprop2)

        at_boundary = ~in_unit
        cand = cls != CLS_NONE
        nonmono = alive & at_boundary & cand & (pk < prev_pk)
        if measure:
            stop_pk = torch.where(nonmono, torch.minimum(stop_pk, prev_pk),
                                  stop_pk)
        alive = alive & ~(at_boundary & (~cand | nonmono))
        start = alive & at_boundary & cand
        if not measure:
            start = start & (pk < b_eff)
            alive = alive & ~(at_boundary & ~start)

        serve = start | (in_unit & alive)
        phase1 = start & (cls >= CLS_WEIGHT)

        nr, np_, nl = _make_tag(
            h_resv, h_prop, h_limit, h_arr,
            state.resv_inv, state.weight_inv, state.limit_inv,
            state.cur_delta, state.cur_rho, narr, ncost, anticipation_ns)
        off = torch.where(phase1, state.resv_inv * (h_cost + h_rho), 0)
        new_depth = depth - 1
        has_more = new_depth > 0
        updh = serve & has_more
        new_h_resv = nr - off
        pr = torch.where(has_more, _fold_prev(p_resv, nr), p_resv) - off
        pp = torch.where(has_more, _fold_prev(p_prop, np_), p_prop)
        pl_ = torch.where(has_more, _fold_prev(p_limit, nl), p_limit)

        unit_cls = torch.where(start, cls, unit_cls)
        cont_cls = (unit_cls == CLS_WEIGHT) | (unit_cls == CLS_LB)

        # counters first: they read the pre-step head cost and unit flag
        # (the head served at this step is the current one)
        cost = cost + torch.where(serve, h_cost, 0)
        served_resv = served_resv + ((start & (cls == CLS_RESV))
                                     | (serve & in_unit))
        units = units + start
        served = served + serve
        lb = lb + (start & (cls >= CLS_LB))
        prev_pk = torch.where(start, pk, prev_pk)
        in_unit = serve & cont_cls & has_more & (new_h_resv <= now)

        h_resv = torch.where(updh, new_h_resv, h_resv)
        h_prop = torch.where(updh, np_, h_prop)
        h_limit = torch.where(updh, nl, h_limit)
        h_arr = torch.where(updh, narr, h_arr)
        h_cost = torch.where(updh, ncost, h_cost)
        h_rho = torch.where(updh, state.cur_rho, h_rho)
        p_resv = torch.where(serve, pr, p_resv)
        p_prop = torch.where(serve, pp, p_prop)
        p_limit = torch.where(serve, pl_, p_limit)
        p_arr = torch.where(updh, narr, p_arr)
        depth = torch.where(serve, new_depth, depth).to(torch.int32)
        qadv = (qadv + updh).to(torch.int32)

    if measure:
        # post-loop stops: a chain still mid-unit cannot be followed
        # (exclude its whole unit); an alive client at a unit boundary
        # stops at its NEXT entry key
        stop_pk = torch.where(in_unit, torch.minimum(stop_pk, prev_pk),
                              stop_pk)
        has = state.active & (depth > 0)
        cls, key = _unified_class(now, has, h_resv, h_limit <= now,
                                  h_prop, h_prop + state.prop_delta, allow)
        pk = _cal_pack(cls, key, kresv, kprop1, kprop2)
        boundary_stop = alive & ~in_unit & (cls != CLS_NONE)
        nonmono_next = boundary_stop & (pk < prev_pk)
        return torch.where(
            boundary_stop,
            torch.minimum(stop_pk, torch.where(nonmono_next, prev_pk, pk)),
            stop_pk)

    fields = dict(head_resv=h_resv, head_prop=h_prop, head_limit=h_limit,
                  head_arrival=h_arr, head_cost=h_cost, head_rho=h_rho,
                  prev_resv=p_resv, prev_prop=p_prop, prev_limit=p_limit,
                  prev_arrival=p_arr, depth=depth)
    return (fields, qadv, units, served, served_resv, lb, prev_pk,
            unit_cls, cost)


def _calendar_batch_core(state: EngineState, now, arr_rows, cost_rows, *,
                         anticipation_ns: int, allow_limit_break: bool,
                         origins=None, stop_min=None, entry=None):
    """Measure + boundary + commit + promote of one calendar batch, given
    the window rows.  ``origins`` injects the ``(kresv, kprop1, kprop2,
    any_cand)`` pack origins (the wheel reads them from its bucket
    index); ``stop_min`` replaces the dense ``torch.min`` boundary (the
    wheel's stop-key scan).  Both must equal the dense reductions they
    replace bit for bit.  ``entry`` is the batch-entry ``(cls, key)``
    when the caller already classified the state.  Returns
    ``(CalendarBatch, b_eff)``."""
    if origins is None:
        cls0, key0 = entry if entry is not None \
            else _classify(state, now, allow_limit_break)

        def class_min(c):
            return torch.min(torch.where(cls0 == c, key0, KEY_INF))

        kresv, kprop1, kprop2 = (class_min(CLS_RESV),
                                 class_min(CLS_WEIGHT), class_min(CLS_LB))
        any_cand = torch.any(cls0 != CLS_NONE)
    else:
        kresv, kprop1, kprop2, any_cand = origins

    stop_pk = _calendar_pass(state, now, arr_rows, cost_rows,
                             allow_limit_break, anticipation_ns,
                             kresv, kprop1, kprop2, None)
    b_eff = torch.min(stop_pk) if stop_min is None else stop_min(stop_pk)
    (fields, qadv, units, served, served_resv, lb, last_pk,
     last_cls, cost_pc) = _calendar_pass(
         state, now, arr_rows, cost_rows, allow_limit_break,
         anticipation_ns, kresv, kprop1, kprop2, b_eff)

    did = served > 0
    popped = did & (qadv > 0)
    pick = torch.where
    new_state = state._replace(
        depth=pick(did, fields["depth"], state.depth),
        q_head=pick(popped, (state.q_head + qadv) % state.ring_capacity,
                    state.q_head).to(torch.int32),
        head_resv=pick(popped, fields["head_resv"], state.head_resv),
        head_prop=pick(popped, fields["head_prop"], state.head_prop),
        head_limit=pick(popped, fields["head_limit"], state.head_limit),
        head_arrival=pick(popped, fields["head_arrival"],
                          state.head_arrival),
        head_cost=pick(popped, fields["head_cost"], state.head_cost),
        head_rho=pick(popped, fields["head_rho"], state.head_rho),
        head_ready=state.head_ready & ~did,
        prev_resv=pick(did, fields["prev_resv"], state.prev_resv),
        prev_prop=pick(did, fields["prev_prop"], state.prev_prop),
        prev_limit=pick(did, fields["prev_limit"], state.prev_limit),
        prev_arrival=pick(popped, fields["prev_arrival"],
                          state.prev_arrival),
    )

    # stored-flag parity (promote loop): the batch's LAST serial decision
    # is the unit with the max entry pack (ties by creation order: the
    # first maximal index, as torch.argmax returns it); if its class is
    # >= 1, its entry ran the final promote pass, whose only unseen head
    # is the one that unit's own chain popped into place
    lp = torch.where(did, last_pk, -1)
    tied = did & (lp == torch.max(lp))
    excl = torch.argmax(torch.where(tied, state.order, -1)).to(torch.int32)
    cls_last = torch.max(torch.where(tied, last_cls, -1))
    do_promote = torch.any(did) & (cls_last >= CLS_WEIGHT)
    has_req_after = new_state.active & (new_state.depth > 0)
    promoted = new_state.head_ready | \
        (has_req_after & (new_state.head_limit <= now))
    promoted = promoted & (
        torch.arange(state.capacity, dtype=torch.int32, device=state.device)
        != excl)
    new_state = new_state._replace(head_ready=torch.where(
        do_promote, promoted, new_state.head_ready))

    count = torch.sum(served).to(torch.int32)
    batch = CalendarBatch(
        state=new_state, count=count,
        resv_count=torch.sum(served_resv).to(torch.int32),
        units=units, served=served, served_resv=served_resv, lb=lb,
        progress_ok=(count > 0) | ~any_cand,
        served_cost=torch.where(did, cost_pc, 0),
        margin=torch.where(did & (b_eff < KEY_INF), b_eff - last_pk, -1))
    return batch, b_eff


def calendar_batch(state: EngineState, now, *, steps: int,
                   anticipation_ns: int = 0,
                   allow_limit_break: bool = False) -> CalendarBatch:
    """One calendar-commit batch (``calendar_impl="minstop"``): up to
    ``steps`` decisions PER CLIENT in two dense passes, no sort.  The
    committed set is exactly the serial engine's next ``count``
    decisions.  ``progress_ok`` False (count 0 with candidates present)
    means the very first serial unit is unfollowable within ``steps``:
    the caller falls back to the serial engine."""
    _check_steps(state, steps)
    now = as_scalar(now, state.device)
    win = ring_window(state, steps)
    arr_rows, cost_rows = _heads_rows((win.arr, win.cost), steps)
    batch, _ = _calendar_batch_core(
        state, now, arr_rows, cost_rows, anticipation_ns=anticipation_ns,
        allow_limit_break=allow_limit_break)
    return batch


# ----------------------------------------------------------------------
# the timer wheel: a maintained bucket index over the entry keys
# ----------------------------------------------------------------------
#
# calendar_impl="wheel" keeps the bucketed ladder's commit structure and
# reads each level's origins and boundary from bucket wheels instead of
# dense [N] reductions: three per-class wheels (count + exact min per
# bucket) built once per batch and adjusted in place between levels
# (only the clients a commit served re-slot), and a transient stop-key
# wheel per level, scanned for its first occupied bucket.  Both scans
# are kernel K2 on the card.  Every wheel read equals the dense
# reduction it replaces (kernels.py, wheel section), so the committed
# set, state and counters equal the bucketed ladder's.  The in-place
# adjust is exact because at a fixed now an unserved client's (class,
# key) cannot change across a commit.

_WHEEL_BUCKETS = 256
_WHEEL_SHIFT = 20        # 2^20 ns ~ 1 ms fine buckets, ~268 ms span
_WHEEL_STOP_SHIFT = 52   # stop packs live in [0, 2^60): 256 buckets


class WheelIndex(NamedTuple):
    """Three class wheels of ``_WHEEL_BUCKETS`` buckets on one axis
    (slot = cls * B + bucket; 3B = unslotted), plus the per-client
    slot/key mirror the in-place adjust needs."""

    origin: torch.Tensor   # int64 bucket-0 left edge (all 3 wheels)
    cnt: torch.Tensor      # int32[3B] occupancy per (class, bucket)
    bmin: torch.Tensor     # int64[3B] exact min key per bucket
    slot: torch.Tensor     # int32[N] current slot (3B = unslotted)
    key: torch.Tensor      # int64[N] slotted key (where slot < 3B)
    reslots: torch.Tensor  # int64 in-place re-slots since build
    hwm: torch.Tensor      # int64 bucket-occupancy high-water mark


def _wheel_slots(cls, key, origin):
    """(class, key) -> wheel slot; non-candidates unslot (3B)."""
    b = wheel_slot(key, origin, _WHEEL_SHIFT, _WHEEL_BUCKETS)
    return torch.where(cls == CLS_NONE, 3 * _WHEEL_BUCKETS,
                       cls * _WHEEL_BUCKETS + b).to(torch.int32)


def wheel_build(state: EngineState, now, allow: bool) -> WheelIndex:
    """Full bucket-scatter of the entry classification (one K2 launch on
    the card), once per batch; levels adjust in place from here."""
    now = as_scalar(now, state.device)
    cls, key = _classify(state, now, allow)
    origin = now - ((_WHEEL_BUCKETS // 2) << _WHEEL_SHIFT)
    slot = _wheel_slots(cls, key, origin)
    cnt, bmin, _val, _found = wheel_scan(key, slot, 3 * _WHEEL_BUCKETS)
    return WheelIndex(origin=origin, cnt=cnt, bmin=bmin, slot=slot,
                      key=key,
                      reslots=torch.zeros((), dtype=torch.int64,
                                          device=state.device),
                      hwm=torch.max(cnt).to(torch.int64))


def wheel_origins(w: WheelIndex):
    """Batch-entry pack origins read from the wheel: per class, the
    first occupied bucket's stored min, equal to the dense masked min.
    Returns ``(kresv, kprop1, kprop2, any_cand)``."""
    b = _WHEEL_BUCKETS
    vals, _b0, found = wheel_nearest(w.cnt.reshape(3, b),
                                     w.bmin.reshape(3, b))
    return vals[0], vals[1], vals[2], torch.any(found)


def _with_drop_bucket(x, fill):
    """``x`` with one more bucket, the target of masked lanes."""
    return torch.cat([x, x.new_full((1,), fill)])


def wheel_adjust(w: WheelIndex, state: EngineState, now, allow: bool,
                 moved) -> WheelIndex:
    """In-place re-slot of exactly the ``moved`` clients: decrement their
    old buckets, increment the new ones, and recompute the min of only
    the touched buckets from the stored keys.  Equals
    :func:`wheel_build` of the new state whenever ``moved`` covers every
    client whose (class, key) changed.  The three drop-mode scatters of
    the JAX module write ``nb + 1`` buckets here; the last takes the
    masked lanes and is cut off."""
    nb = 3 * _WHEEL_BUCKETS
    now = as_scalar(now, state.device)
    cls, key = _classify(state, now, allow)
    new_slot = _wheel_slots(cls, key, w.origin)
    slot2 = torch.where(moved, new_slot, w.slot)
    key2 = torch.where(moved, key, w.key)
    out_s = torch.where(moved, w.slot, nb).to(torch.int64)
    in_s = torch.where(moved, slot2, nb).to(torch.int64)
    ones = torch.ones_like(w.slot)
    cnt2 = _with_drop_bucket(w.cnt, 0).index_add_(0, out_s, -ones) \
        .index_add_(0, in_s, ones)[:nb]
    touched = torch.zeros((nb + 1,), dtype=torch.bool, device=key.device) \
        .index_fill_(0, out_s, True).index_fill_(0, in_s, True)[:nb]
    fresh = torch.full((nb + 1,), KEY_INF, dtype=torch.int64,
                       device=key.device) \
        .scatter_reduce_(0, slot2.to(torch.int64), key2, "amin")[:nb]
    changed = moved & ((slot2 != w.slot) | (key2 != w.key))
    return WheelIndex(
        origin=w.origin, cnt=cnt2,
        bmin=torch.where(touched, fresh, w.bmin), slot=slot2, key=key2,
        reslots=w.reslots + torch.sum(changed),
        hwm=torch.maximum(w.hwm, torch.max(cnt2).to(torch.int64)))


def _wheel_stop_min(stop_pk):
    """The level boundary B_eff as the stop wheel's bucket-scatter +
    first-occupied scan (one K2 launch on the card), equal to
    ``torch.min(stop_pk)``: stop packs are non-negative and below 2^60,
    so 256 buckets of 2^52 cover them, and an all-KEY_INF distribution
    returns KEY_INF like the dense min."""
    slot = torch.where(stop_pk < KEY_INF,
                       wheel_slot(stop_pk, 0, _WHEEL_STOP_SHIFT,
                                  _WHEEL_BUCKETS),
                       _WHEEL_BUCKETS).to(torch.int32)
    _cnt, _bmin, val, _found = wheel_scan(stop_pk, slot, _WHEEL_BUCKETS)
    return val


# ----------------------------------------------------------------------
# the bucketed ladder: L refreshed-budget boundaries per batch
# ----------------------------------------------------------------------
#
# The minstop boundary lets the single most conservative client truncate
# the whole batch (on a Zipf population the heavy client exhausts its
# ``steps`` budget at a low key).  The ladder runs L levels per batch:
# each re-prefetches the ring window from the committed state (a fresh
# per-client budget), measures fresh stops, and commits the exact serial
# prefix below its own boundary, so the concatenated levels are one
# serial prefix.

class CalendarLadderBatch(NamedTuple):
    """Result of one bucketed (or wheel) calendar batch of L levels; the
    committed set is one serial prefix of ``count`` decisions."""

    state: EngineState
    count: torch.Tensor        # int32 committed decisions (all levels)
    resv_count: torch.Tensor   # int32 constraint-phase decisions
    units: torch.Tensor        # int32[N] committed units per client
    served: torch.Tensor       # int32[N] committed decisions per client
    served_resv: torch.Tensor  # int32[N] constraint decisions
    lb: torch.Tensor           # int32[N] limit-break entries (Allow)
    progress_ok: torch.Tensor  # bool: level 0 committed or had no
    #                            candidate
    level_count: torch.Tensor  # int32[L] decisions per level
    level_bound: torch.Tensor  # int64[L] committed boundary per level
    level_stall: torch.Tensor  # bool[L] committed 0 with candidates
    served_cost: torch.Tensor  # int64[N] delivered cost (all levels)


def _calendar_ladder(state: EngineState, now, *, steps: int, levels: int,
                     anticipation_ns: int, allow: bool, wheel: bool,
                     tele: dict | None = None):
    """L ladder levels, each a window prefetch (K1 on the card) + measure
    + boundary + commit from the previous level's committed state.  With
    ``wheel`` the origins and boundaries come from the wheel index (one
    K2 launch to build it, one per level for the stop wheel).  Returns
    ``(CalendarLadderBatch, wheel_stats, tele_out)`` with ``wheel_stats``
    the ``(reslots, occupancy hwm)`` int64 pair, or None.

    ``tele`` (the epoch's telemetry dict, or None) turns on the per-LEVEL
    telemetry of the JAX package's ``_calendar_ladder_scan``: each level
    classifies its own entry state, so a level observes what one minstop
    batch would.  ``tele_out`` is then a dict of the zero-based
    histogram/ledger/window deltas summed over the levels, the
    provenance block threaded through the levels as full state (the
    caller selects it on liveness), ``"margin"`` with a flight ring (each
    client's newest boundary margin, -1 = none) and ``"entry"`` (level
    0's ``(cls, key)``, the batch entry's); else None."""
    _check_steps(state, steps)
    if levels < 1:
        raise ValueError("the ladder needs at least one level")
    dev = state.device
    now = as_scalar(now, dev)
    w = wheel_build(state, now, allow) if wheel else None
    zeros = torch.zeros((state.capacity,), dtype=torch.int32, device=dev)
    units = served = served_resv = lb = zeros
    cost = torch.zeros_like(state.head_cost)
    tacc = None
    if tele is not None:
        tacc = {"p": tele["p"]} if "p" in tele else {}
    counts, resvs, bounds, stalls = [], [], [], []
    st = state
    for lvl in range(levels):
        win = ring_window(st, steps)
        arr_rows, cost_rows = _heads_rows((win.arr, win.cost), steps)
        entry = _classify(st, now, allow) if tele is not None else None
        batch, b_eff = _calendar_batch_core(
            st, now, arr_rows, cost_rows,
            anticipation_ns=anticipation_ns, allow_limit_break=allow,
            origins=None if w is None else wheel_origins(w),
            stop_min=None if w is None else _wheel_stop_min, entry=entry)
        if w is not None:
            # fixed-now commit: exactly the served clients moved
            w = wheel_adjust(w, batch.state, now, allow, batch.served > 0)
        units = units + batch.units
        served = served + batch.served
        served_resv = served_resv + batch.served_resv
        lb = lb + batch.lb
        cost = cost + batch.served_cost
        if tacc is not None:
            _ladder_level_tele(tacc, tele, st, batch, now, entry)
            if lvl == 0:
                tacc["entry"] = entry
        counts.append(batch.count)
        resvs.append(batch.resv_count)
        bounds.append(b_eff)
        # a level that commits nothing with candidates present is a
        # ladder stall (later levels repeat it: same state, same bound)
        stalls.append(~batch.progress_ok)
        st = batch.state
    count = torch.stack(counts)
    stall = torch.stack(stalls)
    ladder = CalendarLadderBatch(
        state=st, count=torch.sum(count).to(torch.int32),
        resv_count=torch.sum(torch.stack(resvs)).to(torch.int32),
        units=units, served=served, served_resv=served_resv, lb=lb,
        progress_ok=~stall[0], level_count=count,
        level_bound=torch.stack(bounds), level_stall=stall,
        served_cost=cost)
    return ladder, (None if w is None else (w.reslots, w.hwm)), tacc


def _ladder_level_tele(tacc: dict, tele: dict, st: EngineState, batch,
                       now, entry) -> None:
    """Accumulate one ladder level's telemetry into ``tacc`` in place:
    the level's deltas combine (hists and windows add, the ledger's max
    column maxes), provenance observes, and the newest margin wins."""
    cls_e, key_e = entry
    hd, ld, sd = _telemetry_delta(
        batch.state, now, cls_e, key_e, batch.served, batch.served_resv,
        batch.lb, batch.count, "h" in tele, "l" in tele,
        cost_pc=batch.served_cost, with_slo="s" in tele)
    for key, delta, combine in (("h", hd, obshist.hist_combine),
                                ("l", ld, obshist.ledger_combine),
                                ("s", sd, obsslo.window_combine)):
        if delta is not None:
            tacc[key] = delta if key not in tacc \
                else combine(tacc[key], delta)
    if "p" in tacc:
        tacc["p"] = _prov_observe(tacc["p"], now, cls_e,
                                  *_entry_gate(st, cls_e), batch.served,
                                  batch.margin)
    if "f" in tele:
        prev = tacc.get("margin")
        tacc["margin"] = batch.margin if prev is None else \
            torch.where(batch.margin >= 0, batch.margin, prev)


def calendar_batch_bucketed(state: EngineState, now, *, steps: int,
                            levels: int, anticipation_ns: int = 0,
                            allow_limit_break: bool = False
                            ) -> CalendarLadderBatch:
    """One bucketed calendar batch: ``levels`` ladder levels, each
    committing the exact serial prefix below its own refreshed stop-key
    boundary.  With ``levels=1`` it equals :func:`calendar_batch`."""
    return _calendar_ladder(state, now, steps=steps, levels=levels,
                            anticipation_ns=anticipation_ns,
                            allow=allow_limit_break, wheel=False)[0]


def calendar_batch_wheel(state: EngineState, now, *, steps: int,
                         levels: int, anticipation_ns: int = 0,
                         allow_limit_break: bool = False
                         ) -> CalendarLadderBatch:
    """One wheel calendar batch: the bucketed ladder driven by the
    maintained bucket index, equal to :func:`calendar_batch_bucketed`
    at the same ``levels`` on every field and the state.  On the card
    every wheel scan is kernel K2."""
    return _calendar_ladder(state, now, steps=steps, levels=levels,
                            anticipation_ns=anticipation_ns,
                            allow=allow_limit_break, wheel=True)[0]


class CalendarEpoch(NamedTuple):
    """M calendar batches' output, stacked on the device."""

    state: EngineState
    count: torch.Tensor        # int32[M] decisions per batch
    resv_count: torch.Tensor   # int32[M]
    progress_ok: torch.Tensor  # bool[M]
    served: torch.Tensor       # int32[N] per-client decisions (epoch)
    metrics: torch.Tensor      # int64[NUM_METRICS] (zeros unless
    #                            with_metrics)
    level_count: torch.Tensor  # int32[M, L] decisions per ladder level
    #                            (L = 1 for "minstop")
    hists: object = None       # telemetry accumulators, as PrefixEpoch
    ledger: object = None
    flight: object = None
    slo: object = None
    prov: object = None


def scan_calendar_epoch(state: EngineState, now, m: int, *, steps: int,
                        anticipation_ns: int = 0,
                        allow_limit_break: bool = False,
                        with_metrics: bool = False,
                        tag_width: int = 64,
                        calendar_impl: str = "minstop",
                        ladder_levels: int = 8,
                        hists=None, ledger=None, flight=None, slo=None,
                        prov=None) -> CalendarEpoch:
    """Run m calendar batches, each prefetching its own ``steps``-row ring
    window.  ``calendar_impl`` picks the commit boundary: "minstop" (one
    global min-stop per batch), "bucketed" (``ladder_levels`` refreshed
    boundaries per batch) or "wheel" (the bucketed ladder on the wheel
    index).  All commit exact serial prefixes; ``ladder_levels=1``
    equals "minstop".

    The device picks the wheel's scan, as it picks K1's: a CUDA state
    launches kernel K2 (or raises), a CPU state runs its plain version;
    there is no switch and no fallback, so the ``pallas_fallbacks``
    metric row, kept for parity with the JAX package, is always 0.

    ``tag_width=32`` carries the tag fields as int32 epoch offsets, as
    in :func:`scan_prefix_epoch`: a window trip reports
    ``progress_ok=False`` and zero counts for that batch and every later
    one, and the ladder and wheel rows of dead batches are 0.

    The telemetry accumulators as in :func:`scan_prefix_epoch`.
    Histogram, ledger, window and provenance observations are per LEVEL
    (a ladder level is one minstop batch, so bucketed-L telemetry equals
    the L-batch minstop composition); flight records are one per client
    per batch, the cost column carrying the client's decisions."""
    if calendar_impl not in _CAL_IMPLS:
        raise ValueError(f"calendar_impl {calendar_impl!r} not in "
                         f"{_CAL_IMPLS}")
    wheel = calendar_impl == "wheel"
    bucketed = calendar_impl == "bucketed" or wheel
    dev = state.device
    now = as_scalar(now, dev)
    carry = _EpochCarry(state, tag_width)
    met = carry.metrics0(with_metrics)
    tele = _tele_init(state, hists, ledger, flight, slo, prov)
    served_acc = torch.zeros((state.capacity,), dtype=torch.int32,
                             device=dev)
    counts, resvs, oks, lvls = [], [], [], []
    for _ in range(m):
        st = carry.state()
        w_reslots = w_hwm = 0
        if bucketed:
            lad, wstats, tacc = _calendar_ladder(
                st, now, steps=steps, levels=int(ladder_levels),
                anticipation_ns=anticipation_ns, allow=allow_limit_break,
                wheel=wheel, tele=tele or None)
            if wstats is not None:
                w_reslots, w_hwm = wstats
            batch_state, count, resv_count = (lad.state, lad.count,
                                              lad.resv_count)
            progress, served, lb = lad.progress_ok, lad.served, lad.lb
            lvl_count = lad.level_count
            levels_used = torch.sum(lvl_count > 0)
            ladder_fb = torch.any(lad.level_stall).to(torch.int64)
            base_decs = lvl_count[0].to(torch.int64)
        else:
            tacc = None
            if tele:
                # one level: the batch-entry classification is shared
                # by the boundary origins and the telemetry
                tacc = {"p": tele["p"]} if "p" in tele else {}
                tacc["entry"] = _classify(st, now, allow_limit_break)
            win = ring_window(st, steps)
            arr_rows, cost_rows = _heads_rows((win.arr, win.cost), steps)
            batch, _ = _calendar_batch_core(
                st, now, arr_rows, cost_rows,
                anticipation_ns=anticipation_ns,
                allow_limit_break=allow_limit_break,
                entry=None if tacc is None else tacc["entry"])
            if tacc is not None:
                _ladder_level_tele(tacc, tele, st, batch, now,
                                   tacc["entry"])
            batch_state, count, resv_count = (batch.state, batch.count,
                                              batch.resv_count)
            progress, served, lb = batch.progress_ok, batch.served, batch.lb
            lvl_count = count.reshape(1)
            levels_used = (count > 0).to(torch.int64)
            ladder_fb = 0
            base_decs = count.to(torch.int64)
        lb_total = torch.sum(lb) if with_metrics else 0
        (count, resv_count, progress, served, lb_total, lvl_count,
         levels_used, ladder_fb, base_decs, w_reslots, w_hwm), good, trip = \
            carry.commit(batch_state, [
                (count, 0), (resv_count, 0), (progress, False),
                (served, 0), (lb_total, 0), (lvl_count, 0),
                (levels_used, 0), (ladder_fb, 0), (base_decs, 0),
                (w_reslots, 0), (w_hwm, 0)])
        if with_metrics:
            # a batch with candidates that cannot make progress is the
            # guard-trip analog (serial fallback); a dead batch's
            # progress is False and its live gate clears the trip
            met = _batch_metrics(
                met, batch_state, count=count, resv=resv_count,
                prop=count - resv_count, lb=lb_total,
                guards_ok=progress, rebase_fallback=trip, live=good,
                ladder_levels_used=levels_used,
                ladder_base_decisions=base_decs,
                ladder_fallbacks=ladder_fb, wheel_occ_hwm=w_hwm,
                wheel_reslots=w_reslots)
        if tele:
            tele = _tele_fold(tele, tacc.get("h"), tacc.get("l"), good,
                              tacc.get("s"))
            if "p" in tele:
                tele["p"] = obsprov.prov_select(good, tacc["p"], tele["p"])
            if "f" in tele:
                # one record per served client (gated counts, so a dead
                # batch records nothing), classed by the batch entry
                cls_e, key_e = tacc["entry"]
                gate_n = torch.sum(_entry_gate(st, cls_e)[1],
                                   dtype=torch.int64)
                iota = torch.arange(st.capacity, dtype=torch.int32,
                                    device=dev)
                tele = _tele_flight(
                    tele, torch.where(served > 0, iota, -1), cls_e, key_e,
                    served, good, margin=tacc["margin"], gate=gate_n)
        counts.append(count)
        resvs.append(resv_count)
        oks.append(progress)
        lvls.append(lvl_count)
        served_acc = served_acc + served
    return CalendarEpoch(state=carry.final(), count=torch.stack(counts),
                         resv_count=torch.stack(resvs),
                         progress_ok=torch.stack(oks), served=served_acc,
                         metrics=met, level_count=torch.stack(lvls),
                         **_tele_result(tele))


def calendar_stop_ladder(state: EngineState, now, *, steps: int,
                         levels: int, anticipation_ns: int = 0,
                         allow_limit_break: bool = False, heads=None):
    """The planner view of the ladder: one measure pass, then
    the stop-key CDF quantiles B_1 <= ... <= B_levels of the finite stop
    packs (``kernels.radix_quantile_ladder``).  B_1 is exactly the
    minstop boundary; the higher quantiles predict where successive
    refreshed-budget levels land on a skewed stop distribution (a
    diagnostic: the commit path re-measures per level).  ``heads`` is a
    ``(arr, cost)`` pair of [w, N] window rows with w >= ``steps`` (None:
    one K1 prefetch here).  Returns ``(ladder int64[levels], stop_pk
    int64[N])``."""
    _check_steps(state, steps)
    now = as_scalar(now, state.device)
    if heads is None:
        win = ring_window(state, steps)
        heads = (win.arr, win.cost)
    arr_rows, cost_rows = _heads_rows(heads, steps)
    cls0, key0 = _classify(state, now, allow_limit_break)

    def class_min(c):
        return torch.min(torch.where(cls0 == c, key0, KEY_INF))

    stop_pk = _calendar_pass(state, now, arr_rows, cost_rows,
                             allow_limit_break, anticipation_ns,
                             class_min(CLS_RESV), class_min(CLS_WEIGHT),
                             class_min(CLS_LB), None)
    return radix_quantile_ladder(stop_pk, levels), stop_pk


# ----------------------------------------------------------------------
# epoch-engine dispatch: the one registry + kwargs normalization
# ----------------------------------------------------------------------
#
# Every later plane (the queue, the stream chunk, the guarded runner,
# the supervisor, the mesh) resolves "engine name -> scan function + the
# kwargs that engine takes" here, so a knob cannot reach one loop and
# miss another.

EPOCH_ENGINES = ("prefix", "chain", "calendar")

# Decision-stream fields by layout, for a client-id-space digest: SLOT
# fields hold client slot indices (-1 pads); CAPACITY fields are
# per-slot arrays over the whole [capacity] axis.
DECISION_SLOT_FIELDS = {"prefix": ("slot",), "chain": ("slot",),
                        "calendar": ()}
DECISION_CAPACITY_FIELDS = {"prefix": (), "chain": (),
                            "calendar": ("served",)}


def epoch_scan_fn(engine: str):
    """The epoch-scan function of ``engine`` (KeyError on an unknown
    name)."""
    return {"prefix": scan_prefix_epoch, "chain": scan_chain_epoch,
            "calendar": scan_calendar_epoch}[engine]


def epoch_scan_kwargs(engine: str, *, k: int = 0, chain_depth: int = 4,
                      select_impl: str = "sort", tag_width: int = 64,
                      window_m: int | None = None,
                      calendar_impl: str = "minstop",
                      ladder_levels: int = 8,
                      anticipation_ns: int = 0,
                      allow_limit_break: bool = False,
                      with_metrics: bool = False) -> dict:
    """The shared knob set as the kwargs ``engine``'s scan takes: prefix
    reads k/select_impl/window_m, chain reads k/select_impl/chain_depth,
    and the calendar engine has no [k] cap -- k is its per-client
    serve-step budget (``steps``).  The JAX package's ``wheel_kernel``
    knob has no counterpart: the device picks K2's route."""
    if engine not in EPOCH_ENGINES:
        raise ValueError(f"unknown epoch engine {engine!r} "
                         f"(one of {EPOCH_ENGINES})")
    kw = dict(anticipation_ns=anticipation_ns,
              allow_limit_break=allow_limit_break,
              with_metrics=with_metrics, tag_width=tag_width)
    if engine == "prefix":
        kw.update(k=k, select_impl=select_impl, window_m=window_m)
    elif engine == "chain":
        kw.update(k=k, select_impl=select_impl, chain_depth=chain_depth)
    else:
        kw.update(steps=max(k, 1), calendar_impl=calendar_impl,
                  ladder_levels=ladder_levels)
    return kw
