"""Prefix-commit speculative serving: thousands of decisions per O(N)
pass, on tensors.

Counterpart of ``dmclock_tpu/engine/fastpath.py`` (the flat prefix
path: ring window, classification, serve chains, sort selection,
``speculate_prefix_batch`` and ``scan_prefix_epoch``).  The exactness
argument is the JAX module's: at a fixed ``now`` the serial engine
serves the minimum of one unified (class, key, creation order) key
space; one sort of the packed keys gives the whole candidate service
order, and the longest prefix whose served clients re-enter strictly
after it is exactly what the serial engine would serve.

The ring window is kernel K1 (``csrc/ring_window.cu``) on a CUDA state
and its plain PyTorch version on a CPU state.  Everything else is
PyTorch.  The epoch is a Python loop over batches; counts, guards and
metrics stay on the device and are stacked once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.timebase import MAX_TAG
from ..obs import device as obsdev
from . import _ext
from .kernels import (KEY_INF, NONE, RETURNING, Decision, _fold_prev,
                      _make_tag, as_scalar)
from .state import EngineState

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

_LATER = "a later slice of the port (ROADMAP.md, 'Modules to port')"


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


def ring_window_rows(q_arrival, q_cost, q0, wsize: int):
    """K1's wrapper: the [wsize, N] windows of both tail rings.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (building it at first use) or raises -- there is no
    fallback.  Checks dtypes (int64 rings, int32 ``q0``), shapes,
    contiguity and device."""
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
    if dev.type == "cpu":
        return (_ring_window_torch(q_arrival, q0, wsize),
                _ring_window_torch(q_cost, q0, wsize))
    if dev.type != "cuda":
        raise ValueError(f"ring_window: unsupported device {dev}")
    if not (q_arrival.is_contiguous() and q_cost.is_contiguous()
            and q0.is_contiguous()):
        raise ValueError("ring_window: inputs must be contiguous")
    if wsize > 65535:
        raise ValueError(f"ring_window: window {wsize} > 65535 rows")
    launch = _ext.kernel()
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


def _unified_prefix(state: EngineState, now, k: int, *,
                    chain_depth: int, anticipation_ns: int,
                    allow: bool, heads, max_count,
                    select_impl: str = "sort") -> _Selection:
    """Classify, chain, sort, and commit the longest exact prefix."""
    if select_impl != "sort":
        raise NotImplementedError(
            f"select_impl={select_impl!r} is {_LATER}; use 'sort'")
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

    # packed keys are unique among candidates (creation order is in
    # them); ties exist only among KEY_INF sentinel rows, whose
    # payloads are masked past the committed count
    pks, perm = torch.sort(pk_dense, stable=True)
    idxs = perm.to(torch.int32)
    rpk = epk[perm]
    costs = state.head_cost.to(torch.int32)[perm]
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
                      margin_s=margin_s)


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
                       cost_pc=s.cost_pc, margins=s.margin_s)


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


def _batch_metrics(met, st: EngineState, *, count, resv, prop, lb,
                   guards_ok):
    """Fold one batch's contribution into the epoch metrics vector.  A
    stall is a batch that committed nothing while work sat queued."""
    queued = torch.any(st.active & (st.depth > 0))
    stall = (count == 0) & queued
    return obsdev.metrics_combine(met, obsdev.metrics_delta(
        device=st.device,
        decisions=count.to(torch.int64), resv=resv.to(torch.int64),
        prop=prop.to(torch.int64), limit_break=lb.to(torch.int64),
        stalls=stall.to(torch.int64),
        ring_hwm=torch.max(st.depth).to(torch.int64),
        guard_trips=(~guards_ok).to(torch.int64)))


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
    batch without committing.  ``window_m`` (must divide m) refreshes
    the ring window every ``window_m`` batches; None = one m-row window.
    ``with_metrics`` accumulates the ``obs.device`` vector; decisions
    and state are identical either way.

    ``select_impl="radix"``, ``tag_width=32`` and the telemetry
    accumulators (``hists``, ``ledger``, ``flight``, ``slo``, ``prov``)
    are later slices of the port and raise NotImplementedError."""
    if select_impl != "sort":
        raise NotImplementedError(
            f"select_impl={select_impl!r} is {_LATER}")
    if tag_width != 64:
        raise NotImplementedError(f"tag_width={tag_width} is {_LATER}")
    tele = dict(hists=hists, ledger=ledger, flight=flight, slo=slo,
                prov=prov)
    on = sorted(name for name, v in tele.items() if v is not None)
    if on:
        raise NotImplementedError(f"telemetry accumulators {on} are "
                                  f"{_LATER}")
    w = m if window_m is None else min(int(window_m), m)
    if not (w > 0 and m % w == 0):
        raise ValueError("window_m must divide m")
    dev = state.device
    now = as_scalar(now, dev)
    met = obsdev.metrics_zero(dev)
    counts, guards, slots, phases, costs, lbs = [], [], [], [], [], []
    st = state
    for _chunk in range(m // w):
        window = ring_window(st, w)
        for _ in range(w):
            batch = speculate_prefix_batch(
                st, now, k, anticipation_ns=anticipation_ns,
                heads=_window_heads(st, window),
                allow_limit_break=allow_limit_break)
            st = batch.state
            dec = batch.decisions
            phase = dec.phase.to(torch.int8)
            counts.append(batch.count)
            guards.append(batch.guards_ok)
            slots.append(dec.slot)
            phases.append(phase)
            costs.append(dec.cost.to(torch.int32))
            lbs.append(dec.limit_break)
            if with_metrics:
                resv = torch.sum((dec.slot >= 0) & (phase == 0))
                met = _batch_metrics(
                    met, st, count=batch.count, resv=resv,
                    prop=batch.count - resv,
                    lb=torch.sum(dec.limit_break),
                    guards_ok=batch.guards_ok)
    return PrefixEpoch(state=st, count=torch.stack(counts),
                       guards_ok=torch.stack(guards),
                       slot=torch.stack(slots), phase=torch.stack(phases),
                       cost=torch.stack(costs), lb=torch.stack(lbs),
                       metrics=met)
