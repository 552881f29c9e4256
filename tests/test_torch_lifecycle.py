"""The port's lifecycle plane (``dmclock_tpu_torch/lifecycle``) against
the JAX package's (``dmclock_tpu/lifecycle``), exactly.

- the slot map, validation and the churn specs;
- ``apply_op_vector``: the port folds the ordered rows on the host and
  scatters once per field; on seeded random vectors with repeated slots
  and every order of kinds it equals the JAX package's ordered scan;
- growth and ``compact_tree``;
- ``boundary`` after ``boundary`` of a churn loop (registrations, QoS
  updates, evictions, slot recycling, growth, compaction) with the
  ledger, the SLO block and extras riding it: state, ledger, SLO block,
  extras, counters, snapshot, departed rows and the slot map after every
  boundary;
- the admin WAL, the admin API in process and over HTTP;
- ``encode`` / ``load`` across the packages;
- ``run_serial_churn``: the port's digest equals the JAX package's, and
  a dynamic run equals its static variant, for every scenario;
- the digest gate on the port's three epoch engines.
"""

import hashlib
import json
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmclock_tpu.lifecycle as JL
import dmclock_tpu.lifecycle.plane as JPL
import dmclock_tpu.obs.histograms as JH
import dmclock_tpu.obs.registry as JR
import dmclock_tpu.obs.slo as JSLO
import dmclock_tpu.robust.guarded as JG
import dmclock_tpu_torch.lifecycle as TL
import dmclock_tpu_torch.lifecycle.plane as TPL
import dmclock_tpu_torch.obs.histograms as TH
import dmclock_tpu_torch.obs.registry as TR
import dmclock_tpu_torch.obs.slo as TSLO
import dmclock_tpu_torch.robust.guarded as TG
from dmclock_tpu.core.qos import ClientInfo as JClientInfo
from dmclock_tpu.engine import stream as jstream
from dmclock_tpu.engine.state import grow_state as j_grow
from dmclock_tpu.engine.state import init_state as j_init
from dmclock_tpu_torch.engine import bridge
from dmclock_tpu_torch.engine import stream as tstream
from dmclock_tpu_torch.engine.state import grow_state as t_grow
from dmclock_tpu_torch.engine.state import init_state as t_init
from dmclock_tpu_torch.robust.digest import digest_update

from test_torch_support import (assert_np_equal, jax_to_np, random_state,
                                to_jax, to_torch)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def _state_np(st):
    if isinstance(st.active, torch.Tensor):
        return bridge.state_to_numpy(st)
    return jax_to_np(st)


def assert_states(a, b):
    a, b = _state_np(a), _state_np(b)
    for f in a:
        assert_np_equal(f, a[f], b[f])


JAX = types.SimpleNamespace(
    L=JL, PL=JPL, H=JH, R=JR, SLO=JSLO, G=JG, stream=jstream,
    init=lambda n, q: j_init(n, q), grow=j_grow,
    arr=lambda a: jnp.asarray(a),
    counts=lambda c: jnp.asarray(c),
    ingest=lambda st, c, t, dt, w: jstream.jit_ingest_step(
        dt_epoch_ns=dt, waves=w)(st, jnp.asarray(c), jnp.int64(t)),
    now=lambda t: jnp.int64(t),
    hist_zero=JH.hist_zero, ledger_zero=JH.ledger_zero,
    window_zero=JSLO.window_zero)
PORT = types.SimpleNamespace(
    L=TL, PL=TPL, H=TH, R=TR, SLO=TSLO, G=TG, stream=tstream,
    init=lambda n, q: t_init(n, q, device="cpu"), grow=t_grow,
    arr=lambda a: torch.from_numpy(np.array(a)),
    counts=lambda c: torch.from_numpy(np.array(c)),
    ingest=lambda st, c, t, dt, w: tstream.ingest_step(
        st, torch.from_numpy(np.array(c)), t, dt_epoch_ns=dt, waves=w),
    now=lambda t: t,
    hist_zero=lambda: TH.hist_zero("cpu"),
    ledger_zero=lambda n: TH.ledger_zero(n, "cpu"),
    window_zero=lambda n: TSLO.window_zero(n, "cpu"))


# ----------------------------------------------------------------------
# slot map, validation, churn specs
# ----------------------------------------------------------------------

def slot_script(L):
    m = L.SlotMap(4)
    out = [m.allocate(c) for c in (10, 11, 12)]
    out.append(m.take_order())
    out.append(m.was_used(1))
    out.append(m.was_used(1))
    out.append(m.release(11))
    out.append(m.allocate(13))           # recycles slot 1
    out.append(m.allocate(14))
    out.append(m.allocate(15))           # full
    m.grow(8)
    out += [m.allocate(15), m.allocate(16)]
    m.release(10)
    m.release(14)
    perm = m.compaction_perm()
    out.append(None if perm is None else perm.tolist())
    m.apply_perm(perm)
    out.append(m.compaction_perm())
    out.append(m.translate(np.array([[0, -1, 3, 7, 9]])).tolist())
    out.append(m.scatter_by_cid(np.arange(8) * 10, 20).tolist())
    enc = m.encode()
    m2 = L.SlotMap.load(enc)
    out.append((m2.allocate(30), m2.live_count, m2.capacity,
                {k: np.asarray(v).tolist() for k, v in enc.items()}))
    out.append((m.slot_of, m.cid_of_slot.tolist(), m.ever_used.tolist(),
                m.next_order))
    return out


def test_slot_map_equals_jax():
    assert slot_script(TL) == slot_script(JL)
    assert TL.slots.owner_shard([0, 5, 6], 4).tolist() == \
        JL.slots.owner_shard([0, 5, 6], 4).tolist()
    assert TL.slots.owned_ids(10, 1, 3).tolist() == \
        JL.slots.owned_ids(10, 1, 3).tolist()


@pytest.mark.parametrize("op", [
    {"op": "register", "cid": 1, "r": -5.0, "w": 1.0, "l": 0.0},
    {"op": "register", "cid": 1, "r": 5.0, "w": 1.0, "l": 2.0},
    {"op": "update", "cid": 2, "r": 0.0, "w": float("nan"), "l": 0.0},
    {"op": "register", "cid": 2, "r": "x", "w": 1.0, "l": 0.0},
    {"op": "register", "cid": -1, "r": 0.0, "w": 1.0, "l": 0.0},
    {"op": "register", "cid": 99, "r": 0.0, "w": 1.0, "l": 0.0},
], ids=["negative", "limit_below", "nan", "non_numeric", "negative_id",
        "outside_ids"])
def test_accept_validates_like_jax(op):
    msgs = []
    for L in (JL, TL):
        plane = L.LifecyclePlane(L.make_spec("flash_crowd", total_ids=8))
        with pytest.raises(ValueError) as e:
            plane.accept(op)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if op["cid"] == 1 and op["r"] == -5.0:
        with pytest.raises(ValueError) as err:
            JClientInfo(-5.0, 1.0, 0.0, client=1)
        assert msgs[1] == str(err.value)


@pytest.mark.parametrize("scenario", JL.SCENARIOS)
def test_churn_specs_equal_jax(scenario):
    kw = dict(total_ids=40, seed=3, base_lam=1.5, compact_every=2)
    js, ts = JL.make_spec(scenario, **kw), TL.make_spec(scenario, **kw)
    assert ts == js
    assert TL.static_variant(ts) == JL.static_variant(js)
    assert TL.peak_ids(ts) == JL.peak_ids(js)
    for c in (0, 7, 39):
        assert TL.init_qos(ts, c) == JL.init_qos(js, c)
    for e in range(0, 40, 3):
        assert_np_equal("lam", TL.lam_vector(ts, e), JL.lam_vector(js, e))
        for every in (1, 2, 4):
            assert TL.events(ts, e, every) == JL.events(js, e, every)


def test_unknown_scenario_and_params_raise_like_jax():
    for call in (lambda L: L.make_spec("nope", total_ids=4),
                 lambda L: L.make_spec("flash_crowd", total_ids=4, bad=1)):
        msgs = []
        for L in (JL, TL):
            with pytest.raises(ValueError) as e:
                call(L)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert TL.SCENARIOS == JL.SCENARIOS
    assert TL.COUNTER_KEYS == JL.COUNTER_KEYS
    assert (TPL.LC_NOP, TPL.LC_REGISTER, TPL.LC_UPDATE, TPL.LC_EVICT,
            TPL.LC_IDLE) == (JPL.LC_NOP, JPL.LC_REGISTER, JPL.LC_UPDATE,
                             JPL.LC_EVICT, JPL.LC_IDLE)


# ----------------------------------------------------------------------
# the op vector: the host fold equals the ordered scan
# ----------------------------------------------------------------------

def random_ops(seed: int, n: int, b: int):
    """``b`` rows over a few slots of ``n`` (so slots repeat), kinds in
    every order, including NOP rows and an unknown kind (a NOP too)."""
    rng = np.random.default_rng(seed)
    slots = rng.choice(n, size=min(n, 5), replace=False)
    kind = rng.integers(0, 6, b).astype(np.int32)
    slot = rng.choice(slots, b).astype(np.int32)
    vals = rng.integers(0, 10 ** 9, (4, b)).astype(np.int64)
    return kind, slot, vals[0], vals[1], vals[2], vals[3]


@pytest.mark.parametrize("seed", range(6))
def test_apply_op_vector_equals_the_jax_scan(seed):
    arrays = random_state(100 + seed, 12, 6)
    for b in (1, 3, 8, 16):
        ops = random_ops(seed * 7 + b, 12, b)
        want = JPL.apply_op_vector(to_jax(arrays), *ops)
        got = TPL.apply_op_vector(to_torch(arrays), *ops)
        assert_states(got, want)


def test_apply_op_vector_kinds_one_by_one():
    """Each kind alone, and the orders the plane makes (register then
    update, evict then register on a recycled slot, NOP padding on slot
    0), against the scan."""
    arrays = random_state(5, 6, 4)
    cases = [
        [(1, 2, 5, 6, 7, 9)], [(2, 2, 5, 6, 7, 0)], [(3, 2, 0, 0, 0, 0)],
        [(4, 2, 0, 0, 0, 0)], [(0, 0, 0, 0, 0, 0)] * 4,
        [(1, 2, 1, 2, 3, 4), (2, 2, 4, 5, 6, 0), (0, 0, 0, 0, 0, 0)],
        [(3, 1, 0, 0, 0, 0), (1, 1, 8, 8, 8, 3), (4, 1, 0, 0, 0, 0),
         (2, 1, 1, 1, 1, 0)],
        [(2, 3, 9, 9, 9, 0), (4, 3, 0, 0, 0, 0), (2, 3, 1, 2, 3, 0)],
    ]
    for rows in cases:
        a = np.asarray(rows, dtype=np.int64)
        cols = (a[:, 0].astype(np.int32), a[:, 1].astype(np.int32),
                a[:, 2], a[:, 3], a[:, 4], a[:, 5])
        assert_states(TPL.apply_op_vector(to_torch(arrays), *cols),
                      JPL.apply_op_vector(to_jax(arrays), *cols))
    with pytest.raises(ValueError, match="outside"):
        TPL.apply_op_vector(to_torch(arrays), [1], [6], [0], [0], [0], [0])


def test_grow_and_compact_tree_equal_jax():
    arrays = random_state(9, 10, 4)
    rng = np.random.default_rng(1)
    led = rng.integers(0, 99, (10, 5)).astype(np.int64)
    blk = rng.integers(0, 99, (10, 7)).astype(np.int64)
    extra = rng.integers(0, 99, (10, 3)).astype(np.int32)
    perm = rng.permutation(10).astype(np.int32)
    jt = (to_jax(arrays), jnp.asarray(led), jnp.asarray(blk),
          jnp.asarray(extra))
    tt = (to_torch(arrays), torch.from_numpy(led), torch.from_numpy(blk),
          torch.from_numpy(extra))
    want = JL.compact_tree(jt, perm)
    got = TL.compact_tree(tt, perm)
    assert_states(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert_np_equal("leaf", _np(g), _np(w))
    assert_states(t_grow(got[0], 16), j_grow(want[0], 16))
    with pytest.raises(TypeError):
        TL.compact_tree({"a": torch.zeros(2)}, [1, 0])


# ----------------------------------------------------------------------
# boundary after boundary
# ----------------------------------------------------------------------

# generations live 2 epochs and start 4 apart: gen0 is evicted before
# gen2 registers, so registrations land on recycled slots; capacity0=4
# forces growth; the eviction holes make compaction (every boundary) fire
SPEC = JL.make_spec("churn_storm", total_ids=16, base_lam=1.5,
                    compact_every=1, gens=4, stride=4, life=2,
                    capacity0=4)
RING, M, K, WAVES, DT = 16, 2, 8, 4, 10 ** 8


def churn_loop(B, spec, epochs: int, every: int, *, seed: int = 11,
               plane=None, carry=None, e0: int = 0, extras: bool = True,
               update_at=None):
    """Bench's churn loop at a small shape, with extras riding the
    boundary and a control-plane QoS update accepted at ``update_at``.
    Yields ``(e, plane, state, ledger, slo_block, extras)`` after every
    boundary; returns the carry through ``carry`` (a dict)."""
    if plane is None:
        plane = B.L.LifecyclePlane(spec)
        slo = B.SLO.SloPlane(spec["capacity0"], dt_epoch_ns=DT,
                             ring_depth=8)
        plane.attach_slo(slo)
        n0 = spec["capacity0"]
        c = dict(state=B.init(n0, RING), hists=B.hist_zero(),
                 ledger=B.ledger_zero(n0), slo=slo,
                 block=B.window_zero(n0),
                 extras=[(B.arr(np.arange(n0, dtype=np.int64)), 7),
                         (B.arr(np.ones((n0, 2), dtype=np.int32)), 1)]
                 if extras else None,
                 rng=np.random.Generator(np.random.PCG64(seed)),
                 w0=0, count=0)
    else:
        c = carry
    for e in range(e0, epochs):
        if e % every == 0:
            if e > 0:
                c["block"], closed = c["slo"].roll(
                    c["block"], c["w0"], e,
                    cid_of_slot=plane.slots.cid_of_slot,
                    depth=c["state"].depth)
                c["w0"] = e
            if update_at is not None and e == update_at and \
                    plane.slots.slot_of:
                cid = min(plane.slots.slot_of)
                r, w, l = plane.qos[cid]
                plane.accept({"op": "update", "cid": cid, "r": r,
                              "w": w * 4, "l": l, "apply_at": e})
            out = plane.boundary(c["state"], e, every, ledger=c["ledger"],
                                 slo_block=c["block"], extras=c["extras"])
            if c["extras"] is not None:
                c["state"], c["ledger"], c["block"], c["extras"] = out
            else:
                c["state"], c["ledger"], c["block"] = out
            yield e, plane, c
        raw = c["rng"].poisson(B.L.lam_vector(spec, e)).astype(np.int32)
        c["state"] = B.ingest(c["state"], plane.map_counts(raw), e * DT,
                              DT, WAVES)
        ep = B.G.run_epoch_guarded(
            c["state"], B.now(e * DT + DT), engine="prefix", m=M, k=K,
            with_metrics=True, hists=c["hists"], ledger=c["ledger"],
            slo=c["block"])
        c["state"], c["hists"], c["ledger"] = ep.state, ep.hists, ep.ledger
        c["block"] = ep.slo
        c["count"] += ep.count
    if carry is not None:
        carry.update(c)


def plane_view(plane, c):
    st = _state_np(c["state"])
    return dict(
        state=st, ledger=_np(c["ledger"]).tolist(),
        block=_np(c["block"]).tolist(),
        extras=None if c["extras"] is None else
        [(_np(a).tolist(), f) for a, f in c["extras"]],
        snapshot=plane.snapshot(), counters=dict(plane.counters),
        departed=[(cid, row.tolist())
                  for cid, row in plane.departed_report(drain=False)],
        cids=plane.slots.cid_of_slot.tolist(),
        streak=plane.streak.tolist(), qos=dict(plane.qos),
        count=c["count"], peak=plane.peak_live,
        slo=(c["slo"].window_seq, c["slo"].windows_closed,
             dict(c["slo"].cepoch)))


def _assert_views(got, want):
    for k in want:
        if k == "state":
            for f in want[k]:
                assert_np_equal(f, got[k][f], want[k][f])
        else:
            assert got[k] == want[k], k


def test_boundaries_equal_jax():
    """Every boundary of a churn_storm run: the port's plane leaves what
    the JAX package's does."""
    views = {}
    for name, B in (("jax", JAX), ("port", PORT)):
        views[name] = [plane_view(p, c) for _e, p, c in
                       churn_loop(B, SPEC, 20, 2, update_at=4)]
    assert len(views["port"]) == len(views["jax"]) == 10
    for got, want in zip(views["port"], views["jax"]):
        _assert_views(got, want)
    last = views["port"][-1]["snapshot"]
    assert last["evictions"] > 0 and last["slot_recycles"] > 0
    assert last["compactions"] > 0 and last["grows"] > 0
    assert last["qos_updates"] >= 1


def test_encode_load_across_packages():
    """A JAX plane's encoding loads into the port's, which carries on
    like the JAX plane; the port's encoding loads back into JAX."""
    jc, tc = {}, {}
    for _e, jplane, _c in churn_loop(JAX, SPEC, 8, 2, carry=jc,
                                     extras=False):
        pass
    enc = jplane.encode()
    tplane = TL.LifecyclePlane.load(enc, SPEC)
    assert {k: np.asarray(v).tolist() for k, v in tplane.encode().items()} \
        == {k: np.asarray(v).tolist() for k, v in enc.items()}
    tslo = TSLO.SloPlane.load(jc["slo"].encode(), capacity=int(
        jc["block"].shape[0]), dt_epoch_ns=DT, ring_depth=8)
    tplane.attach_slo(tslo)
    tc.update(state=to_torch(jax_to_np(jc["state"])),
              hists=torch.from_numpy(_np(jc["hists"]).copy()),
              ledger=torch.from_numpy(_np(jc["ledger"]).copy()),
              slo=tslo, block=torch.from_numpy(_np(jc["block"]).copy()),
              extras=None, rng=np.random.Generator(np.random.PCG64(0)),
              w0=jc["w0"], count=jc["count"])
    tc["rng"].bit_generator.state = jc["rng"].bit_generator.state
    jviews = [plane_view(p, c) for _e, p, c in
              churn_loop(JAX, SPEC, 16, 2, plane=jplane, carry=jc, e0=8)]
    tviews = [plane_view(p, c) for _e, p, c in
              churn_loop(PORT, SPEC, 16, 2, plane=tplane, carry=tc, e0=8)]
    for got, want in zip(tviews, jviews):
        _assert_views(got, want)
    back = JL.LifecyclePlane.load(tplane.encode(), SPEC)
    assert back.snapshot() == tplane.snapshot()
    assert {k: np.asarray(v).shape for k, v in
            TL.LifecyclePlane.empty_leaves().items()} == \
        {k: np.asarray(v).shape for k, v in
         JL.LifecyclePlane.empty_leaves().items()}


def test_ensure_capacity_and_force_compact_like_jax():
    outs = []
    for B in (JAX, PORT):
        plane = B.L.LifecyclePlane(SPEC)
        st = B.init(4, RING)
        led = B.ledger_zero(4)
        st, led = plane.boundary(st, 0, 2, ledger=led)
        st, led, ex = plane.ensure_capacity(
            16, st, led, extras=[(B.arr(np.zeros(4, np.int64)), 3)])
        plane.slots.release(1)          # a hole, as an eviction leaves
        st, led = plane.force_compact(st, led, b=2)
        outs.append((_state_np(st), _np(led).tolist(),
                     _np(ex[0][0]).tolist(), plane.snapshot(),
                     plane.slots.cid_of_slot.tolist()))
    for f in outs[0][0]:
        assert_np_equal(f, outs[1][0][f], outs[0][0][f])
    assert outs[1][1:] == outs[0][1:]


# ----------------------------------------------------------------------
# WAL and admin API
# ----------------------------------------------------------------------

def wal_script(B, tmp):
    spec = B.L.make_spec("flash_crowd", total_ids=8, base_lam=1.0)
    plane = B.L.LifecyclePlane(spec, workdir=str(tmp))
    seqs = [plane.accept({"op": "register", "cid": 6, "r": 0.0, "w": 2.0,
                          "l": 0.0, "apply_at": None}),
            plane.accept({"op": "update", "cid": 6, "r": 0.0, "w": 5.0,
                          "l": 0.0, "apply_at": 2})]
    seqs.append(B.L.wal_append(tmp, {"op": "register", "cid": 7,
                                     "r": 1.0, "w": 1.0, "l": 0.0}))
    with open(tmp / "admin.wal", "a") as f:          # a poisoned line
        f.write(json.dumps({"op": "register", "cid": 99, "r": 0.0,
                            "w": 1.0, "l": 0.0, "apply_at": None}) + "\n")
    view0 = [(p["op"], p["cid"]) for p in plane.pending_view()]
    state = B.init(spec["capacity0"], 8)
    state, _ = plane.boundary(state, 0, 2)
    mid = (plane.wal_seen, list(plane.pending), plane.snapshot())
    state, _ = plane.boundary(state, 2, 2)
    wal = (tmp / "admin.wal").read_text()
    return (seqs, view0, mid, plane.wal_seen, plane.snapshot(),
            dict(plane.qos), wal, _state_np(state)["weight_inv"].tolist())


def test_wal_equals_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = wal_script(JAX, tmp_path / "j")
    got = wal_script(PORT, tmp_path / "t")
    assert got == want
    assert got[3] == 4 and got[4]["qos_updates"] == 1


def admin_script(B, call):
    """One sequence of admin requests with boundaries between; ``call``
    sends a request and returns (status, json body)."""
    spec = B.L.make_spec("flash_crowd", total_ids=8, base_lam=1.0)
    plane = B.L.LifecyclePlane(spec)
    api = B.L.AdminAPI(plane, ledger_rows=lambda: {2: np.arange(5)})
    out = []
    send = lambda *a: out.append(call(api, plane, *a))  # noqa: E731
    send("POST", "/clients", {"id": 6, "weight": 2.0})
    send("GET", "/clients/6")
    send("PUT", "/clients/6/qos", {"weight": 8.0})
    send("POST", "/clients", {"id": 6})
    send("POST", "/clients", {"id": 5, "reservation": -1.0})
    send("PUT", "/clients/9/qos", {"weight": 1.0})
    send("DELETE", "/clients/9")
    send("GET", "/clients/xyz")
    send("PUT", "/clients")
    send("POST", "/clients", "not a dict")
    send("GET", "/clients/6/conformance")
    send("PATCH", "/clients/6")
    state = B.init(spec["capacity0"], 8)
    state, _ = plane.boundary(state, 0, 2)
    send("GET", "/clients")
    send("GET", "/clients/6")
    send("GET", "/clients/2")
    send("DELETE", "/clients/6")
    state, _ = plane.boundary(state, 2, 2)
    send("GET", "/clients/6")
    send("GET", "/clients")
    return out, plane.snapshot()


def _in_process(api, plane, method, path, body=None):
    status, ctype, out = api.handler(
        method, path, json.dumps(body).encode() if body is not None else b"")
    assert ctype == "application/json"
    return status, json.loads(out.decode())


def test_admin_api_in_process_equals_jax():
    got = admin_script(PORT, _in_process)
    want = admin_script(JAX, _in_process)
    assert got == want
    assert got[1]["registrations"] == 5 and got[1]["evictions"] == 1


def test_admin_api_over_http_equals_jax():
    """Mounted on each package's own endpoint, over real sockets."""
    results = []
    for B in (JAX, PORT):
        servers = {}

        def call(api, plane, method, path, body=None):
            if id(plane) not in servers:
                srv = B.R.MetricsHTTPServer(B.R.MetricsRegistry(), port=0)
                servers[id(plane)] = srv
                assert B.L.mount_admin_api(srv, plane) is not None
            srv = servers[id(plane)]
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(
                f"http://{srv.host}:{srv.port}{path}", data=data,
                method=method)
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                text = e.read()
                # a method the server has no handler for answers 501
                # with the server's own page, not JSON
                return e.code, json.loads(text) if e.code != 501 else None

        try:
            out = admin_script(B, call)
            srv = next(iter(servers.values()))
            with urllib.request.urlopen(srv.url, timeout=10) as r:
                text = r.read().decode()
        finally:
            for srv in servers.values():
                srv.close()
        results.append((out, text))
    assert results[1] == results[0]
    assert "dmclock_lc_live_clients 4\n" in results[1][1]
    assert TL.mount_admin_api(None, None) is None


# ----------------------------------------------------------------------
# the digest gates
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scenario", JL.SCENARIOS)
def test_serial_digest_equals_jax_and_static(scenario):
    spec = JL.make_spec(scenario, total_ids=16, base_lam=1.5,
                        compact_every=2)
    d_jax, _, n_jax = JL.run_serial_churn(spec, epochs=16, every=2)
    d_dyn, plane, n_dyn = TL.run_serial_churn(spec, epochs=16, every=2,
                                              device="cpu")
    d_st, _, n_st = TL.run_serial_churn(TL.static_variant(spec),
                                        epochs=16, every=2, device="cpu")
    assert d_dyn == d_jax and n_dyn == n_jax
    assert d_dyn == d_st and n_dyn == n_st > 0


def test_serial_churn_storm_recycles_and_compacts():
    d_jax, jplane, _ = JL.run_serial_churn(SPEC, epochs=20, every=2)
    d_dyn, plane, _ = TL.run_serial_churn(SPEC, epochs=20, every=2,
                                          device="cpu")
    d_st, _, _ = TL.run_serial_churn(TL.static_variant(SPEC), epochs=20,
                                     every=2, device="cpu")
    assert d_dyn == d_jax == d_st
    snap = plane.snapshot()
    assert snap == jplane.snapshot()
    assert snap["evictions"] > 0 and snap["slot_recycles"] > 0
    assert snap["compactions"] > 0
    dep = plane.departed_report()
    assert len(dep) == snap["evictions"]
    assert plane.departed_report() == []


def engine_digest(spec, engine: str, epochs: int = 12, every: int = 2):
    """The port's churn loop on ``engine`` (guarded epochs, m=2, k=8):
    the canonical chain digest and the decision count."""
    plane = TL.LifecyclePlane(spec)
    state = t_init(spec["capacity0"], RING, device="cpu")
    rng = np.random.Generator(np.random.PCG64(11))
    digest, total = b"\x00" * 32, 0
    for e in range(epochs):
        if e % every == 0:
            state, _ = plane.boundary(state, e, every)
        raw = rng.poisson(TL.lam_vector(spec, e)).astype(np.int32)
        state = tstream.ingest_step(
            state, torch.from_numpy(plane.map_counts(raw)), e * DT,
            dt_epoch_ns=DT, waves=WAVES)
        ep = TG.run_epoch_guarded(state, e * DT + DT, engine=engine, m=2,
                                  k=8)
        state = ep.state
        total += ep.count
        digest = digest_update(digest, plane.canon_results(ep.results))
    return hashlib.sha256(digest).hexdigest(), total, plane.snapshot()


@pytest.mark.parametrize("engine", ["prefix", "chain", "calendar"])
def test_engine_dynamic_equals_static(engine):
    """Dynamic registration, recycling, growth and compaction leave the
    canonical decision stream of every epoch engine unchanged."""
    d_dyn, n_dyn, snap = engine_digest(SPEC, engine)
    d_st, n_st, _ = engine_digest(TL.static_variant(SPEC), engine)
    assert d_dyn == d_st and n_dyn == n_st > 0
    assert snap["grows"] >= 1 and snap["compactions"] >= 1
    assert snap["evictions"] >= 1
