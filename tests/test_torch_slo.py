"""The port's SLO plane against the JAX package, exactly: the device
window block (delta, combine, masked and dead folds, the contract-epoch
stamp, the totals) and the host ``SloPlane`` (register, update, evict,
roll, conformance rows, ring rows, client views, encode/load, the JSONL
export), driven through the same sequence on the same seeded blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.obs import slo as jslo
from dmclock_tpu_torch.obs import slo as tslo

from test_torch_support import assert_np_equal

DT = 100_000_000


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(jax.device_get(x))


def _cols(seed, n):
    rng = np.random.default_rng(seed)
    served = rng.integers(0, 6, n)
    return [served, served * rng.integers(1, 4, n),
            np.minimum(served, rng.integers(0, 4, n)),
            rng.integers(0, 2, n), rng.integers(0, 2, n),
            rng.integers(0, 1 << 30, n)]


def test_window_block_functions_match_jax():
    n = 30
    cols = _cols(1, n)
    td = tslo.window_delta(*(torch.from_numpy(c) for c in cols))
    jd = jslo.window_delta(*(jnp.asarray(c) for c in cols))
    assert_np_equal("delta", _np(td), _np(jd))
    ce = np.arange(n, dtype=np.int64) % 4 + 1
    tb = tslo.stamp_cepoch(tslo.window_zero(n, "cpu"), ce)
    jb = jslo.stamp_cepoch(jslo.window_zero(n), ce)
    assert_np_equal("stamp", _np(tb), _np(jb))
    for live in (True, False):
        tb2 = tslo.window_fold(tb, td, torch.tensor(live))
        jb2 = jslo.window_fold(jb, jd, jnp.bool_(live))
        assert_np_equal(f"fold live={live}", _np(tb2), _np(jb2))
    assert torch.equal(tslo.window_fold(tb, td, True),
                       tslo.window_combine(tb, td))
    assert torch.equal(tslo.window_fold(tb, td, torch.tensor(False)), tb)
    big = tslo.window_combine(tb, tslo.window_combine(td, td))
    assert_np_equal("combine_np", tslo.window_combine_np(_np(tb), _np(td),
                                                         _np(td)),
                    jslo.window_combine_np(_np(jb), _np(jd), _np(jd)))
    assert_np_equal("combine_np vs device", tslo.window_combine_np(
        _np(tb), _np(td), _np(td)), _np(big))
    assert tslo.window_totals(big) == jslo.window_totals(_np(big))


def _drive(mod, block_of, seed=5, n=12, ring_depth=3):
    """The same plane sequence on ``mod``'s ``SloPlane``: registrations
    with a limit, an update and an evict with re-registration, four
    rolls of seeded blocks (depth at close on two, ``skip_idle`` on one,
    a slot map with a free slot on one).  Returns the plane and every
    roll's (fresh block, closed rows, judged rows)."""
    p = mod.SloPlane(n, dt_epoch_ns=DT, ring_depth=ring_depth)
    rng = np.random.default_rng(seed)
    for c in range(n - 2):
        p.register(c, float(rng.integers(0, 3) * 10),
                   float(rng.integers(1, 5)),
                   float(rng.integers(0, 2) * 60))
    p.update(3, 20.0, 7.0, 0.0)
    p.evict(4)
    p.register(4, 5.0, 2.0, 0.0)
    p.evict(5)
    rolls = []
    fresh = p.stamp(block_of(np.zeros((n, mod.W_FIELDS), np.int64)))
    for r in range(4):
        a = np.asarray(_np(fresh)).copy()
        cols = _cols(seed + r, n)
        a[:, :mod.W_CEPOCH] += np.stack(cols, axis=1)
        a[::4, :mod.W_CEPOCH] = 0             # idle clients
        depth = rng.integers(0, 3, n) if r % 2 else None
        cid_of_slot = None
        if r == 3:
            cid_of_slot = np.arange(n)
            cid_of_slot[1] = -1
        fresh, closed = p.roll(block_of(a), 2 * r, 2 * r + 2,
                               depth=depth, skip_idle=(r == 2),
                               cid_of_slot=cid_of_slot)
        rolls.append((_np(fresh), [w.row() for w in closed],
                      p.conformance_rows(closed)))
    return p, rolls


@pytest.fixture(scope="module")
def planes():
    return (_drive(tslo, lambda a: torch.from_numpy(a)),
            _drive(jslo, lambda a: jnp.asarray(a)))


def test_slo_plane_rolls_match_jax(planes):
    (tp, trolls), (jp, jrolls) = planes
    for (tf, tc, tj), (jf, jc, jj) in zip(trolls, jrolls):
        assert_np_equal("fresh", tf, jf)
        assert tc == jc
        assert tj == jj
    assert any(rows for _, rows, _ in trolls)
    assert [w.row() for w in tp.ring_rows()] == \
        [w.row() for w in jp.ring_rows()]
    assert [w.row() for w in tp.ring_rows(3)] == \
        [w.row() for w in jp.ring_rows(3)]
    assert tp.summary() == jp.summary()
    for cid in (0, 3, 4, 5, 11):
        assert tp.client_view(cid) == jp.client_view(cid)
    assert tp.cepoch == jp.cepoch and tp.contracts == jp.contracts
    assert tp.contract_log == jp.contract_log
    assert_np_equal("cepoch_vector", tp.cepoch_vector(),
                    jp.cepoch_vector())
    slots = np.asarray([3, -1, 0, 7])
    assert_np_equal("cepoch_vector map", tp.cepoch_vector(slots),
                    jp.cepoch_vector(slots))


def test_slo_plane_encode_load_match_jax(planes):
    (tp, _), (jp, _) = planes
    enc, jenc = tp.encode(), jp.encode()
    assert sorted(enc) == sorted(jenc)
    for k in enc:
        assert_np_equal(k, enc[k], jenc[k])
    for depth in (None, 2):
        tq = tslo.SloPlane.load(jenc, capacity=tp.capacity,
                                dt_epoch_ns=DT, ring_depth=depth)
        jq = jslo.SloPlane.load(jenc, capacity=jp.capacity,
                                dt_epoch_ns=DT, ring_depth=depth)
        assert [w.row() for w in tq.ring_rows()] == \
            [w.row() for w in jq.ring_rows()]
        assert tq.summary() == jq.summary()
        assert tq.contracts == jq.contracts
    empty, jempty = tslo.SloPlane.empty_leaves(), jslo.SloPlane.empty_leaves()
    for k in empty:
        assert_np_equal(k, empty[k], jempty[k])


def test_slo_plane_export_and_register_from_inv(planes, tmp_path):
    (tp, trolls), (jp, _) = planes
    closed = [tslo.ClosedWindow.from_row(r) for r in trolls[1][1]]
    jclosed = [jslo.ClosedWindow.from_row(r) for r in trolls[1][1]]
    for judged in (True, False):
        a, b = tmp_path / f"t{judged}.jsonl", tmp_path / f"j{judged}.jsonl"
        assert tp.export_jsonl(str(a), closed, judged) == \
            jp.export_jsonl(str(b), jclosed, judged) > 0
        assert a.read_text() == b.read_text()
        with open(a, "a") as fh:
            fh.write("not json\n[1, 2]\n")
        assert tslo.load_windows_jsonl(str(a)) == \
            jslo.load_windows_jsonl(str(a))
    inv = [np.asarray([10 ** 7, 0, 3 * 10 ** 8], np.int64),
           np.asarray([10 ** 8, 2 * 10 ** 8, 10 ** 9], np.int64),
           np.asarray([0, 0, 5 * 10 ** 7], np.int64)]
    t = tslo.SloPlane(3, dt_epoch_ns=DT)
    j = jslo.SloPlane(3, dt_epoch_ns=DT)
    t.register_from_inv(*(torch.from_numpy(x) for x in inv))
    j.register_from_inv(*inv)
    assert t.contracts == j.contracts and t.cepoch == j.cepoch
