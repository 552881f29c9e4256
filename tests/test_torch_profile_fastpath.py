"""``scripts/torch_profile_fastpath.py``, the port's component profile,
against the JAX repo's ``profile_fastpath.py`` on the CPU.

Each component's step (the body the script chains) equals the JAX
script's scan body on the same state, three steps chained from a zero
carry: the sort selection with its cummin, the radix k-select, the dense
serve retag, the ``ring_window`` prefetch and the window head select
(the JAX bodies are the script's, written out here: they are closures
of its ``main``).  The script's Zipf state equals its JAX counterpart's,
field by field.  Then the rows run at a cut shape on ``--device cpu``:
an epoch and a calendar row (the wheel, whose K2 regions the count
sees), the five component rows, and ``main`` whole with one group,
printing a line a row and the JSON line last."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from __graft_entry__ import _preloaded_state as jax_preloaded
from dmclock_tpu.core.timebase import rate_to_inv_ns
from dmclock_tpu.engine import fastpath as jfp
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.obs import capacity as tcap
from dmclock_tpu_torch.obs import compile_plane as tcp

ROOT = Path(__file__).resolve().parent.parent
N, K, RING = 384, 96, 128

_spec = importlib.util.spec_from_file_location(
    "torch_profile_fastpath", ROOT / "scripts" / "torch_profile_fastpath.py")
PF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PF)


# the JAX script's scan bodies, one step each (profile_fastpath.py main)

def jax_sel_sort(state, t, k):
    n = state.capacity
    iota = jnp.arange(n, dtype=jnp.int32)
    o32 = state.order.astype(jnp.int32)
    c32 = state.head_cost.astype(jnp.int32)
    key = state.head_prop + state.prop_delta + t
    kmin = jnp.min(key)
    k32 = jnp.clip(key - kmin, 0, (1 << 31) - 2).astype(jnp.int32)
    r32 = k32 + jnp.int32(1)
    ks, os_, idxs, _cs, rs = lax.sort((k32, o32, iota, c32, r32),
                                      num_keys=2)
    pk = (ks[:k].astype(jnp.int64) << 32) | \
        (os_[:k].astype(jnp.int64) & 0xFFFFFFFF)
    rpk = (rs[:k].astype(jnp.int64) << 32)
    cm = lax.associative_scan(jnp.minimum, rpk)
    count = jnp.argmax(~(cm > pk)).astype(jnp.int32)
    return t + idxs[0].astype(jnp.int64) + 1, count


def jax_sel_radix(state, t, k):
    n = state.capacity
    iota = jnp.arange(n, dtype=jnp.int32)
    c32 = state.head_cost.astype(jnp.int32)
    omask = (jnp.int64(1) << 28) - 1
    key = state.head_prop + state.prop_delta + t
    kmin = jnp.min(key)
    krel = jnp.clip(key - kmin, 0, (1 << 31) - 2)
    pk = (krel << 28) | (state.order & omask)
    epk = pk + 1
    pks, idxs, rpk, _costs, _lens = jfp._select_radix(
        pk, iota, epk, c32, None, k, min(k, n))
    cm = lax.associative_scan(jnp.minimum, rpk)
    count = jnp.argmax(~(cm > pks)).astype(jnp.int32)
    return t + idxs[0].astype(jnp.int64) + 1, count


def jax_serve(state, t):
    cls = jnp.full((state.capacity,), jfp.CLS_WEIGHT, jnp.int32)
    st = state._replace(prev_prop=state.prev_prop + t)
    sv = jfp._chain_serve(st, jnp.int64(1 << 60), [st.head_arrival],
                          [st.head_cost], cls, False, 0)
    return t + sv.head_prop[0] + 1, sv.head_resv[0]


def jax_prefetch(state, t):
    st = state._replace(q_head=(state.q_head + jnp.int32(t)) % RING)
    win = jfp.ring_window(st, 32)
    return t + win.arr[0, 0] + 1, win.cost[0, 0]


def jax_head_select(state, t, win):
    st = state._replace(q_head=(state.q_head + jnp.int32(t)) % RING)
    narr, ncost = jfp._window_heads(st, win)
    return t + narr[0] + 1, ncost[0]


def _chain(step, t0, steps=3):
    outs, t = [], t0
    for _ in range(steps):
        t, out = step(t)
        outs.append((int(t), int(out)))
    return outs


@pytest.fixture(scope="module")
def states():
    return (jax_preloaded(N, RING, ring=RING),
            tserve._preloaded_state(N, RING, ring=RING, device="cpu"))


def test_components_equal_jax(states):
    js, ts = states
    steps = dict(PF.component_steps(ts, K))
    jwin = jfp.ring_window(js, 32)
    jax_steps = [lambda t: jax_sel_sort(js, t, K),
                 lambda t: jax_sel_radix(js, t, K),
                 lambda t: jax_serve(js, t),
                 lambda t: jax_prefetch(js, t),
                 lambda t: jax_head_select(js, t, jwin)]
    assert len(steps) == len(jax_steps) == 5
    for (name, step), jstep in zip(steps.items(), jax_steps):
        got = _chain(step, torch.zeros((), dtype=torch.int64))
        want = _chain(jstep, jnp.int64(0))
        assert got == want, name


def test_zipf_state_equals_jax():
    st = PF.zipf_state(N, RING, 96, torch.device("cpu"))
    js = jax_preloaded(N, 96, ring=RING)
    w = 1.0 / np.arange(1, N + 1) ** 1.1
    w = np.clip(w / w[N // 2], 0.5, 64.0)
    np.random.default_rng(7).shuffle(w)
    winv = np.asarray([rate_to_inv_ns(x) for x in w], np.int64)
    c = np.arange(N)
    jitter = ((((c * 2654435761) & 0xFFFFF) / float(1 << 20)) * 2.0
              * winv).astype(np.int64)
    js = js._replace(weight_inv=jnp.asarray(winv),
                     head_prop=jnp.asarray(winv + jitter))
    for f in st._fields:
        assert np.array_equal(getattr(st, f).numpy(),
                              np.asarray(getattr(js, f))), f


def test_rows_at_a_cut_shape(states):
    _, ts = states
    peaks = tcap.device_peaks("cpu")
    row = PF.measure_epoch("epoch", ts, peaks, k=K, reps=1, m_lo=1,
                           m_hi=2)
    assert row["decisions_per_batch"] == K and row["us"] != 0
    assert row["cost_analysis"]["bytes_accessed"] > 0
    zs = PF.zipf_state(N, RING, 96, torch.device("cpu"))
    cal = PF.measure_calendar("wheel", zs, peaks, impl="wheel", levels=2,
                              reps=1, m_lo=1, m_hi=2, steps=2)
    assert cal["decisions_per_batch"] > 0
    assert cal["cost_analysis"]["flops"] > 0
    comps = [PF.measure_steps(name, step, peaks, reps=1, it_lo=2, it_hi=4)
             for name, step in PF.component_steps(ts, K)]
    assert [r["name"] for r in comps] == \
        [name for name, _ in PF.component_steps(ts, K)]
    for r in comps:
        assert r["cost_analysis"]["bytes_accessed"] > 0, r["name"]
        assert r["achieved_bytes_per_s"] is None or \
            r["peak_share"] == r["achieved_bytes_per_s"] \
            / peaks["peak_bytes_per_s"]
    # the prefetch row counts K1's formula once a step
    pre = dict(PF.component_steps(ts, K))[
        "ring_window prefetch (K1, per EPOCH)"]
    with tcp.CostCounter() as c:
        pre(torch.zeros((), dtype=torch.int64))
    assert c.ops()["kernel:ring_window"] == dict(
        calls=1, **tfp.ring_window_cost(N, PF.WINDOW))


def test_main_prints_rows_then_the_json_line(capsys, tmp_path):
    out = tmp_path / "rows.json"
    assert PF.main(["--n", "256", "--k", "64", "--reps", "1", "--rows",
                    "component", "--out", str(out), "--device",
                    "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    line = json.loads(lines[-1])
    assert json.loads(out.read_text()) == line
    assert [r["name"] for r in line["rows"]] == \
        [ln.split("  ")[0].strip() for ln in lines[2:-1]]
    assert line["n"] == 256 and len(line["rows"]) == 5
