"""``scripts/torch_run_sweeps.py`` against the JAX repo's
``benchmark/run_sweeps.py`` on the CPU: the k/m sweep, the regime rows
and the markdown ``main`` writes.

Every row runs at the script's cut shape (``CUT``: 2,048 clients, depth
64, k=512, m=4, the serial floor 64 steps) on both sides.  Where the JAX
function takes its shape as arguments (``_timed_prefix_epochs``,
``_timed_transient_chain``) it is called; where it hard-codes 100,000
clients the JAX side is rebuilt from the same JAX building blocks
(``__graft_entry__._preloaded_state``, ``kernels.engine_run``,
``._replace``) exactly as the script uses them.  Held exactly: each
row's fill (so its decision total), the ``state_digest`` of every warm
epoch and chain in order, ``resv_state``'s ``head_resv`` and both
serial-floor runs' decisions.  The sections ``main`` writes from the
same rows equal the JAX script's table for table, with its headings up
to the shape and the device they name."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as graft
import profile_util
from dmclock_tpu.engine import kernels as JK

ROOT = Path(__file__).resolve().parent.parent


def load_script(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SW = load_script("torch_run_sweeps", ROOT / "scripts" / "torch_run_sweeps.py")
RS = load_script("run_sweeps", ROOT / "benchmark" / "run_sweeps.py")


def record_digests(monkeypatch):
    """Patch both packages' ``state_digest`` to log every value it
    returns; returns ``(port log, JAX log)``."""
    got, want = [], []
    port, jx = SW.state_digest, profile_util.state_digest

    def port_digest(st):
        x = port(st)
        got.append(int(x))
        return x

    def jax_digest(st):
        x = jx(st)
        want.append(int(np.asarray(x)))
        return x

    monkeypatch.setattr(SW, "state_digest", port_digest)
    monkeypatch.setattr(profile_util, "state_digest", jax_digest)
    return got, want


def same_tree(a, b, what: str) -> None:
    assert a._fields == b._fields, what
    for f in a._fields:
        x, y = getattr(a, f).cpu().numpy(), np.asarray(getattr(b, f))
        assert np.array_equal(x, y), f"{what}: {f} differs"


def jax_resv_state(n: int, depth: int):
    """``run_sweeps.tpu_regime_sweep``'s ``resv_state`` at ``n``."""
    st = graft._preloaded_state(n, depth, ring=depth)
    c = np.arange(n)
    phase = ((c * 2654435761) & 0xFFFFF) / float(1 << 20)
    rinv = np.asarray(st.resv_inv)
    jit = (phase * 2.0 * rinv).astype(np.int64)
    return st._replace(head_resv=jnp.asarray(rinv + jit))


def test_state_digest_equals_profile_util():
    from dmclock_tpu.engine.fastpath import scan_prefix_epoch
    ep = SW.scan_prefix_epoch(SW.resv_state(256, 16, "cpu"), 0, 2, 64,
                              anticipation_ns=0)
    jep = scan_prefix_epoch(jax_resv_state(256, 16), jnp.int64(0), 2, 64,
                            anticipation_ns=0)
    got = SW.state_digest(ep.state)
    assert got.dtype == SW.torch.int64 and got.dim() == 0
    assert int(got) == int(np.asarray(profile_util.state_digest(jep.state)))


def test_km_sweep_equals_the_jax_script(monkeypatch):
    sh = SW.CUT["km"]
    got_d, want_d = record_digests(monkeypatch)
    got = SW.tpu_km_sweep(**sh, device="cpu")
    want = []
    for k, m, d in sh["grid"]:
        hi = max(2, sh["chain_decisions"] // (m * k))
        lo = SW.lo_epochs(hi, k, m, sh["lo_decisions"])
        _, fill = RS._timed_prefix_epochs(
            lambda d=d: graft._preloaded_state(sh["n"], d, ring=d), 0, hi,
            k, m, epochs_lo=lo, reps=sh["reps"])
        want.append((k, m, fill))
    assert [(k, m, fill) for k, m, _, fill in got] == want
    # a warm epoch and two chains a rep, in order
    assert len(got_d) == 3 * sh["reps"] * len(sh["grid"])
    assert got_d == want_d


def test_lo_chain_is_the_jax_rule():
    """At bench's 3 * 2**21 decisions ``lo_epochs`` is the rule the JAX
    ``_timed_prefix_epochs`` applies when it is given no lo chain."""
    for hi, k, m in ((16, 65536, 8), (6, 65536, 21), (2, 98304, 64),
                     (8, 49152, 21), (128, 16384, 64)):
        assert SW.lo_epochs(hi, k, m, 3 << 21) == max(
            1, hi // 4, -((3 << 21) // -(m * k)))
    assert SW.lo_epochs(8, 49152, 21, 3 << 21) == 7


def test_regime_sweep_equals_the_jax_script(monkeypatch):
    sh = SW.CUT["regime"]
    n, depth, k, m, epochs = (sh[x] for x in ("n", "depth", "k", "m",
                                               "epochs"))
    assert np.array_equal(SW.resv_state(n, depth, "cpu").head_resv.numpy(),
                          np.asarray(jax_resv_state(n, depth).head_resv))
    got_d, want_d = record_digests(monkeypatch)
    got = SW.tpu_regime_sweep(**sh, device="cpu")

    lo = SW.lo_epochs(epochs, k, m, sh["lo_decisions"])
    want = []
    _, fill = RS._timed_prefix_epochs(lambda: jax_resv_state(n, depth),
                                      10**15, epochs, k, m, epochs_lo=lo,
                                      reps=sh["reps"])
    want.append(fill)
    st = jax_resv_state(n, depth)
    now = int(np.asarray(st.head_resv).min()) + 2 * 10**7
    want.append(RS._timed_transient_chain(st, now, epochs, k, m)[1])
    _, fill = RS._timed_prefix_epochs(
        lambda: graft._preloaded_state(n, depth, ring=depth), 0, epochs, k,
        m, epochs_lo=lo, reps=sh["reps"])
    want.append(fill)
    serial = jax.jit(lambda s, t: JK.engine_run(
        s, t, sh["serial_steps"], allow_limit_break=False,
        anticipation_ns=0, advance_now=False))
    state = graft._preloaded_state(n, depth, ring=depth)
    runs = []
    for _ in range(2):
        state, _, decs = serial(state, jnp.int64(0))
        jax.device_get(profile_util.state_digest(state))
        runs.append(decs)
    want.append(1.0)
    assert [name for name, _, _ in got] == [
        "reservation backlog", "resv->weight transition (transient)",
        "weight steady state", "exact serial engine"]
    assert [fill for _, _, fill in got] == want
    assert got_d == want_d

    _, _, (warm, timed) = SW.serial_floor(
        SW._preloaded_state(n, depth, ring=depth, device="cpu"),
        sh["serial_steps"])
    same_tree(warm, runs[0], "serial floor, warm run")
    same_tree(timed, runs[1], "serial floor, timed run")
    assert int((timed.slot >= 0).sum()) == sh["serial_steps"]


def _sections(doc: str) -> dict:
    """``{heading: the lines under it}`` of a markdown document."""
    out, cur = {}, None
    for ln in doc.splitlines():
        if ln.startswith("## "):
            cur = ln
            out[cur] = []
        elif cur is not None and ln:
            out[cur].append(ln)
    return out


def _shape_free(heading: str) -> str:
    h = heading.replace("## TPU prefix-epoch", "## Prefix-epoch")
    h = re.sub(r",? ?platform=\w+( \([^)]*\))?", "", h)
    h = re.sub(r"\b\d+k? clients", "N clients", h)
    return re.sub(r"\b([km])=\d+", r"\1=K", h)


def test_main_writes_the_jax_sections(monkeypatch, tmp_path):
    """``main`` at the cut shape on the CPU, then the JAX ``main`` fed the
    same rows (its section files and RESULTS.md in a temporary
    directory): every common section is the JAX one, table line for table
    line, under the JAX heading up to the shape and the device."""
    rows = {}
    for fn in ("tpu_km_sweep", "tpu_regime_sweep", "tpu_sustained_sweep",
               "cfg4_calibration_sweep", "device_sim_headline",
               "tpu_calendar_sweep", "tpu_allow_regime_row"):
        def rec(*a, _fn=getattr(SW, fn), _name=fn, **kw):
            rows[_name] = _fn(*a, **kw)
            return rows[_name]
        monkeypatch.setattr(SW, fn, rec)
    out = tmp_path / "sweeps.md"
    assert SW.main(["--cut", "--regimes", "--calibrate", "--devsim",
                    "--calendar", "--device", "cpu", "--out",
                    str(out)]) == 0
    got = _sections(out.read_text())

    for fn, r in rows.items():
        if fn not in ("tpu_calendar_sweep", "tpu_allow_regime_row"):
            monkeypatch.setattr(RS, fn, lambda _r=r: _r)
    monkeypatch.setattr(RS, "__file__", str(tmp_path / "run_sweeps.py"))
    monkeypatch.setattr(RS, "RESULTS", tmp_path / "RESULTS.md")
    monkeypatch.setattr("sys.argv", ["run_sweeps.py", "--skip-native",
                                     "--regimes", "--devsim",
                                     "--calibrate"])
    RS.main()
    want = _sections((tmp_path / "RESULTS.md").read_text())

    assert len(want) == 5 and len(got) == 7
    got_by = {_shape_free(h): body for h, body in got.items()}
    for h, body in want.items():
        assert _shape_free(h) in got_by, h
        assert got_by[_shape_free(h)] == body, h
    plat = "platform=cpu"
    assert all(h.endswith(f"{plat})") for h in got)
    assert "## Calendar engine serve-only drain (2048 clients, minstop, " \
           "platform=cpu)" in got
    assert got["## AtLimit Allow limit-break (2048 clients, "
               "platform=cpu)"][:2] == SW.COLUMNS["allow"]

    # at the full shape the headings are the JAX script's literal ones
    full = SW.headings(SW.FULL, "platform=cuda (NVIDIA H100 80GB HBM3, "
                                "700.00 W)")
    jax_heads = {_shape_free(h) for h in want}
    assert {_shape_free(full[k]) for k in ("km", "regime", "sustained",
                                           "devsim", "calibration")} \
        == jax_heads
    assert "100k clients, k=49152, m=21" in full["regime"]
    assert "100k clients, Zipf, k=49152 m=21, dt=50ms" in full["calibration"]


def test_cuda_by_default_and_no_fallback():
    if SW.torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        SW.main(["--cut", "--skip-km", "--calendar"])
    with pytest.raises(RuntimeError, match="cuda"):
        SW.tpu_calendar_sweep(64, 16, ((1, 4, 1),))
