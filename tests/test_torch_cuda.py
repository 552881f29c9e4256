"""The port's CUDA kernels (K1 ring window, K2 wheel scan) against their
plain PyTorch versions, and a cfg4 round on the card against the CPU.
Marked ``cuda``: every test skips where CUDA is unavailable.

This file imports neither ``jax`` nor the JAX package, so it also runs
on a machine with the card and no JAX, without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from dmclock_tpu_torch.engine import _ext
from dmclock_tpu_torch.engine import fastpath as tfp
from dmclock_tpu_torch.engine import kernels as tk
from dmclock_tpu_torch.obs.device import MET_REBASE_FALLBACKS

from test_torch_cases import (RING_MAIN_SHAPES, RING_SHAPES, WHEEL_CASES,
                              plain_wheel_scan, ring_case, wheel_case)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel: needs an NVIDIA GPU")
    return torch.device("cuda")


def _ring_window_matches_plain(cuda, n, q, w, ring, q0):
    ta, tc, tq = (torch.from_numpy(x).to(cuda)
                  for x in (ring, np.roll(ring, 1, axis=1), q0))
    before = _ext.LAUNCHES["ring_window"]
    ga, gc = tfp.ring_window_rows(ta, tc, tq, w)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] == before + 1
    assert ga.shape == gc.shape == (w, n)
    assert torch.equal(ga, tfp._ring_window_torch(ta, tq, w))
    assert torch.equal(gc, tfp._ring_window_torch(tc, tq, w))


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, w", RING_SHAPES + RING_MAIN_SHAPES)
def test_ring_window_kernel_matches_plain(cuda, n, q, w):
    _ring_window_matches_plain(cuda, n, q, w, *ring_case(n, q, n + q + w))


@pytest.mark.cuda
@pytest.mark.parametrize("n, q, w", RING_SHAPES)
def test_ring_window_kernel_floor_mod_of_any_head(cuda, n, q, w):
    """``q_head`` from [-2Q, 2Q): the kernel's 32-bit floored modulo
    equals the plain version's ``torch.remainder``."""
    _ring_window_matches_plain(cuda, n, q, w,
                               *ring_case(n, q, 3 * n + w, -2 * q, 2 * q))


@pytest.mark.cuda
def test_ring_window_kernel_rejects_strided_input(cuda):
    ring = torch.zeros((8, 16), dtype=torch.int64, device=cuda)
    q0 = torch.zeros((8,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfp.ring_window_rows(ring[:, ::2], ring[:, ::2], q0, 4)


# the wheel-scan cases of tests/test_torch_wheel.py and the two cfg4
# shapes: the wheel build (N=100000, nb=768) and the stop wheel
# (N=100000, nb=256)
K2_CASES = WHEEL_CASES + [("entry_keys", 100_000, 768),
                          ("stop_packs", 100_000, 256)]


def _assert_scan_matches_plain(got, keys, slot, nb):
    want = tk._wheel_scan_torch(keys, slot, nb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name, n, nb", K2_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in K2_CASES])
def test_wheel_scan_kernel_matches_plain(cuda, name, n, nb):
    keys, slot = wheel_case(name, n, nb)
    tkeys, tslot = torch.from_numpy(keys).to(cuda), \
        torch.from_numpy(slot).to(cuda)
    before = _ext.LAUNCHES["wheel_scan"]
    got = tk.wheel_scan(tkeys, tslot, nb)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["wheel_scan"] == before + 1
    _assert_scan_matches_plain(got, tkeys, tslot, nb)
    cnt, bmin, val, found = plain_wheel_scan(keys, slot, nb)
    assert np.array_equal(got[0].cpu().numpy(), cnt)
    assert np.array_equal(got[1].cpu().numpy(), bmin)
    assert int(got[2]) == val and bool(got[3]) == found


@pytest.mark.cuda
def test_wheel_scan_kernel_leaves_its_workspace_clean(cuda):
    """Calls in sequence at both bucket counts, one with every lane
    masked: each equals the plain version, so no call sees what the one
    before it merged."""
    seq = [("entry_keys", 100_000, 768), ("all_masked", 100_000, 256),
           ("stop_packs", 100_000, 256), ("entry_keys", 100_000, 768)]
    for k, (name, n, nb) in enumerate(seq):
        keys, slot = (torch.from_numpy(x).to(cuda)
                      for x in wheel_case(name, n, nb, seed=k))
        before = _ext.LAUNCHES["wheel_scan"]
        got = tk.wheel_scan(keys, slot, nb)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["wheel_scan"] == before + 1
        _assert_scan_matches_plain(got, keys, slot, nb)
        assert bool(got[3]) == (name != "all_masked")


@pytest.mark.cuda
def test_wheel_scan_kernel_replays_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph, replayed with the inputs
    changed in place between replays: each replay equals the plain
    version on the inputs it read."""
    n, nb = 1000, 256
    keys, slot = (torch.from_numpy(x).to(cuda)
                  for x in wheel_case("random", n, nb))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.wheel_scan(keys, slot, nb)           # workspace, build, warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tk.wheel_scan(keys, slot, nb)
    for name in ("stop_packs", "one_bucket", "all_masked"):
        k2, s2 = wheel_case(name, n, nb, seed=5)
        keys.copy_(torch.from_numpy(k2))
        slot.copy_(torch.from_numpy(s2))
        graph.replay()
        torch.cuda.synchronize()
        _assert_scan_matches_plain(got, keys, slot, nb)
        cnt, bmin, val, found = plain_wheel_scan(k2, s2, nb)
        assert np.array_equal(got[0].cpu().numpy(), cnt)
        assert int(got[2]) == val and bool(got[3]) == found


@pytest.mark.cuda
def test_wheel_scan_first_call_under_capture_raises(cuda, monkeypatch):
    """The workspace must not come from a graph's private pool: a first
    call on a device inside a capture raises, and allocates nothing."""
    keys, slot = (torch.from_numpy(x).to(cuda)
                  for x in wheel_case("random", 64, 8))
    tk.wheel_scan(keys, slot, 8)                # builds the kernel
    monkeypatch.setattr(tk, "_WHEEL_WORKSPACE", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            tk.wheel_scan(keys, slot, 8)
    assert tk._WHEEL_WORKSPACE == {}


@pytest.mark.cuda
def test_wheel_scan_kernel_rejects_bad_input(cuda):
    keys = torch.zeros((64,), dtype=torch.int64, device=cuda)
    slot = torch.zeros((64,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tk.wheel_scan(keys[::2], slot[::2], 8)
    with pytest.raises(TypeError):
        tk.wheel_scan(keys.to(torch.int32), slot, 8)
    with pytest.raises(TypeError):
        tk.wheel_scan(keys, slot.to(torch.int64), 8)


@pytest.mark.cuda
def test_wheel_round_on_the_card_equals_cpu(cuda):
    """One cfg4 round at 512 clients: on the card (K1 and K2 launched)
    equal to the same round on the CPU, every output and the state."""
    from dmclock_tpu_torch import serve

    st, draws = serve.cfg4_setup(512, 1, device="cpu")
    want = serve.cfg4_rounds(st, draws, calendar_impl="wheel")
    before = dict(_ext.LAUNCHES)
    got = serve.cfg4_rounds(
        st._replace(**{f: getattr(st, f).to(cuda) for f in st._fields}),
        draws.to(cuda), calendar_impl="wheel")
    torch.cuda.synchronize()
    c = serve.CFG4
    assert _ext.LAUNCHES["ring_window"] - before["ring_window"] \
        == c["m"] * c["ladder_levels"]
    assert _ext.LAUNCHES["wheel_scan"] - before["wheel_scan"] \
        == c["m"] * (1 + c["ladder_levels"])
    for f in ("count", "resv_count", "progress_ok", "served",
              "level_count", "metrics"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f, a, b in zip(want.state._fields, got.state, want.state):
        assert torch.equal(a.cpu(), b), f
    assert int(want.count.sum()) > 0


def _assert_results_equal(a, b, what=""):
    """Every field of two result NamedTuples, a state field by field."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:       # a telemetry accumulator that was off
            assert y is None, f"{what}.{f}"
            continue
        if isinstance(x, tuple):
            _assert_results_equal(x, y, f"{what}.{f}")
            continue
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), \
            f"{what}.{f}"


@pytest.mark.cuda
@pytest.mark.parametrize("now", [0, 20_000_000])
def test_radix_on_the_card_equals_sort(cuda, now):
    """4096 clients at the serve ring (320 deep), weight phase only and
    both phases: radix selection equals sort on every output, the
    metrics and the state, in prefix and chain epochs; K1 once per
    prefix epoch and once per chain batch."""
    from dmclock_tpu_torch import serve

    st = serve._preloaded_state(4096, 320, ring=320, device=cuda)
    runs = {}
    for impl in ("sort", "radix"):
        before = _ext.LAUNCHES["ring_window"]
        runs[impl] = (
            serve.serve_epochs(st, 2, k=1024, m=8, now_ns=now,
                               select_impl=impl),
            serve.chain_epochs(st, 1, k=1024, m=4, now_ns=now,
                               select_impl=impl))
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["ring_window"] - before == 2 + 4
    for a, b in zip(runs["radix"], runs["sort"]):
        _assert_results_equal(a, b, "radix vs sort")
    assert bool(runs["radix"][0].guards_ok.all())
    assert int(runs["radix"][0].count.sum()) > 0


@pytest.mark.cuda
def test_tag32_on_the_card_equals_tag64(cuda):
    """4096 clients of the high-rate backlog (rates x1000, ring 128):
    ``tag_width=32`` equals 64 in the prefix (sort and radix), chain and
    calendar (all three schemes) epochs, every output, the metrics and
    the state, and never trips."""
    from dmclock_tpu_torch import serve

    hi = serve.high_rate_state(4096, 128, device=cuda)
    now = 20_000        # every high-rate reservation tag (10 us) eligible
    runs = {
        "prefix sort": lambda w: tfp.scan_prefix_epoch(
            hi, now, 8, 1024, anticipation_ns=0, with_metrics=True,
            tag_width=w),
        "prefix radix": lambda w: tfp.scan_prefix_epoch(
            hi, now, 8, 1024, anticipation_ns=0, with_metrics=True,
            tag_width=w, select_impl="radix", window_m=4),
        "chain": lambda w: tfp.scan_chain_epoch(
            hi, now, 4, 1024, chain_depth=4, anticipation_ns=0,
            with_metrics=True, tag_width=w),
    }
    for impl in ("minstop", "bucketed", "wheel"):
        runs[f"calendar {impl}"] = (
            lambda w, impl=impl: tfp.scan_calendar_epoch(
                hi, now, 2, steps=8, with_metrics=True, tag_width=w,
                calendar_impl=impl, ladder_levels=3))
    for name, run in runs.items():
        e32, e64 = run(32), run(64)
        assert int(e32.metrics[MET_REBASE_FALLBACKS]) == 0, name
        assert int(e32.count.sum()) > 0, name
        _assert_results_equal(e32, e64, name)


def _to(res, dev):
    """A result NamedTuple (nested ones and None fields included) on
    ``dev``."""
    return type(res)(*(None if x is None else _to(x, dev)
                       if isinstance(x, tuple) else x.to(dev)
                       for x in res))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cfg3", "cfg4"])
def test_stream_and_telemetry_on_the_card(cuda, workload):
    """Four rounds of the row at a small width on the card (cfg3: 1024
    clients; cfg4 minstop: 512): with telemetry, SLO and provenance on
    they equal the same rounds on the CPU, accumulators included; the
    stream loop (chunks of 2) equals the rounds except the ingest_drops
    row; telemetry off moves no decision, state or metric."""
    from dmclock_tpu_torch import serve

    n = 1024 if workload == "cfg3" else 512
    setup = serve.cfg3_setup if workload == "cfg3" else serve.cfg4_setup
    kw = {} if workload == "cfg3" else dict(calendar_impl="minstop")
    rounds = serve.cfg3_rounds if workload == "cfg3" else serve.cfg4_rounds
    stream = serve.cfg3_stream if workload == "cfg3" else serve.cfg4_stream
    runs = {}
    for dev in ("cpu", cuda):
        st, draws = setup(n, 4, device=dev)
        tele = serve.tele_zero(n, plane=serve.slo_plane(workload, n),
                               device=dev)
        runs[dev] = (rounds(st, draws, tele=tele, **kw),
                     stream(st, draws, tele=tele, chunk=2, **kw),
                     rounds(st, draws, **kw))
    torch.cuda.synchronize()
    on, streamed, off = runs[cuda]
    _assert_results_equal(_to(on, "cpu"), runs["cpu"][0], "card vs cpu")
    assert int(on.count.sum()) > 0
    keep = torch.ones(on.metrics.shape[-1], dtype=torch.bool, device=cuda)
    keep[7] = False                            # ingest_drops
    for res, what in ((streamed, "stream"), (off, "telemetry off")):
        _assert_results_equal(res.state, on.state, f"{what}.state")
        for f in res._fields[1:]:
            if f not in ("tele", "metrics"):
                assert torch.equal(getattr(res, f), getattr(on, f)), \
                    f"{what}.{f}"
        assert torch.equal(res.metrics[keep], on.metrics[keep]), what
    assert torch.equal(off.metrics, on.metrics)
    _assert_results_equal(streamed.tele, on.tele, "stream telemetry")


@pytest.mark.cuda
def test_chain_epoch_on_the_card_equals_cpu(cuda):
    """A chain epoch at 512 clients on the card (K1 once per batch)
    equals the same epoch on the CPU, at both tag widths."""
    from dmclock_tpu_torch import serve

    st = serve._preloaded_state(512, 16, ring=16, device="cpu")
    gpu = st._replace(**{f: getattr(st, f).to(cuda) for f in st._fields})
    for width in (64, 32):
        want = tfp.scan_chain_epoch(st, 20_000_000, 4, 256, chain_depth=4,
                                    anticipation_ns=0, with_metrics=True,
                                    tag_width=width)
        before = _ext.LAUNCHES["ring_window"]
        got = tfp.scan_chain_epoch(gpu, 20_000_000, 4, 256, chain_depth=4,
                                   anticipation_ns=0, with_metrics=True,
                                   tag_width=width)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["ring_window"] - before == 4
        _assert_results_equal(got, want, f"tag{width}")
        if width == 64:
            assert int(want.count.sum()) > 0


@pytest.mark.cuda
def test_ingest_on_the_card_equals_cpu(cuda):
    """A batch of creates, repeated adds and reactivating adds, ingested
    on the card and on the CPU: the same state, field by field."""
    from dmclock_tpu_torch.engine.state import init_state

    rng = np.random.default_rng(61)
    n, q = 256, 16
    rows, made, depth = [], 0, np.zeros(n, dtype=np.int64)
    for i in range(3000):
        if made < n and (made == 0 or rng.random() < 0.1):
            rows.append((tk.OP_CREATE, made, 0, 0, 0, 0,
                         int(rng.integers(10**6, 10**9)),
                         int(rng.integers(10**6, 10**9)), 0, made))
            made += 1
            continue
        s = int(rng.integers(0, made))
        if depth[s] < q:
            depth[s] += 1
            rows.append((tk.OP_ADD, s, 10**9 + i * 1000, 1, 1, 1, 0, 0, 0,
                         0))
    rows = np.asarray(rows, dtype=np.int64).T
    want = tk.ingest(init_state(n, q, device="cpu"), tk.IngestOps(*rows),
                     anticipation_ns=0)
    got = tk.ingest(init_state(n, q, device=cuda), tk.IngestOps(*rows),
                    anticipation_ns=0)
    for f, a, b in zip(want._fields, got, want):
        assert torch.equal(a.cpu(), b), f


@pytest.mark.cuda
def test_queue_on_the_card_equals_cpu(cuda):
    """The pull queue's API at 300 clients (bulk load with growth,
    pull_batch, a stream, buffered pulls with adds between, do_clean with
    erases), and the push queue behind the virtual server at 100: on the
    card equal to the CPU, and no K1 or K2 launch."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.core.recs import ReqParams
    from dmclock_tpu_torch.engine.queue import TpuPullPriorityQueue

    def run(device):
        infos = serve.queue_classes(400)
        clock = [0.0]
        q = TpuPullPriorityQueue(lambda c: infos[c], speculative_batch=16,
                                 monotonic_clock=lambda: clock[0],
                                 device=device)
        serve.queue_bulk_load(q, 300)
        t = serve.QUEUE["dt_round_ns"]
        out = [serve.pullreq_row(p) for p in q.pull_batch(t, 128)]
        out += [serve.pullreq_row(p) for w in
                q.pull_batch_stream(t, 10**6, 2, 32) for p in w]
        for i in range(64):
            t += 2000
            if i % 4 == 0:
                q.add_request(("x", i), 300 + i // 4, ReqParams(), time_ns=t)
            out.append(serve.pullreq_row(q.pull_request(t)))
        q.do_clean()
        clock[0] = 1000.0
        q.do_clean()
        q.settle()
        return out, q.ledger_rows(), q.departed_report(), q.state

    before = dict(_ext.LAUNCHES)
    got = run(cuda)
    assert dict(_ext.LAUNCHES) == before
    want = run("cpu")
    assert got[0] == want[0]
    assert {k: v.tolist() for k, v in got[1].items()} == \
        {k: v.tolist() for k, v in want[1].items()}
    assert [(c, r.tolist()) for c, r in got[2]] == \
        [(c, r.tolist()) for c, r in want[2]]
    for f, a, b in zip(want[3]._fields, got[3], want[3]):
        assert torch.equal(a.cpu(), b), f
    push, woke = serve.virtual_server("push", 100, device=cuda)
    assert (push, woke) == serve.virtual_server("pull", 100, device="cpu")
    assert len(push) == 100 and woke > 0


@pytest.mark.cuda
@pytest.mark.parametrize("scenario, total_ids", [("flash_crowd", 200),
                                                 ("churn_storm", 96)])
def test_churn_row_on_the_card_equals_the_cpu(cuda, scenario, total_ids):
    """Bench's churn row at a small shape whose capacities (50 or 24
    doubling) are not multiples of K1's tile: K1 launches once per
    epoch, and every output but the wall clock equals the CPU run's;
    the static variant gives the same digest."""
    from dmclock_tpu_torch import serve

    kw = dict(total_ids=total_ids, epochs=16, k=32)
    _ext.reset_launches()
    got = serve.churn_row(scenario, device=cuda, **kw)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] == kw["epochs"]
    assert _ext.LAUNCHES["wheel_scan"] == 0
    want = serve.churn_row(scenario, device="cpu", **kw)
    for key in want:
        if key not in ("wall_s", "dps"):
            assert got[key] == want[key], key
    static = serve.churn_row(scenario, device=cuda, static=True, **kw)
    assert static["digest"] == got["digest"]


def _supervised_job(loop: str):
    from dmclock_tpu_torch.robust import supervisor as TS

    return TS.EpochJob(engine="calendar", calendar_impl="wheel",
                       ladder_levels=2, n=512, depth=8, ring=16, epochs=4,
                       m=2, k=8, ckpt_every=2, with_hists=True,
                       with_ledger=True, flight_records=16, with_prov=True,
                       with_slo=True, engine_loop=loop)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["round", "stream"])
def test_supervised_job_on_the_card_equals_cpu(cuda, tmp_path, loop):
    """A wheel job with every plane on: the card's bare run equals the
    CPU's field by field (K1 and K2 launched), and a killed and resumed
    run on the card is crash-equivalent to it."""
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    job = _supervised_job(loop)
    want = TS.run_job(job, device="cpu")
    _ext.reset_launches()
    got = TS.run_job(job, device=cuda)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] > 0
    assert _ext.LAUNCHES["wheel_scan"] > 0
    for f in got._fields:
        x, y = getattr(got, f), getattr(want, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f
    # killed after the last epoch, before its save: the resume lands on
    # the epoch-2 snapshot and replays epochs 2 and 3
    res = TS.run_supervised(
        job, tmp_path, TH.HostFaultPlan(
            kill_at_decisions=(want.decisions - 1,)), device=cuda)
    TS.assert_crash_equivalent(res, want)
    assert res.restarts == 1 and res.resumed_from is not None


@pytest.mark.cuda
def test_cuda_error_is_not_retried_or_restarted(cuda, tmp_path,
                                                monkeypatch):
    """The class a CUDA error raises (``torch.AcceleratorError``, a
    RuntimeError) leaves the trampoline at once: no retry, no ladder
    step, no restart.  The error is raised by hand: a real one would
    poison this process's context for the tests after it."""
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    err = getattr(torch, "AcceleratorError", RuntimeError)
    calls = [0]

    def broken(engine):
        def scan(*a, **k):
            calls[0] += 1
            raise err("CUDA error: an illegal memory access was "
                      "encountered")
        return scan

    monkeypatch.setattr(tfp, "epoch_scan_fn", broken)
    job = TS.EpochJob(n=64, depth=4, ring=8, epochs=2, m=2, k=8,
                      select_impl="radix", ladder=True, ladder_threshold=1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        TS.run_supervised(job, tmp_path, TH.zero_host_plan(), device=cuda,
                          sleep=lambda s: None)
    assert calls[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("calendar_impl", [None, "minstop", "wheel"])
def test_device_sim_on_the_card_equals_cpu(cuda, calendar_impl):
    """The device sim's headline construction at 512 clients, 8 servers,
    ring 64: two slices on the card equal the CPU on every field, with
    K1 launched at w=1 (prefix batches) or w=8 (calendar batches) and
    K2 on the wheel; a calendar run equals the prefix run."""
    from dmclock_tpu_torch.sim import device_sim as TDS

    def run(device, impl):
        _, sim, spec = TDS.headline_setup(512, calendar_impl=impl,
                                          device=device)
        counts = TDS.StepCounts()
        sim = TDS.device_sim_step(sim, spec, 2, counts=counts)
        return TDS.device_sim_to_numpy(sim), counts

    before = dict(_ext.LAUNCHES)
    got, counts = run(cuda, calendar_impl)
    k1 = _ext.LAUNCHES["ring_window"] - before["ring_window"]
    k2 = _ext.LAUNCHES["wheel_scan"] - before["wheel_scan"]
    assert k1 == counts.prefix_batches + (
        counts.calendar_batches * (4 if calendar_impl == "wheel" else 1)
        if calendar_impl else 0)
    assert (k2 > 0) == (calendar_impl == "wheel")
    want, _ = run("cpu", calendar_impl)
    base, _ = run("cpu", None)

    def same(a, b, path="sim"):
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], f"{path}.{k}")
            else:
                assert a[k].dtype == b[k].dtype and \
                    np.array_equal(a[k], b[k]), f"{path}.{k}"
    same(got, want)
    same(want, base)
    assert int(got["served_resv"].sum() + got["served_prop"].sum()) > 0
    assert int(got["guard_trips"]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pull", "push"])
def test_dmc_sim_on_the_card_equals_cpu(cuda, mode):
    """The harness over the dmclock-torch model on the card: the trace
    and the per-client phase split equal the CPU run's."""
    from dmclock_tpu_torch.sim import config as tcfg
    from dmclock_tpu_torch.sim.dmc_sim import run_sim

    cfg = tcfg.SimConfig(
        client_groups=2, server_groups=1, server_soft_limit=True,
        cli_group=[tcfg.ClientGroup(client_count=3, client_total_ops=40,
                                    client_iops_goal=120,
                                    client_outstanding_ops=8,
                                    client_reservation=15.0,
                                    client_limit=0.0,
                                    client_server_select_range=2),
                   tcfg.ClientGroup(client_count=2, client_total_ops=30,
                                    client_iops_goal=100,
                                    client_outstanding_ops=8,
                                    client_reservation=0.0,
                                    client_limit=40.0, client_weight=2.0,
                                    client_req_cost=2,
                                    client_server_select_range=2)],
        srv_group=[tcfg.ServerGroup(server_count=2, server_iops=80)])
    got = run_sim(cfg, seed=7, record_trace=True, server_mode=mode,
                  device=cuda)
    want = run_sim(cfg, seed=7, record_trace=True, server_mode=mode,
                   device="cpu")
    assert got.trace == want.trace and len(got.trace) == 180
    for cid in want.clients:
        a, b = got.clients[cid].stats, want.clients[cid].stats
        assert (a.reservation_ops, a.priority_ops) == \
            (b.reservation_ops, b.priority_ops)
