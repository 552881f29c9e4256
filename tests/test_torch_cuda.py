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

from test_torch_cases import (K3_DOOR_CASES, RING_MAIN_SHAPES, RING_SHAPES,
                              RING_SWEEP_SHAPES, WHEEL_CASES, k3_rows,
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
@pytest.mark.parametrize("n, q, w",
                         RING_SHAPES + RING_MAIN_SHAPES + RING_SWEEP_SHAPES)
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

    prep = serve.cfg4_setup(512, 1, calendar_impl="wheel", device="cpu")
    st, draws = prep.state, prep.draws
    want = serve.cfg4_rounds(st, draws, calendar_impl="wheel", t0=prep.t0)
    before = dict(_ext.LAUNCHES)
    got = serve.cfg4_rounds(
        st._replace(**{f: getattr(st, f).to(cuda) for f in st._fields}),
        draws.to(cuda), calendar_impl="wheel", t0=prep.t0)
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
        prep = setup(n, 4, device=dev)
        st, draws, kw["t0"] = prep.state, prep.draws, prep.t0
        tele = serve.tele_zero(n, plane=serve.slo_plane(workload, n,
                                                        state=st),
                               t0=prep.t0, device=dev)
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
    card equal to the CPU, no K1 or K2 launch, and K3 (the ingest's
    recurrence) launched by the queue's ingests."""
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
    after = dict(_ext.LAUNCHES)
    assert after["ingest_scan"] > before.pop("ingest_scan")
    assert {k: after[k] for k in before} == before
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
def test_churn_row_on_the_card_equals_the_cpu(cuda, monkeypatch, scenario,
                                              total_ids):
    """Bench's churn row at a small shape whose capacities (50 or 24
    doubling) are not multiples of K1's tile: K1 launches once per
    epoch, and every output but the wall clock equals the CPU run's;
    the static variant gives the same digest."""
    from dmclock_tpu_torch import serve

    from dmclock_tpu_torch.obs import compile_plane as tcp

    kw = dict(total_ids=total_ids, epochs=16, k=32)
    _ext.reset_launches()
    # each run on a fresh compile plane: its ingest program's captures
    # (a retrace a capacity move) are then its own
    monkeypatch.setattr(tcp, "_PLANE", tcp.CompilePlane())
    got = serve.churn_row(scenario, device=cuda, **kw)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] == kw["epochs"]
    assert _ext.LAUNCHES["wheel_scan"] == 0
    monkeypatch.setattr(tcp, "_PLANE", tcp.CompilePlane())
    want = serve.churn_row(scenario, device="cpu", **kw)
    for key in want:
        # the captures' wall is a wall clock (0 on the CPU)
        if key not in ("wall_s", "dps", "compile_ms_total"):
            assert got[key] == want[key], key
    assert got.keys() == want.keys()
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
    from dmclock_tpu_torch.robust import guarded as TG
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    err = getattr(torch, "AcceleratorError", RuntimeError)
    calls = [0]
    # a fresh epoch cache: a program an earlier test captured would
    # replay its graph without calling the scan
    monkeypatch.setattr(TG, "_EPOCH_JIT_CACHE", {})

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


def _mesh_chunk(device, *, engine, n, s, epochs, seed, **kw):
    """One mesh chunk of ``s`` shards of ``n`` clients (the EpochJob
    preload, ring 16 preloaded 12 deep, Poisson(2) arrivals in 4 waves,
    100 ms epochs) on ``device``; returns the chunk as host numpy."""
    from dmclock_tpu_torch.obs import slo as TSLO
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.robust import supervisor as TS

    job = TS.EpochJob(engine=engine, n=n, depth=12, ring=16, m=2,
                      k=64 if engine == "prefix" else 4, waves=4, **kw)
    mesh = TM.make_mesh(s, device)
    fn = TM.build_mesh_chunk(
        mesh, engine=engine, epochs=epochs, m=job.m, k=job.k,
        dt_epoch_ns=job.dt_epoch_ns, waves=job.waves,
        calendar_impl=job.calendar_impl, ladder_levels=job.ladder_levels,
        counter_sync_every=1)
    state = TM.stack_shards(TS._job_state(job, device), s)
    cd, cr, vd, vr = TM.counter_init(s, n, device=device)
    counts = np.random.default_rng(seed).poisson(
        2.0, (s, epochs, n)).astype(np.int32)
    out = fn(state, cd, cr, vd, vr, 0, torch.from_numpy(counts).to(device),
             slo=TM.stack_shards(TSLO.window_zero(n, device), s))
    host = {}
    for f in TM.MeshChunk._fields:
        v = getattr(out, f)
        if isinstance(v, dict):
            host.update({f"outs.{k}": x.cpu().numpy() for k, x in v.items()})
        elif isinstance(v, tuple):
            host.update({f"{f}.{k}": x.cpu().numpy()
                         for k, x in zip(v._fields, v)})
        elif v is not None:
            host[f] = v.cpu().numpy()
    return host


@pytest.mark.cuda
@pytest.mark.parametrize("engine, kw, k2", [
    ("prefix", {}, False),
    ("calendar", dict(calendar_impl="wheel", ladder_levels=4), True)])
def test_mesh_chunk_on_the_card_equals_cpu(cuda, engine, kw, k2):
    """A mesh chunk of 4 shards x 1,000 clients (the prefix engine, and
    the wheel calendar, on which K2 runs per shard) equals the CPU on
    every field of the chunk, with K1 (and K2) launched."""
    before = dict(_ext.LAUNCHES)
    got = _mesh_chunk(cuda, engine=engine, n=1000, s=4, epochs=2, seed=3,
                      **kw)
    assert _ext.LAUNCHES["ring_window"] > before["ring_window"]
    assert (_ext.LAUNCHES["wheel_scan"] > before["wheel_scan"]) == k2
    want = _mesh_chunk("cpu", engine=engine, n=1000, s=4, epochs=2, seed=3,
                       **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and \
            np.array_equal(got[key], want[key]), key
    assert int(got["outs.count"].sum()) > 0


@pytest.mark.cuda
def test_device_hbm_budget_on_the_card(cuda, monkeypatch):
    from dmclock_tpu_torch.obs import capacity as TC

    monkeypatch.delenv("DMCLOCK_HBM_BUDGET_BYTES", raising=False)
    budget = TC.device_hbm_budget()
    assert budget == torch.cuda.get_device_properties(cuda).total_memory
    plan = TC.plan_capacity(ring=16, engine="prefix", m=4, k=256,
                            telemetry=True, slo=True, stream_chunk=8)
    assert plan["budget_bytes"] == budget and plan["max_clients"] > 10 ** 6
    assert TC.device_peaks()["label"].startswith("H100") or \
        "H100" not in torch.cuda.get_device_name(cuda)


@pytest.mark.cuda
def test_supervised_mesh_job_on_the_card_equals_cpu(cuda, tmp_path):
    """A supervised mesh job (4 shards x 1,000 clients, a fault plan,
    histograms, ledger and SLO on) on the card, bare and killed once and
    resumed, equals the same job on the CPU on every result field, with
    K1 launched once a shard-epoch on the card."""
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    job = TS.EpochJob(engine="prefix", n=1000, depth=12, ring=16, m=2,
                      k=64, waves=4, epochs=4, ckpt_every=2,
                      engine_loop="mesh", n_shards=4, with_hists=True,
                      with_ledger=True, with_slo=True,
                      fault_plan="seed=7,p_dropout=0.2,p_dup=0.1")
    before = _ext.LAUNCHES["ring_window"]
    got = TS.run_job(job, device=cuda)
    launched = _ext.LAUNCHES["ring_window"] - before
    want = TS.run_job(job, device="cpu")
    assert 0 < launched <= job.epochs * job.n_shards
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    plan = TH.HostFaultPlan(kill_at_decisions=(got.decisions // 2,))
    sup = TS.run_supervised(job, tmp_path / "wd", plan, device=cuda)
    assert sup.restarts == 1
    TS.assert_crash_equivalent(sup, got)


def _mesh_replay_chunk(device, *, trip):
    """One chunk of 4 shards x 1,000 clients x 4 epochs under a sampled
    fault plan that takes shards down: the guarded fused chunk (at
    ``tag_width=32`` with client 0's tag 2^33 ns ahead when ``trip``,
    so the chunk is discarded and replays on the host loop) and the host
    replay itself, each drained as the supervisor drains it: the row
    digest, the metric fold, the counters, views, state and SLO blocks,
    as host numpy."""
    import hashlib

    from dmclock_tpu_torch.obs import device as tobs
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.robust import faults as TF
    from dmclock_tpu_torch.robust import guarded as TG
    from dmclock_tpu_torch.robust import supervisor as TS
    from dmclock_tpu_torch.robust.digest import digest_update

    s, e, n = 4, 4, 1000
    tag = dict(tag_width=32, tag_spread_ns=1 << 33) if trip else {}
    job = TS.EpochJob(engine="prefix", n=n, depth=12, ring=16, m=2, k=64,
                      waves=4, **tag)
    plan = TF.sample_plan(11, e, s, p_dropout=0.3, mean_outage_steps=2.0,
                          p_delay=0.2, p_dup=0.2, max_skew_ns=1000)
    fc = TF.plan_chunk(plan, 0, e)
    assert not fc.up.all()
    kw = dict(engine="prefix", epochs=e, m=job.m, k=job.k,
              dt_epoch_ns=job.dt_epoch_ns, waves=job.waves,
              with_metrics=True, tag_width=job.tag_width,
              counter_sync_every=2, faults=fc)
    state = TM.stack_shards(TS._job_state(job, device), s)
    ctrs = TM.counter_init(s, n, device=device)
    counts = torch.from_numpy(np.random.default_rng(3).poisson(
        2.0, (s, e, n)).astype(np.int32)).to(device)
    legs = {
        "fused": TG.run_mesh_chunk_guarded(state, *ctrs, 0, counts,
                                           mesh=TM.make_mesh(s, device),
                                           **kw),
        "host": TG.mesh_chunk_host_replay(state, *ctrs, 0, counts, **kw)}
    # the host replay's rows, live and down, stay on the state's device
    # (the fused leg's rows are its one read back)
    for row in legs["host"].epochs:
        for grp in row:
            for r in grp:
                assert r.metrics.device.type == torch.device(device).type
    out = {}
    for leg, g in legs.items():
        d, met = b"\x00" * 32, np.zeros(tobs.NUM_METRICS, dtype=np.int64)
        for row in g.epochs:
            flat = tuple(r for grp in row for r in grp)
            for r in flat:
                met = tobs.metrics_combine_np(met, r.metrics)
            d = digest_update(d, flat)
        out[leg] = {"digest": hashlib.sha256(d).hexdigest(),
                    "counts": tuple(g.counts), "metrics": met,
                    "mesh_fallback": g.mesh_fallback,
                    **{f: getattr(g, f).cpu().numpy()
                       for f in ("cd", "cr", "view_d", "view_r", "slo",
                                 "slo_merged")},
                    **{f"state.{f}": x.cpu().numpy()
                       for f, x in zip(g.state._fields, g.state)}}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("trip", [False, True], ids=["clean", "tag32-trip"])
def test_mesh_host_replay_with_down_shards_on_the_card(cuda, trip):
    """The host replay of a chunk with shards down on the card: the down
    shards' neutral rows lie on the card beside the live shards' rows
    (the fused leg's rows are its one read back to the host),
    and the drained chunk (row digest, metric fold, counters, views,
    state, SLO blocks) equals the fused chunk on the card and both legs
    on the CPU.  With the tag32 trip the fused leg is itself the host
    replay (``mesh_fallback`` 1), with K1 launched on the card."""
    before = _ext.LAUNCHES["ring_window"]
    got = _mesh_replay_chunk(cuda, trip=trip)
    assert _ext.LAUNCHES["ring_window"] > before
    want = _mesh_replay_chunk("cpu", trip=trip)
    assert got["fused"]["mesh_fallback"] == int(trip)
    assert got["host"]["mesh_fallback"] == 1
    assert sum(got["host"]["counts"]) > 0
    for a, b in ((got["fused"], got["host"]), (got["fused"], want["fused"]),
                 (got["host"], want["host"])):
        assert a.keys() == b.keys()
        for key in b:
            if isinstance(b[key], np.ndarray):
                assert a[key].dtype == b[key].dtype and \
                    np.array_equal(a[key], b[key]), key
            elif key != "mesh_fallback":
                assert a[key] == b[key], key


@pytest.mark.cuda
def test_supervised_mesh_chaos_trip_on_the_card_equals_cpu(cuda):
    """A supervised mesh job at ``tag_width=32`` under a fault plan with
    shards down: its chunks trip and replay on the host loop on the card
    (chaos fallbacks), and the job equals the same job on the CPU on
    every result field."""
    from dmclock_tpu_torch.robust import supervisor as TS

    job = TS.EpochJob(engine="prefix", n=1000, depth=12, ring=16, m=2,
                      k=64, waves=4, epochs=4, ckpt_every=2,
                      engine_loop="mesh", n_shards=4, with_hists=True,
                      with_ledger=True, with_slo=True, tag_width=32,
                      tag_spread_ns=1 << 33,
                      fault_plan="seed=7,p_dropout=0.3,p_dup=0.1")
    got = TS.run_job(job, device=cuda)
    want = TS.run_job(job, device="cpu")
    assert got.mesh_chaos_fallbacks > 0
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


# every key of a sustained row that reads the wall clock or the card's
# events (serve.sustained_row); ``compile_ms_total`` is the kernel
# build's wall where the row's first launch built the library
_ROW_WALL = ("dps", "round_ms_p50", "round_ms_p99", "round_ms_mean",
             "chain_ms", "sync_latency_ms", "event_round_ms_median",
             "event_round_ms_mean", "latency_window", "compile_ms_total")


@pytest.mark.cuda
def test_sustained_row_on_the_card_equals_cpu(cuda, monkeypatch, tmp_path):
    """Bench's cfg3 row (calibration, two pairs of timed chains with the
    SLO block rolled once a chain, two conformance rounds, the verdict
    and the tails) at a small shape on the card equals the CPU run in
    every key that does not read the wall clock, the conformance table
    byte for byte (the cost counter's ``cost_analysis`` among them); K1
    launches once a round, the captured round's warm-up and the round
    the counter counts included.  Each run records on a fresh compile
    plane (a second capture of one entry in a process is a retrace)."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs import compile_plane as tcp

    kw = dict(rounds=4, rounds_lo=2, reps=2, latency_rounds=0)
    _ext.reset_launches()
    monkeypatch.setattr(tcp, "_PLANE", tcp.CompilePlane())
    got = serve.sustained_row("cfg3", 512, **kw, device=cuda,
                              conformance_out=str(tmp_path / "card.jsonl"))
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] == 1 + 3 + 2 * (2 + 4) + 2 + 1
    assert _ext.LAUNCHES["wheel_scan"] == 0
    monkeypatch.setattr(tcp, "_PLANE", tcp.CompilePlane())
    want = serve.sustained_row("cfg3", 512, **kw, device="cpu",
                               conformance_out=str(tmp_path / "cpu.jsonl"))
    assert got.keys() - set(_ROW_WALL) == want.keys() - set(_ROW_WALL)
    for key in want:
        if key not in _ROW_WALL + ("spans",):
            assert got[key] == want[key], key
    assert got["slo"]["rolls"] == 4
    assert (tmp_path / "card.jsonl").read_bytes() == \
        (tmp_path / "cpu.jsonl").read_bytes()


@pytest.mark.cuda
def test_latency_rounds_event_window_on_the_card(cuda):
    """The latency rounds on the card: a CUDA event a round, the oldest
    of the window synchronised at each step, so every round gives one
    sample (``latency_samples == latency_rounds``), with the window of
    4 that fewer than 20 rounds force."""
    from dmclock_tpu_torch import serve

    row = serve.sustained_row("cfg4", 256, rounds=2, rounds_lo=0, reps=1,
                              latency_rounds=12, conformance_rounds=0,
                              device=cuda)
    assert row["latency_samples"] == 12
    assert row["latency_window"] == 4
    assert row["round_ms_p99"] >= row["round_ms_p50"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["round", "stream", "mesh"])
def test_controller_job_on_the_card_equals_cpu(cuda, tmp_path, loop):
    """A controller-on job (the clamp forced every boundary) on the card
    equals the CPU run on every result field, trajectory and knobs
    included, and a kill after a journaled decision resumes to it."""
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    job = TS.EpochJob(engine="prefix", n=512, depth=6, ring=10, epochs=8,
                      m=2, k=64, seed=5, arrival_lam=1.0, waves=2,
                      ckpt_every=2, engine_loop=loop,
                      n_shards=2 if loop == "mesh" else 1,
                      controller={"backlog_hi": 1})
    got = TS.run_job(job, device=cuda)
    want = TS.run_job(job, device="cpu")
    assert got.controller_decisions > 0
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    plan = TH.HostFaultPlan(kill_at_controller=((4, "after_journal"),))
    sup = TS.run_supervised(job, tmp_path / "wd", plan, device=cuda)
    assert sup.restarts == 1 and sup.controller_replays >= 1
    TS.assert_crash_equivalent(sup, got)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["prefix", "wheel"])
def test_migration_on_the_card_equals_cpu(cuda, engine):
    """Live migration on the card's mesh (rows rewritten in place on the
    shard views): the move log, counters and digest equal the CPU run's;
    the wheel calendar launches K2."""
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.robust import supervisor as TS

    kw = dict(engine="calendar", k=4, calendar_impl="wheel",
              ladder_levels=2) if engine == "wheel" else \
        dict(engine="prefix", k=16)
    job = TS.EpochJob(
        n=96, depth=6, ring=10, epochs=8, m=2, seed=5, arrival_lam=1.0,
        waves=2, ckpt_every=2, engine_loop="mesh", n_shards=4,
        placement="p2c",
        churn=make_spec("shard_skew", total_ids=64, seed=3, cold_frac=0.5,
                        cold_until=10 ** 9),
        controller=dict(sync_max=1, backlog_hi=10 ** 9, occ_lo=0.0,
                        hysteresis=1, cooldown=8, migrate_skew_hi=1.5,
                        migrate_pick="cold"), **kw)
    before = _ext.LAUNCHES["wheel_scan"]
    got = TS.run_job(job, device=cuda)
    assert (_ext.LAUNCHES["wheel_scan"] > before) == (engine == "wheel")
    want = TS.run_job(job, device="cpu")
    assert got.migrations > 0
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.cuda
def test_run_serve_on_the_card_equals_cpu(cuda):
    """One seeded admitted-counts trace through the serving loop on the
    card and on the CPU: the same record but the latency, K1 once an
    epoch on the card."""
    from dmclock_tpu_torch.net.serve import RpcServeConfig, run_serve

    rng = np.random.default_rng(21)
    trace = [rng.integers(0, 5, (2, 2000)).astype(int).tolist()
             for _ in range(4)]
    cfg = dict(n=2000, depth=8, ring=16, epochs=8, m=4, k=512, waves=4,
               ckpt_every=2)
    before = _ext.LAUNCHES["ring_window"]
    got = run_serve(RpcServeConfig(**cfg, device="cuda"), trace=trace)
    assert _ext.LAUNCHES["ring_window"] - before == cfg["epochs"]
    want = run_serve(RpcServeConfig(**cfg, device="cpu"), trace=trace)
    assert got["decisions"] > 0
    for key in want:
        if key != "latency":
            assert got[key] == want[key], key


# ----------------------------------------------------------------------
# the mesh across devices: launches on the tensors' device, and the
# grouped layout on one card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_launch_on_the_last_card_while_cuda0_is_current(cuda):
    """K1 and K2 on the last visible card while ``cuda:0`` is the current
    device: each wrapper launches on its tensors' device, equal to the
    plain version."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two CUDA devices to put a kernel's tensors "
                    f"off the current one; {count} visible")
    last = torch.device("cuda", count - 1)
    with torch.cuda.device(0):
        ring, q0 = ring_case(4096, 16, 7)
        ta, tc, tq = (torch.from_numpy(x).to(last)
                      for x in (ring, np.roll(ring, 1, axis=1), q0))
        before = dict(_ext.LAUNCHES)
        ga, gc = tfp.ring_window_rows(ta, tc, tq, 4)
        keys, slot = wheel_case("random", 4096, 768)
        cnt, bmin, val, found = tk.wheel_scan(
            torch.from_numpy(keys).to(last),
            torch.from_numpy(slot).to(last), 768)
        torch.cuda.synchronize(last)
        assert torch.cuda.current_device() == 0
    assert _ext.LAUNCHES["ring_window"] == before["ring_window"] + 1
    assert _ext.LAUNCHES["wheel_scan"] == before["wheel_scan"] + 1
    assert ga.device == last and cnt.device == last
    assert torch.equal(ga, tfp._ring_window_torch(ta, tq, 4))
    assert torch.equal(gc, tfp._ring_window_torch(tc, tq, 4))
    want = plain_wheel_scan(keys, slot, 768)
    got = (cnt.cpu().numpy(), bmin.cpu().numpy(), int(val), bool(found))
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["prefix", "wheel"])
def test_grouped_mesh_chunk_on_one_card_equals_stacked(cuda, engine):
    """The mesh chunk over ``("cuda:0",) * 4`` groups equals the one
    stacked group on the card, field by field."""
    from dmclock_tpu_torch.obs import slo as TSLO
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.robust import supervisor as TS

    s, n, epochs = 8, 2000, 2
    kw = dict(calendar_impl="wheel", ladder_levels=2) \
        if engine == "wheel" else {}
    job = TS.EpochJob(engine="prefix" if engine == "prefix" else
                      "calendar", n=n, depth=12, ring=16, m=2,
                      k=64 if engine == "prefix" else 4, waves=4, **kw)
    counts = torch.from_numpy(np.random.default_rng(3).poisson(
        2.0, (s, epochs, n)).astype(np.int32))
    outs = []
    for devices in (("cuda:0",), ("cuda:0",) * 4):
        mesh = TM.make_mesh(s, devices=devices)
        fn = TM.build_mesh_chunk(
            mesh, engine=job.engine, epochs=epochs, m=job.m, k=job.k,
            dt_epoch_ns=job.dt_epoch_ns, waves=job.waves,
            calendar_impl=job.calendar_impl,
            ladder_levels=job.ladder_levels)
        state = TM.stack_shards(TS._job_state(job, "cuda:0"), s, mesh)
        out = fn(state, *TM.counter_init(s, n, mesh=mesh), 0,
                 TM.place_shards(counts.to("cuda:0"), mesh),
                 slo=TM.stack_shards(TSLO.window_zero(n, "cuda:0"), s,
                                     mesh))
        outs.append(groups.gather(out, "cpu"))
    assert groups.is_grouped(out.cd)
    for f in TM.MeshChunk._fields:
        a, b = getattr(outs[0], f), getattr(outs[1], f)
        for x, y in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y), f
    assert int(outs[0].outs["count"].sum()) > 0


def _leaves(tree):
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in _leaves(v)]


@pytest.mark.cuda
def test_grouped_reducers_on_one_card_equal_stacked(cuda):
    """``server_sum``, ``server_max`` and the six telemetry reducers over
    ``("cuda:0",) * 4`` groups equal the stacked reductions."""
    from dmclock_tpu_torch.obs import device as TOD
    from dmclock_tpu_torch.obs import histograms as TH
    from dmclock_tpu_torch.obs import provenance as TP
    from dmclock_tpu_torch.obs import slo as TSLO
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.parallel import tracker as TT

    gen = torch.Generator().manual_seed(5)
    big = 1 << 61

    def rnd(*shape):
        return torch.randint(-big, big, shape, generator=gen,
                             dtype=torch.int64).to(cuda)

    devs = ("cuda:0",) * 4
    x = rnd(8, 1000)
    for got, want in ((TT.server_sum(groups.place(x, devs))[3], x.sum(0)),
                      (TT.server_max(groups.place(x, devs)),
                       x.max(0).values)):
        assert torch.equal(got, want)
    prov = TP.ProvBlock(margin_hist=rnd(8, TH.NUM_BUCKETS + 1),
                        scal=rnd(8, TP.PS_FIELDS), last_served=rnd(8, 100))
    for fn, v in ((TOD.metrics_mesh_reduce, rnd(8, TOD.NUM_METRICS)),
                  (TH.hist_mesh_reduce, rnd(8, TH.NUM_HISTS,
                                            TH.NUM_BUCKETS + 1)),
                  (TH.ledger_mesh_reduce, rnd(8, 100, TH.LED_COLS)),
                  (TSLO.window_mesh_reduce, rnd(8, 100, TSLO.W_FIELDS)),
                  (TP.pressure_mesh_reduce, rnd(8, TP.PRESS_FIELDS)),
                  (TP.prov_mesh_reduce, prov)):
        for a, b in zip(_leaves(fn(groups.place(v, devs))),
                        _leaves(fn(v))):
            assert torch.equal(a, b), fn.__name__


@pytest.mark.cuda
def test_cost_count_of_a_serve_epoch_on_the_card_equals_the_cpu(cuda):
    """The cost counter's count of one serve epoch (N=4,096, ring 320,
    m=4, k=1,024) is the same on the card as on the CPU, op for op: K1's
    launch counts its formula on both, and host-device copies nothing."""
    from dmclock_tpu_torch import serve as tserve
    from dmclock_tpu_torch.obs import compile_plane as tcp

    got = {}
    for dev in (cuda, torch.device("cpu")):
        st = tserve._preloaded_state(4096, 320, ring=320, device=dev)
        with tcp.CostCounter() as c:
            ep = tfp.scan_prefix_epoch(st, 0, 4, 1024, anticipation_ns=0,
                                       with_metrics=True)
        got[dev.type] = (c.cost_analysis(), c.ops(), int(ep.count.sum()))
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][1]["kernel:ring_window"]["bytes_accessed"] == \
        tfp.ring_window_cost(4096, 4)["bytes_accessed"]


@pytest.mark.cuda
def test_kernel_launches_under_the_counter_record_their_formula(cuda):
    """A K1 and a K2 launch under the cost counter record their formula
    and nothing else (the outputs' allocations are hidden), and each
    still launches once."""
    from dmclock_tpu_torch.obs import compile_plane as tcp

    n, q, w, nb = 10_000, 256, 32, 768
    gen = torch.Generator(device="cuda").manual_seed(9)
    ring = torch.randint(0, 1 << 40, (n, q), generator=gen, device=cuda,
                         dtype=torch.int64)
    cost = ring + 1
    q0 = torch.randint(0, q, (n,), generator=gen, device=cuda,
                       dtype=torch.int32)
    keys = torch.randint(-(1 << 40), 1 << 40, (n,), generator=gen,
                         device=cuda, dtype=torch.int64)
    slot = torch.randint(0, nb + 1, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    before = dict(_ext.LAUNCHES)
    with tcp.CostCounter() as c:
        tfp.ring_window_rows(ring, cost, q0, w)
        tk.wheel_scan(keys, slot, nb)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ring_window"] == before["ring_window"] + 1
    assert _ext.LAUNCHES["wheel_scan"] == before["wheel_scan"] + 1
    assert c.ops() == {
        "kernel:ring_window": dict(calls=1, **tfp.ring_window_cost(n, w)),
        "kernel:wheel_scan": dict(calls=1, **tk.wheel_scan_cost(n, nb))}


# ----------------------------------------------------------------------
# captured programs (obs/compile_plane.py)
# ----------------------------------------------------------------------

def _tree_equal(got, want):
    from torch.utils import _pytree as pytree

    a, b = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _clone(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda x: x.clone() if torch.is_tensor(x) else x, tree)


def _replays_equal_eager(prog, args, step):
    """``prog`` on ``args`` and then on ``step(args, out, i)`` three times,
    each replay equal to the eager body on a clone of its inputs and
    launching the kernels the eager body launches, as the capture
    recorded.  Returns the last arguments and the launches a replay."""
    prog(*args)                          # the warm-up and the capture
    (cap,) = prog.captures()
    assert cap["memory_analysis"]["pool_bytes"] >= 0
    names = list(_ext.LAUNCHES)
    for i in range(3):
        before = dict(_ext.LAUNCHES)
        want = prog.fn(*_clone(args))
        torch.cuda.synchronize()
        eager = {k: _ext.LAUNCHES[k] - before[k] for k in names}
        before = dict(_ext.LAUNCHES)
        got = prog(*args)
        torch.cuda.synchronize()
        replay = {k: _ext.LAUNCHES[k] - before[k] for k in names}
        assert replay == eager == {k: cap["launches"].get(k, 0)
                                   for k in names}
        _tree_equal(got, want)
        args = step(args, got, i)
    return args, replay


@pytest.mark.cuda
def test_captured_serve_epoch_equals_its_eager_body(cuda):
    """A captured serve epoch at N=4,096 (the state donated), replayed
    with a fresh state, then chained with two ``now`` values; a donated
    chain copies nothing in: its state keeps its buffers."""
    import functools

    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs import compile_plane as tcp

    st = serve._preloaded_state(4096, 64, ring=64, device="cuda")
    prog = tcp.instrumented_jit(
        functools.partial(tfp.scan_prefix_epoch, m=4, k=1024,
                          anticipation_ns=0, with_metrics=True),
        cache="bench.serve", entry=("test", 4096), donate_argnums=(0,))
    nows = (0, 3_000_000, 9_000_000)
    out, launches = _replays_equal_eager(
        prog, (st, 0), lambda a, out, i: (out.state, nows[i]))
    assert launches == {"ring_window": 1, "wheel_scan": 0, "ingest_scan": 0}
    ptrs = [t.data_ptr() for t in out[0]]
    again = prog(out[0], 0)
    assert [t.data_ptr() for t in again.state] == ptrs
    tcp.clear_compiled()


@pytest.mark.cuda
@pytest.mark.parametrize("workload, impl, launches", [
    ("cfg3", "minstop", {"ring_window": 1, "wheel_scan": 0,
                         "ingest_scan": 0}),
    ("cfg4", "wheel", {"ring_window": 2 * 2, "wheel_scan": 2 * 3,
                       "ingest_scan": 0})])
def test_captured_round_equals_its_eager_body(cuda, workload, impl,
                                              launches):
    """Bench's captured round (``serve.round_program``) at a cut width,
    state and accumulators donated, over 3 replays with new draws,
    ``t_base`` and the chained state: each equals the eager round, with
    K1 once a prefix round or once a calendar batch and level (K2 once a
    batch and level plus once a batch on the wheel: m (1 + levels))."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs import compile_plane as tcp
    from dmclock_tpu_torch.obs import histograms as thist
    from dmclock_tpu_torch.obs import provenance as tprov
    from dmclock_tpu_torch.obs import slo as tslo

    n = 2048
    c = dict(serve.CFG3, k=512, m=4) if workload == "cfg3" else \
        dict(serve.CFG4, m=2, steps=8, ladder_levels=2)
    rates, weights = serve.sustained_qos(workload, n)
    st = serve._sustained_setup(n, c["ring"], c["depth0"], rates, weights,
                                device="cuda")
    tele = serve.Tele(hists=thist.hist_zero("cuda"),
                      ledger=thist.ledger_zero(n, "cuda"),
                      slo=tslo.window_zero(n, "cuda"),
                      prov=tprov.prov_init(n, 0, "cuda"))
    rng = np.random.default_rng(3)
    draws = [torch.from_numpy(np.minimum(rng.poisson(3.0, n), c["waves"])
                              .astype(np.int32)).to(cuda) for _ in range(4)]
    prog = serve.round_program(workload, n, c, impl, st, tele,
                               telemetry=True, slo=True)
    dt = c["dt_round_ns"]
    _, got = _replays_equal_eager(
        prog, (st, draws[0], 0, tele),
        lambda a, out, i: (out.state, draws[i + 1], (i + 1) * dt,
                           serve._tele_of(out)))
    assert got == launches
    tcp.clear_compiled()


@pytest.mark.cuda
def test_a_body_that_reads_the_card_back_fails_to_capture(cuda):
    from dmclock_tpu_torch.obs import compile_plane as tcp

    def reads_back(x):
        return x * int(x.sum())

    prog = tcp.instrumented_jit(reads_back, cache="probe",
                                entry=("reads", "back"))
    with pytest.raises(tcp.CaptureError, match=r"probe \('reads', 'back'\)"):
        prog(torch.ones(4, dtype=torch.int64, device=cuda))
    assert tcp.device_failure(tcp.CaptureError("x"))


def _scan_rows(rng, r: int, b: int, leaving: bool):
    """K3 rows: tags near the int64 edges, both sides of the trigger,
    with ``leaving`` joined tags that leave the set again."""
    m = np.where(rng.random(r) < 0.25, tk.KEY_INF,
                 rng.integers(-(1 << 62), 1 << 62, r))
    m = np.where(rng.random(r) < 0.1, -(1 << 63) + 7, m)
    end = np.where(rng.random(r) < 0.5, r, np.arange(r)
                   + rng.integers(0, 7, r)) if leaving else np.full(r, r)
    rows = np.zeros((7, b), dtype=np.int64)
    rows[:, :r] = np.stack([m, rng.random(r) < 0.5,
                            rng.integers(-(1 << 62), 1 << 62, r),
                            rng.integers(0, 1 << 40, r),
                            rng.random(r) < 0.8,
                            rng.integers(0, 1 << 62, r),
                            np.minimum(end, r)])
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize(
    "r, b, opts, door",
    [(0, 8, {"leaving": False}, None), (1, 1, {"leaving": False}, None),
     (700, 1024, {"leaving": True}, None),
     (10_000, 10_000, {"leaving": False}, None)]
    + [(r, b, opts, door) for _, r, b, opts, door in K3_DOOR_CASES])
def test_ingest_scan_kernel_matches_plain(cuda, r, b, opts, door):
    """K3 (one launch) against its plain version on the first ``r``
    columns, exactly: random rows at the int64 edges (``leaving``: with
    joined tags that leave the set), and the door cases of
    ``test_torch_cases.K3_DOOR_CASES``, each of which leaves the kernel's
    scan by its door (``info``: min(F, L), L, the crossing row)."""
    rows = _scan_rows(np.random.default_rng(r), r, b, opts["leaving"]) \
        if door is None else k3_rows(r, b, 24, **opts)
    x, c = torch.from_numpy(rows).to(cuda), torch.tensor(r, device=cuda)
    before = _ext.LAUNCHES["ingest_scan"]
    got = tk.ingest_scan(x, c)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["ingest_scan"] == before + 1
    want = tk._ingest_scan_torch(torch.from_numpy(rows), torch.tensor(r))
    assert torch.equal(got.cpu()[:r], want[:r])
    if door is not None:
        info = torch.empty((3,), dtype=torch.int64, device=cuda)
        got = tk._ingest_scan_launch(x, c, x.device, info)
        s, lim, kt = info.tolist()
        assert door == ("none" if s == lim == r else
                        "leaving" if s == lim else "check"), (s, lim)
        if "cross_at" in opts:
            assert kt == opts["cross_at"] + 1
        assert torch.equal(got.cpu()[:r], want[:r])


def _ingest_case(seed: int, n: int = 64, q: int = 8, b: int = 256):
    """A state of ``n`` slots (a third idle, queues up to 3 deep) and a
    ``b``-row batch of adds and creates, slots created twice among them,
    as numpy."""
    from dmclock_tpu_torch.engine import bridge
    from dmclock_tpu_torch.engine.state import init_state

    rng = np.random.default_rng(seed)
    a = bridge.state_to_numpy(init_state(n, q, device="cpu"))
    a["active"][: n - 8] = True
    a["idle"][rng.random(n) < 0.33] = True
    a["weight_inv"][:] = rng.integers(10 ** 6, 10 ** 9, n)
    a["order"][:] = np.arange(n)
    a["depth"][: n - 8] = rng.integers(0, 4, n - 8)
    a["head_prop"][:] = rng.integers(10 ** 10, 10 ** 11, n)
    depth = a["depth"].astype(np.int64).copy()
    rows = []
    for i in range(b):
        s = int(rng.integers(0, n))
        if rng.random() < 0.15 or depth[s] >= q:
            rows.append((tk.OP_CREATE, s, 0, 0, 0, 0, 10 ** 7, 10 ** 8, 0,
                         1000 + i))
            depth[s] = 0
        else:
            rows.append((tk.OP_ADD, s, 10 ** 11 + i, 1, 1, 2, 0, 0, 0, 0))
            depth[s] += 1
    return a, np.asarray(rows, dtype=np.int64).T.copy()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ingest_on_the_card_equals_the_cpu(cuda, seed):
    """The fixed-shape ingest (K3 inside) on the card equals the same
    pass on the CPU on every field, and reads nothing back."""
    from dmclock_tpu_torch.engine import bridge

    a, rows = _ingest_case(seed)
    want = tk.ingest(bridge.state_from_numpy(a, "cpu"),
                     torch.from_numpy(rows), anticipation_ns=0)
    st, ops = bridge.state_from_numpy(a, cuda), \
        torch.from_numpy(rows).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tk.ingest(st, ops, anticipation_ns=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f, g, w in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w), f


@pytest.mark.cuda
@pytest.mark.parametrize("steps, segments", [(1, 1), (145, 2)])
def test_queue_ingest_run_is_captured_whole(cuda, steps, segments):
    """The queue's ``ingest_run`` on the card: one graph holding the
    ingest, the serial leg's blocks (child graphs) and the packing, or,
    for a leg of more than a block and a remainder, two segments with
    the blocks replayed between them; each replay equal to the eager
    body, with no synchronising operation.  Then ``run`` of 145 steps,
    whose body opens with the leg (an empty first segment)."""
    from dmclock_tpu_torch.engine import bridge
    from dmclock_tpu_torch.engine import queue as TQ
    from dmclock_tpu_torch.obs import compile_plane as tcp

    a, rows = _ingest_case(4)
    prog = TQ._shared_jit_ingest_run(steps, False, False, 0)
    prog.clear_compiled()
    st, ops = bridge.state_from_numpy(a, cuda), \
        torch.from_numpy(rows).to(cuda)
    prog(st, ops, 2 * 10 ** 11)
    (cap,) = prog.captures()
    assert cap["segments"] == segments and cap["launches"] == \
        {"ingest_scan": 1}
    for i in range(3):
        with tcp.eager():
            want = prog.fn(*_clone((st, ops, 2 * 10 ** 11 + i)))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = prog(st, ops, 2 * 10 ** 11 + i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        _tree_equal(got, want)
    run = TQ._shared_jit_run(145, False, False, 0)
    run.clear_compiled()
    first = run(st, 2 * 10 ** 11)
    with tcp.eager():
        want = run.fn(*_clone((st, 2 * 10 ** 11)))
    _tree_equal(first, want)
    _tree_equal(run(st, 2 * 10 ** 11), want)
    assert run.captures()[0]["segments"] == 2
    tcp.clear_compiled()


# ----------------------------------------------------------------------
# the programs over several groups (one graph a group a segment)
# ----------------------------------------------------------------------

GROUPS8 = ("cuda:0",) * 8


def _held_grouped(monkeypatch, prog, args, step, legs_a_call):
    """A grouped program (``compile_plane.StagedJit`` with one leg a
    group) on the card: its first call captures one graph a leg; then
    three calls on ``step(args, out, i)``, each replaying
    ``legs_a_call`` legs with the sync debug mode's errors on (0 syncs
    a call), equal to its body run eagerly on a clone of its inputs and
    capturing nothing new.  Returns the results of the three calls."""
    from dmclock_tpu_torch.obs import compile_plane as tcp

    calls = []
    real = tcp.Leg.__call__

    def counted(self, *a, **k):
        calls.append(self.group)
        return real(self, *a, **k)

    monkeypatch.setattr(tcp.Leg, "__call__", counted)
    prog(*args)
    caps = prog.captures()
    assert caps and all(c["graph_nodes"] for c in caps)
    assert all(len(leg.program._programs) <= 1 for leg in prog.legs)
    seen = len(caps)
    outs = []
    for i in range(3):
        with tcp.eager():
            want = prog.fn(*_clone(args))
        torch.cuda.synchronize()
        calls.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = prog(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert len(calls) == legs_a_call
        _tree_equal(got, want)
        assert len(prog.captures()) == seen
        outs.append(got)
        args = step(args, got, i)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("every", [1, 2])
def test_grouped_mesh_chunk_program_replays_one_leg_a_group(
        cuda, monkeypatch, every):
    """``mesh.chunk`` over 8 groups of ``cuda:0`` (8 x 256 clients, 4
    epochs, K=1 flat or K=2 with collective skipping): one capture a
    group, 8 legs a segment at 0 syncs, each call equal to its eager
    body and to the one-group program on the same inputs."""
    from dmclock_tpu_torch.obs import compile_plane as tcp
    from dmclock_tpu_torch.obs import slo as TSLO
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.robust import supervisor as TS

    s, n, epochs = 8, 256, 4
    job = TS.EpochJob(engine="prefix", n=n, depth=12, ring=16, m=2, k=64,
                      waves=4)
    cfg = dict(engine="prefix", epochs=epochs, m=job.m, k=job.k,
               dt_epoch_ns=job.dt_epoch_ns, waves=job.waves,
               counter_sync_every=every,
               collective_skipping=every > 1)
    rng = np.random.default_rng(5)
    draws = [torch.from_numpy(rng.poisson(2.0, (s, epochs, n))
                              .astype(np.int32)).to(cuda)
             for _ in range(4)]
    one = TM.make_mesh(s, devices=("cuda:0",))
    mesh = TM.make_mesh(s, devices=GROUPS8)
    stacked = TM.jit_mesh_chunk(one, **cfg)
    prog = TM.jit_mesh_chunk(mesh, **cfg)
    prog.clear_compiled()
    assert isinstance(prog, tcp.StagedJit) and len(prog.legs) == 8
    state = TM.stack_shards(TS._job_state(job, cuda), s, mesh)
    w = TM.stack_shards(TSLO.window_zero(n, cuda), s, mesh)
    args = (state, *TM.counter_init(s, n, mesh=mesh), 0,
            TM.place_shards(draws[0], mesh), None, None, w)

    def nxt(a, out, i):
        return (out.state, out.cd, out.cr, out.view_d, out.view_r,
                (i + 1) * epochs, TM.place_shards(draws[i + 1], mesh),
                None, None, out.slo)

    outs = _held_grouped(monkeypatch, prog, args, nxt,
                         8 * epochs // every)
    # the one-group program on the first replay's inputs
    ref = stacked(*(groups.gather(a) if groups.is_grouped(a) else a
                    for a in args))
    _tree_equal(groups.gather(outs[0]), ref)
    assert int(ref.outs["count"].sum()) > 0
    tcp.clear_compiled()


@pytest.mark.cuda
def test_grouped_cluster_programs_replay_one_leg_a_group(cuda,
                                                         monkeypatch):
    """``cluster.cluster_step``, ``cluster.robust_cluster_step`` under
    an outage and ``cluster.mesh_rounds`` (2 rounds) over 8 groups of
    ``cuda:0`` (8 servers x 512 clients, 32 decisions a step): one
    capture a group, 8 legs a round at 0 syncs, each call equal to its
    eager body and to the one-group program."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs import compile_plane as tcp
    from dmclock_tpu_torch.obs import device as obsdev
    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.robust import cluster as RC
    from dmclock_tpu_torch.robust import faults as TF

    ns, nc, k, adv = 8, 512, 32, 50_000_000
    cfg = (k, 3, 0, False, adv)
    mesh, cl, costs = serve.multichip_cluster(ns, nc, "orig", cuda,
                                              devices=GROUPS8)
    one, cl1, _ = serve.multichip_cluster(ns, nc, "orig", cuda)
    costs = torch.from_numpy(costs).to(cuda)
    arr = torch.full((ns, nc), 3, dtype=torch.int32, device=cuda)
    step = CL.mesh_step_jit({}, CL.cluster_step, mesh, cfg)
    step.clear_compiled()
    outs = _held_grouped(monkeypatch, step, (cl, arr, costs),
                         lambda a, out, i: (out[0], arr, costs), 8)
    _tree_equal(groups.gather(outs[0]),
                CL.mesh_step_jit({}, CL.cluster_step, one, cfg)(
                    groups.gather(cl), arr, costs))

    plan = TF.single_outage_plan(4, ns, server=1, down_from=1,
                                 down_until=3)
    faults = [RC.fault_step_inputs(TF.plan_step(plan, t), mesh)
              for t in range(4)]
    rstep = RC._jit_step(mesh, cfg)
    rstep.clear_compiled()
    rc = RC.init_robust(cl)
    rstep(rc, arr, costs, fault=faults[3])    # the captures
    for t in range(3):
        with tcp.eager():
            want = rstep.fn(*_clone((rc, arr, costs)),
                            fault=_clone(faults[t]))
        torch.cuda.set_sync_debug_mode("error")
        try:
            rc, decs = rstep(rc, arr, costs, fault=faults[t])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        _tree_equal((rc, decs), want)
    assert [leg.name for leg in rstep.legs] == ["legs"] * 8 + \
        ["faulty_legs"] * 8
    assert all(len(leg.program._programs) == 1
               for leg in rstep.legs[8:])

    views = CL.init_mesh_views(ns, nc, device=cuda)
    met = torch.zeros((ns, obsdev.NUM_METRICS), dtype=torch.int64,
                      device=cuda)
    rounds = CL.jit_mesh_rounds(mesh, epochs=2, decisions_per_step=k,
                                max_arrivals=3, advance_ns=adv)
    rounds.program.clear_compiled()
    arr2 = torch.stack([arr, arr])
    args = (cl, arr2, costs) + tuple(CL.place_shards(x, mesh)
                                     for x in views + (met,))
    outs = _held_grouped(
        monkeypatch, rounds.program, args,
        lambda a, out, i: (out.cluster, arr2, costs, out.view_delta,
                           out.view_rho, out.metrics), 16)
    ref = CL.jit_mesh_rounds(one, epochs=2, decisions_per_step=k,
                             max_arrivals=3, advance_ns=adv)(
        groups.gather(cl), arr2, costs, *views, met)
    _tree_equal(groups.gather(outs[0]), ref)
    tcp.clear_compiled()


@pytest.mark.cuda
def test_grouped_device_sim_program_equals_one_group(cuda):
    """The device sim's step over 8 groups of ``cuda:0`` (the headline's
    prefix path at 4,096 clients, 2 slices): one leg a group and server,
    equal to the one-group program and to its eager body."""
    from dmclock_tpu_torch.obs import compile_plane as tcp
    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.sim import device_sim as DS

    _, sim0, spec = DS.headline_setup(4096, device=cuda)
    one = DS.jit_device_sim_step(spec, 2, devices=(cuda,))
    want = DS.device_sim_to_numpy(one(_clone(sim0)))
    mesh = CL.make_mesh(spec.n_servers, devices=GROUPS8)
    step = DS.jit_device_sim_step(spec, 2, devices=mesh.devices)
    step.program.clear_compiled()
    grouped = DS.shard_device_sim(sim0, mesh)
    with tcp.eager():
        eager = DS.device_sim_to_numpy(step(_clone(grouped)))
    first = DS.device_sim_to_numpy(step(_clone(grouped)))
    again = DS.device_sim_to_numpy(step(_clone(grouped)))
    for got in (eager, first, again):
        _np_tree_equal(got, want)
    assert len(step.program.captures()) == len(step.program.legs)
    assert groups.is_grouped(grouped.engine)
    tcp.clear_compiled()


def _np_tree_equal(got: dict, want: dict) -> None:
    """Two nested dicts of host arrays, equal in keys, dtypes and
    values."""
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _np_tree_equal(got[key], want[key])
        else:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key
