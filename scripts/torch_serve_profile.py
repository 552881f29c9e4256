"""Where the time of a ``serve`` or ``chain`` epoch or a ``cfg3`` or
``cfg4`` round goes on the card (PyTorch port).

    python3 scripts/torch_serve_profile.py [--n 100000] [--epochs 1]
    python3 scripts/torch_serve_profile.py --select-impl radix
    python3 scripts/torch_serve_profile.py --tag-width 32 --high-rate
    python3 scripts/torch_serve_profile.py --workload chain [--m 8]
    python3 scripts/torch_serve_profile.py --workload cfg4 [--rounds 1]
        [--calendar-impl minstop] [--telemetry on]
    python3 scripts/torch_serve_profile.py --workload cfg3 [--telemetry on]
    python3 scripts/torch_serve_profile.py --workload queue [--n 10000]
    python3 scripts/torch_serve_profile.py --workload churn [--epochs 64]
    python3 scripts/torch_serve_profile.py --workload device_sim
        [--rounds 2] [--calendar-impl minstop]
    python3 scripts/torch_serve_profile.py --workload mesh [--n-shards 8] \
        [--devices cuda:0,cuda:0 | --devices 4]
        [--counter-sync-every 4]
    python3 scripts/torch_serve_profile.py --workload rpc [--n 100000]

Builds the workload's state (``dmclock_tpu_torch.serve``: the preloaded
``serve`` backlog, with ``--high-rate`` the same backlog at 1000x the
rates in a 128-slot ring, the shape on which ``--tag-width 32`` never
trips; or the ``cfg3`` or ``cfg4`` state with its arrival draws
uploaded, with ``--telemetry on`` bench's accumulators riding the
rounds), runs one warm-up epoch or round, then traces ``--epochs``
epochs or ``--rounds`` rounds with ``torch.profiler`` (CPU and CUDA
activities).  ``serve`` runs at ``now = 0`` and ``chain`` at 20 ms
(every reservation tag eligible), each with its ``--select-impl`` and
``--tag-width``.  Prints, on the card it ran on: the host wall time, the
device busy time (the union of kernel intervals) and so the device idle
share, the number of kernel launches, the device time of the port's
kernels (K1 ``ring_window``, K2 ``wheel_scan``) and their share, and
the operators that take most device time.  ``queue`` profiles two
windows of the pull queue at the chip shape (``serve.serve_queue``):
the flush that ingests the bulk load's last rows, and one
``pull_batch(100 ms, 2048)`` (with its launches per decision).
``churn`` profiles bench's churn row (``serve.churn_row``, flash_crowd,
4,096 ids, SLO on) over ``--epochs`` epochs (64, the row's own), with a
span tracer beside it for the wall share of the lifecycle boundaries;
it prints launches per epoch, counting only the epoch loop's (a
``churn.loop_end`` profiler range marks where the loop ends, after its
last round, so the final SLO roll, the read-backs and the digest's
copies that follow are counted apart).  ``device_sim`` profiles the
device sim's closed-loop headline (``sim.device_sim.headline_setup``:
100,000 clients on 8 servers, ring 64, 8,192 serves a server a slice)
op by op and through the program (``jit_device_sim_step``) in one
call, each over ``--rounds`` slices after one warm-up launch of 2
slices (the program's captures), and prints launches, read backs and
serve batches (launched and in a server's loop) per slice (with
``--calendar-impl`` the slices front-load calendar batches).  ``mesh``
profiles one chunk of bench's mesh row (``serve.mesh_row``'s shape:
100,000 clients over ``--n-shards`` shards on the card, 8 epochs) after
one warm chunk, and prints launches per shard-epoch and the counter
sum's share: its device time (CUDA events over repeated sums of the
chunk's counters) and launches per epoch against the chunk's.
``--devices`` lays the shards out in device groups
(``make_mesh(S, devices=...)``; a name may repeat, a count names the
first cards) and runs the grouped chunk the same way; the counter sum
is then the reduction within and between the groups.  ``rpc``
profiles the RPC serving loop at ``rpc_full``'s shape
(``net.serve.run_serve``: 100,000 clients, ring 128 preloaded 64 deep,
prefix m=8 batches of k=65,536, 8 waves, a boundary every 2 epochs, 6
epochs) with the ingest server in process and 4 loadgen worker
processes of 16,384 requests sending while the chunks run, and prints
each chunk's wall, device busy time, idle share and launches (a
``rpc.chunk`` profiler range around each guarded chunk call, the next
boundary's take and fsync inside it) and each boundary's (chunk start
to chunk start: the drain, the SLO roll, the NOTIFY and the
checkpoint too).  The full
table goes to
``chiprun_out/<workload>[_<knobs>]_profile.txt``.  Needs CUDA; exits non-zero
without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the profiler ranges this script opens (``record_function``)
RANGES = ("churn.loop_end", "rpc.chunk")


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("serve", "chain", "cfg3",
                                           "cfg4", "queue", "churn",
                                           "device_sim", "mesh", "rpc"),
                    default="serve")
    ap.add_argument("--n", type=int, default=None,
                    help="clients (100000; cfg3 and queue 10000)")
    ap.add_argument("--depth", type=int, default=320,
                    help="serve, chain: queue depth and ring size")
    ap.add_argument("--k", type=int, default=65536)
    ap.add_argument("--m", type=int, default=None,
                    help="batches per epoch (serve 32, chain 8)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="serve, chain (1); churn (64)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="cfg3, cfg4 (1); device_sim: slices (2)")
    ap.add_argument("--telemetry", choices=("on", "off"), default="off",
                    help="cfg3, cfg4: the histograms, ledger, SLO window "
                    "and provenance accumulators (bench's defaults are "
                    "on)")
    ap.add_argument("--calendar-impl",
                    choices=("minstop", "bucketed", "wheel"),
                    default=None,
                    help="cfg4: the calendar scheme (wheel, the "
                    "default: bench's cfg4_wheel row; minstop: its cfg4 "
                    "row); device_sim: front-load the slices with "
                    "calendar batches (default none)")
    ap.add_argument("--select-impl", choices=("sort", "radix"),
                    default="sort", help="serve, chain")
    ap.add_argument("--tag-width", type=int, choices=(64, 32), default=64,
                    help="serve, chain")
    ap.add_argument("--high-rate", action="store_true",
                    help="serve: the backlog at 1000x the rates, ring 128")
    ap.add_argument("--n-shards", type=int, default=8, help="mesh")
    ap.add_argument("--counter-sync-every", type=int, default=1,
                    help="mesh")
    ap.add_argument("--devices", default=None,
                    help="mesh: the layout's devices (cuda:0,cuda:1; a "
                         "name may repeat) or a count of cards")
    ap.add_argument("--out", default=None,
                    help="table file (chiprun_out/<workload>[_<knobs>]"
                    "_profile.txt)")
    a = ap.parse_args(argv)
    if a.calendar_impl is None and a.workload == "cfg4":
        a.calendar_impl = "wheel"
    if a.rounds is None:
        a.rounds = 2 if a.workload == "device_sim" else 1
    if a.n is None:
        a.n = 10_000 if a.workload in ("queue", "cfg3") else 100_000
    knobs = dict(select_impl=a.select_impl, tag_width=a.tag_width)
    tag = "".join([f"_{a.select_impl}" if a.select_impl != "sort" else "",
                   f"_tag{a.tag_width}" if a.tag_width != 64 else "",
                   "_high_rate" if a.high_rate else "",
                   f"_{a.calendar_impl}" if (
                       a.workload == "cfg4" and a.calendar_impl != "wheel"
                       or a.workload == "device_sim" and a.calendar_impl)
                   else "",
                   "_telemetry" if a.telemetry == "on"
                   and a.workload in ("cfg3", "cfg4") else ""])
    out = a.out or os.path.join(ROOT, "chiprun_out",
                                f"{a.workload}{tag}_profile.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs CUDA", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs import device as obsdev

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if a.workload == "queue":
        return _profile_queue(serve, a.n, card, out)
    if a.workload == "churn":
        return _profile_churn(serve, a.epochs or 64, card, out)
    if a.workload == "device_sim":
        return _profile_device_sim(a.n, a.rounds, a.calendar_impl, card,
                                   out)
    if a.workload == "rpc":
        return _profile_rpc(a.n, card, out)
    if a.workload == "mesh":
        from dmclock_tpu_torch.device import parse_devices

        return _profile_mesh(serve, a.n, a.n_shards, a.counter_sync_every,
                             card, out, None if a.devices is None
                             else parse_devices(a.devices))
    a.epochs = a.epochs or 1
    if a.workload == "serve":
        m = 32 if a.m is None else a.m
        if a.high_rate:
            st = serve.high_rate_state(a.n, 128, device="cuda")
        else:
            st = serve._preloaded_state(a.n, a.depth, ring=a.depth,
                                        device="cuda")
        shape = dict(n=a.n, ring=st.ring_capacity, k=a.k, m=m,
                     epochs=a.epochs, high_rate=a.high_rate, **knobs)
        st = serve.serve_epochs(st, 1, k=a.k, m=m, **knobs).state

        def run():
            return serve.serve_epochs(st, a.epochs, k=a.k, m=m, **knobs)
    elif a.workload == "chain":
        m = 8 if a.m is None else a.m
        shape = dict(n=a.n, ring=a.depth, k=a.k, m=m, epochs=a.epochs,
                     chain_depth=4, now_ns=20_000_000, **knobs)
        st = serve._preloaded_state(a.n, a.depth, ring=a.depth,
                                    device="cuda")
        st = serve.chain_epochs(st, 1, k=a.k, m=m, **knobs).state

        def run():
            return serve.chain_epochs(st, a.epochs, k=a.k, m=m, **knobs)
    else:
        cfg3 = a.workload == "cfg3"
        cfg = serve.CFG3 if cfg3 else serve.CFG4
        kw = {} if cfg3 else dict(calendar_impl=a.calendar_impl)
        shape = dict(n=a.n, rounds=a.rounds, **cfg, **kw,
                     telemetry=a.telemetry)
        setup = serve.cfg3_setup if cfg3 else serve.cfg4_setup
        rounds = serve.cfg3_rounds if cfg3 else serve.cfg4_rounds
        # bench's calibration, then one warm timed round
        prep = setup(a.n, 1 + a.rounds, device="cuda", **kw)
        st, draws, t0 = prep.state, prep.draws, prep.t0
        tele = serve.Tele()
        if a.telemetry == "on":
            tele = serve.tele_zero(a.n, plane=serve.slo_plane(
                a.workload, a.n, state=st), t0=t0, device="cuda")
        warm = rounds(st, draws[:1], t0=t0, tele=tele, **kw)
        st, tele = warm.state, warm.tele

        def run():
            return rounds(st, draws[1:], t0=t0 + cfg["dt_round_ns"],
                          tele=tele, **kw)
    res, prof = _profiled(run)
    table = prof.pop("table")
    with open(out, "w") as f:
        f.write(f"{card}\n{table}\n")
    print(table)
    print(json.dumps({
        "card": card, "workload": a.workload, **shape,
        "decisions": int(res.count.sum()),
        "metrics": obsdev.metrics_dict(res.metrics), **prof}))
    return 0


def _profiled(run, mark: str | None = None, events_out=None):
    """``run()`` under ``torch.profiler`` (CPU and CUDA activities):
    ``(result, stats)``, stats with the host wall time, the device busy
    time (the union of kernel intervals), the idle share, the launches,
    the port kernels' time and share, the top operators by device time,
    and the operator table under ``"table"``.  With ``mark``, the name of
    a profiler range that ``run`` opens once after a synchronize, stats
    also split the launches into those that started on the card before
    that range (``launches_before_mark``) and after it.  With
    ``events_out`` (a dict), its ``"events"`` gets the profiler's
    events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the profiler also puts a range opened with ``record_function`` on
    # the device's timeline: such annotations are not kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in RANGES]
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in kernels)
    port_us = {name: sum(e.time_range.end - e.time_range.start
                         for e in kernels if name in e.name)
               for name in ("ring_window", "wheel_scan")}
    port_n = {name: sum(1 for e in kernels if name in e.name)
              for name in port_us}
    split = {}
    if mark is not None:
        marks = [e.time_range.start for e in prof.events()
                 if e.name == mark
                 and e.device_type == torch.autograd.DeviceType.CPU]
        if len(marks) != 1:
            raise RuntimeError(f"{len(marks)} {mark!r} ranges, want 1")
        before = sum(1 for e in kernels if e.time_range.start < marks[0])
        split = {"launches_before_mark": before,
                 "launches_after_mark": len(kernels) - before}
    if events_out is not None:
        events_out["events"] = prof.events()
    averages = prof.key_averages()
    top = sorted((e for e in averages if e.key not in RANGES),
                 key=lambda e: -e.self_device_time_total)[:12]
    return res, {**split,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernel_launches": len(kernels),
        "port_kernels": {name: {"launches": port_n[name],
                                "device_ms": port_us[name] / 1e3,
                                "share_of_busy": port_us[name]
                                / max(busy, 1e-9)}
                         for name in port_us},
        "top_device_ms": {e.key: e.self_device_time_total / 1e3
                          for e in top},
        "table": averages.table(sort_by="self_cuda_time_total",
                                row_limit=40)}


def _profile_churn(serve, epochs: int, card: str, out: str) -> int:
    """Bench's churn row at its accelerator shape over ``epochs``
    epochs (one short warm-up run first), profiled, with a span tracer
    for the boundaries' and the guarded epochs' wall shares."""
    from torch.profiler import record_function

    from dmclock_tpu_torch.obs.spans import SpanTracer

    class LoopEndTracer(SpanTracer):
        """Opens the ``churn.loop_end`` range, after a synchronize, when
        the loop's last ``bench.round`` span closes: the loop launches
        nothing after that span, and every launch before it has run."""
        rounds = 0

        def _record(self, name, *rest) -> None:
            super()._record(name, *rest)
            if name == "bench.round":
                self.rounds += 1
                if self.rounds == epochs:
                    torch.cuda.synchronize()
                    with record_function("churn.loop_end"):
                        pass

    serve.churn_row(epochs=8, device="cuda")                 # warm
    tracer = LoopEndTracer()
    res, prof = _profiled(lambda: serve.churn_row(
        epochs=epochs, tracer=tracer, device="cuda"),
        mark="churn.loop_end")
    with open(out, "w") as f:
        f.write(f"{card}\n{prof.pop('table')}\n")
    stats = tracer.name_stats()
    span_ms = {f"{name}|{cat}": v[1] / 1e6
               for (name, cat), v in stats.items()}
    wall_ms = res["wall_s"] * 1e3
    boundary_ms = span_ms.get("lifecycle.boundary|host_prep", 0.0)
    print(json.dumps({
        "card": card, "workload": "churn_flash_crowd", "epochs": epochs,
        "decisions": res["decisions"], "row_wall_s": res["wall_s"],
        "launches_per_epoch": prof["launches_before_mark"] / epochs,
        "boundary_share_of_row_wall": boundary_ms / wall_ms,
        "span_total_ms": span_ms, **prof}))
    return 0


def _profile_device_sim(n: int, slices: int, calendar_impl, card: str,
                        out: str) -> int:
    """The device sim's headline shape, op by op (``device_sim_step``)
    and through the program (``jit_device_sim_step``, the entry points'
    path) in one call: each after one warm-up launch of 2 slices (the
    program's captures), then ``slices`` slices profiled, with the
    serve batches launched and in a server's loop and the read backs
    counted (``StepCounts``)."""
    from dmclock_tpu_torch.engine import _ext
    from dmclock_tpu_torch.sim import device_sim as DS

    rows, tables = {}, []
    for how in ("op_by_op", "program"):
        _, sim, spec = DS.headline_setup(n, calendar_impl=calendar_impl,
                                         device="cuda")
        if how == "program":
            devs = DS.sim_devices(sim)
            warm = DS.jit_device_sim_step(spec, 2, devices=devs)
            run = DS.jit_device_sim_step(spec, slices, devices=devs)
        else:
            warm = run = None

        def step(s, k, counts=None, fn=None):
            if fn is not None:
                return fn(s, counts=counts)
            return DS.device_sim_step(s, spec, k, counts=counts)

        sim = step(sim, 2, fn=warm)
        if run is not None and slices != 2:
            sim = step(sim, slices, fn=run)     # its captures, unprofiled
        counts = DS.StepCounts()
        k0 = dict(_ext.LAUNCHES)
        before = DS.served_total(sim)
        res, prof = _profiled(lambda: step(sim, slices, counts, run))
        ops = DS.served_total(res) - before
        DS.check_guard_trips(res)
        tables.append(f"{how}:\n{prof.pop('table')}")
        rows[how] = {
            "ops": ops, "ops_per_slice": ops / slices,
            "launches_per_slice": prof["kernel_launches"] / slices,
            "read_backs_per_slice": counts.read_backs / slices,
            "prefix_batches_per_slice": counts.prefix_batches / slices,
            "prefix_live_per_slice": counts.prefix_live / slices,
            "calendar_batches_per_slice": counts.calendar_batches / slices,
            "calendar_live_per_slice": counts.calendar_live / slices,
            "k1_k2_launches": {k: _ext.LAUNCHES[k] - k0[k] for k in k0},
            **prof}
        del sim, res
        DS._STEP_JIT_CACHE.clear()
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        f.write(card + "\n" + "\n".join(tables) + "\n")
    print(json.dumps({
        "card": card, "workload": "device_sim", "n": n,
        "servers": spec.n_servers, "q_per_slice": spec.q_per_slice,
        "ring": DS.HEADLINE_RING, "slices": slices,
        "calendar_impl": calendar_impl, "prefix_block": DS.PREFIX_BLOCK,
        **rows}))
    return 0


def _profile_queue(serve, n: int, card: str, out: str) -> int:
    """The pull queue at the chip shape: the bulk load's last flush and
    one ``pull_batch(100 ms, 2048)``, each profiled."""
    from dmclock_tpu_torch.engine.queue import TpuPullPriorityQueue

    c = serve.QUEUE
    infos = serve.queue_classes(n)
    q = TpuPullPriorityQueue(lambda cid: infos[cid],
                             speculative_batch=c["spec"], device="cuda")
    adds = serve.queue_bulk_load(q, n)
    rows = len(q._pending)
    _, flush = _profiled(q.flush)
    q.pull_batch(c["dt_round_ns"], 8)                      # warm
    batch, pull = _profiled(lambda: q.pull_batch(c["dt_round_ns"],
                                                 c["batch"]))
    decisions = sum(1 for p in batch if p.is_retn())
    with open(out, "w") as f:
        f.write(f"{card}\n[flush of {rows} rows]\n{flush.pop('table')}\n"
                f"[pull_batch {c['batch']}]\n{pull.pop('table')}\n")
    pull["launches_per_decision"] = pull["kernel_launches"] / decisions
    print(json.dumps({
        "card": card, "workload": "queue", "n": n, "adds": adds,
        "capacity": q.state.capacity, "ring": q.state.ring_capacity,
        "flush": dict(flush, rows=rows,
                      launches_per_row=flush["kernel_launches"] / rows),
        "pull_batch": dict(pull, decisions=decisions)}))
    return 0



def _profile_mesh(serve, clients: int, n_shards: int, every: int,
                  card: str, out: str, devices=None) -> int:
    """One chunk of the mesh row's shape after one warm chunk, profiled;
    the counter sum (``parallel.tracker.global_counters_from`` over the
    per-shard counters restacked by the layout, once an epoch) timed
    apart with CUDA events on the first group's device."""
    import numpy as np

    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.parallel.tracker import global_counters_from

    c = serve.MESH
    n, chunk = clients // n_shards, c["chunk"]
    job = serve.mesh_job(n)
    mesh = TM.make_mesh(n_shards, "cuda") if devices is None \
        else TM.make_mesh(n_shards, devices=devices)
    fn = TM.build_mesh_chunk(
        mesh, engine=job.engine, epochs=chunk,
        m=job.m, k=job.k, dt_epoch_ns=job.dt_epoch_ns, waves=job.waves,
        with_metrics=True, counter_sync_every=every, ingest=True)
    rng = np.random.Generator(np.random.PCG64(serve.MESH_SEED))

    def draw():
        return TM.place_shards(serve.mesh_draws(
            rng, n_shards, n, chunk, job.arrival_lam, mesh.device), mesh)

    def sync():
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)

    state, cd, cr, vd, vr, slo = serve.mesh_start(job, n_shards,
                                                  mesh.device, mesh)
    warm = fn(state, cd, cr, vd, vr, 0, draw(), slo=slo)
    counts = draw()
    res, prof = _profiled(lambda: fn(
        warm.state, warm.cd, warm.cr, warm.view_d, warm.view_r, chunk,
        counts, slo=warm.slo))
    cds = [TM.shard_view(res.cd, s) for s in range(n_shards)]
    crs = [TM.shard_view(res.cr, s) for s in range(n_shards)]

    def counter_sum():
        return global_counters_from(TM.restack_shards(cds, mesh),
                                    TM.restack_shards(crs, mesh))

    for _ in range(3):
        counter_sum()
    reps = 200
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    with torch.cuda.device(mesh.device):
        start.record()
        for _ in range(reps):
            counter_sum()
        end.record()
    sync()
    sum_ms = start.elapsed_time(end) / reps
    sums = chunk if every == 1 else chunk // every
    shard_epochs = n_shards * chunk
    with open(out, "w") as f:
        f.write(f"{card}\n{prof.pop('table')}\n")
    print(json.dumps({
        "card": card, "workload": "mesh", "clients": clients,
        "n_shards": n_shards, "counter_sync_every": every, "epochs": chunk,
        "devices": [str(d) for d in mesh.devices],
        "decisions": int(groups.gather(res.outs["count"]).sum()),
        "launches_per_shard_epoch": prof["kernel_launches"] / shard_epochs,
        "counter_sum_ms": sum_ms, "counter_sums": sums,
        "counter_sum_share_of_busy": sum_ms * sums
        / max(prof["device_busy_ms"], 1e-9),
        "counter_sum_share_of_wall": sum_ms * sums
        / max(prof["wall_ms"], 1e-9),
        **prof}))
    return 0


def _profile_rpc(n: int, card: str, out: str) -> int:
    """Three boundaries of the RPC serving loop at ``rpc_full``'s shape
    with live traffic, profiled; per-chunk and per-boundary idle shares
    from ``rpc.chunk`` ranges."""
    import tempfile

    from torch.profiler import record_function

    from dmclock_tpu_torch.net.serve import (RpcServeConfig, make_server,
                                             run_serve)
    from dmclock_tpu_torch.robust import guarded

    real = guarded.run_stream_chunk_guarded

    def ranged(*args, **kw):
        with record_function("rpc.chunk"):
            return real(*args, **kw)

    with tempfile.TemporaryDirectory() as wd:
        cfg = RpcServeConfig(engine="prefix", n=n, depth=64, ring=128,
                             epochs=6, m=8, k=65536, waves=8, ckpt_every=2,
                             wait_ops=1, wait_timeout_s=300, workdir=wd,
                             device="cuda")
        server = make_server(cfg).start()
        lg = subprocess.Popen(
            [sys.executable, "-m", "dmclock_tpu_torch.net.loadgen",
             "--port", str(server.port), "--workers", "4", "--requests",
             "16384", "--n-clients", str(n), "--seed", "7",
             "--timeout-s", "5.0"], cwd=ROOT, stdout=subprocess.PIPE,
            text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        guarded.run_stream_chunk_guarded = ranged
        held = {}
        try:
            res, stats = _profiled(lambda: run_serve(cfg, server=server),
                                   events_out=held)
            # the workers finish against the live server (a client whose
            # server is gone reconnects without end)
            lg_out, _ = lg.communicate(timeout=300)
        finally:
            guarded.run_stream_chunk_guarded = real
            if lg.poll() is None:
                lg.kill()
                lg.wait()
            server.stop()
    events = held["events"]
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in RANGES]
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in events if e.name == "rpc.chunk"
                    and e.device_type == torch.autograd.DeviceType.CPU)

    def window(t0, t1):
        iv = [(max(e.time_range.start, t0), min(e.time_range.end, t1))
              for e in kernels
              if e.time_range.end > t0 and e.time_range.start < t1]
        busy = _busy_us(iv)
        return {"wall_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / max(t1 - t0, 1e-9),
                "kernel_launches": sum(1 for e in kernels
                                       if t0 <= e.time_range.start < t1)}

    chunks = [window(a, b) for a, b in ranges]
    bounds = [window(ranges[i][0], ranges[i + 1][0])
              for i in range(len(ranges) - 1)]
    with open(out, "w") as f:
        f.write(f"{card}\n{stats.pop('table')}\n")
    print(json.dumps({
        "card": card, "workload": "rpc", "clients": n,
        "decisions": res["decisions"], "latency": res["latency"],
        "loadgen": json.loads(lg_out.strip().splitlines()[-1]),
        "chunks": chunks, "boundaries": bounds, **stats}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
