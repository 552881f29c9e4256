"""dmc_sim -- dmClock QoS simulation CLI.

The port's counterpart of ``dmclock_tpu/sim/dmc_sim.py``, with every
flag of it; the reference simulator binary is
``sim/src/test_dmclock_main.cc:46-342``.  Reads a reference-format INI
config (``-c/--conf``), runs the closed-loop multi-server multi-client
simulation, and prints per-group / per-server tables.  The queues run
on ``--device`` (default ``cuda``; asking for it without a card raises).

    python -m dmclock_tpu_torch.sim.dmc_sim -c configs/dmc_sim_example.conf
    python -m dmclock_tpu_torch.sim.dmc_sim -c conf --device cpu
    python -m dmclock_tpu_torch.sim.dmc_sim -c conf --model dmclock-delayed \
        --device cpu

``dmclock``, ``dmclock-delayed`` and ``dmclock-native`` are the host
reference models (``models``); ``--use-prop-heap`` applies to
``dmclock-native``.
"""

from __future__ import annotations

import argparse
import functools
import sys

from .. import models
from ..device import DEFAULT_DEVICE, resolve_device
from ..obs.trace import DecisionTrace
from .config import SimConfig, parse_config_file
from .harness import Simulation

DEFAULT_MODEL = "dmclock-torch"


def run_sim(cfg: SimConfig, model: str = DEFAULT_MODEL, seed: int = 12345,
            record_trace: bool = False,
            server_mode: str = "pull",
            registry=None, decision_trace=None,
            tracer=None, device=DEFAULT_DEVICE) -> Simulation:
    """Build and run one simulation; the queues live on ``device``
    (resolved first, so ``cuda`` without a card raises for every
    model)."""
    dev = resolve_device(device)
    _pull_factory, tracker_factory = models.get(model)
    if server_mode == "push":
        queue_factory = models.get_push(model)
    else:
        queue_factory = _pull_factory
    queue_factory = functools.partial(queue_factory, device=dev)
    sim = Simulation(cfg, queue_factory, tracker_factory, seed=seed,
                     record_trace=record_trace, server_mode=server_mode,
                     registry=registry, decision_trace=decision_trace,
                     tracer=tracer)
    sim.run()
    return sim


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dmc_sim",
                                description=__doc__.splitlines()[0])
    p.add_argument("-c", "--conf", help="INI config file "
                   "(reference sim/dmc_sim_example.conf format)")
    p.add_argument("--model", default=DEFAULT_MODEL,
                   help="scheduler model to simulate "
                   f"({', '.join(models.names())})")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device of the queues' engine state (default "
                   "cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--server-mode", default="pull",
                   choices=("pull", "push"),
                   help="drive servers by polling (pull) or let the "
                   "queue push via handle_f (the reference dmc_sim's "
                   "mode)")
    p.add_argument("--intervals", action="store_true",
                   help="print per-client per-second op counts")
    p.add_argument("--trace", metavar="FILE", default=None,
                   help="write a bounded JSONL decision trace "
                   "(schema: docs/OBSERVABILITY.md)")
    p.add_argument("--trace-limit", type=int, default=1_000_000,
                   help="max trace rows before dropping (bounded "
                   "trace; default 1M)")
    p.add_argument("--trace-out", metavar="FILE.json", default=None,
                   help="write a Chrome trace-event / Perfetto "
                   "timeline of host spans (ingest / dispatch wall "
                   "time per server; obs.spans) -- loadable in "
                   "chrome://tracing; decisions are bit-identical "
                   "with or without it")
    p.add_argument("--conformance", action="store_true",
                   help="print the per-client QoS conformance table "
                   "(delivered rate vs reservation/weight/limit), "
                   "plus reservation-tardiness percentiles when the "
                   "backend materializes tags")
    p.add_argument("--slo-check", action="store_true",
                   help="cross-check the queue backends' SLO window "
                   "mirror (obs.slo; open window == cumulative "
                   "ledger on every countable column, contract "
                   "epochs stamped) and exit nonzero on mismatch; "
                   "passes with a note when no backend exposes the "
                   "mirror")
    p.add_argument("--ledger-check", action="store_true",
                   help="cross-check backend conformance ledgers "
                   "(device-truth per-client served/reservation "
                   "counts) against the host-recomputed sim stats; "
                   "exits nonzero on a mismatch")
    p.add_argument("--metrics-out", metavar="FILE", default=None,
                   help="dump the metrics registry at exit: Prometheus "
                   "text (.prom/.txt) or JSON snapshot (.json)")
    p.add_argument("--metrics-port", type=int, metavar="PORT",
                   default=None,
                   help="serve the live metrics registry over HTTP "
                   "(GET /metrics, Prometheus text; /metrics.json) "
                   "for the duration of the run; 0 picks an "
                   "ephemeral port (printed)")
    p.add_argument("--use-prop-heap", action="store_true",
                   help="dmclock-native model: enable the O(1) "
                   "idle-reactivation prop heap (reference "
                   "USE_PROP_HEAP equivalent; same behavior, faster "
                   "adds at scale)")
    args = p.parse_args(argv)
    if args.use_prop_heap and args.model != "dmclock-native":
        p.error("--use-prop-heap applies to --model dmclock-native")
    # unconditional: an in-process caller running main() again must not
    # inherit a previous run's flag
    models.USE_PROP_HEAP = bool(args.use_prop_heap)
    try:
        models.get(args.model)
    except KeyError as e:
        p.error(e.args[0])

    if args.server_mode == "push" and \
            args.model not in models.push_names():
        p.error(f"model {args.model!r} has no push-mode queue "
                f"(push models: {', '.join(models.push_names())})")
    try:
        cfg = parse_config_file(args.conf) if args.conf else SimConfig()
    except OSError as e:
        p.error(f"cannot read config file: {e}")
    trace = DecisionTrace(args.trace, limit=args.trace_limit) \
        if args.trace else None
    tracer = None
    if args.trace_out:
        from ..obs.spans import SpanTracer
        tracer = SpanTracer()
    registry = None
    http_srv = None
    if args.metrics_port is not None:
        from ..obs.registry import MetricsRegistry, start_http_server
        registry = MetricsRegistry()
        # fail-soft: a taken port (e.g. a supervisor restarting this
        # sim while the old incarnation drains) logs a warning and
        # runs without a scrape endpoint instead of dying
        http_srv = start_http_server(registry, port=args.metrics_port)
        if http_srv is not None:
            print(f"# metrics: serving {http_srv.url}")
    try:
        sim = run_sim(cfg, model=args.model, seed=args.seed,
                      server_mode=args.server_mode,
                      registry=registry, decision_trace=trace,
                      tracer=tracer, device=args.device)
    finally:
        if trace is not None:
            trace.close()
        if http_srv is not None:
            http_srv.close()
        if tracer is not None:
            # export even on a crashed run (the timeline of a failed
            # sim is exactly when you want it), but FAIL-SOFT: an
            # unwritable path must neither fail a healthy run after
            # all the work nor mask the sim's own exception from
            # inside this finally block
            try:
                from ..obs.trace_export import export_chrome_trace
                n_ev = export_chrome_trace(tracer, args.trace_out)
                print(f"# trace-out: {n_ev} spans -> "
                      f"{args.trace_out} (chrome://tracing; "
                      f"{tracer.spans_dropped} dropped past the "
                      "ring)")
            except OSError as e:
                print(f"# trace-out failed: {e}", file=sys.stderr)
    report = sim.report()
    print(report.format(show_intervals=args.intervals))
    if args.conformance:
        print(report.format_conformance())
        pct = report.tardiness_percentiles()
        if pct is not None:
            print("-- reservation tardiness (log2-quantized upper "
                  "bounds) --")
            print(f"p50 {pct['p50_ns']:.0f} ns | "
                  f"p90 {pct['p90_ns']:.0f} ns | "
                  f"p99 {pct['p99_ns']:.0f} ns | "
                  f"mean {pct['mean_ns']:.0f} ns "
                  f"({pct['count']} constraint serves)")
    if args.ledger_check:
        chk = report.ledger_check()
        if chk is None:
            print("# ledger-check: no backend exposes a conformance "
                  "ledger (host-recomputed stats are the only "
                  "record); pass")
        elif chk["mismatches"]:
            print(f"# ledger-check: FAILED -- "
                  f"{len(chk['mismatches'])} client(s) diverge "
                  f"between the backend ledger and the host "
                  f"recount: {chk['mismatches'][:5]}")
            return 1
        else:
            print(f"# ledger-check: ok ({chk['clients']} clients, "
                  f"{chk['ops']} ops; backend ledger == host "
                  "recount)")
    if args.ledger_check and args.trace:
        # trace-vs-counters cross-check (schema v2): the JSONL trace's
        # per-phase totals must equal the harness recount (= the
        # device MET_RESV/MET_PROP mirror the ledger-check above
        # already pinned against it) -- a hard error unless rows were
        # deliberately dropped past --trace-limit
        if trace.rows_dropped:
            print(f"# trace-check: skipped ({trace.rows_dropped} "
                  "rows dropped past --trace-limit; totals cannot "
                  "match by construction)")
        else:
            from ..obs.trace import summarize
            try:
                stats = summarize(args.trace,
                                  report.phase_totals())
            except ValueError as e:
                print(f"# trace-check: FAILED -- {e}")
                return 1
            print(f"# trace-check: ok ({stats['rows']} rows; "
                  "per-phase totals == host recount == device "
                  "counters)")
    if args.slo_check:
        chk = report.slo_window_check()
        if chk is None:
            print("# slo-check: no backend exposes the SLO window "
                  "mirror; pass")
        elif chk["mismatches"]:
            print(f"# slo-check: FAILED -- "
                  f"{len(chk['mismatches'])} client(s) diverge "
                  f"between the window mirror and the ledger: "
                  f"{chk['mismatches'][:5]}")
            return 1
        else:
            print(f"# slo-check: ok ({chk['clients']} clients, "
                  f"{chk['windows_ops']} windowed ops == ledger)")
    if trace is not None and trace.rows_dropped:
        print(f"# trace: {trace.rows_written} rows written, "
              f"{trace.rows_dropped} dropped past --trace-limit")
    if args.metrics_out:
        reg = sim.registry
        if args.metrics_out.endswith(".json"):
            text = reg.snapshot_json(indent=1)
        else:
            text = reg.prometheus()
        with open(args.metrics_out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
