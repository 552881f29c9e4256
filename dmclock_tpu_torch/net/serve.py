"""The RPC serving loop (docs/RPC.md; counterpart of
``dmclock_tpu/net/serve.py``): journal -> fused chunk on the card ->
checkpoint, double-buffered, SIGKILL-resumable, replayable.

The loop is the supervisor's stream loop with the Poisson pregen
swapped for the network coalesce: at every checkpoint boundary the
:class:`net.server.IngestServer` drains its coalesce buffer into an
``int32[epochs, n]`` superwave matrix, the :class:`net.journal
.ArrivalJournal` makes that matrix durable (fsync BEFORE apply), and
:func:`robust.guarded.run_stream_chunk_guarded` admits it through
the EXISTING device-side clamp -- no new device math, no new RNG.
Consequences, each load-bearing:

- **digest gate**: a run fed the journaled trace through the same
  loop (``trace=journal.counts_trace()``, no sockets) produces the
  IDENTICAL chain digest -- the ``--mode rpc`` acceptance gate.
- **crash equivalence**: SIGKILL anywhere -- including between the
  journal fsync and the chunk apply -- resumes from the newest
  rotation checkpoint, REPLAYS any journaled-but-unapplied record,
  rehydrates the dedup watermarks and the carry vector from the
  journal, and lands on the uninterrupted run's digest and
  admitted-counts trace.  Nothing admits twice, nothing journaled
  drops.
- **double buffering**: the ``overlap()`` seam takes + journals
  boundary T+1's arrivals while the device runs chunk T, so network
  receive and the fsync both hide under device compute.

Each boundary copies its journaled matrix to the card once; the ingest
server's thread is numpy only, and only this loop's thread launches
work on the card.  A boundary's NOTIFY verdicts are built only while a
subscriber is connected (with none, the batch is only counted); the
JAX package builds them always.  ``RpcServeConfig.device`` (default
``"cuda"``) picks the card; the JAX package's config JSON loads
unchanged.

Run it as a module for the subprocess legs (SIGKILL legs, smoke
runs)::

    python -m dmclock_tpu_torch.net.serve --config cfg.json \
        --out out.json [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import signal
import time
from typing import List, Optional

import numpy as np

from .journal import ArrivalJournal
from .server import IngestServer


@dataclasses.dataclass(frozen=True)
class RpcServeConfig:
    """Plain-data serving config (JSON-round-trips into the
    subprocess legs, the EpochJob discipline)."""

    engine: str = "prefix"
    n: int = 16                  # clients == coalesce slots
    depth: int = 4               # preloaded queue depth
    ring: int = 10
    epochs: int = 8
    m: int = 2
    k: int = 16
    chain_depth: int = 4
    select_impl: str = "sort"
    tag_width: int = 64
    calendar_impl: str = "minstop"
    ladder_levels: int = 8
    wheel_kernel: str = "xla"
    seed: int = 11
    waves: int = 4
    dt_epoch_ns: int = 10 ** 8
    ckpt_every: int = 2
    keep: int = 4
    n_shards: int = 1            # PlacementMap routing attribution
    with_slo: bool = True        # conformance verdicts in NOTIFYs
    # network knobs
    host: str = "127.0.0.1"
    port: int = 0
    high_watermark: int = 0      # 0 = auto (n * waves * 4)
    retry_after_ms: int = 25
    idle_timeout_s: float = 30.0
    fault_spec: Optional[str] = None
    # pacing: hold the FIRST boundary take until this many ops
    # admitted (a smoke run fills the buffer before serving starts)
    wait_ops: int = 0
    wait_timeout_s: float = 60.0
    # durable state (None = memory-only journal, no checkpoints --
    # the replay twin's shape)
    workdir: Optional[str] = None
    metrics_port: Optional[int] = None
    device: str = "cuda"         # the card (or "cpu" when asked)


def _cfg_from_json(d: dict) -> RpcServeConfig:
    fields = {f.name for f in dataclasses.fields(RpcServeConfig)}
    return RpcServeConfig(**{k: v for k, v in d.items()
                             if k in fields})


def _serve_job(cfg: RpcServeConfig):
    """The EpochJob twin of this config -- what lets the serving
    loop reuse the supervisor's deterministic preload verbatim (the
    digest gate's replay twin builds the same state the same way)."""
    from ..robust.supervisor import EpochJob

    return EpochJob(engine=cfg.engine, n=cfg.n, depth=cfg.depth,
                    ring=cfg.ring, epochs=cfg.epochs, m=cfg.m,
                    k=cfg.k, chain_depth=cfg.chain_depth,
                    select_impl=cfg.select_impl,
                    tag_width=cfg.tag_width,
                    calendar_impl=cfg.calendar_impl,
                    ladder_levels=cfg.ladder_levels,
                    wheel_kernel=cfg.wheel_kernel, seed=cfg.seed,
                    waves=cfg.waves, dt_epoch_ns=cfg.dt_epoch_ns,
                    ckpt_every=cfg.ckpt_every, keep=cfg.keep)


def make_server(cfg: RpcServeConfig) -> IngestServer:
    """Build (not start) the ingest server for a config, with
    PlacementMap ownership wired in as the per-shard routing
    attribution (``dmclock_rpc_shard_routed_ops_total``)."""
    shard_of = None
    if cfg.n_shards > 1:
        from ..lifecycle.placement import PlacementMap

        pm = PlacementMap(cfg.n_shards, cfg.n, mode="p2c",
                          seed=cfg.seed)
        pm.place_batch(list(range(cfg.n)),
                       backlog=np.zeros(cfg.n_shards,
                                        dtype=np.int64))
        shard_of = pm.shard_of
    return IngestServer(
        cfg.n, waves=cfg.waves, host=cfg.host, port=cfg.port,
        high_watermark=cfg.high_watermark or None,
        retry_after_ms=cfg.retry_after_ms,
        fault_spec=cfg.fault_spec, shard_of=shard_of,
        idle_timeout_s=cfg.idle_timeout_s)


def _ckpt_payload(state, digest: bytes, epoch: int, decisions: int,
                  met: np.ndarray) -> dict:
    return {"rpc_state": state,
            "rpc_digest": np.frombuffer(
                digest.ljust(32, b"\x00"), dtype=np.uint8).copy(),
            "rpc_epoch": np.int64(epoch),
            "rpc_decisions": np.int64(decisions),
            "rpc_met": np.asarray(met, dtype=np.int64)}


def trace_sha(trace: List[list]) -> str:
    """Canonical hash of an admitted-counts trace -- what the crash
    and chaos gates compare across incarnations."""
    blob = json.dumps(trace, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


def run_serve(cfg: RpcServeConfig, *,
              server: Optional[IngestServer] = None,
              trace: Optional[List[list]] = None,
              crash_after_fsync: Optional[int] = None) -> dict:
    """Run the serving loop to completion (or resume it) and return
    the result record.

    Exactly one arrivals source per boundary, in priority order: an
    existing journal record (resume/replay), the live ``server``
    coalesce, or the ``trace`` matrix (the self-generated twin).
    ``crash_after_fsync=k`` SIGKILLs the process immediately after
    boundary ``k``'s journal record is durable and before its chunk
    applies -- the exact window the crash-equivalence tests pin.
    """
    import torch

    from ..device import resolve_device
    from ..engine.stream import chunk_bounds
    from ..obs import device as obsdev
    from ..robust.digest import digest_update
    from ..robust.guarded import run_stream_chunk_guarded
    from ..robust.supervisor import _job_state
    from ..utils import checkpoint as ckpt_mod

    dev = resolve_device(cfg.device)
    job = _serve_job(cfg)
    state = _job_state(job, dev)
    digest = b""
    decisions = 0
    met = np.zeros(obsdev.NUM_METRICS, dtype=np.int64)
    start = 0
    resumed = False

    ckpt_dir = None
    journal = ArrivalJournal(cfg.workdir)
    if cfg.workdir is not None:
        ckpt_dir = os.path.join(cfg.workdir, "ckpt")
        if ckpt_mod.rotation_paths(ckpt_dir):
            like = _ckpt_payload(state, b"\x00" * 32, 0, 0, met)
            tree, _ = ckpt_mod.restore_pytree_rotating(ckpt_dir, like,
                                                       device=dev)
            state = tree["rpc_state"]
            digest = bytes(np.asarray(tree["rpc_digest"],
                                      dtype=np.uint8).tobytes())
            start = int(tree["rpc_epoch"])
            decisions = int(tree["rpc_decisions"])
            met = np.asarray(tree["rpc_met"], dtype=np.int64).copy()
            resumed = True
    if server is not None:
        last = journal.last_marks()
        if last is not None:
            server.restore_marks(last)
        carry = journal.entries[-1].get("carry") \
            if journal.entries else None
        if carry:
            with server._lock:
                server.pending += np.asarray(carry, dtype=np.int64)

    # the SLO plane: conformance verdicts for the completion
    # notifications -- same contract layout as the preload (rate
    # floor 100 ops/s, weights 1 + i % 4), re-registered identically
    # on resume (deterministic counters; docs/RPC.md)
    slo_plane = slo_block = None
    slo_w0 = start
    if cfg.with_slo:
        from ..obs import slo as slo_mod

        slo_plane = slo_mod.SloPlane(cfg.n,
                                     dt_epoch_ns=cfg.dt_epoch_ns)
        for c in range(cfg.n):
            slo_plane.register(c, 100.0, 1.0 + (c % 4), 0.0)
        slo_block = slo_plane.stamp(slo_mod.window_zero(cfg.n, dev))

    scrape = None
    if cfg.metrics_port is not None:
        from ..obs.registry import start_http_server

        scrape = start_http_server(port=cfg.metrics_port,
                                   host=cfg.host, fail_soft=True)
        if scrape is not None and server is not None:
            scrape.mount("/rpc", server.http_handler)

    if server is not None and cfg.wait_ops > 0 and start == 0 \
            and len(journal) == 0:
        deadline = time.monotonic() + cfg.wait_timeout_s
        while time.monotonic() < deadline:
            if server.counters["admitted_ops"] >= cfg.wait_ops:
                break
            time.sleep(0.01)

    lats: List[int] = []
    drops_seen = int(met[obsdev.MET_INGEST_DROPS])
    nxt: dict = {}

    def record_for(k: int, epochs_k: int) -> dict:
        """Take + durably journal boundary ``k`` (live mode)."""
        t = server.take_chunk(epochs_k)
        ent = journal.append({
            "seq": k, "counts": t.counts.tolist(),
            "carry": t.carry, "marks": t.marks,
            "events": t.events})
        nxt.setdefault("arrivals", {})[k] = t.arrivals_ns
        return ent

    bounds = list(chunk_bounds(start, cfg.epochs, cfg.ckpt_every))
    for e0, b in bounds:
        kb = e0 // cfg.ckpt_every
        ent = journal.entry_at(kb)
        if ent is None:
            if server is not None:
                ent = record_for(kb, b - e0)
            elif trace is not None:
                if kb >= len(trace):
                    raise ValueError(
                        f"replay trace ends at boundary {len(trace)}"
                        f", need {kb}")
                ent = journal.append({
                    "seq": kb, "counts": list(trace[kb]),
                    "carry": [], "marks": {}, "events": {}})
            else:
                raise ValueError("no arrivals source: need a live "
                                 "server, a trace, or a journal")
        if crash_after_fsync is not None and kb == crash_after_fsync:
            # the crash-equivalence window: the record is durable,
            # the chunk has NOT applied
            os.kill(os.getpid(), signal.SIGKILL)
        # the boundary's one host-to-card copy of its matrix
        counts = torch.from_numpy(
            np.asarray(ent["counts"], dtype=np.int32)).to(dev)

        overlap = None
        if server is not None and b < cfg.epochs:
            k_next, e_next = kb + 1, min(
                b + cfg.ckpt_every, cfg.epochs) - b

            def overlap(k_next=k_next, e_next=e_next):
                if journal.entry_at(k_next) is None:
                    record_for(k_next, e_next)

        g = run_stream_chunk_guarded(
            state, e0, counts, engine=cfg.engine, epochs=b - e0,
            m=cfg.m, k=cfg.k, chain_depth=cfg.chain_depth,
            dt_epoch_ns=cfg.dt_epoch_ns, waves=cfg.waves,
            with_metrics=True, select_impl=cfg.select_impl,
            tag_width=cfg.tag_width,
            calendar_impl=cfg.calendar_impl,
            ladder_levels=cfg.ladder_levels, slo=slo_block,
            overlap=overlap)
        state = g.state
        slo_block = g.slo
        for i in range(b - e0):
            decisions += g.counts[i]
            digest = digest_update(digest, g.epochs[i])
            for r in g.epochs[i]:
                if getattr(r, "metrics", None) is not None:
                    met = obsdev.metrics_combine_np(met, r.metrics)

        # the verdicts are built only for a subscriber to hear: at
        # 100,000 clients the rows and their JSON take seconds of the
        # host thread that launches the chunks
        heard = server is not None and server.subscribers() > 0
        verdicts = []
        if slo_plane is not None:
            slo_block, closed = slo_plane.roll(
                slo_block, slo_w0, b, depth=state.depth)
            slo_w0 = b
            if heard:
                verdicts = slo_plane.conformance_rows(closed)

        commit_ns = time.monotonic_ns()
        for t_arr in nxt.get("arrivals", {}).pop(kb, []):
            lats.append(commit_ns - t_arr)
        if server is not None:
            drops_now = int(met[obsdev.MET_INGEST_DROPS])
            server.note_device_drops(drops_now - drops_seen)
            drops_seen = drops_now
            if heard:
                server.publish({"b": b, "boundary": kb,
                                "decisions": int(sum(g.counts)),
                                "verdicts": verdicts})
            else:
                server.publish_unheard()
            if scrape is not None:
                try:
                    from ..obs import rpc as obsrpc

                    obsrpc.publish_rpc(scrape.registry,
                                       server.status())
                    obsrpc.publish_rpc_latency(
                        scrape.registry,
                        obsrpc.latency_summary(lats))
                except Exception:
                    pass

        if ckpt_dir is not None:
            ckpt_mod.save_pytree_rotating(
                ckpt_dir, _ckpt_payload(state, digest, b, decisions,
                                        met), keep=cfg.keep)

    from ..obs import rpc as obsrpc

    events = journal.entries[-1].get("events", {}) \
        if journal.entries else {}
    if server is not None:
        events = dict(server.counters)
    out = {
        "mode": "rpc-serve" if server is not None else "rpc-replay",
        "resumed": resumed,
        "digest": digest.hex(),
        "decisions": int(decisions),
        "boundaries": len(journal),
        "trace_sha": trace_sha(journal.counts_trace()),
        "admitted_ops_traced": int(sum(
            int(np.asarray(ent["counts"]).sum())
            for ent in journal.entries)),
        "carry_ops": int(np.asarray(
            journal.entries[-1].get("carry") or [0]).sum())
        if journal.entries else 0,
        "ingest_drops": int(met[obsdev.MET_INGEST_DROPS]),
        "events": events,
        "latency": obsrpc.latency_summary(lats),
    }
    if scrape is not None:
        scrape.close()
    return out


def main(argv=None) -> int:
    """Subprocess entry for the smoke runs and the SIGKILL legs: runs
    a live serving leg (or a journal resume of one) and writes the
    result record as JSON."""
    ap = argparse.ArgumentParser(prog="dmclock_tpu_torch.net.serve")
    ap.add_argument("--config", required=True,
                    help="RpcServeConfig as JSON")
    ap.add_argument("--out", required=True,
                    help="result record path (written atomically)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    ap.add_argument("--crash-after-fsync", type=int, default=None)
    ap.add_argument("--resume-replay", action="store_true",
                    help="resume WITHOUT a live server: finish from "
                    "the journal alone (post-SIGKILL incarnation)")
    ap.add_argument("--device", default=None,
                    help="cuda (the config's default) or cpu")
    args = ap.parse_args(argv)

    with open(args.config, "r", encoding="utf-8") as f:
        cfg = _cfg_from_json(json.load(f))
    if args.device is not None:
        cfg = dataclasses.replace(cfg, device=args.device)

    server = None
    if not args.resume_replay:
        server = make_server(cfg).start()
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(server.port))
            os.replace(tmp, args.port_file)
    try:
        out = run_serve(cfg, server=server,
                        crash_after_fsync=args.crash_after_fsync)
    finally:
        if server is not None:
            server.stop()
    tmp = args.out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f, sort_keys=True)
    os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
