"""The port's RPC ingest front end (``dmclock_tpu_torch/net/`` and
``obs/rpc.py``) against the JAX package: the counterparts of
``tests/test_rpc.py`` (framing, the fault grammar and its oracle, the
arrival journal, the admission core, real loopback sockets, the load
generator's schedules, the ``dmclock_rpc_*`` families, the live-versus-
replay digest gate and the SIGKILL between the journal's fsync and the
chunk's apply), with the wire bytes, fates, oracles, schedules and
journals held equal to the JAX package's; the same journaled trace
through both packages' ``run_serve`` replays to one digest and trace
hash; and ``serve.rpc_row`` against ``bench.bench_rpc``."""

import dataclasses
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dmclock_tpu.net import faults as jfaults
from dmclock_tpu.net import framing as jframing
from dmclock_tpu.net.journal import ArrivalJournal as JJournal
from dmclock_tpu_torch.net import faults, framing
from dmclock_tpu_torch.net import loadgen
from dmclock_tpu_torch.net.client import RpcClient, drain_notifies
from dmclock_tpu_torch.net.journal import ArrivalJournal
from dmclock_tpu_torch.net.server import IngestServer

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_loadgen", REPO / "scripts" / "loadgen.py")
jloadgen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jloadgen)

CHAOS = "seed=5,p_drop=0.3,p_dup=0.2,p_reorder=0.1"


# ----------------------------------------------------------------------
# framing
# ----------------------------------------------------------------------

def test_req_ack_roundtrip():
    t, f = framing.unpack(framing.pack_req(7, 123, 3, attempt=2))
    assert t == framing.T_REQ and f == (7, 123, 3, 2)
    t, f = framing.unpack(framing.pack_ack(7, 123, framing.ST_BUSY, 50))
    assert t == framing.T_ACK and f == (7, 123, framing.ST_BUSY, 50)
    # byte for byte the JAX package's wire format
    assert framing.pack_req(7, 123, 3, 2) == jframing.pack_req(7, 123, 3, 2)
    assert framing.pack_ack(7, 123, 2, 50) == jframing.pack_ack(7, 123, 2,
                                                                50)
    assert framing.frame(b"xyz") == jframing.frame(b"xyz")


def test_notify_sub_roundtrip():
    obj = {"b": 4, "verdicts": [[0, "conformant"]]}
    t, f = framing.unpack(framing.pack_notify(obj))
    assert t == framing.T_NOTIFY and f[0] == obj
    assert framing.pack_notify(obj) == jframing.pack_notify(obj)
    t, f = framing.unpack(framing.pack_sub())
    assert t == framing.T_SUB and f == ()
    assert framing.pack_sub() == jframing.pack_sub()


def test_framer_reassembles_byte_at_a_time():
    payloads = [framing.pack_req(1, 0, 2),
                framing.pack_ack(1, 0, framing.ST_OK),
                framing.pack_notify({"k": 1})]
    stream = b"".join(framing.frame(p) for p in payloads)
    fr = framing.Framer()
    got = []
    for i in range(len(stream)):
        got.extend(fr.feed(stream[i:i + 1]))
    assert got == payloads
    assert fr.pending() == 0
    assert jframing.Framer().feed(stream) == payloads


def test_framer_rejects_oversized_prefix():
    fr = framing.Framer()
    bad = (framing.MAX_FRAME + 1).to_bytes(4, "big")
    with pytest.raises(framing.ProtocolError):
        fr.feed(bad)
    assert framing.MAX_FRAME == jframing.MAX_FRAME


def test_unknown_type_and_bad_body_raise():
    with pytest.raises(framing.ProtocolError):
        framing.unpack(bytes([99]) + b"x")
    with pytest.raises(framing.ProtocolError):
        framing.unpack(bytes([framing.T_REQ]) + b"\x01\x02")
    with pytest.raises(framing.ProtocolError):
        framing.unpack(b"")


# ----------------------------------------------------------------------
# the fault plane and its oracle
# ----------------------------------------------------------------------

def test_parse_grammar():
    text = "seed=9, p_drop=0.25, stall_ms=40, p_stall=0.5"
    spec = faults.parse_net_fault_spec(text)
    assert spec["seed"] == 9 and spec["p_drop"] == 0.25
    assert spec["stall_ms"] == 40
    assert spec == jfaults.parse_net_fault_spec(text)
    assert faults.describe(spec) == jfaults.describe(spec)
    assert faults.parse_net_fault_spec(None) is None
    assert faults.parse_net_fault_spec("") is None
    assert faults.parse_net_fault_spec("seed=3") is None


def test_parse_rejects_typos_and_ranges():
    with pytest.raises(ValueError):
        faults.parse_net_fault_spec("p_dorp=0.1")
    with pytest.raises(ValueError):
        faults.parse_net_fault_spec({"p_drop": 0.1, "wat": 1})
    with pytest.raises(ValueError):
        faults.parse_net_fault_spec("p_drop=1.5")


def test_decide_is_pure_and_attempt_sensitive():
    spec = faults.parse_net_fault_spec(CHAOS)
    ids = [(c, s, a) for c in range(8) for s in range(8) for a in range(3)]
    fates = [faults.decide(spec, *i) for i in ids]
    assert fates == [faults.decide(spec, *i) for i in ids]
    assert fates == [jfaults.decide(spec, *i) for i in ids]
    assert [faults.stall_ms(dict(spec, p_stall=0.5, stall_ms=9), *i)
            for i in ids] == \
        [jfaults.stall_ms(dict(spec, p_stall=0.5, stall_ms=9), *i)
         for i in ids]
    assert any(faults.decide(spec, c, s, 0) != faults.decide(spec, c, s, 1)
               for c in range(8) for s in range(8))


def test_oracle_order_independent():
    spec = faults.parse_net_fault_spec(CHAOS)
    sched = [(c, s) for c in range(16) for s in range(8)]
    fwd = faults.plan_events(spec, sched)
    assert fwd == faults.plan_events(spec, list(reversed(sched)))
    assert fwd == jfaults.plan_events(spec, sched)
    assert fwd["admitted"] + fwd["lost"] == len(sched)


def test_oracle_extremes():
    sched = [(c, s) for c in range(4) for s in range(4)]
    assert faults.plan_events(None, sched) == {
        "drops": 0, "dups": 0, "reorders": 0, "lost": 0,
        "admitted": len(sched)}
    all_drop = faults.plan_events(
        {"seed": 1, "p_drop": 1.0, "p_dup": 0.0, "p_reorder": 0.0,
         "p_stall": 0.0, "stall_ms": 0}, sched, max_attempts=3)
    assert all_drop["lost"] == len(sched)
    assert all_drop["drops"] == len(sched) * 3


def test_schedule_oracle_flattens_workers():
    spec = faults.parse_net_fault_spec("seed=2,p_drop=0.5")
    scheds = [[(0, 0), (0, 1)], [(1, 0)]]
    assert faults.plan_schedule_events(spec, scheds) \
        == faults.plan_events(spec, [(0, 0), (0, 1), (1, 0)]) \
        == jfaults.plan_schedule_events(spec, scheds)


# ----------------------------------------------------------------------
# the arrival journal
# ----------------------------------------------------------------------

def _entry(seq):
    return {"seq": seq, "counts": [[seq, 1]], "carry": [0, 0],
            "marks": {"0": [seq, []]}, "events": {}}


def test_journal_append_reload_roundtrip_across_packages(tmp_path):
    j = ArrivalJournal(str(tmp_path))
    for k in range(3):
        j.append(_entry(k))
    for cls in (ArrivalJournal, JJournal):
        j2 = cls(str(tmp_path))
        assert len(j2) == 3
        assert j2.counts_trace() == [[[k, 1]] for k in range(3)]
        assert j2.last_marks() == {"0": [2, []]}
        assert j2.entry_at(1)["counts"] == [[1, 1]]
        assert j2.entry_at(7) is None


def test_journal_torn_tail_truncated_on_disk(tmp_path):
    j = ArrivalJournal(str(tmp_path))
    j.append(_entry(0))
    j.append(_entry(1))
    with open(j.path, "ab") as f:
        f.write(b'{"seq": 2, "counts": [[')
    j2 = ArrivalJournal(str(tmp_path))
    assert len(j2) == 2
    assert j2.append(_entry(2))["seq"] == 2
    assert len(ArrivalJournal(str(tmp_path))) == 3


def test_journal_sequence_gap_refused(tmp_path):
    j = ArrivalJournal(str(tmp_path))
    j.append(_entry(0))
    with open(j.path, "ab") as f:
        f.write(json.dumps(_entry(5)).encode() + b"\n")
    assert len(ArrivalJournal(str(tmp_path))) == 1


def test_memory_journal_never_touches_disk():
    j = ArrivalJournal(None)
    j.append(_entry(0))
    assert j.path is None and len(j) == 1


# ----------------------------------------------------------------------
# the admission core (direct calls under the lock)
# ----------------------------------------------------------------------

def _server(**kw):
    kw.setdefault("datagram", False)
    return IngestServer(4, waves=2, port=0, **kw)


def test_exactly_once_under_reordered_seqs():
    srv = _server()
    try:
        assert srv.admit_frame(1, 2, 1, 0)[0] == framing.ST_OK
        assert srv.admit_frame(1, 0, 1, 0)[0] == framing.ST_OK
        assert srv.admit_frame(1, 2, 1, 1)[0] == framing.ST_DUP
        assert srv.admit_frame(1, 1, 1, 0)[0] == framing.ST_OK
        assert srv._marks[1] == [2, set()]
        assert srv.admit_frame(1, 1, 1, 3)[0] == framing.ST_DUP
        assert srv.counters["deduped"] == 2
        assert srv.counters["admitted_reqs"] == 3
    finally:
        srv.stop()


def test_backpressure_busy_and_device_pressure():
    srv = _server(high_watermark=4, retry_after_ms=30)
    try:
        assert srv.admit_frame(0, 0, 4, 0)[0] == framing.ST_OK
        st, hint = srv.admit_frame(1, 0, 1, 0)
        assert st == framing.ST_BUSY and hint == 30
        srv.note_device_drops(3)
        st, hint = srv.admit_frame(1, 0, 1, 1)
        assert st == framing.ST_BUSY and hint == 60
        assert srv.counters["device_drop_signals"] == 1
        srv.note_device_drops(0)
        srv.take_chunk(2)
        assert srv.admit_frame(1, 0, 1, 2)[0] == framing.ST_OK
    finally:
        srv.stop()


def test_take_chunk_waves_cap_and_carry():
    srv = _server()
    try:
        srv.admit_frame(0, 0, 5, 0)
        t = srv.take_chunk(2)
        assert t.counts.dtype == np.int32 and t.counts.shape == (2, 4)
        assert t.counts.tolist()[0][0] == 2
        assert t.counts.tolist()[1][0] == 2
        assert t.carry[0] == 1
        assert int(t.counts.sum()) + sum(t.carry) == 5
        t2 = srv.take_chunk(1)
        assert t2.counts.tolist()[0][0] == 1
        assert sum(t2.carry) == 0
    finally:
        srv.stop()


def test_reordered_admit_lands_one_take_late():
    srv = _server(fault_spec="seed=1,p_reorder=1.0")
    try:
        assert srv.admit_frame(2, 0, 3, 0)[0] == framing.ST_OK
        assert srv.counters["reordered"] == 1
        t = srv.take_chunk(2)
        assert int(t.counts.sum()) == 0
        assert t.carry[2 % 4] == 3
        assert int(srv.take_chunk(2).counts.sum()) == 3
    finally:
        srv.stop()


def test_restore_marks_refuses_dead_incarnations_admits():
    srv = _server()
    try:
        srv.restore_marks({"3": [4, [7]]})
        assert srv.admit_frame(3, 2, 1, 0)[0] == framing.ST_DUP
        assert srv.admit_frame(3, 7, 1, 0)[0] == framing.ST_DUP
        assert srv.admit_frame(3, 5, 1, 0)[0] == framing.ST_OK
    finally:
        srv.stop()


def test_status_and_http_handler():
    srv = _server(shard_of=lambda cid: cid % 2)
    try:
        srv.admit_frame(1, 0, 2, 0)
        st, ctype, body = srv.http_handler("GET", "/rpc/status", None)
        assert st == 200 and ctype == "application/json"
        doc = json.loads(body)
        assert doc["queue_depth"] == 2
        assert doc["shard_rx"] == {"1": 2}
        assert doc["counters"]["admitted_ops"] == 2
        assert srv.http_handler("POST", "/rpc/status", b"")[0] == 405
    finally:
        srv.stop()


def test_admission_sequence_equals_jax():
    """One frame sequence (chaos on, reorders, retries, a take between)
    through both servers: the same verdicts, counters, marks and
    matrices."""
    from dmclock_tpu.net.server import IngestServer as JServer

    t = IngestServer(8, waves=2, port=0, datagram=False, fault_spec=CHAOS,
                     high_watermark=40)
    j = JServer(8, waves=2, port=0, datagram=False, fault_spec=CHAOS,
                high_watermark=40)
    try:
        rng = np.random.default_rng(4)
        frames = [(int(rng.integers(8)), int(rng.integers(6)),
                   int(rng.integers(1, 4)), int(rng.integers(3)))
                  for _ in range(120)]
        for i, fr in enumerate(frames):
            assert t.admit_frame(*fr) == j.admit_frame(*fr)
            if i % 40 == 39:
                a, b = t.take_chunk(3), j.take_chunk(3)
                assert np.array_equal(a.counts, b.counts)
                assert a.marks == b.marks and a.events == b.events
                assert a.carry == b.carry
        assert t.counters == j.counters
    finally:
        t.stop()
        j.stop()


# ----------------------------------------------------------------------
# loopback: real sockets, chaos accounting, notifications
# ----------------------------------------------------------------------

def test_client_retry_and_idempotent_resend():
    with IngestServer(4, waves=4, port=0) as srv:
        with RpcClient("127.0.0.1", srv.port, timeout_s=1.0) as cli:
            assert cli.request(2, 0, 3) == framing.ST_OK
            assert cli.request(2, 0, 3) == framing.ST_DUP
        assert srv.counters["admitted_ops"] == 3
        assert srv.counters["deduped"] == 1


def test_datagram_transport_admits():
    with IngestServer(4, waves=4, port=0) as srv:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(2.0)
            s.sendto(framing.pack_req(1, 0, 2, 0), ("127.0.0.1", srv.port))
            t, f = framing.unpack(s.recv(4096))
        assert t == framing.T_ACK
        assert f[:3] == (1, 0, framing.ST_OK)
        assert srv.counters["datagrams"] == 1


def test_chaos_accounting_is_exact():
    scheds = loadgen.full_schedule(11, workers=2, requests=30,
                                   n_clients=8, max_nops=3)
    oracle = faults.plan_schedule_events(
        faults.parse_net_fault_spec(CHAOS),
        [[(c, s) for c, s, _ in sc] for sc in scheds])
    with IngestServer(8, waves=4, port=0, high_watermark=4096,
                      fault_spec=CHAOS) as srv:
        threads = [threading.Thread(
            target=loadgen.run_worker, args=("127.0.0.1", srv.port, sc),
            kwargs=dict(timeout_s=0.15)) for sc in scheds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        c = srv.counters
        assert c["drops_injected"] == oracle["drops"]
        assert c["dup_frames"] == oracle["dups"]
        assert c["reordered"] == oracle["reorders"]
        assert c["admitted_reqs"] == oracle["admitted"]
        assert c["deduped"] >= oracle["dups"]
        assert srv.queue_depth() == c["admitted_ops"]


def test_notify_reaches_subscribers():
    with IngestServer(4, waves=4, port=0) as srv:
        got = []
        t = threading.Thread(target=lambda: got.extend(drain_notifies(
            "127.0.0.1", srv.port, timeout_s=2.0, max_batches=1)))
        t.start()
        time.sleep(0.4)
        srv.publish({"boundary": 0, "decisions": 12})
        t.join(timeout=10)
        assert got and got[0]["decisions"] == 12


def test_jax_client_drives_port_server():
    """The JAX package's client against the port's server: one wire."""
    from dmclock_tpu.net.client import RpcClient as JClient

    with IngestServer(4, waves=4, port=0) as srv:
        with JClient("127.0.0.1", srv.port, timeout_s=1.0) as cli:
            assert cli.request(3, 0, 2) == framing.ST_OK
            assert cli.request(3, 0, 2) == framing.ST_DUP
        assert srv.counters["admitted_ops"] == 2


# ----------------------------------------------------------------------
# the load generator
# ----------------------------------------------------------------------

KW = dict(workers=3, requests=20, n_clients=10, max_nops=3)


def test_same_seed_byte_identical_and_equal_to_the_script():
    a = loadgen.full_schedule(7, **KW)
    assert loadgen.schedule_blob(a) == loadgen.schedule_blob(
        loadgen.full_schedule(7, **KW))
    for seed, kw in ((7, KW), (11, dict(workers=4, requests=16384,
                                        n_clients=100000, max_nops=3))):
        assert loadgen.schedule_blob(loadgen.full_schedule(seed, **kw)) \
            == jloadgen.schedule_blob(jloadgen.full_schedule(seed, **kw))


def test_seed_and_worker_sensitivity():
    a = loadgen.full_schedule(7, **KW)
    b = loadgen.full_schedule(8, **KW)
    assert loadgen.schedule_blob(a) != loadgen.schedule_blob(b)
    assert loadgen.worker_schedule(7, 0, **KW) \
        != loadgen.worker_schedule(7, 1, **KW)


def test_partitions_disjoint_and_seqs_dense():
    for w, sched in enumerate(loadgen.full_schedule(7, **KW)):
        assert all(c % 3 == w for c, _, _ in sched)
        per = {}
        for c, s, n in sched:
            assert s == per.get(c, 0)
            per[c] = s + 1
            assert 1 <= n <= 3


def test_schedule_only_cli_matches_library(capsys):
    rc = loadgen.main(["--schedule-only", "--seed", "7", "--workers",
                       "3", "--requests", "20", "--n-clients", "10",
                       "--max-nops", "3"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(loadgen.schedule_blob(
        loadgen.full_schedule(7, **KW)))


def test_cli_spawn_workers_admit_over_sockets():
    """The module CLI's worker processes over real sockets; they load no
    torch and nothing of the JAX package."""
    srv = IngestServer(8, waves=4, high_watermark=4096,
                       datagram=False).start()
    try:
        lg = subprocess.run(
            [sys.executable, "-m", "dmclock_tpu_torch.net.loadgen",
             "--port", str(srv.port), "--workers", "2", "--requests", "8",
             "--n-clients", "8", "--seed", "3", "--timeout-s", "2.0"],
            capture_output=True, text=True, timeout=120, cwd=str(REPO))
        assert lg.returncode == 0, (lg.stdout, lg.stderr)
        merged = json.loads(lg.stdout)
        assert merged["ok"] == 16 and merged["failed"] == 0
        assert srv.counters["admitted_reqs"] == 16
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# obs: the dmclock_rpc_* families
# ----------------------------------------------------------------------

def test_publish_families_and_latency():
    from dmclock_tpu.obs import rpc as jrpc
    from dmclock_tpu_torch.obs import rpc as obsrpc
    from dmclock_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    obsrpc.publish_rpc(reg, {
        "queue_depth": 5, "connections": 2, "device_pressure": True,
        "shard_rx": {"0": 7, "1": 3}, "notify_oversized": 1,
        "counters": {"requests": 40, "admitted_ops": 33, "busy": 4}})
    snap = reg.snapshot()
    assert snap["dmclock_rpc_notify_oversized_total"][0]["value"] == 1
    assert snap["dmclock_rpc_requests_total"][0]["value"] == 40
    assert snap["dmclock_rpc_admitted_ops_total"][0]["value"] == 33
    assert snap["dmclock_rpc_queue_depth"][0]["value"] == 5
    assert snap["dmclock_rpc_backpressure_engaged"][0]["value"] == 1
    shards = {m["labels"]["shard"]: m["value"]
              for m in snap["dmclock_rpc_shard_routed_ops_total"]}
    assert shards == {"0": 7, "1": 3}
    assert obsrpc.COUNTER_FAMILIES == jrpc.COUNTER_FAMILIES
    empty = obsrpc.latency_summary([])
    assert empty["samples"] == 0 and empty["p99_ms"] == 0.0
    samples = [10 ** 6] * 99 + [10 ** 9]
    summ = obsrpc.latency_summary(samples)
    assert summ == jrpc.latency_summary(samples)
    assert summ["max_ms"] == pytest.approx(1000.0)
    obsrpc.publish_rpc_latency(reg, summ)
    assert reg.snapshot()["dmclock_rpc_admit_to_commit_max_ms"][0][
        "value"] == pytest.approx(1000.0)


# ----------------------------------------------------------------------
# the serving loop
# ----------------------------------------------------------------------

BASE = dict(engine="prefix", n=8, depth=2, ring=8, epochs=4, m=2, k=8,
            chain_depth=2, waves=2, ckpt_every=2, seed=11, with_slo=True,
            wait_ops=0, port=0)


def _cfg(**over):
    from dmclock_tpu_torch.net.serve import RpcServeConfig

    return RpcServeConfig(**dict(BASE, device="cpu", **over))


def _drive(scheds, port):
    threads = [threading.Thread(
        target=loadgen.run_worker, args=("127.0.0.1", port, sc),
        kwargs=dict(timeout_s=2.0)) for sc in scheds]
    for t in threads:
        t.start()
    return threads


def test_digest_gate_live_vs_replay(tmp_path):
    from dmclock_tpu.net import serve as jserve
    from dmclock_tpu_torch.net.serve import make_server, run_serve, \
        trace_sha

    scheds = loadgen.full_schedule(13, workers=2, requests=10, n_clients=8,
                                   max_nops=2)
    total = sum(n for sc in scheds for _, _, n in sc)
    cfg = _cfg(workdir=str(tmp_path), wait_ops=total)
    server = make_server(cfg).start()
    try:
        threads = _drive(scheds, server.port)
        live = run_serve(cfg, server=server)
        for t in threads:
            t.join(timeout=60)
    finally:
        server.stop()
    assert live["mode"] == "rpc-serve" and not live["resumed"]
    assert live["decisions"] > 0
    assert live["admitted_ops_traced"] + live["carry_ops"] == total
    trace = ArrivalJournal(str(tmp_path)).counts_trace()
    assert trace_sha(trace) == live["trace_sha"]
    replay = run_serve(dataclasses.replace(cfg, workdir=None, wait_ops=0),
                       trace=trace)
    assert replay["mode"] == "rpc-replay"
    assert replay["digest"] == live["digest"]
    assert replay["trace_sha"] == live["trace_sha"]
    assert replay["decisions"] == live["decisions"]
    # the JAX package's loop, fed the same journaled trace, lands on the
    # same digest and trace hash
    jrep = jserve.run_serve(jserve.RpcServeConfig(**BASE), trace=trace)
    assert jrep["digest"] == live["digest"]
    assert jrep["trace_sha"] == live["trace_sha"]
    assert jserve.trace_sha(trace) == trace_sha(trace)


@pytest.mark.parametrize("engine", ["prefix", "calendar"])
def test_replay_equals_jax_run_serve(engine):
    """One seeded trace (more ops than a chunk admits: the device clamp
    drops some) through both packages' replays: every key of the record
    but the latency equal."""
    from dmclock_tpu.net import serve as jserve
    from dmclock_tpu_torch.net.serve import run_serve

    rng = np.random.default_rng(21)
    trace = [rng.integers(0, 4, (2, 8)).astype(int).tolist()
             for _ in range(4)]
    over = dict(epochs=8, engine=engine, k=8 if engine == "prefix" else 4)
    got = run_serve(_cfg(**over), trace=trace)
    want = jserve.run_serve(jserve.RpcServeConfig(**dict(BASE, **over)),
                            trace=trace)
    assert got["decisions"] > 0
    for key in want:
        if key != "latency":
            assert got[key] == want[key], key


def test_sigkill_between_fsync_and_apply_is_crash_equivalent(tmp_path):
    """The module CLI in a child process, SIGKILLed right after boundary
    3's record is durable and before its chunk applies; the resumed run
    (journal alone) equals an uninterrupted run fed the same trace."""
    from dmclock_tpu_torch.net.serve import run_serve, trace_sha

    scheds = loadgen.full_schedule(29, workers=2, requests=12, n_clients=8,
                                   max_nops=2)
    total = sum(n for sc in scheds for _, _, n in sc)
    cfg = _cfg(epochs=8, workdir=str(tmp_path), wait_ops=total)
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(json.dumps(dataclasses.asdict(cfg)))
    out_json = tmp_path / "out.json"
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmclock_tpu_torch.net.serve", "--config",
         str(cfg_json), "--out", str(out_json), "--port-file",
         str(port_file), "--crash-after-fsync", "3", "--device", "cpu"],
        cwd=str(REPO), env=dict(os.environ))
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists():
            assert time.monotonic() < deadline, "no port file"
            assert proc.poll() is None, "server died early"
            time.sleep(0.05)
        threads = _drive(scheds, int(port_file.read_text()))
        for t in threads:
            t.join(timeout=120)
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    assert not out_json.exists()
    journal = ArrivalJournal(str(tmp_path))
    assert len(journal) == 4
    trace = journal.counts_trace()
    traced = int(sum(np.asarray(c).sum() for c in trace))
    assert traced + int(np.asarray(journal.entries[-1]["carry"]).sum()) \
        == total
    resumed = run_serve(cfg)
    assert resumed["resumed"] is True
    assert resumed["boundaries"] == 4
    assert resumed["trace_sha"] == trace_sha(trace)
    twin = run_serve(dataclasses.replace(cfg, workdir=None, wait_ops=0),
                     trace=trace)
    assert resumed["digest"] == twin["digest"]
    assert resumed["decisions"] == twin["decisions"]
    assert len(ArrivalJournal(str(tmp_path))) == 4


# ----------------------------------------------------------------------
# bench's rpc row
# ----------------------------------------------------------------------

# keys whose values depend on when the coalesce takes ran (socket timing
# and wall clocks), in bench's run and the port's alike
_TIMED = ("dps", "wall_s", "lat_p50_ms", "lat_p99_ms", "decisions",
          "digest", "ingest_drops", "admitted_ops", "carry_ops", "deduped")


@pytest.mark.parametrize("fault_spec", [None, "seed=7,p_drop=0.1,"
                                        "p_dup=0.05,p_reorder=0.05"],
                         ids=["clean", "chaos"])
def test_rpc_row_equals_bench(fault_spec):
    """``serve.rpc_row`` at bench's CPU shape against
    ``bench.bench_rpc``: the same keys; every key that does not hang on
    socket timing equal (the oracle's and the server's chaos counts
    among them); both gates true; and in each run every op sent is
    traced or carried."""
    import bench
    from dmclock_tpu_torch import serve as tserve

    shape = dict(n=16, epochs=8, requests=32)
    got = tserve.rpc_row(fault_spec=fault_spec, device="cpu", **shape)
    want = bench.bench_rpc(fault_spec=fault_spec, **shape)
    assert set(got) == set(want) == {"rpc"}
    g, w = got["rpc"], want["rpc"]
    assert set(g) == set(w)
    for key in w:
        if key not in _TIMED:
            assert g[key] == w[key], key
    assert g["digest_match"] and g["chaos_exact"]
    scheds = loadgen.full_schedule(17, workers=4, requests=32,
                                   n_clients=16, max_nops=3)
    if fault_spec is None:
        total = sum(n for sc in scheds for _, _, n in sc)
        assert g["admitted_ops"] + g["carry_ops"] == total


def test_oversized_notify_leaves_admission_running():
    """A NOTIFY batch over ``MAX_FRAME`` (one boundary's verdicts at
    100,000 clients) reaches a subscriber whole, as frames of at most
    ``MAX_FRAME``; one that cannot be cut is counted in
    ``notify_oversized`` and not as a batch; the event loop keeps
    admitting over its socket afterwards."""
    rows = [[i, "x" * 64] for i in range(framing.MAX_FRAME // 24)]
    with IngestServer(4, waves=4, port=0) as srv:
        got = []
        t = threading.Thread(target=lambda: got.extend(drain_notifies(
            "127.0.0.1", srv.port, timeout_s=2.0, max_batches=16)))
        t.start()
        deadline = time.monotonic() + 10
        while srv.subscribers() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.subscribers() == 1
        srv.publish({"b": 4, "boundary": 1, "verdicts": rows})
        srv.publish({"blob": "x" * framing.MAX_FRAME})
        t.join(timeout=30)
        parts = len(got)
        assert parts > 1
        assert [g["part"] for g in got] == list(range(parts))
        assert all(g["parts"] == parts and g["b"] == 4
                   and g["boundary"] == 1 for g in got)
        assert [r for g in got for r in g["verdicts"]] == rows
        assert srv.counters["notify_batches"] == 1
        assert srv.notify_oversized == 1
        assert srv.status()["notify_oversized"] == 1
        with RpcClient("127.0.0.1", srv.port, timeout_s=2.0) as cli:
            assert cli.request(1, 0, 2) == framing.ST_OK
        assert srv.counters["admitted_ops"] == 2
        assert srv._thread.is_alive()


def test_serving_loop_builds_verdicts_only_for_a_subscriber(monkeypatch):
    """With a subscriber, every boundary's NOTIFY carries the SLO plane's
    verdicts, one a client; with none, the loop counts the same batches
    and never builds the rows, and its digest is the same."""
    from dmclock_tpu_torch.net.serve import make_server, run_serve
    from dmclock_tpu_torch.obs import slo as slo_mod

    cfg = _cfg(epochs=4)
    server = make_server(cfg).start()
    try:
        got = []
        t = threading.Thread(target=lambda: got.extend(drain_notifies(
            "127.0.0.1", server.port, timeout_s=3.0, max_batches=2)))
        t.start()
        deadline = time.monotonic() + 10
        while server.subscribers() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        heard = run_serve(cfg, server=server)
        t.join(timeout=30)
    finally:
        server.stop()
    assert [g["boundary"] for g in got] == [0, 1]
    assert all(len(g["verdicts"]) == cfg.n for g in got)
    assert heard["events"]["notify_batches"] == 2

    def refuse(self, closed):
        raise AssertionError("verdicts built with no subscriber")

    monkeypatch.setattr(slo_mod.SloPlane, "conformance_rows", refuse)
    server = make_server(cfg).start()
    try:
        unheard = run_serve(cfg, server=server)
    finally:
        server.stop()
    assert unheard["events"]["notify_batches"] == 2
    assert unheard["digest"] == heard["digest"]
