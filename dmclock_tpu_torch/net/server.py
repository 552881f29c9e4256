"""The ingest server: a stdlib ``selectors`` event loop coalescing
tagged requests from many concurrent client processes into the
superwave count matrix the fused stream chunk admits (docs/RPC.md;
the port's copy of ``dmclock_tpu/net/server.py``).  Numpy and the
standard library only: the server thread never touches ``torch``, and
only the serving loop's thread launches work on the card.

Design stance: the network plane owns EVERYTHING nondeterministic --
socket interleaving, retries, backpressure, injected chaos -- and
compresses it into one deterministic artifact per chunk boundary:
the ``int32[epochs, n]`` admitted-counts matrix the arrival journal
makes durable.  Downstream of ``take_chunk`` the run is a pure
function of that trace, which is what makes ``--mode rpc``
digest-comparable to a self-generated replay and SIGKILL-resumable.

Robustness plane, in one place:

- **backpressure**: total queued ops at or past ``high_watermark``
  answers ``ST_BUSY`` with a ``retry_after_ms`` hint instead of
  admitting; a device-side admission-clamp signal
  (:meth:`IngestServer.note_device_drops`, fed from the
  ``MET_INGEST_DROPS`` delta) halves the watermark and doubles the
  hint until the clamp drains -- the 429 path is DERIVED from the
  engine's own ``ingest_drops`` / ``bounded_by`` counters, not a
  second opinion.
- **exactly-once admission**: per-client ``(mark, extras)`` seq
  watermarks dedup retries and injected duplicates even under
  reordering (``extras`` holds out-of-order admits until the mark
  catches up); the watermarks ride every journal record, so a
  resumed server keeps refusing what a dead incarnation admitted.
- **bounded connections**: per-connection idle timeouts reap stalled
  peers; oversized/malformed frames close only the offending
  connection.
- **chaos**: the seeded :mod:`.faults` plane runs at frame ingress
  with exact counter accounting (the ci gate compares them to the
  host oracle).
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import faults as faults_mod
from . import framing

_RECV = 1 << 16


class _Conn:
    __slots__ = ("sock", "framer", "out", "last", "sub", "addr")

    def __init__(self, sock, addr) -> None:
        self.sock = sock
        self.addr = addr
        self.framer = framing.Framer()
        self.out = bytearray()
        self.last = time.monotonic()
        self.sub = False


class TakeResult(tuple):
    """``(counts, marks, events, arrivals_ns, carry)`` from one
    coalesce take -- counts is the journal/device matrix, marks the
    dedup watermarks after it, events the cumulative counter
    snapshot, arrivals_ns the admission timestamps the latency plane
    prices, carry the leftover queued ops (admitted but beyond this
    chunk's ``epochs * waves`` capacity -- journaled so a crash
    cannot lose them).  ``carry`` is snapshotted under the SAME lock
    hold as ``counts``: an op is in exactly one of the two."""

    __slots__ = ()

    def __new__(cls, counts, marks, events, arrivals_ns, carry):
        return tuple.__new__(cls, (counts, marks, events,
                                   arrivals_ns, carry))

    counts = property(lambda s: s[0])
    marks = property(lambda s: s[1])
    events = property(lambda s: s[2])
    arrivals_ns = property(lambda s: s[3])
    carry = property(lambda s: s[4])


class IngestServer:
    """Threaded ingest front-end for one serving loop.

    ``route`` maps a client id to its coalesce slot (default
    ``cid % n_slots`` -- the closed-population identity);
    ``shard_of`` (e.g. ``PlacementMap.shard_of``) attributes per-
    shard received-ops counters for the routing/observability plane
    without touching admission math.
    """

    COUNTERS = ("requests", "admitted_ops", "admitted_reqs",
                "deduped", "busy", "drops_injected", "dup_frames",
                "reordered", "proto_errors", "conns_opened",
                "conns_timed_out", "notify_batches",
                "device_drop_signals", "datagrams")

    def __init__(self, n_slots: int, *, waves: int,
                 host: str = "127.0.0.1", port: int = 0,
                 high_watermark: Optional[int] = None,
                 retry_after_ms: int = 25,
                 fault_spec=None,
                 route: Optional[Callable[[int], int]] = None,
                 shard_of: Optional[Callable[[int], int]] = None,
                 idle_timeout_s: float = 30.0,
                 datagram: bool = True) -> None:
        self.n = int(n_slots)
        self.waves = int(waves)
        self.spec = faults_mod.parse_net_fault_spec(fault_spec)
        self.route = route or (lambda cid: int(cid) % self.n)
        self.shard_of = shard_of
        self.hwm = int(high_watermark) if high_watermark \
            else self.n * self.waves * 4
        self.retry_after_ms = int(retry_after_ms)
        self.idle_timeout_s = float(idle_timeout_s)

        self._lock = threading.Lock()
        self.pending = np.zeros(self.n, dtype=np.int64)
        self._held: List[Tuple[int, int]] = []   # reordered (slot, n)
        # cid -> [mark, set(extras)]: mark = highest seq with every
        # seq <= mark admitted; extras = admitted seqs above the mark
        # (out-of-order arrivals awaiting contiguity)
        self._marks: Dict[int, list] = {}
        self._arrivals: List[int] = []
        self.counters: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        # batches too big for any frame: beside the counters, which the
        # arrival journal records in the JAX package's layout
        self.notify_oversized = 0
        self.shard_rx: Dict[int, int] = {}
        self._device_pressure = False

        self._sel = selectors.DefaultSelector()
        self._lsock = socket.socket(socket.AF_INET,
                                    socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET,
                               socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(128)
        self._lsock.setblocking(False)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._sel.register(self._lsock, selectors.EVENT_READ,
                           ("accept", None))
        self._dsock = None
        if datagram:
            self._dsock = socket.socket(socket.AF_INET,
                                        socket.SOCK_DGRAM)
            self._dsock.bind((self.host, self.port))
            self._dsock.setblocking(False)
            self._sel.register(self._dsock, selectors.EVENT_READ,
                               ("datagram", None))
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           ("wake", None))
        self._notify_q: deque = deque()
        self._subs = 0                          # subscribed conns
        self._conns: Dict[int, _Conn] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "IngestServer":
        self._thread = threading.Thread(target=self._loop,
                                        name="rpc-ingest",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for conn in list(self._conns.values()):
            self._close(conn)
        for s in (self._lsock, self._dsock):
            if s is not None:
                try:
                    self._sel.unregister(s)
                except (KeyError, ValueError):
                    pass
                s.close()
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        self._sel.close()

    def __enter__(self) -> "IngestServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    # -- admission (any thread; lock-guarded) --------------------------
    def _seen(self, cid: int, seq: int) -> bool:
        ent = self._marks.get(cid)
        return ent is not None and (seq <= ent[0] or seq in ent[1])

    def _mark(self, cid: int, seq: int) -> None:
        ent = self._marks.setdefault(cid, [-1, set()])
        ent[1].add(seq)
        while ent[0] + 1 in ent[1]:
            ent[0] += 1
            ent[1].discard(ent[0])

    def _admit_once(self, cid: int, seq: int, nops: int,
                    reorder: bool) -> Tuple[int, int]:
        if self._seen(cid, seq):
            self.counters["deduped"] += 1
            return framing.ST_DUP, 0
        hwm = max(1, self.hwm // 2) if self._device_pressure \
            else self.hwm
        held = sum(n for _, n in self._held)
        if int(self.pending.sum()) + held >= hwm:
            self.counters["busy"] += 1
            hint = self.retry_after_ms * \
                (2 if self._device_pressure else 1)
            return framing.ST_BUSY, hint
        self._mark(cid, seq)
        slot = int(self.route(cid)) % self.n
        if reorder:
            self._held.append((slot, int(nops)))
            self.counters["reordered"] += 1
        else:
            self.pending[slot] += int(nops)
        self.counters["admitted_ops"] += int(nops)
        self.counters["admitted_reqs"] += 1
        self._arrivals.append(time.monotonic_ns())
        if self.shard_of is not None:
            sh = int(self.shard_of(cid))
            self.shard_rx[sh] = self.shard_rx.get(sh, 0) + int(nops)
        return framing.ST_OK, 0

    def admit_frame(self, cid: int, seq: int, nops: int,
                    attempt: int) -> Optional[Tuple[int, int]]:
        """Run one REQ through chaos ingress + dedup + backpressure;
        returns ``(status, retry_after_ms)`` for the ACK, or None
        when the chaos plane dropped the frame (no ACK at all -- the
        client's timeout is the signal)."""
        with self._lock:
            self.counters["requests"] += 1
            drop, dup, reorder = faults_mod.decide(
                self.spec, cid, seq, attempt)
            if drop:
                self.counters["drops_injected"] += 1
                return None
            st = self._admit_once(cid, seq, nops, reorder)
            if dup and st[0] != framing.ST_BUSY:
                # the network delivered a second copy; it must hit
                # the watermark (BUSY admits nothing, so there is no
                # watermark for a copy to hit -- the client retries
                # the whole frame)
                self.counters["dup_frames"] += 1
                self._admit_once(cid, seq, nops, reorder)
            return st

    # -- the coalesce take (serve-loop thread) -------------------------
    def take_chunk(self, epochs: int) -> TakeResult:
        """Drain the coalesce buffer into an ``int32[epochs, n]``
        superwave matrix (per-slot, per-epoch rows capped at
        ``waves`` -- the device clamp's own wave geometry, so the
        host never fabricates an epoch the device would refuse).
        Ops beyond ``epochs * waves`` per slot stay pending for the
        next take; held (reordered) admissions pour into the buffer
        AFTER the matrix is built, landing one boundary late by
        construction."""
        epochs = int(epochs)
        counts = np.zeros((epochs, self.n), dtype=np.int32)
        with self._lock:
            for e in range(epochs):
                take = np.minimum(self.pending, self.waves)
                counts[e] = take.astype(np.int32)
                self.pending -= take
            for slot, nops in self._held:
                self.pending[slot] += nops
            self._held.clear()
            marks = {str(c): [int(m[0]), sorted(m[1])]
                     for c, m in self._marks.items()}
            events = dict(self.counters)
            arrivals = self._arrivals
            self._arrivals = []
            carry = [int(x) for x in self.pending]
        return TakeResult(counts, marks, events, arrivals, carry)

    def restore_marks(self, marks: Optional[dict]) -> None:
        """Rehydrate dedup watermarks from a journal record (resume):
        what a dead incarnation durably admitted stays admitted."""
        if not marks:
            return
        with self._lock:
            for cid, (mark, extras) in marks.items():
                self._marks[int(cid)] = [int(mark),
                                         set(int(x) for x in extras)]

    def note_device_drops(self, delta: int) -> None:
        """Feed the device admission clamp's ``ingest_drops`` delta:
        any clamping this chunk tightens backpressure (halved
        watermark, doubled retry hint) until a clean chunk clears
        it."""
        with self._lock:
            if int(delta) > 0:
                self.counters["device_drop_signals"] += 1
                self._device_pressure = True
            else:
                self._device_pressure = False

    # -- notifications -------------------------------------------------
    def publish(self, obj) -> None:
        """Queue one completion NOTIFY batch for every subscriber
        (best-effort: subscribers are telemetry, never admission).

        A batch over ``MAX_FRAME`` (one boundary's verdicts at 100,000
        clients is about 36 MB) goes as consecutive frames, each the
        batch's other keys with a slice of ``verdicts`` and ``part`` /
        ``parts`` added; one that cannot be split so is sent to no one
        and counted in ``self.notify_oversized``, not in
        ``notify_batches``.
        The JAX package's server raises on such a batch in its event
        loop, which ends admission."""
        payloads = _notify_payloads(obj)
        with self._lock:
            if payloads:
                self.counters["notify_batches"] += 1
            else:
                self.notify_oversized += 1
        self._notify_q.extend(payloads)
        self._wake()

    def subscribers(self) -> int:
        """Connections subscribed to NOTIFYs now.  The serving loop
        builds a boundary's verdicts only when this is not 0."""
        return self._subs

    def publish_unheard(self) -> None:
        """Count one boundary's batch that no subscriber was there to
        receive, without building or encoding it."""
        with self._lock:
            self.counters["notify_batches"] += 1

    # -- status / metrics ----------------------------------------------
    def queue_depth(self) -> int:
        with self._lock:
            return int(self.pending.sum()) \
                + sum(n for _, n in self._held)

    def status(self) -> dict:
        with self._lock:
            return {
                "port": self.port,
                "queue_depth": int(self.pending.sum())
                + sum(n for _, n in self._held),
                "high_watermark": self.hwm,
                "device_pressure": bool(self._device_pressure),
                "connections": len(self._conns),
                "clients_seen": len(self._marks),
                "fault_spec": faults_mod.describe(self.spec),
                "shard_rx": {str(k): v
                             for k, v in sorted(self.shard_rx.items())},
                "counters": dict(self.counters),
                "notify_oversized": self.notify_oversized,
            }

    def http_handler(self, method: str, path: str, body):
        """``GET /rpc/status`` handler for
        :meth:`obs.registry.MetricsHTTPServer.mount` -- the admin API
        and the ingest plane share one endpoint (docs/RPC.md)."""
        if method != "GET":
            return 405, "text/plain", b"method not allowed"
        return 200, "application/json", json.dumps(
            self.status(), sort_keys=True).encode("utf-8")

    # -- event loop ----------------------------------------------------
    def _loop(self) -> None:
        last_sweep = time.monotonic()
        while not self._stop:
            for key, mask in self._sel.select(timeout=0.2):
                kind, conn = key.data
                if kind == "accept":
                    self._accept()
                elif kind == "datagram":
                    self._datagram()
                elif kind == "wake":
                    try:
                        while os.read(self._wake_r, 4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    if mask & selectors.EVENT_READ:
                        self._readable(conn)
                    if conn.sock.fileno() >= 0 and \
                            mask & selectors.EVENT_WRITE:
                        self._flush(conn)
            self._drain_notify()
            now = time.monotonic()
            if now - last_sweep >= 1.0:
                self._sweep_idle(now)
                last_sweep = now

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, addr)
            self._conns[sock.fileno()] = conn
            self.counters["conns_opened"] += 1
            self._sel.register(sock, selectors.EVENT_READ,
                               ("conn", conn))

    def _close(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(conn.sock.fileno(), None)
        if conn.sub:
            conn.sub = False
            self._subs -= 1
        try:
            conn.sock.close()
        except OSError:
            pass

    def _on_payload(self, conn: _Conn, payload: bytes) -> None:
        t, fields = framing.unpack(payload)
        if t == framing.T_REQ:
            cid, seq, nops, attempt = fields
            verdict = self.admit_frame(cid, seq, nops, attempt)
            if verdict is not None:
                conn.out += framing.frame(
                    framing.pack_ack(cid, seq, *verdict))
        elif t == framing.T_SUB:
            if not conn.sub:
                conn.sub = True
                self._subs += 1
        else:
            raise framing.ProtocolError(
                f"unexpected frame type {t} from client")

    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        conn.last = time.monotonic()
        try:
            for payload in conn.framer.feed(data):
                self._on_payload(conn, payload)
        except framing.ProtocolError:
            self.counters["proto_errors"] += 1
            self._close(conn)
            return
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        if conn.out:
            try:
                sent = conn.sock.send(conn.out)
                del conn.out[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close(conn)
                return
        want = selectors.EVENT_READ | \
            (selectors.EVENT_WRITE if conn.out else 0)
        try:
            self._sel.modify(conn.sock, want, ("conn", conn))
        except (KeyError, ValueError):
            pass

    def _datagram(self) -> None:
        assert self._dsock is not None
        while True:
            try:
                payload, addr = self._dsock.recvfrom(_RECV)
            except (BlockingIOError, OSError):
                return
            self.counters["datagrams"] += 1
            try:
                t, fields = framing.unpack(payload)
            except framing.ProtocolError:
                self.counters["proto_errors"] += 1
                continue
            if t != framing.T_REQ:
                self.counters["proto_errors"] += 1
                continue
            cid, seq, nops, attempt = fields
            verdict = self.admit_frame(cid, seq, nops, attempt)
            if verdict is not None:
                try:
                    self._dsock.sendto(
                        framing.pack_ack(cid, seq, *verdict), addr)
                except OSError:
                    pass

    def _drain_notify(self) -> None:
        while self._notify_q:
            framed = framing.frame(self._notify_q.popleft())
            for conn in list(self._conns.values()):
                if conn.sub:
                    conn.out += framed
                    self._flush(conn)

    def _sweep_idle(self, now: float) -> None:
        for conn in list(self._conns.values()):
            if now - conn.last > self.idle_timeout_s:
                self.counters["conns_timed_out"] += 1
                self._close(conn)


def _notify_payloads(obj) -> List[bytes]:
    """``obj`` as NOTIFY payloads of at most ``MAX_FRAME`` bytes: the
    one payload JAX's server sends when it fits, else ``verdicts`` cut
    into equal slices sized for half a frame each; ``[]`` when a slice
    still does not fit or there is no ``verdicts`` list to cut."""
    payload = framing.pack_notify(obj)
    if len(payload) <= framing.MAX_FRAME:
        return [payload]
    rows = obj.get("verdicts") if isinstance(obj, dict) else None
    if not isinstance(rows, list) or len(rows) < 2:
        return []
    parts = -(-len(payload) // (framing.MAX_FRAME // 2))
    step = -(-len(rows) // parts)
    slices = [rows[i:i + step] for i in range(0, len(rows), step)]
    out = []
    for i, part in enumerate(slices):
        p = framing.pack_notify(dict(obj, verdicts=part, part=i,
                                     parts=len(slices)))
        if len(p) > framing.MAX_FRAME:
            return []
        out.append(p)
    return out
