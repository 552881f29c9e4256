"""The blocking RPC client (docs/RPC.md "Client contract"; the port's
copy of ``dmclock_tpu/net/client.py``).

What a well-behaved tenant of the ingest plane does, in one class:

- **timeout retry**: an unACKed frame (chaos drop, dead server) is
  re-sent with ``attempt + 1`` after a full exponential backoff step
  -- the attempt number is part of the frame identity, so the fault
  plane draws a fresh fate and the server's accounting stays exact.
- **backpressure honor**: ``ST_BUSY`` sleeps the server's
  ``retry_after_ms`` hint (plus the current backoff) and re-sends
  the SAME attempt -- backpressure is not a network fault, and
  keeping the attempt stable is what lets the chaos oracle price
  dup/reorder fates independently of queue depth.
- **idempotent resends**: ``ST_DUP`` is success (the earlier copy
  admitted; the ACK just got lost or raced a retry).
- **reconnect**: a torn connection rebuilds the socket and re-sends
  the in-flight frame (same attempt -- the transport died, not the
  admission).

Every worker of :mod:`.loadgen` drives exactly this class
over a real socket; nothing here is test scaffolding.
"""

from __future__ import annotations

import socket
import time
from typing import Optional

from . import framing


class RpcError(RuntimeError):
    """Request abandoned after ``max_attempts`` unACKed sends."""


class RpcClient:
    """One connection, one in-flight request at a time (the loadgen
    runs N processes for concurrency -- real multi-tenant pressure,
    not asyncio simulation)."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 0.5, max_attempts: int = 8,
                 backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 1.0,
                 sleep=time.sleep) -> None:
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self._sock: Optional[socket.socket] = None
        self.stats = {"sent": 0, "ok": 0, "dup": 0, "busy": 0,
                      "timeouts": 0, "reconnects": 0, "failed": 0}

    # -- transport -----------------------------------------------------
    def _ensure(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._teardown()

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _backoff(self, step: int) -> float:
        return min(self.backoff_base_s * (2 ** step),
                   self.backoff_cap_s)

    # -- the request path ----------------------------------------------
    def request(self, cid: int, seq: int, nops: int) -> int:
        """Admit ``nops`` ops for ``(cid, seq)``; returns the final
        ACK status (``ST_OK`` or ``ST_DUP``).  Raises
        :class:`RpcError` when every attempt times out."""
        attempt = 0
        step = 0
        while attempt < self.max_attempts:
            try:
                sock = self._ensure()
                sock.settimeout(self.timeout_s)
                sock.sendall(framing.frame(
                    framing.pack_req(cid, seq, nops, attempt)))
                self.stats["sent"] += 1
                payload = self._read_ack(sock, cid, seq)
            except socket.timeout:
                # dropped (chaos or loss): fresh attempt, fresh fate
                self.stats["timeouts"] += 1
                self._sleep(self._backoff(step))
                attempt += 1
                step += 1
                continue
            except (ConnectionError, OSError):
                self.stats["reconnects"] += 1
                self._teardown()
                self._sleep(self._backoff(step))
                step += 1
                continue          # transport died: SAME attempt
            status, retry_ms = payload
            if status == framing.ST_OK:
                self.stats["ok"] += 1
                return status
            if status == framing.ST_DUP:
                self.stats["dup"] += 1
                return status
            # ST_BUSY: honor the hint, re-send the SAME attempt
            self.stats["busy"] += 1
            self._sleep(retry_ms / 1000.0 + self._backoff(step))
            step += 1
        self.stats["failed"] += 1
        raise RpcError(f"cid={cid} seq={seq}: no ACK after "
                       f"{self.max_attempts} attempts")

    def _read_ack(self, sock, cid: int, seq: int):
        """Read frames until THIS request's ACK arrives (NOTIFYs and
        stale ACKs from abandoned attempts are skipped)."""
        while True:
            t, fields = framing.unpack(framing.read_frame(
                sock, timeout=self.timeout_s))
            if t != framing.T_ACK:
                continue
            a_cid, a_seq, status, retry_ms = fields
            if a_cid == cid and a_seq == seq:
                return status, retry_ms


def drain_notifies(host: str, port: int, *, timeout_s: float = 1.0,
                   max_batches: int = 10):
    """Subscribe and collect NOTIFY batches until the socket goes
    quiet (a test/debug helper; loadgen workers do not subscribe)."""
    out = []
    with socket.create_connection((host, int(port)),
                                  timeout=timeout_s) as sock:
        sock.sendall(framing.frame(framing.pack_sub()))
        try:
            while len(out) < max_batches:
                t, fields = framing.unpack(
                    framing.read_frame(sock, timeout=timeout_s))
                if t == framing.T_NOTIFY:
                    out.append(fields[0])
        except (socket.timeout, ConnectionError):
            pass
    return out
