"""Wire format for the RPC ingest plane (docs/RPC.md "Framing"; the
port's copy of ``dmclock_tpu/net/framing.py``, byte for byte the same
wire format).

One payload encoding, two transports:

- **stream** (TCP): each frame is a 4-byte big-endian length prefix
  followed by that many payload bytes.  :class:`Framer` decodes the
  byte stream incrementally (partial frames across ``recv`` calls are
  the normal case, not an error).
- **datagram** (UDP): one payload per datagram, no length prefix --
  the datagram boundary IS the frame boundary.

Payload = 1 type byte + fixed ``struct`` body (JSON body for NOTIFY,
whose schema is host-side telemetry, not admission state).  All
integers are network byte order.  The format is versionless on
purpose: the client and server ship in the same tree, and an unknown
type byte is a protocol error, not a negotiation.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Tuple

# frame types
T_REQ = 1        # client -> server: admit `nops` ops for client `cid`
T_ACK = 2        # server -> client: per-REQ verdict
T_NOTIFY = 3     # server -> subscribers: batched completion report
T_SUB = 4        # client -> server: subscribe this conn to NOTIFYs

# ACK statuses
ST_OK = 0        # accepted into the coalesce buffer
ST_DUP = 1       # (cid, seq) already admitted -- idempotent resend
ST_BUSY = 2      # backpressure: retry after `retry_after_ms`

_LEN = struct.Struct("!I")
_REQ = struct.Struct("!IQIH")     # cid, seq, nops, attempt
_ACK = struct.Struct("!IQBI")     # cid, seq, status, retry_after_ms

#: refuse frames bigger than this (a corrupt length prefix must not
#: make the server buffer gigabytes)
MAX_FRAME = 1 << 20


def pack_req(cid: int, seq: int, nops: int, attempt: int = 0) -> bytes:
    return bytes([T_REQ]) + _REQ.pack(int(cid), int(seq), int(nops),
                                      int(attempt))


def pack_ack(cid: int, seq: int, status: int,
             retry_after_ms: int = 0) -> bytes:
    return bytes([T_ACK]) + _ACK.pack(int(cid), int(seq), int(status),
                                      int(retry_after_ms))


def pack_notify(obj) -> bytes:
    return bytes([T_NOTIFY]) + json.dumps(
        obj, sort_keys=True, separators=(",", ":")).encode("utf-8")


def pack_sub() -> bytes:
    return bytes([T_SUB])


def unpack(payload: bytes) -> Tuple[int, tuple]:
    """Decode one payload to ``(type, fields)``.

    - REQ -> ``(cid, seq, nops, attempt)``
    - ACK -> ``(cid, seq, status, retry_after_ms)``
    - NOTIFY -> ``(obj,)`` (decoded JSON)
    - SUB -> ``()``
    """
    if not payload:
        raise ProtocolError("empty payload")
    t = payload[0]
    body = payload[1:]
    try:
        if t == T_REQ:
            return t, _REQ.unpack(body)
        if t == T_ACK:
            return t, _ACK.unpack(body)
        if t == T_NOTIFY:
            return t, (json.loads(body.decode("utf-8")),)
        if t == T_SUB:
            if body:
                raise ProtocolError("SUB carries no body")
            return t, ()
    except (struct.error, ValueError) as e:
        raise ProtocolError(f"bad frame body (type {t}): {e}") from e
    raise ProtocolError(f"unknown frame type {t}")


def frame(payload: bytes) -> bytes:
    """Length-prefix a payload for the stream transport."""
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(payload)} bytes)")
    return _LEN.pack(len(payload)) + payload


class ProtocolError(ValueError):
    """Malformed frame: the connection that produced it is closed
    (one bad peer must not take the accept loop down)."""


class Framer:
    """Incremental stream decoder: feed received bytes, harvest
    complete payloads.  Tolerates arbitrary fragmentation; rejects
    oversized length prefixes immediately (before buffering)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        out: List[bytes] = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (n,) = _LEN.unpack_from(self._buf, 0)
            if n > MAX_FRAME:
                raise ProtocolError(f"frame length {n} > {MAX_FRAME}")
            if len(self._buf) < _LEN.size + n:
                return out
            out.append(bytes(self._buf[_LEN.size:_LEN.size + n]))
            del self._buf[:_LEN.size + n]

    def pending(self) -> int:
        """Bytes buffered awaiting a complete frame (0 at a clean
        frame boundary -- what the tests assert after a drain)."""
        return len(self._buf)


def read_frame(sock, timeout: Optional[float] = None) -> bytes:
    """Blocking single-frame read off a stream socket (the simple
    client path; the server never blocks like this).  Raises
    ``ConnectionError`` on EOF mid-frame."""
    if timeout is not None:
        sock.settimeout(timeout)
    need = _LEN.size
    head = _recv_exact(sock, need)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame length {n} > {MAX_FRAME}")
    return _recv_exact(sock, n)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)
