"""The deterministic network fault plane (docs/RPC.md "Chaos"; the
port's copy of ``dmclock_tpu/net/faults.py``).

Same design contract as the device fault plane
(:mod:`..robust.faults`): a seeded spec parsed from a
compact ``key=value`` grammar, a PURE decision function of the frame
identity, and an EXACT host oracle -- the chaos gate asserts the
server's fault counters equal the oracle's plan, not "roughly
behaved".

Decisions hash ``(seed, cid, seq, attempt)`` through splitmix64, so
they are independent of arrival order, socket interleaving, and
retry timing: the same logical request draws the same fate in every
run, which is what makes exact accounting possible across N worker
processes racing over real sockets.

Fault semantics (applied at server frame ingress, simulating the
network; docs/RPC.md for the full contract):

- ``drop``: the frame vanishes -- no ACK; the client times out and
  retries with ``attempt + 1`` (a fresh fate draw).
- ``dup``: the frame is delivered twice back-to-back; the second
  copy hits the dedup watermark (counted ``deduped``).  Evaluated
  only on the attempt that actually admits.
- ``reorder``: delivery is delayed past the current coalesce window
  -- the request is ACKed normally but admits at the NEXT chunk
  boundary.  Evaluated only on the admitting attempt.
- ``stall_ms``: client-side -- the loadgen worker sleeps this long
  before sending the affected frame (slow-client robustness; the
  server's idle-timeout plane is what it exercises).  Drawn with the
  same hash, salt 3.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

_KEYS = ("seed", "p_drop", "p_dup", "p_reorder", "p_stall",
         "stall_ms")
_FLOAT_KEYS = frozenset(("p_drop", "p_dup", "p_reorder", "p_stall"))

# fate salts (distinct streams per fault kind)
_S_DROP, _S_DUP, _S_REORDER, _S_STALL = 1, 2, 3, 4

_SCALE = 1 << 64          # float probabilities -> integer thresholds
#                           (the fate draw is a full u64)


def parse_net_fault_spec(spec: Union[str, dict, None]
                         ) -> Optional[dict]:
    """Parse ``"seed=7,p_drop=0.1,p_dup=0.05"`` (or a dict) into a
    normalized spec dict; None/empty -> None (fault plane off).
    Unknown keys are an error -- a typo'd chaos spec must not
    silently run a clean leg."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = spec.strip()
        if not spec:
            return None
        out: Dict[str, float] = {}
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in _KEYS:
                raise ValueError(f"unknown net fault key {k!r} "
                                 f"(have {', '.join(_KEYS)})")
            out[k] = float(v) if k in _FLOAT_KEYS else int(v)
        spec = out
    else:
        bad = set(spec) - set(_KEYS)
        if bad:
            raise ValueError(f"unknown net fault keys {sorted(bad)}")
        spec = dict(spec)
    spec.setdefault("seed", 0)
    for k in _FLOAT_KEYS:
        p = float(spec.setdefault(k, 0.0))
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"{k}={p} outside [0, 1]")
    spec.setdefault("stall_ms", 0)
    if not any(spec[k] > 0 for k in _FLOAT_KEYS):
        return None
    return spec


def describe(spec: Optional[dict]) -> str:
    """Compact spec tag for logs and bench JSON."""
    if spec is None:
        return "none"
    parts = [f"seed={int(spec['seed'])}"]
    parts += [f"{k}={spec[k]:g}" for k in sorted(_FLOAT_KEYS)
              if spec.get(k, 0.0) > 0]
    if spec.get("stall_ms", 0):
        parts.append(f"stall_ms={int(spec['stall_ms'])}")
    return ",".join(parts)


def _mix(seed: int, cid: int, seq: int, attempt: int,
         salt: int) -> int:
    """splitmix64 over the frame identity -- one u64 fate draw."""
    x = (seed * 0x9E3779B97F4A7C15 + cid * 0xBF58476D1CE4E5B9
         + seq * 0x94D049BB133111EB + attempt * 0xD6E8FEB86659FD93
         + salt * 0xA24BAED4963EE407) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _hit(spec: dict, key: str, cid: int, seq: int, attempt: int,
         salt: int) -> bool:
    p = float(spec.get(key, 0.0))
    if p <= 0.0:
        return False
    return _mix(int(spec["seed"]), cid, seq, attempt, salt) \
        < int(p * _SCALE)


def decide(spec: Optional[dict], cid: int, seq: int,
           attempt: int) -> Tuple[bool, bool, bool]:
    """The pure fate function: ``(drop, dup, reorder)`` for one frame
    identity.  Same triple in the server, the oracle, and any test."""
    if spec is None:
        return False, False, False
    cid, seq, attempt = int(cid), int(seq), int(attempt)
    return (_hit(spec, "p_drop", cid, seq, attempt, _S_DROP),
            _hit(spec, "p_dup", cid, seq, attempt, _S_DUP),
            _hit(spec, "p_reorder", cid, seq, attempt, _S_REORDER))


def stall_ms(spec: Optional[dict], cid: int, seq: int,
             attempt: int) -> int:
    """Client-side slow-sender stall for this frame (0 = none)."""
    if spec is None or spec.get("stall_ms", 0) <= 0:
        return 0
    if _hit(spec, "p_stall", int(cid), int(seq), int(attempt),
            _S_STALL):
        return int(spec["stall_ms"])
    return 0


def plan_events(spec: Optional[dict],
                schedule: Sequence[Tuple[int, int]],
                max_attempts: int = 8) -> Dict[str, int]:
    """The exact host oracle: walk every ``(cid, seq)`` in
    ``schedule`` through the fate function exactly like a retrying
    client would, and return the event totals a faithful server run
    MUST report (the ci chaos gate's equality check).

    ``drops`` counts dropped attempt-frames; ``dups``/``reorders``
    are per admitted request (evaluated at the admitting attempt --
    BUSY retries re-send the same attempt, so backpressure cannot
    skew the accounting); ``lost`` counts requests whose every
    attempt up to ``max_attempts`` dropped (the loadgen reports these
    as failures, the server never saw them admit)."""
    out = {"drops": 0, "dups": 0, "reorders": 0, "lost": 0,
           "admitted": 0}
    for cid, seq in schedule:
        admitted_at = None
        for a in range(int(max_attempts)):
            drop, _, _ = decide(spec, cid, seq, a)
            if drop:
                out["drops"] += 1
            else:
                admitted_at = a
                break
        if admitted_at is None:
            out["lost"] += 1
            continue
        out["admitted"] += 1
        _, dup, reorder = decide(spec, cid, seq, admitted_at)
        if dup:
            out["dups"] += 1
        if reorder:
            out["reorders"] += 1
    return out


def plan_schedule_events(spec: Optional[dict],
                         schedules: Sequence[Sequence[Tuple[int, int]]],
                         max_attempts: int = 8) -> Dict[str, int]:
    """Oracle over several workers' schedules (order-independent by
    construction -- the fate hash never sees arrival order)."""
    flat: List[Tuple[int, int]] = [rq for sched in schedules
                                   for rq in sched]
    return plan_events(spec, flat, max_attempts=max_attempts)
