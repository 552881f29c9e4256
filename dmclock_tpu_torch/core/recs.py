"""Wire-level record types of the dmClock protocol (the port's copy of
``dmclock_tpu/core/recs.py``; reference ``dmclock_recs.h:25-72``): the
reservation-vs-priority phase marker and ``ReqParams{delta, rho}``, the
whole payload a client piggybacks onto each request.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Phase(enum.IntEnum):
    """Which scheduling phase served a request (dmclock_recs.h:33).
    An ``IntEnum``: callers may compare it with a phase of another
    package by value."""

    RESERVATION = 0
    PRIORITY = 1

    def __str__(self) -> str:
        return "reservation" if self is Phase.RESERVATION else "priority"


@dataclass(frozen=True)
class ReqParams:
    """Per-request distributed-protocol payload (dmclock_recs.h:40-72).

    delta: completions this client saw (across every server) since its
    previous request to the receiving server; rho: the same, counting
    reservation-phase completions only.  Invariant: rho <= delta."""

    delta: int = 0
    rho: int = 0

    def __post_init__(self) -> None:
        if self.rho > self.delta:
            raise ValueError(f"ReqParams invariant violated: rho "
                             f"{self.rho} > delta {self.delta}")

    def __str__(self) -> str:
        return f"ReqParams{{ delta:{self.delta}, rho:{self.rho} }}"
