"""The dmClock request-tag algebra, on Python ints (the port's copy of
``dmclock_tpu/core/tags.py``; reference ``dmclock_server.h:135-274``).

Each request carries three virtual-time tags:

  reservation = max(t, prev_r + r_inv * (rho   + cost))   # uses rho
  proportion  = max(t, prev_p + w_inv * (delta + cost))   # uses delta
  limit       = max(t, prev_l + l_inv * (delta + cost))   # uses delta

where a zero inverse pins the tag to MAX_TAG (reservation, proportion)
or MIN_TAG (limit).  Anticipation (``:159-161``): an arrival within
``anticipation_timeout`` of the previous request's arrival is backdated
by the timeout.  The device engine computes the same recurrence on
tensors (``engine.kernels._make_tag``); the host oracle queues
(``core.scheduler``) and the pull queue's REJECT admission mirror
compute it here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .qos import ClientInfo
from .timebase import MAX_CHARGE_UNITS, MAX_TAG, MIN_TAG, ORGANIC_TAG_CAP

__all__ = ["tag_calc", "RequestTag", "ZERO_TAG"]


def tag_calc(time_ns: int, prev_ns: int, inv_ns: int, dist_val: int,
             extreme_is_high: bool, cost: int) -> int:
    """``inv_ns == 0`` disables the axis: the tag pins to MAX_TAG
    (``extreme_is_high``) or MIN_TAG.  Otherwise the client's virtual
    clock advances ``inv_ns`` per unit of (distributed credit + cost),
    floored at ``time_ns``; charged units saturate at MAX_CHARGE_UNITS
    and the tag at ORGANIC_TAG_CAP."""
    if inv_ns == 0:
        return MAX_TAG if extreme_is_high else MIN_TAG
    units = min(dist_val + cost, MAX_CHARGE_UNITS)
    return min(max(time_ns, prev_ns + inv_ns * units), ORGANIC_TAG_CAP)


@dataclass
class RequestTag:
    """Tags + protocol metadata for one queued request
    (reference dmclock_server.h:135-274).

    ``ready`` flips true once the request's limit tag has passed
    (within-limit), enabling weight-phase service.  ``arrival`` is the
    wall time the request entered the queue (drives anticipation).
    """

    reservation: int
    proportion: int
    limit: int
    arrival: int
    delta: int = 0
    rho: int = 0
    cost: int = 1
    ready: bool = False

    @classmethod
    def from_prev(cls, prev: "RequestTag", info: ClientInfo,
                  delta: int, rho: int, time_ns: int, cost: int = 1,
                  anticipation_timeout_ns: int = 0) -> "RequestTag":
        """The tag recurrence (reference dmclock_server.h:145-183)."""
        assert cost > 0
        max_time = time_ns
        if time_ns - anticipation_timeout_ns < prev.arrival:
            max_time -= anticipation_timeout_ns
        reservation = tag_calc(max_time, prev.reservation,
                               info.reservation_inv_ns, rho, True, cost)
        proportion = tag_calc(max_time, prev.proportion,
                              info.weight_inv_ns, delta, True, cost)
        limit = tag_calc(max_time, prev.limit,
                         info.limit_inv_ns, delta, False, cost)
        # at least one of reservation/proportion must be usable
        # (reference assert, dmclock_server.h:182)
        assert reservation < MAX_TAG or proportion < MAX_TAG, \
            "client has neither reservation nor weight"
        return cls(reservation=reservation, proportion=proportion,
                   limit=limit, arrival=time_ns, delta=delta, rho=rho,
                   cost=cost, ready=False)

    def copy(self) -> "RequestTag":
        return replace(self)

    def __str__(self) -> str:
        from .timebase import format_tag
        return (f"{{ RequestTag:: ready:{str(self.ready).lower()}"
                f" r:{format_tag(self.reservation)}"
                f" p:{format_tag(self.proportion)}"
                f" l:{format_tag(self.limit)} }}")


# The zero tag for not-yet-tagged queued requests under delayed tag
# calculation (reference initial_tag(DelayedTagCalc), dmclock_server.h:
# 878-880) and every client's initial prev_tag (ClientRec ctor, :385).
ZERO_TAG = RequestTag(reservation=0, proportion=0, limit=0, arrival=0,
                      delta=0, rho=0, cost=1, ready=False)
