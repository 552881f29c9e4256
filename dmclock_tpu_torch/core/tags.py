"""One axis of the dmClock request-tag recurrence, on Python ints (the
port's copy of ``tag_calc`` in ``dmclock_tpu/core/tags.py``; reference
``dmclock_server.h:246-259``).  The device engine computes the same
recurrence on tensors (``engine.kernels._make_tag``); the pull queue's
REJECT admission mirror computes the limit axis here, on the host.
"""

from __future__ import annotations

from .timebase import MAX_CHARGE_UNITS, MAX_TAG, MIN_TAG, ORGANIC_TAG_CAP


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
