"""Canonical time / tag arithmetic base: int64 nanoseconds.

The port's own copy of the constants and helpers of
``dmclock_tpu/core/timebase.py`` that it uses.  Every backend performs
the same integer arithmetic, so request ordering between the JAX
reference and this port is bit-equal, not approximate.

Sentinels: MAX_TAG / MIN_TAG are +/-2^62 -- far beyond any organic
nanosecond timestamp yet leaving int64 headroom so that ``prev +
increment`` on organic values can never collide with a sentinel.
"""

from __future__ import annotations

NS_PER_SEC = 1_000_000_000

# Tag sentinels (reference: max_tag/min_tag, dmclock_server.h:60-65).
MAX_TAG = 1 << 62
MIN_TAG = -(1 << 62)

# Time sentinels (reference: TimeZero/TimeMax, dmclock_util.h:34-35);
# TIME_ZERO means "no time".
TIME_ZERO = 0
TIME_MAX = 1 << 62

# Idle-reactivation trigger ("much larger than any organic value",
# dmclock_server.h:957-958).
LOWEST_PROP_TAG_TRIGGER = MAX_TAG // 2

# Saturation bounds keeping the int64 algebra overflow-free:
# inv <= 2^40 ns/unit, charged units (dist + cost) <= 2^20 per request,
# so one increment is < 2^60 and prev (< 2^62) + increment < 2^63.
# Organic tags are capped at MAX_TAG - 1 so they never equal a sentinel.
MAX_INV_NS = 1 << 40
MAX_CHARGE_UNITS = 1 << 20
ORGANIC_TAG_CAP = MAX_TAG - 1


def sec_to_ns(t: float) -> int:
    """Float seconds to integer nanoseconds (round to nearest)."""
    return round(t * NS_PER_SEC)


def rate_to_inv_ns(rate: float) -> int:
    """QoS rate (ops/sec) -> nanoseconds of virtual time per unit cost,
    with the 0 -> 0 "axis disabled" sentinel (``ClientInfo::update``,
    dmclock_server.h:111-118), saturating at MAX_INV_NS."""
    if rate == 0.0:
        return 0
    return min(round(NS_PER_SEC / rate), MAX_INV_NS)
