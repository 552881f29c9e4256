"""Per-client QoS parameters (the port's copy of ``dmclock_tpu/core/qos.py``).

Equivalent of the reference's ``ClientInfo`` (``dmclock_server.h:95-132``):
(reservation, weight, limit) rates plus cached integer nanosecond
increments per unit cost (``timebase.rate_to_inv_ns``), 0 -> 0 meaning
"axis disabled".

Construction validates its inputs: a NaN, infinite or negative rate,
or a nonzero limit below the reservation, raises ``ValueError`` naming
the client when the caller gives one.
"""

from __future__ import annotations

import math
from typing import Any, Optional

from .timebase import rate_to_inv_ns


def _validate_qos(reservation: float, weight: float, limit: float,
                  client: Optional[Any]) -> None:
    who = f" for client {client!r}" if client is not None else ""
    for label, v in (("reservation", reservation), ("weight", weight),
                     ("limit", limit)):
        if math.isnan(v):
            raise ValueError(f"QoS {label} is NaN{who}")
        if math.isinf(v):
            raise ValueError(f"QoS {label} is infinite{who} "
                             "(use 0 to disable the axis)")
        if v < 0:
            raise ValueError(f"QoS {label} must be >= 0{who}, "
                             f"got {v}")
    if limit > 0 and limit < reservation:
        raise ValueError(
            f"QoS limit {limit} < reservation {reservation}{who}: "
            "the cap would sit below the guaranteed floor, so the "
            "contract is unsatisfiable")


def validate_client_info(info, name: Optional[Any] = None) -> None:
    """Validate a QoS triple without building a :class:`ClientInfo`.

    ``info`` is a ClientInfo, anything with reservation/weight/limit
    attributes, or a ``(reservation, weight, limit)`` sequence; ``name``
    names the owner in errors (default: the ClientInfo's ``client``).
    Non-numeric values raise ``ValueError`` too."""
    if isinstance(info, (tuple, list)):
        r, w, l = info
    else:
        r, w, l = info.reservation, info.weight, info.limit
        if name is None:
            name = getattr(info, "client", None)
    try:
        r, w, l = float(r), float(w), float(l)
    except (TypeError, ValueError):
        who = f" for client {name!r}" if name is not None else ""
        raise ValueError(f"QoS triple must be numeric{who}, got "
                         f"({r!r}, {w!r}, {l!r})")
    _validate_qos(r, w, l, name)


class ClientInfo:
    """QoS triple: minimum (reservation), proportional (weight), maximum
    (limit), with cached ns-per-unit-cost increments.  Mutable through
    :meth:`update` (``update_client_info``, reference :633-648)."""

    __slots__ = ("reservation", "weight", "limit",
                 "reservation_inv_ns", "weight_inv_ns", "limit_inv_ns",
                 "client")

    def __init__(self, reservation: float, weight: float, limit: float,
                 client: Optional[Any] = None):
        self.client = client
        self.update(reservation, weight, limit)

    def update(self, reservation: float, weight: float,
               limit: float) -> None:
        reservation = float(reservation)
        weight = float(weight)
        limit = float(limit)
        validate_client_info((reservation, weight, limit),
                             name=self.client)
        self.reservation = reservation
        self.weight = weight
        self.limit = limit
        self.reservation_inv_ns = rate_to_inv_ns(self.reservation)
        self.weight_inv_ns = rate_to_inv_ns(self.weight)
        self.limit_inv_ns = rate_to_inv_ns(self.limit)

    def __repr__(self) -> str:
        return (f"ClientInfo(r={self.reservation}, w={self.weight}, "
                f"l={self.limit})")
