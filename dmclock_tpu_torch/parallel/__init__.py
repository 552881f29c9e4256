"""Distributed (multi-server) dmClock on one card.

The reference's entire inter-node mechanism is four piggybacked scalars:
``ReqParams{delta, rho}`` client->server and the phase + cost back
(reference ``dmclock_recs.h:40-72``), with the client-side
``ServiceTracker`` (``dmclock_client.h:157-287``) diffing global
completion counters per server.  ``parallel.tracker`` keeps the same
contract on tensors: per-(server, client) counters on a leading server
axis, the global counters a sum over it (the JAX package's ``psum`` over
its mesh; the mesh itself, ``parallel/cluster.py`` and
``parallel/mesh.py``, is not ported yet).
"""

from .tracker import (BorrowTrackerState, TrackerState,
                      borrow_tracker_prepare, borrow_tracker_track,
                      init_borrow_tracker, init_tracker,
                      tracker_prepare, tracker_track)

__all__ = [
    "TrackerState", "init_tracker", "tracker_prepare", "tracker_track",
    "BorrowTrackerState", "init_borrow_tracker",
    "borrow_tracker_prepare", "borrow_tracker_track",
]
