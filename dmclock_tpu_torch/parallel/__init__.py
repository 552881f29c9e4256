"""Distributed (multi-server) dmClock, on one card or across devices.

The reference's entire inter-node mechanism is four piggybacked scalars:
``ReqParams{delta, rho}`` client->server and the phase + cost back
(reference ``dmclock_recs.h:40-72``), with the client-side
``ServiceTracker`` (``dmclock_client.h:157-287``) diffing global
completion counters per server.  ``parallel.tracker`` keeps the same
contract on tensors: per-(server, client) counters on a leading server
axis, the global counters a sum over it (the JAX package's ``psum`` over
its mesh).  ``parallel.cluster`` is the multi-server cluster on the
serial engine and ``parallel.mesh`` the mesh serving plane's fused
chunk, both with the servers stacked on one device or, laid out by
``parallel.groups``, in contiguous groups stacked on several devices
(the JAX package's single controller over a mesh of devices).
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
