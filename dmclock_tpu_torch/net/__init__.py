"""The RPC ingest front end (docs/RPC.md; counterpart of
``dmclock_tpu/net/``).

Many concurrent client processes push tagged requests over real loopback
sockets; the host coalesces them into the stream chunk's superwave count
matrix, and the existing admission clamp prices them on the card.  The
network plane adds no device math, so a live run is digest-comparable to
a replay fed the same admitted-counts trace.

- :mod:`.framing` -- wire format: length-prefixed stream frames and
  single-datagram frames sharing one payload encoding.
- :mod:`.faults` -- the seeded network fault plane (drops, duplicates,
  reorders) with an exact host oracle for the chaos gates.
- :mod:`.journal` -- the fsync'd arrival journal on the checkpoint grid.
- :mod:`.server` -- the selectors event loop: backpressure, dedup
  watermarks, per-shard routing accounting, completion notifications.
- :mod:`.client` -- the blocking client with bounded exponential backoff.
- :mod:`.serve` -- the serving loop: journal, fused chunk on the card,
  checkpoint; double-buffered, SIGKILL-resumable, replayable.
- :mod:`.loadgen` -- the multi-process load generator driving the
  client over seeded schedules.

Every module but :mod:`.serve` is numpy and the standard library only.
"""

from . import faults, framing, journal  # noqa: F401

__all__ = ["framing", "faults", "journal"]
