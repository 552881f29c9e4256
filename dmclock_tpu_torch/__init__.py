"""dmclock-tpu on PyTorch and CUDA: the dmClock batch engine for one
NVIDIA Hopper card.

A port of the JAX package ``dmclock_tpu`` (which stays the reference):
the same int64-nanosecond tag algebra, the same SoA client state and
the same decision streams, bit for bit.  Plain tensor code is PyTorch;
each kernel the JAX package wrote in Pallas for the TPU is a kernel
written by hand for Hopper under ``engine/csrc/``.

Layers (each mirrors its counterpart in ``dmclock_tpu``):
  core    -- the int64-ns time/tag constants
  engine  -- SoA client state, the exact serial engine, superwave
             ingest, the prefix-commit and calendar fast paths, the
             stream chunk, and their kernels (ring window, timer-wheel
             scan)
  obs     -- the on-device metrics vector, the admission clamp and the
             telemetry accumulators (histograms, ledger, SLO windows,
             provenance, flight ring)
  robust  -- the guarded epoch and stream chunk, the degradation
             ladder, host fault plans and the crash-equivalent
             supervisor (with ``utils.checkpoint``)
  serve   -- the serving entry points (``serve_only``, ``serve_cfg3``,
             ``serve_cfg4``, the queues)

Every entry point takes ``device=`` and defaults to ``"cuda"``; the CPU
is used only when the caller asks for it, and asking for CUDA on a
machine without it raises (``device.resolve_device``).
"""

__version__ = "0.1.0"
