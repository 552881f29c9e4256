"""dmclock-tpu on PyTorch and CUDA: the dmClock batch engine for one
NVIDIA Hopper card.

A port of the JAX package ``dmclock_tpu`` (which stays the reference):
the same int64-nanosecond tag algebra, the same SoA client state and
the same decision streams, bit for bit.  Plain tensor code is PyTorch;
each kernel the JAX package wrote in Pallas for the TPU is a kernel
written by hand for Hopper under ``engine/csrc/``.

Layers (each mirrors its counterpart in ``dmclock_tpu``):
  core    -- the int64-ns time/tag algebra, the QoS records, the host
             oracle queues and the client trackers
  engine  -- SoA client state, the exact serial engine, superwave
             ingest, the prefix-commit and calendar fast paths, the
             stream chunk, and their kernels (ring window, timer-wheel
             scan)
  obs     -- the on-device metrics vector, the admission clamp and the
             telemetry accumulators (histograms, ledger, SLO windows,
             provenance, flight ring); spans, the registry and its
             publishers, the burn-rate evaluator and the watchdog
  robust  -- the guarded epoch and stream chunk, the degradation
             ladder, host fault plans and the crash-equivalent
             supervisor (with ``utils.checkpoint``)
  control -- the closed-loop controller the supervisor runs at its
             checkpoint boundaries (and, on the mesh, live migration)
  net     -- the RPC ingest front end: wire framing, the network fault
             plane, the arrival journal, the ingest server and client,
             the serving loop and the load generator
  serve   -- the serving entry points (``serve_only``, bench's
             sustained rows ``sustained_row`` and ``frontier``, the
             queues, churn, the mesh, and the controller, rpc and
             mesh_rebalance rows)
  native  -- the ctypes binding of the C++ runtime under ``native/``
  sim     -- the simulators: the discrete-event harness, ``dmc_sim`` /
             ``ssched_sim`` over the model registry (``models``), and
             the device-resident multi-server closed loop
             (``device_sim``, with ``parallel.tracker``)

Every entry point takes ``device=`` and defaults to ``"cuda"``; the CPU
is used only when the caller asks for it, and asking for CUDA on a
machine without it raises (``device.resolve_device``).
"""

__version__ = "0.1.0"
