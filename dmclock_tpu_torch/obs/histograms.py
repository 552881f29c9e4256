"""Column layout of the per-client conformance ledger (the port's copy of
the ``LED_*`` constants of ``dmclock_tpu/obs/histograms.py``).  The pull
queue keeps a host ledger in this layout; the device histograms and the
ledger's device accumulation are not ported yet."""

LED_OPS = 0           # decisions served
LED_RESV_OPS = 1      # constraint-phase decisions
LED_LIMIT_BREAKS = 2  # AtLimit::Allow limit-break entries
LED_TARD_SUM = 3      # reservation tardiness sum, ns (entry-head obs)
LED_TARD_MAX = 4      # reservation tardiness max, ns
LED_COLS = 5
