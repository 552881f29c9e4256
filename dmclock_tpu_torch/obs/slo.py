"""Column layout of an SLO window row (the port's copy of the ``W_*``
constants of ``dmclock_tpu/obs/slo.py``).  The pull queue keeps a host
window per client in this layout; the device window block is not ported
yet."""

W_OPS = 0          # decisions delivered in the window
W_COST = 1         # delivered cost (sum of served request costs)
W_RESV_OPS = 2     # constraint-phase (reservation-eligible) decisions
W_TARDY_OPS = 3    # reservation entries served past their deadline
W_LB_OPS = 4       # AtLimit::Allow limit-break entries
W_TARD_SUM = 5     # reservation tardiness sum, ns (entry-head obs)
W_CEPOCH = 6       # contract-epoch id (host-stamped at window open)
W_FIELDS = 7
