"""The robustness plane of the PyTorch port: bounded retry of transient
host-side failures, the guarded epoch and stream-chunk runners and the
degradation ladder (``guarded``), the chain digest of a decision stream
(``digest``), host fault plans (``host_faults``), the crash-equivalent
supervisor of resumable epoch jobs (``supervisor``), seeded cluster fault
plans (``faults``) and the degraded-mode cluster (``cluster``)."""
