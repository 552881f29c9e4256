"""Robustness helpers for the PyTorch port: bounded retry of transient
host-side failures around device launches and the guarded epoch runner
(``guarded``), and the chain digest of a decision stream (``digest``)."""
