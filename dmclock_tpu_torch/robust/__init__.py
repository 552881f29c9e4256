"""Robustness helpers for the PyTorch port: bounded retry of transient
host-side failures around device launches (``guarded``)."""
