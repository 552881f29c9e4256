"""Scheduling observability for the PyTorch port: the on-device metrics
vector and the admission clamp (``obs.device``)."""
