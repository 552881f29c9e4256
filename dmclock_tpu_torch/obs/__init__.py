"""Scheduling observability for the PyTorch port: the on-device metrics
vector (``obs.device``)."""
