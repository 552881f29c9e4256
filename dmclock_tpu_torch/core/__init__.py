"""Core dmClock constants for the PyTorch port (own copy; the port
imports nothing from ``dmclock_tpu``)."""
