"""Host utilities of the PyTorch port: the profiling accumulators
(``profile``) and crash-safe checkpoints (``checkpoint``)."""

from .profile import ProfileCombiner, ProfileTimer

__all__ = ["ProfileTimer", "ProfileCombiner"]
