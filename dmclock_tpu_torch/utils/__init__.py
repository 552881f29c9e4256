"""Host utilities of the PyTorch port: the profiling accumulators
(``profile``)."""

from .profile import ProfileCombiner, ProfileTimer

__all__ = ["ProfileTimer", "ProfileCombiner"]
