"""Host utilities of the PyTorch port: the profiling accumulators
(``profile``), crash-safe checkpoints (``checkpoint``) and the
periodic job thread (``periodic``)."""

from .profile import ProfileCombiner, ProfileTimer

__all__ = ["ProfileTimer", "ProfileCombiner"]
