"""The dmClock batch engine on PyTorch: SoA client state (``state``),
the numpy bridge (``bridge``), tag algebra, the exact serial engine,
superwave ingest and the timer-wheel scan (``kernels``), the prefix and
calendar fast paths (``fastpath``) and the build of the CUDA kernels
(``_ext``)."""

from .state import EngineState, grow_state, init_state
from .kernels import engine_run, engine_step

__all__ = ["EngineState", "init_state", "grow_state",
           "engine_step", "engine_run"]
