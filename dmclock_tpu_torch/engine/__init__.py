"""The dmClock batch engine on PyTorch: SoA client state (``state``),
the numpy bridge (``bridge``), tag algebra and the exact serial engine
(``kernels``), the prefix-commit fast path (``fastpath``) and the build
of its CUDA kernels (``_ext``)."""

from .state import EngineState, grow_state, init_state
from .kernels import engine_run, engine_step

__all__ = ["EngineState", "init_state", "grow_state",
           "engine_step", "engine_run"]
