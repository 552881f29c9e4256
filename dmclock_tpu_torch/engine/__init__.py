"""The dmClock batch engine on PyTorch: SoA client state (``state``),
the numpy bridge (``bridge``), tag algebra, the exact serial engine, the
ingest paths and the timer-wheel scan (``kernels``), the prefix and
calendar fast paths (``fastpath``), the stream chunk (``stream``), the
build of the CUDA kernels (``_ext``), and the pull and push queue API
over the serial engine (``queue``, ``push_queue``)."""

from .state import EngineState, grow_state, init_state
from .kernels import engine_run, engine_step, ingest
from .queue import TpuPullPriorityQueue
from .push_queue import TpuPushPriorityQueue

__all__ = ["EngineState", "init_state", "grow_state",
           "engine_step", "engine_run", "ingest",
           "TpuPullPriorityQueue", "TpuPushPriorityQueue"]
