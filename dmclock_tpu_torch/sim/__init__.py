"""The port's simulators: the discrete-event harness (``harness``) with
its config (``config``), the ``dmc_sim`` / ``ssched_sim`` CLIs over the
model registry (``dmclock_tpu_torch.models``), the FIFO baseline
(``ssched``), and the device-resident multi-server closed loop
(``device_sim``).  Counterparts of ``dmclock_tpu/sim/``."""

from .config import ClientGroup, ServerGroup, SimConfig, parse_config_file
from .harness import EventLoop, SimReport, SimulatedClient, SimulatedServer, Simulation
from .ssched import NullServiceTracker, SimpleQueue

__all__ = [
    "ClientGroup", "ServerGroup", "SimConfig", "parse_config_file",
    "EventLoop", "SimReport", "SimulatedClient", "SimulatedServer",
    "Simulation", "NullServiceTracker", "SimpleQueue",
]
