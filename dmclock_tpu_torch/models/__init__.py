"""Scheduler "model" registry of the port (the counterpart of
``dmclock_tpu/models/__init__.py``, with the same API).

The model families of this framework are its schedulers.  Each entry
binds a queue factory + tracker factory pair for the sim harness
(the reference's type-glue headers ``sim/src/test_dmclock.h:33-62`` and
``sim/src/test_ssched.h``):

  dmclock         -- the oracle queues (``core.scheduler``) +
                     ``OrigTracker``, immediate tags (pull and push)
  dmclock-delayed -- the same with delayed tag calculation
  dmclock-torch   -- the device-engine queues (``engine.queue``,
                     ``engine.push_queue``) + ``OrigTracker``; the JAX
                     package's ``dmclock-tpu``
  dmclock-native  -- the C++ runtime via ctypes (``native``), delayed
                     tags (pull)
  ssched          -- FIFO baseline + no-op tracker

``dmclock``, ``dmclock-delayed`` and ``dmclock-native`` are host
reference models by design, as in the JAX package: they hold the
reference's semantics the device engine is compared against, and run
no tensor.  Every queue factory takes ``device=`` (default ``"cuda"``)
for the registry's uniform signature; the sim passes the device it was
given and the host models ignore it.  :data:`NOT_PORTED` (the JAX
package's models the port does not carry) is empty.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..core.scheduler import AtLimit, PullPriorityQueue, PushPriorityQueue
from ..core.tracker import ServiceTracker
from ..device import DEFAULT_DEVICE
from ..sim.ssched import NullServiceTracker, SimpleQueue

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {}
_PUSH_REGISTRY: Dict[str, Callable] = {}

# the JAX package's models this port does not carry, with the reason
NOT_PORTED: Dict[str, str] = {}

# the native model's optional prop heap (the reference USE_PROP_HEAP
# build flag made runtime; behaviorally invisible), set by dmc_sim
# --use-prop-heap
USE_PROP_HEAP = False


def register(name: str, queue_factory: Callable,
             tracker_factory: Callable) -> None:
    _REGISTRY[name] = (queue_factory, tracker_factory)


def register_push(name: str, queue_factory: Callable) -> None:
    """Push-mode factory: (server_id, info_f, anticipation_ns, soft, *,
    can_handle_f, handle_f, now_ns_f, sched_at_f, capacity_f, device)
    -> push queue."""
    _PUSH_REGISTRY[name] = queue_factory


def _refuse_not_ported(name: str) -> None:
    if name in NOT_PORTED:
        raise KeyError(f"model {name!r} is not ported to "
                       f"dmclock_tpu_torch: it {NOT_PORTED[name]}; "
                       f"have {sorted(_REGISTRY)}")


def get(name: str) -> Tuple[Callable, Callable]:
    _refuse_not_ported(name)
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler model {name!r}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_push(name: str) -> Callable:
    _refuse_not_ported(name)
    if name not in _PUSH_REGISTRY:
        raise KeyError(f"model {name!r} has no push-mode queue; "
                       f"have {sorted(_PUSH_REGISTRY)}")
    return _PUSH_REGISTRY[name]


def names():
    return sorted(_REGISTRY)


def push_names():
    return sorted(_PUSH_REGISTRY)


def _at_limit(soft_limit: bool) -> AtLimit:
    # soft limit -> AtLimit.Allow, hard -> Wait (reference
    # test_dmclock_main.cc:190-198 create_queue_f)
    return AtLimit.ALLOW if soft_limit else AtLimit.WAIT


def _dmclock_tracker():
    return ServiceTracker(run_gc_thread=False)


def _dmclock_queue(delayed: bool):
    def factory(server_id, client_info_f, anticipation_ns, soft_limit, *,
                device=DEFAULT_DEVICE):
        return PullPriorityQueue(
            client_info_f, delayed_tag_calc=delayed,
            at_limit=_at_limit(soft_limit),
            anticipation_timeout_ns=anticipation_ns, run_gc_thread=False)
    return factory


def _dmclock_push_queue(delayed: bool):
    def factory(server_id, client_info_f, anticipation_ns, soft_limit, *,
                can_handle_f, handle_f, now_ns_f, sched_at_f,
                capacity_f=None, device=DEFAULT_DEVICE):
        # the host queue consults can_handle before every dispatch (the
        # reference's pacing); the free-slot count is unused
        return PushPriorityQueue(
            client_info_f, can_handle_f, handle_f,
            now_ns_f=now_ns_f, sched_at_f=sched_at_f,
            delayed_tag_calc=delayed, at_limit=_at_limit(soft_limit),
            anticipation_timeout_ns=anticipation_ns, run_gc_thread=False)
    return factory


def _dmclock_native_queue(server_id, client_info_f, anticipation_ns,
                          soft_limit, *, device=DEFAULT_DEVICE):
    # imported lazily; raises with a clear message without the library
    from ..native import NativePullPriorityQueue
    return NativePullPriorityQueue(
        client_info_f, delayed_tag_calc=True,
        at_limit=_at_limit(soft_limit),
        anticipation_timeout_ns=anticipation_ns,
        use_prop_heap=USE_PROP_HEAP)


def _dmclock_torch_queue(server_id, client_info_f, anticipation_ns,
                         soft_limit, *, device=DEFAULT_DEVICE):
    # speculative_batch: the sim pulls one decision per service event,
    # so per-launch dispatch dominates; the buffer serves provably-
    # valid prefetched decisions launch-free (the JAX package's
    # dmclock-tpu factory, models/__init__.py:78-90)
    from ..engine.queue import TpuPullPriorityQueue
    return TpuPullPriorityQueue(
        client_info_f, at_limit=_at_limit(soft_limit),
        anticipation_timeout_ns=anticipation_ns, speculative_batch=4,
        device=device)


def _dmclock_torch_push_queue(server_id, client_info_f, anticipation_ns,
                              soft_limit, *, can_handle_f, handle_f,
                              now_ns_f, sched_at_f, capacity_f=None,
                              device=DEFAULT_DEVICE):
    # capacity_f (the sim server's free-slot count, reference
    # has_avail_thread sim_server.h:179) sizes each dispatch batch so
    # one device launch serves a whole burst of free threads; with
    # threads == 1 batches are size 1 and the decision stream is the
    # host push queue's one-per-trigger pacing
    from ..engine.push_queue import TpuPushPriorityQueue
    return TpuPushPriorityQueue(
        client_info_f, can_handle_f, handle_f,
        now_ns_f=now_ns_f, sched_at_f=sched_at_f, capacity_f=capacity_f,
        at_limit=_at_limit(soft_limit),
        anticipation_timeout_ns=anticipation_ns, device=device)


def _ssched_queue(server_id, client_info_f, anticipation_ns, soft_limit,
                  *, device=DEFAULT_DEVICE):
    return SimpleQueue()


def _ssched_push_queue(server_id, client_info_f, anticipation_ns,
                       soft_limit, *, can_handle_f, handle_f, now_ns_f,
                       sched_at_f, capacity_f=None, device=DEFAULT_DEVICE):
    return SimpleQueue(can_handle_f=can_handle_f, handle_f=handle_f)


register("dmclock", _dmclock_queue(delayed=False), _dmclock_tracker)
register("dmclock-delayed", _dmclock_queue(delayed=True), _dmclock_tracker)
register("dmclock-torch", _dmclock_torch_queue, _dmclock_tracker)
register("dmclock-native", _dmclock_native_queue, _dmclock_tracker)
register("ssched", _ssched_queue, NullServiceTracker)
register_push("dmclock", _dmclock_push_queue(delayed=False))
register_push("dmclock-delayed", _dmclock_push_queue(delayed=True))
register_push("dmclock-torch", _dmclock_torch_push_queue)
register_push("ssched", _ssched_push_queue)
