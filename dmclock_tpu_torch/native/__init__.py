"""ctypes bindings to the native C++ dmClock runtime (the port's own
copy of ``dmclock_tpu/native/__init__.py``).

Loads ``libdmclock_c.so`` (built from the repo's ``native/src/capi.cc``)
and wraps it in the API of the oracle ``core.scheduler.PullPriorityQueue``
and ``core.tracker.ServiceTracker``, so the sim harness and the
differential tests drive the oracle, the native runtime and the device
engine interchangeably.  All three implement the identical int64-ns tag
algebra (``core/timebase.py`` == ``native/include/dmclock/time.h``), so
decision streams are compared op for op.  It is a host reference model:
no tensor, no device.

The library is found via ``$DMCLOCK_NATIVE_LIB``, the in-repo
``native/build/libdmclock_c.so`` (git-ignored), or a cmake build from
``native/src``, in that order; a library of a stale ABI is rebuilt
once.  ``load_library`` returns None when the library cannot be had
(no cmake, a failed build); callers (tests, the sim models) degrade
gracefully.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from collections import deque
from pathlib import Path
from typing import Any, Callable, Deque, Dict, Optional

from ..core.qos import ClientInfo
from ..core.recs import Phase, ReqParams
from ..core.scheduler import AtLimit, NextReqType, PullReq

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_BUILD_DIR = _NATIVE_DIR / "build"

_lib: Optional[ctypes.CDLL] = None
_lib_err: Optional[str] = None


def _so_path() -> Path:
    return _BUILD_DIR / "libdmclock_c.so"


_CAPI_VERSION = 2


def _rebuild() -> Optional[Path]:
    """A cmake build of the C library (the missing and the stale-ABI
    paths); None without cmake or on a failed build."""
    if not shutil.which("cmake"):
        return None
    try:
        subprocess.run(["cmake", "-S", str(_NATIVE_DIR), "-B",
                        str(_BUILD_DIR)], check=True,
                       capture_output=True, timeout=300)
        subprocess.run(["cmake", "--build", str(_BUILD_DIR), "-j",
                        "--target", "dmclock_c"], check=True,
                       capture_output=True, timeout=600)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    so = _so_path()
    return so if so.exists() else None


def ensure_built() -> Optional[Path]:
    """Build libdmclock_c.so with cmake if missing; None on failure."""
    env = os.environ.get("DMCLOCK_NATIVE_LIB")
    if env:
        if not Path(env).exists():
            raise FileNotFoundError(
                f"DMCLOCK_NATIVE_LIB={env!r} does not exist; refusing "
                "to silently fall back to a different library")
        return Path(env)
    so = _so_path()
    if so.exists():
        return so
    return _rebuild()


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the C ABI library; None if unavailable."""
    global _lib, _lib_err
    if _lib is not None:
        return _lib
    if _lib_err is not None:
        return None
    so = ensure_built()
    if so is None:
        _lib_err = "no compiler/cmake or build failed"
        return None
    lib = ctypes.CDLL(str(so))

    # ABI version gate: a stale prebuilt .so would silently ignore
    # newer trailing arguments (C calling convention), turning e.g.
    # use_prop_heap into a no-op.  Rebuild once on mismatch; refuse to
    # proceed if that does not converge.
    if not hasattr(lib, "dmc_capi_version") or \
            lib.dmc_capi_version() != _CAPI_VERSION:
        del lib
        so = _rebuild()
        if so is None:
            _lib_err = "stale native ABI and rebuild failed"
            raise RuntimeError(
                "libdmclock_c.so has a stale ABI and could not be "
                "rebuilt; remove native/build and rebuild")
        lib = ctypes.CDLL(str(so))
        if not hasattr(lib, "dmc_capi_version") or \
                lib.dmc_capi_version() != _CAPI_VERSION:
            _lib_err = "stale native ABI after rebuild"
            raise RuntimeError(
                "libdmclock_c.so ABI version mismatch persists after "
                "rebuild (DMCLOCK_NATIVE_LIB pointing at an old "
                "library?)")

    u64, i64, u32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32
    p = ctypes.POINTER
    lib.dmc_queue_create.restype = ctypes.c_void_p
    lib.dmc_queue_create.argtypes = [ctypes.c_int, ctypes.c_int, i64,
                                     i64, ctypes.c_uint, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_double,
                                     u64]
    lib.dmc_queue_destroy.argtypes = [ctypes.c_void_p]
    lib.dmc_queue_set_client_info.argtypes = [
        ctypes.c_void_p, u64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double]
    lib.dmc_queue_update_client_info.argtypes = [ctypes.c_void_p, u64]
    lib.dmc_queue_add.restype = ctypes.c_int
    lib.dmc_queue_add.argtypes = [ctypes.c_void_p, u64, u64, u32, u32,
                                  i64, u32]
    lib.dmc_queue_pull.restype = ctypes.c_int
    lib.dmc_queue_pull.argtypes = [ctypes.c_void_p, i64, p(u64), p(u64),
                                   p(ctypes.c_int), p(u32), p(i64)]
    lib.dmc_queue_request_count.restype = u64
    lib.dmc_queue_request_count.argtypes = [ctypes.c_void_p]
    lib.dmc_queue_client_count.restype = u64
    lib.dmc_queue_client_count.argtypes = [ctypes.c_void_p]
    lib.dmc_queue_empty.restype = ctypes.c_int
    lib.dmc_queue_empty.argtypes = [ctypes.c_void_p]
    lib.dmc_queue_counters.argtypes = [ctypes.c_void_p, p(u64), p(u64),
                                       p(u64)]
    lib.dmc_queue_remove_by_client.restype = u64
    lib.dmc_queue_remove_by_client.argtypes = [
        ctypes.c_void_p, u64, ctypes.c_int, p(u64), u64]
    lib.dmc_queue_do_clean.argtypes = [ctypes.c_void_p]
    lib.dmc_queue_set_fake_clock.argtypes = [ctypes.c_void_p,
                                             ctypes.c_double]
    lib.dmc_queue_heap_branching.restype = ctypes.c_uint
    lib.dmc_queue_heap_branching.argtypes = [ctypes.c_void_p]

    lib.dmc_tracker_create.restype = ctypes.c_void_p
    lib.dmc_tracker_create.argtypes = [ctypes.c_int]
    lib.dmc_tracker_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dmc_tracker_track_resp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           u64, ctypes.c_int, u32]
    lib.dmc_tracker_get_req_params.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u64, p(u32), p(u32)]

    _lib = lib
    return _lib


class NativePullPriorityQueue:
    """The C++ Pull queue behind the oracle-queue Python API.

    Request payloads and client ids are arbitrary Python objects; the
    wrapper maps them to the uint64 handles the C ABI speaks and keeps
    per-client FIFOs of payloads mirroring the native queue order (the
    handle seam ``native/src/capi.cc``; the API of ``core/scheduler.py``
    ``PullPriorityQueue``).
    """

    def __init__(self, client_info_f: Callable[[Any], ClientInfo], *,
                 delayed_tag_calc: bool = True,
                 at_limit: AtLimit = AtLimit.WAIT,
                 reject_threshold_ns: int = 0,
                 anticipation_timeout_ns: int = 0,
                 heap_branching: int = 2,
                 dynamic_cli_info: bool = False,
                 use_prop_heap: bool = False,
                 idle_age_s: float = 0.0,
                 erase_age_s: float = 0.0,
                 check_time_s: float = 0.0,
                 erase_max: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native dmclock library unavailable")
        self._lib = lib
        self.client_info_f = client_info_f
        # GC ages: 0 keeps the library default (reference constants)
        self._h = lib.dmc_queue_create(
            1 if delayed_tag_calc else 0, at_limit.value,
            int(reject_threshold_ns), int(anticipation_timeout_ns),
            int(heap_branching), 1 if dynamic_cli_info else 0,
            1 if use_prop_heap else 0, float(idle_age_s),
            float(erase_age_s), float(check_time_s), int(erase_max))
        self._dynamic = dynamic_cli_info
        self._cid: Dict[Any, int] = {}
        self._next_cid = 1
        self._payloads: Dict[int, Deque[Any]] = {}
        self._client_of: Dict[int, Any] = {}

    # -- client plumbing ------------------------------------------------
    def _client_handle(self, client_id: Any) -> int:
        cid = self._cid.get(client_id)
        if cid is None:
            cid = self._next_cid
            self._next_cid += 1
            self._cid[client_id] = cid
            self._client_of[cid] = client_id
            self._payloads[cid] = deque()
            info = self.client_info_f(client_id)
            self._lib.dmc_queue_set_client_info(
                self._h, cid, info.reservation, info.weight, info.limit)
        elif self._dynamic:
            info = self.client_info_f(client_id)
            self._lib.dmc_queue_set_client_info(
                self._h, cid, info.reservation, info.weight, info.limit)
        return cid

    # -- oracle-compatible API ------------------------------------------
    def add_request(self, request: Any, client_id: Any,
                    req_params: ReqParams = ReqParams(),
                    time_ns: Optional[int] = None, cost: int = 1) -> int:
        assert time_ns is not None, \
            "native parity surface requires explicit virtual times"
        cid = self._client_handle(client_id)
        q = self._payloads[cid]
        q.append(request)
        rc = self._lib.dmc_queue_add(self._h, cid, 0,
                                     req_params.delta, req_params.rho,
                                     int(time_ns), int(cost))
        if rc != 0:          # EAGAIN (AtLimit.REJECT): ownership returns
            q.pop()
        return rc

    def pull_request(self, now_ns: int) -> PullReq:
        client = ctypes.c_uint64()
        req_id = ctypes.c_uint64()
        phase = ctypes.c_int()
        cost = ctypes.c_uint32()
        when = ctypes.c_int64()
        t = self._lib.dmc_queue_pull(
            self._h, int(now_ns), ctypes.byref(client),
            ctypes.byref(req_id), ctypes.byref(phase), ctypes.byref(cost),
            ctypes.byref(when))
        if t == NextReqType.RETURNING.value:
            cid = client.value
            request = self._payloads[cid].popleft()
            return PullReq(NextReqType.RETURNING,
                           client=self._client_of[cid], request=request,
                           phase=Phase(phase.value), cost=cost.value)
        if t == NextReqType.FUTURE.value:
            return PullReq(NextReqType.FUTURE, when_ready=when.value)
        return PullReq(NextReqType.NONE)

    def update_client_info(self, client_id: Any) -> None:
        cid = self._cid.get(client_id)
        if cid is None:
            return
        info = self.client_info_f(client_id)
        self._lib.dmc_queue_set_client_info(
            self._h, cid, info.reservation, info.weight, info.limit)
        self._lib.dmc_queue_update_client_info(self._h, cid)

    def remove_by_client(self, client_id: Any, reverse: bool = False,
                         accum: Optional[Callable[[Any], None]] = None
                         ) -> None:
        cid = self._cid.get(client_id)
        if cid is None:
            return
        q = self._payloads[cid]
        cap = len(q)
        out = (ctypes.c_uint64 * max(cap, 1))()
        n = self._lib.dmc_queue_remove_by_client(
            self._h, cid, 1 if reverse else 0, out, cap)
        assert n == cap, "payload mirror out of sync with native queue"
        items = list(q)
        if reverse:
            items = list(reversed(items))
        if accum is not None:
            for r in items:
                accum(r)
        q.clear()

    def do_clean(self) -> None:
        self._lib.dmc_queue_do_clean(self._h)

    def set_fake_clock(self, now_s: float) -> None:
        """Deterministic GC clock (mirrors the oracle's injected
        monotonic_clock) -- march it forward, then do_clean()."""
        self._lib.dmc_queue_set_fake_clock(self._h, float(now_s))

    def request_count(self) -> int:
        return int(self._lib.dmc_queue_request_count(self._h))

    def client_count(self) -> int:
        return int(self._lib.dmc_queue_client_count(self._h))

    def empty(self) -> bool:
        return bool(self._lib.dmc_queue_empty(self._h))

    @property
    def _counters(self):
        r = ctypes.c_uint64()
        pr = ctypes.c_uint64()
        lb = ctypes.c_uint64()
        self._lib.dmc_queue_counters(self._h, ctypes.byref(r),
                                     ctypes.byref(pr), ctypes.byref(lb))
        return int(r.value), int(pr.value), int(lb.value)

    @property
    def reserv_sched_count(self) -> int:
        return self._counters[0]

    @property
    def prop_sched_count(self) -> int:
        return self._counters[1]

    @property
    def limit_break_sched_count(self) -> int:
        return self._counters[2]

    def heap_branching(self) -> int:
        return int(self._lib.dmc_queue_heap_branching(self._h))

    def shutdown(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dmc_queue_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class NativeServiceTracker:
    """The C++ ServiceTracker behind the oracle-tracker API
    (``core/tracker.py`` ServiceTracker; native ``tracker.h``)."""

    def __init__(self, borrowing: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native dmclock library unavailable")
        self._lib = lib
        self._b = 1 if borrowing else 0
        self._sid: Dict[Any, int] = {}
        self._next_sid = 1
        self._h = lib.dmc_tracker_create(self._b)

    def _server_handle(self, server: Any) -> int:
        sid = self._sid.get(server)
        if sid is None:
            sid = self._next_sid
            self._next_sid += 1
            self._sid[server] = sid
        return sid

    def get_req_params(self, server: Any) -> ReqParams:
        delta = ctypes.c_uint32()
        rho = ctypes.c_uint32()
        self._lib.dmc_tracker_get_req_params(
            self._h, self._b, self._server_handle(server),
            ctypes.byref(delta), ctypes.byref(rho))
        return ReqParams(delta.value, rho.value)

    def track_resp(self, server: Any, phase: Phase, cost: int = 1) -> None:
        self._lib.dmc_tracker_track_resp(
            self._h, self._b, self._server_handle(server),
            int(phase), int(cost))

    def shutdown(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dmc_tracker_destroy(self._h, self._b)
            self._h = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


__all__ = ["NativePullPriorityQueue", "NativeServiceTracker",
           "load_library", "ensure_built"]
