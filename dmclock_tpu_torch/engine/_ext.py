"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every source under ``csrc/`` (``ring_window.cu`` = K1,
``wheel_scan.cu`` = K2, ``ingest_scan.cu`` = K3) compiles with ONE
``nvcc`` call for ``sm_90a`` into one shared library under
``dmclock_tpu_torch/_build/`` (listed in ``.gitignore``), at first use.  The library's file name carries a hash
of all the sources and the flags, so an edited source never loads a
stale build; a build writes to a temporary name and renames it into
place, so concurrent builders never load a half-written file.

``LAUNCHES`` holds one plain integer per kernel: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its path went through the kernels.

Every ``build()`` call is recorded in the compile plane
(``obs/compile_plane.py``) under the cache ``kernels``: an ``nvcc`` run
with its wall (and a ``compile`` span when a tracer is attached), or a
current library found.

Nothing here runs at import time: the CPU tests import every module on
a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..obs import compile_plane

_PKG = Path(__file__).resolve().parent.parent
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = (_CSRC / "ring_window.cu", _CSRC / "wheel_scan.cu",
           _CSRC / "ingest_scan.cu")
_VP = ctypes.c_void_p
_INT = ctypes.c_int
# kernel name -> (C entry point, argtypes)
ENTRIES = {
    # ring_window_launch(arr, cost, q_head, out_arr, out_cost, n, q, w,
    #                    stream)
    "ring_window": ("ring_window_launch",
                    [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP]),
    # wheel_scan_launch(keys, slot, ws_cnt, ws_min, cnt, bmin, val,
    #                   found, n, nb, stream)
    "wheel_scan": ("wheel_scan_launch",
                   [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT,
                    _VP]),
    # ingest_scan_launch(rows, count, out, ws, b, stream)
    "ingest_scan": ("ingest_scan_launch", [_VP, _VP, _VP, _VP, _INT, _VP]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {name: 0 for name in ENTRIES}
# the compile plane's cache name for the kernel library
CACHE = "kernels"

_loaded: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)"
                       ": the CUDA kernels cannot be built")


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libdmclock_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless a current build exists; returns
    its path.  Raises with the compiler's output if the build fails.
    The call is recorded in the compile plane (module docstring)."""
    clock = compile_plane.plane().clock_ns
    t0 = clock()
    out = _lib_path()
    lookup_ns = clock() - t0
    if out.exists():
        compile_plane.record_found(CACHE, out.name, lookup_ns)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    with compile_plane.timed_build(CACHE, out.name, lookup_ns):
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"kernel build failed: nvcc exit "
                               f"{proc.returncode}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def kernel(name: str):
    """The C entry point of kernel ``name`` (a key of ``ENTRIES``),
    building the library at first use."""
    if name not in _loaded:
        entry, argtypes = ENTRIES[name]
        fn = getattr(ctypes.CDLL(str(build())), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return _loaded[name]
