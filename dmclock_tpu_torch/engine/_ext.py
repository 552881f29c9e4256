"""Build and load the port's CUDA kernel (plain C interface, ctypes).

``csrc/ring_window.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library under ``dmclock_tpu_torch/_build/`` (listed in
``.gitignore``), at first use.  The library's file name carries a hash
of its source, so an edited source never loads a stale build; a build
writes to a temporary name and renames it into place, so concurrent
builders never load a half-written file.

``LAUNCHES`` holds one plain integer per kernel: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its path went through the kernels.

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

_PKG = Path(__file__).resolve().parent.parent
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCE = _CSRC / "ring_window.cu"
ENTRY = "ring_window_launch"
_VP = ctypes.c_void_p
_INT = ctypes.c_int
ARGTYPES = [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"ring_window": 0}

_loaded = None


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
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libring_window-{digest[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless a current build exists; returns
    its path.  Raises with the compiler's output if the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def kernel():
    """The C entry point of the ring-window kernel, building its library
    at first use."""
    global _loaded
    if _loaded is None:
        fn = getattr(ctypes.CDLL(str(build())), ENTRY)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _loaded = fn
    return _loaded
