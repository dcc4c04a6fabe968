"""Build the port's CUDA kernels at first use and bind them with ctypes.

One ``nvcc`` call compiles every ``segma_tpu_torch/csrc/*.cu`` into
``segma_tpu_torch/_build/libsegma_kernels.so`` (listed in ``.gitignore``).
The sources export plain C functions, so no PyTorch header is compiled and
the build takes seconds. A library newer than every source is reused.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsegma_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, spills and shared memory
)

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def nvcc_command(out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def build() -> list[str]:
    """Compile every kernel source into the shared library. Returns what
    ptxas said of each kernel: its registers, spills and shared memory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return [
        line.strip() for line in (proc.stdout + proc.stderr).splitlines()
        if "entry function" in line or "registers" in line or "spill" in line
    ]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.segma_logmel.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.segma_logmel.restype = i
            lib.segma_flash_attn_fwd.argtypes = [
                p, p, p, p, i, i, i, ctypes.c_float, p
            ]
            lib.segma_flash_attn_fwd.restype = i
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")
