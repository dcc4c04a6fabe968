"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``segma_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together so that the build takes as long as its slowest source,
into an object under ``segma_tpu_torch/_build/`` (listed in ``.gitignore``);
one more ``nvcc`` links the objects into ``libsegma_kernels.so``. The
``*.cuh`` headers there are included by the sources. The sources export
plain C functions, so no PyTorch header is compiled and the build takes
seconds. A library newer than every source and header is reused.

The host library ``libsegmawav.so`` (the WAV reader, ``csrc/wavio.cpp``) is
built the same way by the host C++ compiler, beside it: it needs no CUDA, so
it builds wherever the port runs, the CPU included. Both builds run under
one lock, so threads that reach a first use together build once.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, spills and shared memory
)

HOST_SOURCE = SRC_DIR / "wavio.cpp"
HOST_LIB_PATH = BUILD_DIR / "libsegmawav.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared", "-pthread")

_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None
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


def compile_command(src: Path, obj: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [_nvcc(), "-shared", "-o", str(out), *map(str, objs)]


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(f.stat().st_mtime > built for f in [*sources(), *SRC_DIR.glob("*.cuh")])


def build() -> list[str]:
    """Compile every kernel source into the shared library. Returns what
    ptxas said of each kernel: its registers, spills and shared memory, and
    any warning (a serialised wgmma, an ignored setmaxnreg)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = LIB_PATH.with_suffix(f".{tag}.tmp")
    try:
        procs = [
            subprocess.Popen(
                compile_command(src, obj), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(sources(), objs)
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        for src, proc, out in zip(sources(), procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        link = subprocess.run(link_command(objs, tmp), capture_output=True, text=True,
                              check=False)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, LIB_PATH)
    return [
        line.strip() for line in "".join(outputs).splitlines()
        if any(w in line for w in ("entry function", "registers", "spill", "warning"))
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
            lib.segma_logmel.argtypes = [p, p, p, p, p, p, i, i, i, p]
            lib.segma_logmel.restype = i
            f = ctypes.c_float
            lib.segma_flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
            lib.segma_flash_attn_fwd.restype = i
            lib.segma_wavlm_attn_fwd.argtypes = [p] * 6 + [i, i, i, f, p]
            lib.segma_wavlm_attn_fwd.restype = i
            lib.segma_flash_attn_bwd.argtypes = [p] * 10 + [i, i, i, f, f, p]
            lib.segma_flash_attn_bwd.restype = i
            lib.segma_flash_attn_fwd_f32.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
            lib.segma_flash_attn_fwd_f32.restype = i
            lib.segma_flash_attn_bwd_f32.argtypes = [p] * 10 + [i, i, i, f, f, p]
            lib.segma_flash_attn_bwd_f32.restype = i
            lib.segma_lstm_fwd.argtypes = [p, p, p, i, i, i, i, p]
            lib.segma_lstm_fwd.restype = i
            lib.segma_lstm_fwd_clusters.argtypes = [i, ctypes.POINTER(i)]
            lib.segma_lstm_fwd_clusters.restype = i
            _lib = lib
    return _lib


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++): the WAV reader cannot be built")


def build_host() -> None:
    """Compile the WAV reader into ``HOST_LIB_PATH`` (a temporary file first,
    then renamed, so a process never loads a half-written library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = HOST_LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(HOST_SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the WAV reader failed to build:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, HOST_LIB_PATH)


def host_library() -> ctypes.CDLL:
    """The loaded WAV reader, built first if missing or older than its source."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            if (not HOST_LIB_PATH.exists()
                    or HOST_SOURCE.stat().st_mtime > HOST_LIB_PATH.stat().st_mtime):
                build_host()
            lib = ctypes.CDLL(str(HOST_LIB_PATH))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.wavio_probe.argtypes = [ctypes.c_char_p, p]
            lib.wavio_probe.restype = i
            lib.wavio_read_range.argtypes = [ctypes.c_char_p, i64, i64, p]
            lib.wavio_read_range.restype = i64
            lib.wavio_read_pcm16.argtypes = [ctypes.c_char_p, i64, i64, p]
            lib.wavio_read_pcm16.restype = i64
            lib.wavio_read_batch_pcm16.argtypes = [p, i64, i64, p, p, i]
            lib.wavio_read_batch_pcm16.restype = i
            _host_lib = lib
    return _host_lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")
