"""ctypes bindings to the port's WAV reader, ``csrc/wavio.cpp`` (counterpart
of ``segma_tpu/utils/native.py``).

``utils/io`` reads every WAV through it: header probes, ranged decodes and
threaded batch decodes run in C++. The library is built with the host C++
compiler at first use (``ops/_build.host_library``); a build that fails
raises, and nothing falls back to the numpy readers, which stay in
``utils/io`` as the plain versions that the tests hold this one to.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from segma_tpu_torch.ops import _build

# wavio.cpp's return codes
_ERRORS = {
    -1: "cannot open file",
    -2: "not a decodable RIFF/WAVE file (bad or truncated header)",
    -3: "unsupported WAV sample encoding",
}


def _err(call: str, rc: int, path: Path | str) -> ValueError:
    return ValueError(f"{path}: {_ERRORS.get(rc, f'error {rc}')} ({call})")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def probe(path: Path | str) -> tuple[int, int, int, int, int]:
    """(sample_rate, channels, bits, format, n_frames)."""
    out = np.zeros(5, np.int64)
    rc = _build.host_library().wavio_probe(str(path).encode(), _ptr(out))
    if rc != 0:
        raise _err("wavio_probe", rc, path)
    return tuple(int(v) for v in out)


def read_range(path: Path | str, start: int, n: int, channels: int) -> np.ndarray:
    """Interleaved float32 (frames, channels) of frames [start, start + n);
    ``n < 0`` reads to the end."""
    if n < 0:
        n = probe(path)[4] - max(0, start)
    buf = np.empty(max(n, 0) * channels, np.float32)
    got = _build.host_library().wavio_read_range(str(path).encode(), start, n, _ptr(buf))
    if got < 0:
        raise _err("wavio_read_range", got, path)
    return buf[: got * channels].reshape(int(got), channels)


def read_pcm16(path: Path | str, start: int = 0, n: int = -1) -> np.ndarray | None:
    """Raw int16 samples of a mono PCM16 file; None for any other layout."""
    if n < 0:
        _sr, channels, bits, fmt, frames = probe(path)
        if fmt != 1 or bits != 16 or channels != 1:
            return None
        n = frames - max(0, start)
    buf = np.empty(max(n, 0), np.int16)
    got = _build.host_library().wavio_read_pcm16(str(path).encode(), start, n, _ptr(buf))
    if got == -3:  # not mono PCM16
        return None
    if got < 0:
        raise _err("wavio_read_pcm16", got, path)
    return buf[:got]


def read_batch_pcm16(
    paths: list[Path | str], max_frames: int, n_threads: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """Threaded decode of mono PCM16 files -> (int16 (n, max_frames) zero
    padded, lengths (n,))."""
    n = len(paths)
    buf = np.empty((n, max_frames), np.int16)
    lengths = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = _build.host_library().wavio_read_batch_pcm16(
        ctypes.cast(c_paths, ctypes.c_void_p), n, max_frames, _ptr(buf), _ptr(lengths),
        n_threads,
    )
    if rc != 0:
        raise _err("wavio_read_batch_pcm16", rc, "batch")
    return buf, lengths
