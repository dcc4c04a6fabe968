"""The port's native WAV reader (``segma_tpu_torch/csrc/wavio.cpp`` through
``utils/native``) against the port's numpy readers (``utils/io``'s ``*_np``)
and the JAX package's ``segma_tpu.utils.native`` on the same files: mono
and stereo PCM16, PCM24 and PCM32, float32 and float64, the extensible
header, a data chunk that claims more bytes than the file holds, and a
truncated header. Every decode is compared exactly (the C++ and numpy
conversions are the same f32 divisions).

The library builds here with the host C++ compiler, once, even when four
threads reach its first use together.
"""

from __future__ import annotations

import struct
import threading
from pathlib import Path

import numpy as np
import pytest

from segma_tpu.utils import native as jnative
from segma_tpu_torch.ops import _build
from segma_tpu_torch.utils import io, native

SR = 16_000


def _wav_bytes(samples: np.ndarray, fmt: int, bits: int, extensible: bool = False,
               claim_extra: int = 0) -> bytes:
    """RIFF/WAVE bytes of (frames, channels) samples already in their on-disk
    dtype; ``claim_extra`` makes the data chunk claim that many more bytes."""
    frames, channels = samples.shape
    if bits == 24:
        i32 = samples.astype("<i4").reshape(-1)
        raw = np.stack([(i32 >> s) & 0xFF for s in (0, 8, 16)], 1).astype(np.uint8).tobytes()
    else:
        raw = samples.tobytes()
    block = channels * bits // 8
    if extensible:
        fmt_body = struct.pack("<HHIIHH", 0xFFFE, channels, SR, SR * block, block, bits)
        fmt_body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) + b"\x00" * 14
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, channels, SR, SR * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    chunks += b"LIST" + struct.pack("<I", 5) + b"abcde\x00"  # an odd chunk to skip
    chunks += b"data" + struct.pack("<I", len(raw) + claim_extra) + raw
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.fixture(scope="module")
def wavs(tmp_path_factory) -> dict[str, Path]:
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (3_001, 2))
    files = {
        "pcm16_mono": _wav_bytes((x[:, :1] * 32767).astype("<i2"), 1, 16),
        "pcm16_stereo": _wav_bytes((x * 32767).astype("<i2"), 1, 16),
        "pcm24": _wav_bytes((x[:, :1] * 8388607).astype("<i4"), 1, 24),
        "pcm32_stereo": _wav_bytes((x * 2147483000).astype("<i4"), 1, 32),
        "float32": _wav_bytes(x[:, :1].astype("<f4"), 3, 32),
        "float64_stereo": _wav_bytes(x.astype("<f8"), 3, 64),
        "extensible_pcm16": _wav_bytes((x[:, :1] * 32767).astype("<i2"), 1, 16,
                                       extensible=True),
        "claims_too_much": _wav_bytes((x[:, :1] * 32767).astype("<i2"), 1, 16,
                                      claim_extra=1 << 30),
    }
    paths = {}
    for name, data in files.items():
        paths[name] = root / f"{name}.wav"
        paths[name].write_bytes(data)
    paths["truncated_header"] = root / "truncated_header.wav"
    paths["truncated_header"].write_bytes(files["pcm16_mono"][:30])
    return paths


GOOD = ["pcm16_mono", "pcm16_stereo", "pcm24", "pcm32_stereo", "float32", "float64_stereo",
        "extensible_pcm16", "claims_too_much"]


def test_library_builds_once_under_racing_threads(tmp_path, monkeypatch):
    """Four threads reach the first use together: one build, one library."""
    monkeypatch.setattr(_build, "HOST_LIB_PATH", tmp_path / "libsegmawav.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_host_lib", None)
    builds = []
    real = _build.build_host

    def counted() -> None:
        builds.append(threading.get_ident())
        real()

    monkeypatch.setattr(_build, "build_host", counted)
    start = threading.Barrier(4)
    libs = []

    def first_use() -> None:
        start.wait()
        libs.append(_build.host_library())

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert (tmp_path / "libsegmawav.so").exists()
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("name", GOOD)
def test_probe_and_read_range_match_numpy_and_jax(wavs, name):
    path = wavs[name]
    sr, channels, bits, fmt, n = native.probe(path)
    assert (sr, channels, bits, fmt, n) == jnative.probe(path)
    info = io.get_audio_info_np(path)
    assert (sr, channels, n) == (info.sample_rate, info.n_channels, info.n_samples) == (
        SR, channels, 3_001)
    for start, count in ((0, -1), (0, 100), (1_000, 500), (2_990, 100), (5_000, 10)):
        got = native.read_range(path, start, count, channels)
        np.testing.assert_array_equal(got, jnative.read_range(path, start, count, channels))
        np.testing.assert_array_equal(got.T, io.get_samples_in_range_np(path, start, count))
        np.testing.assert_array_equal(io.get_samples_in_range(path, start, count), got.T)
    assert io.get_audio_info(path) == info


@pytest.mark.parametrize("name", GOOD)
def test_read_pcm16_matches_numpy_and_jax(wavs, name):
    path = wavs[name]
    got = native.read_pcm16(path)
    ref = io.read_pcm16_mono_np(path)
    assert (got is None) == (ref is None) == (jnative.read_pcm16(path) is None)
    assert io.probe_pcm16_mono(path) == io.probe_pcm16_mono_np(path) == (got is not None)
    if got is not None:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jnative.read_pcm16(path))
        np.testing.assert_array_equal(io.read_pcm16_mono(path), ref)
        np.testing.assert_array_equal(native.read_pcm16(path, 100, 50), ref[100:150])


def test_read_batch_pcm16_matches_jax(wavs, tmp_path):
    paths = []
    for i in range(5):
        p = tmp_path / f"f{i}.wav"
        p.write_bytes(_wav_bytes(np.full((1_000 + i, 1), 8_192 + i, "<i2"), 1, 16))
        paths.append(p)
    buf, lengths = native.read_batch_pcm16(paths, max_frames=1_003, n_threads=3)
    jbuf, jlengths = jnative.read_batch_pcm16(paths, max_frames=1_003, n_threads=3)
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(lengths, jlengths)
    np.testing.assert_array_equal(lengths, [1_000, 1_001, 1_002, 1_003, 1_003])
    assert buf[0, 1_000:].max() == 0 and buf[3].min() == 8_195
    with pytest.raises(ValueError, match="not mono PCM16|unsupported"):
        native.read_batch_pcm16([*paths, wavs["float32"]], max_frames=10)


def test_truncated_header_raises_like_numpy(wavs):
    path = wavs["truncated_header"]
    with pytest.raises(ValueError, match="truncated header"):
        native.probe(path)
    with pytest.raises(ValueError):
        jnative.probe(path)
    with pytest.raises(ValueError):
        io.get_audio_info_np(path)
    for read in (io.get_audio_info, io.read_pcm16_mono, io.probe_pcm16_mono):
        with pytest.raises(ValueError):
            read(path)
    with pytest.raises(ValueError, match="cannot open"):
        native.probe(path.parent / "missing.wav")


def test_io_reads_through_the_native_reader(wavs, monkeypatch):
    """utils/io's readers call the native library, with no numpy fallback."""
    calls = []
    real = _build.host_library

    def spy():
        calls.append(1)
        return real()

    monkeypatch.setattr(_build, "host_library", spy)
    path = wavs["pcm16_stereo"]
    io.get_audio_info(path)
    io.get_samples_in_range(path, 0, 10)
    io.probe_pcm16_mono(path)
    io.read_pcm16_mono(path)
    assert len(calls) >= 4

    def broken():
        raise RuntimeError("the WAV reader failed to build")

    monkeypatch.setattr(_build, "host_library", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        io.get_samples_in_range(path, 0, 10)
