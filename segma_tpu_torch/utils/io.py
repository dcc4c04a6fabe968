"""WAV reading and writing (counterpart of ``segma_tpu/utils/io.py``):
header probing, ranged sample reads, the zero-decode int16 fast path, and
``write_data_to_disk`` (16-bit PCM).

``get_audio_info``, ``get_samples_in_range``, ``probe_pcm16_mono`` and
``read_pcm16_mono`` read through the native reader (``utils/native``, built
from ``csrc/wavio.cpp`` at first use). Their ``*_np`` counterparts here are
the plain numpy versions that the tests hold the native reader to.

Supported encodings: PCM 16/24/32-bit and IEEE float32/64.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


@dataclass
class AudioInfo:
    sample_rate: int
    n_samples: int
    n_channels: int


@dataclass
class _WavLayout:
    """Where the samples live inside a RIFF container."""

    sample_rate: int
    n_channels: int
    bits_per_sample: int
    audio_format: int
    data_offset: int
    data_size: int

    @property
    def bytes_per_frame(self) -> int:
        return self.n_channels * self.bits_per_sample // 8

    @property
    def n_samples(self) -> int:
        return self.data_size // self.bytes_per_frame


def _parse_wav_header(audio_p: Path) -> _WavLayout:
    """Walk RIFF chunks to locate ``fmt `` and ``data``."""
    with audio_p.open("rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{audio_p}: not a RIFF/WAVE file")
        fmt = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = header[:4], struct.unpack("<I", header[4:8])[0]
            if chunk_id == b"fmt ":
                body = f.read(chunk_size)
                if len(body) < 16:  # minimum valid PCM fmt chunk
                    raise ValueError(f"{audio_p}: truncated fmt chunk")
                (audio_format, n_channels, sample_rate, _, _, bits) = struct.unpack(
                    "<HHIIHH", body[:16]
                )
                if audio_format == _EXTENSIBLE and chunk_size >= 40:
                    # SubFormat GUID's first two bytes carry the real format.
                    if len(body) < 26:
                        # chunk_size CLAIMS >=40 but the file ends early: a
                        # bare unpack would leak struct.error to callers
                        # expecting ValueError
                        raise ValueError(
                            f"{audio_p}: truncated extensible fmt chunk"
                        )
                    audio_format = struct.unpack("<H", body[24:26])[0]
                if n_channels == 0 or bits < 8 or bits % 8:
                    # sub-byte encodings (4-bit ADPCM): bytes_per_frame
                    # would be 0 and every n_samples division would crash
                    raise ValueError(
                        f"{audio_p}: unsupported WAV layout "
                        f"(channels={n_channels}, bits={bits})"
                    )
                fmt = (audio_format, n_channels, sample_rate, bits)
            elif chunk_id == b"data":
                if fmt is None:
                    raise ValueError(f"{audio_p}: data chunk before fmt chunk")
                audio_format, n_channels, sample_rate, bits = fmt
                # clamp the CLAIMED size to the bytes actually present: a
                # tiny file claiming a 4 GB data chunk would otherwise make
                # every caller size its buffers off the claim
                data_offset = f.tell()
                f.seek(0, 2)
                avail = max(0, f.tell() - data_offset)
                return _WavLayout(
                    sample_rate=sample_rate,
                    n_channels=n_channels,
                    bits_per_sample=bits,
                    audio_format=audio_format,
                    data_offset=data_offset,
                    data_size=min(chunk_size, avail),
                )
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
        raise ValueError(f"{audio_p}: no data chunk found")


def get_audio_info(audio_p: Path | str) -> AudioInfo:
    """Header-only probe: sample rate, sample count, channel count."""
    from segma_tpu_torch.utils import native

    sr, channels, _bits, _fmt, n_frames = native.probe(audio_p)
    return AudioInfo(sample_rate=sr, n_samples=n_frames, n_channels=channels)


def get_audio_info_np(audio_p: Path | str) -> AudioInfo:
    """``get_audio_info`` in numpy."""
    layout = _parse_wav_header(Path(audio_p))
    return AudioInfo(
        sample_rate=layout.sample_rate,
        n_samples=layout.n_samples,
        n_channels=layout.n_channels,
    )


def _decode(raw: bytes, layout: _WavLayout, n_frames: int) -> np.ndarray:
    """bytes -> float32 (n_channels, n_frames), normalized to [-1, 1]."""
    fmt, bits = layout.audio_format, layout.bits_per_sample
    if fmt == _PCM and bits == 16:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif fmt == _PCM and bits == 32:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif fmt == _PCM and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as_i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as_i32 = (as_i32 << 8) >> 8  # sign-extend
        data = as_i32.astype(np.float32) / 8388608.0
    elif fmt == _IEEE_FLOAT and bits == 32:
        data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif fmt == _IEEE_FLOAT and bits == 64:
        data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV encoding: format={fmt} bits={bits}")
    return data.reshape(n_frames, layout.n_channels).T


def get_samples_in_range(
    audio_p: Path | str, start_f: int, duration_f: int
) -> np.ndarray:
    """Read samples ``[start_f : start_f + duration_f]`` as float32
    ``(n_channels, n_samples)``. ``duration_f == -1`` reads to the end.

    Matches the reference contract (``io.py:30-47``) without decoding the
    rest of the file.
    """
    from segma_tpu_torch.utils import native

    channels = native.probe(audio_p)[1]
    return np.ascontiguousarray(native.read_range(audio_p, start_f, duration_f, channels).T)


def get_samples_in_range_np(
    audio_p: Path | str, start_f: int, duration_f: int
) -> np.ndarray:
    """``get_samples_in_range`` in numpy."""
    audio_p = Path(audio_p)
    layout = _parse_wav_header(audio_p)
    total = layout.n_samples
    start_f = max(0, min(start_f, total))
    if duration_f < 0:
        n_frames = total - start_f
    else:
        n_frames = max(0, min(duration_f, total - start_f))
    bpf = layout.bytes_per_frame
    with audio_p.open("rb") as f:
        f.seek(layout.data_offset + start_f * bpf)
        raw = f.read(n_frames * bpf)
    n_read = len(raw) // bpf
    return _decode(raw[: n_read * bpf], layout, n_read)


def get_all_samples(audio_p: Path | str) -> np.ndarray:
    """Decode the whole file as float32 (n_channels, n_samples)."""
    return get_samples_in_range(audio_p, 0, -1)


def probe_pcm16_mono(audio_p: Path | str) -> bool:
    """Header-only probe: True iff the file is mono 16-bit PCM, the files
    ``read_pcm16_mono`` reads; the device audio cache picks its buffer dtype
    from it before decoding anything."""
    from segma_tpu_torch.utils import native

    _sr, channels, bits, fmt, _n = native.probe(audio_p)
    return fmt == _PCM and bits == 16 and channels == 1


def probe_pcm16_mono_np(audio_p: Path | str) -> bool:
    """``probe_pcm16_mono`` in numpy."""
    layout = _parse_wav_header(Path(audio_p))
    return layout.audio_format == _PCM and layout.bits_per_sample == 16 and layout.n_channels == 1


def read_pcm16_mono(audio_p: Path | str) -> np.ndarray | None:
    """Zero-decode fast path: return the raw int16 samples of a mono PCM16
    WAV, or None when the file is not mono PCM16.

    The pipeline ships int16 to the device and normalizes there, which
    halves the bytes copied from the host."""
    from segma_tpu_torch.utils import native

    return native.read_pcm16(audio_p)


def read_pcm16_mono_np(audio_p: Path | str) -> np.ndarray | None:
    """``read_pcm16_mono`` in numpy."""
    audio_p = Path(audio_p)
    layout = _parse_wav_header(audio_p)
    if layout.audio_format != _PCM or layout.bits_per_sample != 16:
        return None
    if layout.n_channels != 1:
        return None
    with audio_p.open("rb") as f:
        f.seek(layout.data_offset)
        raw = f.read(layout.data_size)
    return np.frombuffer(raw, dtype="<i2")


def write_data_to_disk(
    data: np.ndarray, output_file: Path | str, sample_rate: int = 16_000
) -> None:
    """Write float32 samples (n_channels, n_samples) or (n_samples,) as a
    16-bit PCM WAV file (``output_file`` with a ``.wav`` suffix)."""
    output_file = Path(output_file).with_suffix(".wav")
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    pcm = (np.clip(data.T, -1.0, 1.0) * 32767.0).astype("<i2")
    n_channels = pcm.shape[1]
    data_bytes = pcm.tobytes()
    with output_file.open("wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data_bytes)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, _PCM, n_channels, sample_rate,
                            sample_rate * n_channels * 2, n_channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data_bytes)))
        f.write(data_bytes)
