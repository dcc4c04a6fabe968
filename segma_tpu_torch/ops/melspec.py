"""Whisper log-mel frontend (counterpart of ``segma_tpu/ops/melspec.py``).

Numerics follow Whisper's frontend: n_fft 400, hop 160, periodic Hann window,
center reflect padding, slaney-scale slaney-norm mel filterbank, last frame
dropped, log10 with (max - 8) clamping and (x + 4) / 4 scaling. The work is
done by ``ops.logmel``: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
SAMPLE_RATE = 16_000
WHISPER_CONTEXT_S = 30.0


def _hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )


def mel_filterbank(
    sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS
) -> np.ndarray:
    """(n_freqs, n_mels) slaney-normalized triangular mel filterbank."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=2)
def dft_basis(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed DFT basis (n_fft, n_fft // 2 + 1): cos and -sin."""
    n_freqs = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    k = np.arange(n_freqs)[None, :]
    n = np.arange(n_fft)[:, None]
    angle = 2.0 * np.pi * k * n / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def log_mel_spectrogram(wav: torch.Tensor) -> torch.Tensor:
    """Whisper log-mel of (B, T) waveforms -> (B, T // 160, 80) f32."""
    from segma_tpu_torch.ops.logmel import finish, log10_mel

    return finish(log10_mel(wav))


def whisper_input_features(
    wav: torch.Tensor, chunk_length_s: float = WHISPER_CONTEXT_S, sr: int = SAMPLE_RATE
) -> torch.Tensor:
    """Pad with zeros or trim (B, T) waveforms to the Whisper context (30 s)
    and return (B, n_mels, 3000) features."""
    target = int(chunk_length_s * sr)
    t = wav.shape[1]
    if t < target:
        wav = F.pad(wav, (0, target - t))
    elif t > target:
        wav = wav[:, :target]
    return log_mel_spectrogram(wav).transpose(1, 2)
