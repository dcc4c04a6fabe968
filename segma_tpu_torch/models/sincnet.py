"""``sincnet_hydra``: a learnable band-pass (SincNet) front end, a BiLSTM and
hydra heads on raw waveforms (counterpart of ``segma_tpu/models/sincnet.py``).

The sinc filter bank is rebuilt from two (filters,) parameters, each
filter's low cut and band width, on every forward, then applied as one
strided conv with explicit (half, half) padding. Then log-compression,
LayerNorm, max-pool 4, two strided convs (k5/s4, k5/s2, padding (2, 2)),
each followed by tanh GELU and LayerNorm (flax's defaults: the tanh
approximation, eps 1e-6), the BiLSTM and fused hydra heads: one frame per
``32 * stride`` samples (320 at the default stride 10).

The upper band edge is ``minimum(f1 + min_band + |band|, sr / 2)``, not
``clamp(max=sr / 2)``: at the default initialisation the last filter's edge
is exactly sr / 2 in f32, and at that tie JAX's ``clip`` passes half the
gradient to each side, as ``torch.minimum`` does; ``clamp`` passes all of it.

Submodules carry the flax names (``sinc``, ``LayerNorm_0`` ...
``LayerNorm_2``, ``conv1``, ``conv2``, ``lstm_shared``, ``heads``). The
compute dtype is ``model.config.dtype``; the BiLSTM and the heads run in
IEEE f32 whatever it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from segma_tpu_torch import resolve_device
from segma_tpu_torch.config import Config, LSTMConfig, SincNetHydraConfig
from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel, ieee_f32
from segma_tpu_torch.models.hubert.encoder import _conv
from segma_tpu_torch.models.layers import BiLSTM, HydraHeads
from segma_tpu_torch.models.vad import FLAX_LN_EPS, gelu
from segma_tpu_torch.models.whisper.builders import init_random_
from segma_tpu_torch.models.whisper.encoder import layer_norm
from segma_tpu_torch.utils.encoders import MultiLabelEncoder


def mel_spaced_edges(n_filters: int, sr: int) -> tuple[np.ndarray, np.ndarray]:
    """Initial (low_hz, band_hz) on a mel-spaced grid over [30, sr/2 - 100]."""
    lo_mel = 2595.0 * np.log10(1.0 + 30.0 / 700.0)
    hi_mel = 2595.0 * np.log10(1.0 + (sr / 2 - 100.0) / 700.0)
    mel = np.linspace(lo_mel, hi_mel, n_filters + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


class SincConv(nn.Module):
    """Parametrised sinc band-pass filter bank (SincNet): (B, T) -> (B, T', F)."""

    def __init__(self, filters: int = 80, kernel_size: int = 251, stride: int = 10,
                 sample_rate: int = 16_000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.sample_rate = kernel_size, stride, sample_rate
        self.min_low_hz, self.min_band_hz, self.dtype = min_low_hz, min_band_hz, dtype
        low, band = mel_spaced_edges(filters, sample_rate)
        self.low_hz = nn.Parameter(torch.from_numpy(low))
        self.band_hz = nn.Parameter(torch.from_numpy(band))

    def bank(self) -> torch.Tensor:
        """(F, K) f32 impulse responses: ideal band-pass, Hamming-windowed,
        each divided by twice its band width (unit peak response)."""
        sr, k = self.sample_rate, self.kernel_size
        dev = self.low_hz.device
        f1 = self.min_low_hz + torch.abs(self.low_hz)
        f2 = torch.minimum(f1 + self.min_band_hz + torch.abs(self.band_hz),
                           torch.full((), sr / 2.0, device=dev))
        half = (k - 1) // 2
        t = torch.arange(-half, half + 1, dtype=torch.float32, device=dev) / sr

        def low_pass(f: torch.Tensor) -> torch.Tensor:
            return 2.0 * f[:, None] * torch.sinc(2.0 * f[:, None] * t[None, :])

        n = torch.arange(k, dtype=torch.float32, device=dev)
        window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (k - 1))
        bank = (low_pass(f2) - low_pass(f1)) * window[None, :]
        return bank / (2.0 * (f2 - f1))[:, None]

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        half = (self.kernel_size - 1) // 2
        out = F.conv1d(wav[:, None, :].to(self.dtype), self.bank()[:, None, :].to(self.dtype),
                       stride=self.stride, padding=half)
        return out.transpose(1, 2)


class SincNetModule(nn.Module):
    """(B, T) waveform -> (B, n_windows, n_labels) logits."""

    def __init__(self, n_labels: int, n_windows: int, filters: int = 80,
                 kernel_size: int = 251, stride: int = 10, hidden: int = 128,
                 lstm: LSTMConfig | None = None, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.n_windows = n_windows
        self.dtype = dtype
        self.sinc = SincConv(filters=filters, kernel_size=kernel_size, stride=stride,
                             dtype=dtype)
        self.LayerNorm_0 = nn.LayerNorm(filters, eps=FLAX_LN_EPS)
        self.conv1 = nn.Conv1d(filters, hidden, 5, stride=4, padding=2)
        self.LayerNorm_1 = nn.LayerNorm(hidden, eps=FLAX_LN_EPS)
        self.conv2 = nn.Conv1d(hidden, hidden, 5, stride=2, padding=2)
        self.LayerNorm_2 = nn.LayerNorm(hidden, eps=FLAX_LN_EPS)
        width = hidden
        self.lstm_shared = None
        if lstm is not None:
            self.lstm_shared = BiLSTM(hidden, lstm)
            width = self.lstm_shared.out_features
        self.heads = HydraHeads(width, n_labels)

    def forward(self, wav: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train=True`` applies the BiLSTM's dropout with masks from
        ``generator``."""
        with ieee_f32(self.dtype):
            x = self.sinc(wav)
            x = torch.log1p(torch.abs(x.float())).to(self.dtype)  # compressed energies
            x = layer_norm(x, self.LayerNorm_0).transpose(1, 2)
            x = F.max_pool1d(x, 4, 4)
            x = gelu(_conv(x, self.conv1)).transpose(1, 2)
            x = layer_norm(x, self.LayerNorm_1).transpose(1, 2)
            x = gelu(_conv(x, self.conv2)).transpose(1, 2)
            x = layer_norm(x, self.LayerNorm_2)
            if self.lstm_shared is not None:
                x = self.lstm_shared(x, keep=self.n_windows, train=train, generator=generator)
            return self.heads(x)[:, : self.n_windows].float()


def build_sincnet_hydra(label_encoder: MultiLabelEncoder, config: Config,
                        device: str | torch.device | None = "cuda",
                        generator: torch.Generator | None = None) -> SegmentationModel:
    """``sincnet_hydra`` with random weights from ``generator`` (seed 0 when
    None) on ``device``; the filter edges start on the mel-spaced grid."""
    dev = resolve_device(device)
    mc = config.model.config
    if not isinstance(mc, SincNetHydraConfig):
        mc = SincNetHydraConfig()
    lstm = mc.lstm or LSTMConfig(hidden_size=128, num_layers=2, bidirectional=True, dropout=0.0)
    if mc.kernel_size % 2 == 0:
        raise ValueError(f"sincnet_hydra kernel_size must be odd, got {mc.kernel_size}")
    # sinc (k, s) -> pool (4, 4, VALID) -> conv (5, 4) -> conv (5, 2): the
    # paddings are the left pads the module applies
    conv_settings = ConvolutionSettings(
        kernels=(mc.kernel_size, 4, 5, 5),
        strides=(mc.stride, 4, 4, 2),
        paddings=(mc.kernel_size // 2, 0, 2, 2),
    )
    n_windows = conv_settings.n_windows(
        config.audio.chunk_duration_f, strict=config.audio.strict_frames
    )
    module = SincNetModule(
        n_labels=len(label_encoder.base_labels), n_windows=n_windows, filters=mc.filters,
        kernel_size=mc.kernel_size, stride=mc.stride, hidden=mc.hidden, lstm=lstm,
        dtype=torch.float32 if mc.dtype == "f32" else torch.bfloat16,
    )
    init_random_(module, generator or torch.Generator().manual_seed(0))
    module.to(dev)
    return SegmentationModel(
        name="sincnet_hydra",
        module=module,
        conv_settings=conv_settings,
        label_encoder=label_encoder,
        config=config,
        device=dev,
        class_weights=config.train.class_weights,
    )
