"""Model wrapper: module + receptive-field geometry (the inference half of
``segma_tpu/models/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from segma_tpu_torch.config import Config
from segma_tpu_torch.models.geometry import ConvolutionSettings
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

__all__ = ["ConvolutionSettings", "SegmentationModel"]


@dataclass
class SegmentationModel:
    """A segmentation model: a module mapping (B, T) f32 waveforms to
    (B, n_windows, n_labels) f32 logits, plus the geometry that links its
    frames to samples. The module holds its weights and lives on
    ``device``."""

    name: str
    module: nn.Module
    conv_settings: ConvolutionSettings
    label_encoder: MultiLabelEncoder
    config: Config
    device: torch.device

    @property
    def n_labels(self) -> int:
        return len(self.label_encoder.base_labels)

    @property
    def n_windows(self) -> int:
        return self.conv_settings.n_windows(
            self.config.audio.chunk_duration_f,
            strict=self.config.audio.strict_frames,
        )

    def to(self, device: torch.device) -> "SegmentationModel":
        """Move the module's weights to ``device`` (in place)."""
        self.module.to(device)
        self.device = torch.device(device)
        return self

    def apply(self, wav: torch.Tensor) -> torch.Tensor:
        """Forward pass: (B, T) waveforms -> (B, n_windows, n_labels) logits."""
        with torch.inference_mode():
            return self.module(wav)

    def inference_transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Raw module outputs -> per-label logits: the identity for hydra heads."""
        return logits
