"""Whisper encoder and the Whisper-based segmentation models."""

from segma_tpu_torch.models.whisper.builders import build_whisper_model

__all__ = ["build_whisper_model"]
