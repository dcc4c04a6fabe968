"""Model registry (counterpart of ``segma_tpu/models/__init__.py``).

Builders take ``(label_encoder, config, device="cuda", generator=None)``
and return a ``SegmentationModel`` with random weights drawn from
``generator``. Ported: the five Whisper variants (``whisperidou``,
``whisperimax``, ``surgical_whisper``, ``hydra_whisper``,
``surgical_hydra``) and ``surgical_hubert_hydra``, the six models of the
reference, each served and trained.
"""

from __future__ import annotations

from typing import Callable

from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel

ModelBuilder = Callable[..., SegmentationModel]


def _lazy_whisper(name: str) -> ModelBuilder:
    def build(label_encoder, config, device="cuda", generator=None, **kwargs):
        from segma_tpu_torch.models.whisper import build_whisper_model

        return build_whisper_model(
            name, label_encoder, config, device=device, generator=generator, **kwargs
        )

    return build


def _lazy_hubert(name: str) -> ModelBuilder:
    def build(label_encoder, config, device="cuda", generator=None, **kwargs):
        from segma_tpu_torch.models.hubert import build_hubert_model

        return build_hubert_model(
            name, label_encoder, config, device=device, generator=generator, **kwargs
        )

    return build


class _Registry(dict):
    """Model registry with a helpful unknown-name error."""

    def __missing__(self, name: str):
        raise KeyError(
            f"unknown or unported model {name!r}; ported models: "
            + ", ".join(sorted(self))
        )


Models: dict[str, ModelBuilder] = _Registry({
    **{name: _lazy_whisper(name) for name in (
        "whisperidou", "whisperimax", "surgical_whisper", "hydra_whisper", "surgical_hydra")},
    "surgical_hubert_hydra": _lazy_hubert("surgical_hubert_hydra"),
})

__all__ = ["ConvolutionSettings", "Models", "SegmentationModel"]
