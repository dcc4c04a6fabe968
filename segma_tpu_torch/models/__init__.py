"""Model registry (counterpart of ``segma_tpu/models/__init__.py``).

Builders take ``(label_encoder, config, device="cuda", generator=None)``
and return a ``SegmentationModel`` with random weights drawn from
``generator``. Only ``surgical_hydra`` is ported.
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


class _Registry(dict):
    """Model registry with a helpful unknown-name error."""

    def __missing__(self, name: str):
        raise KeyError(
            f"unknown or unported model {name!r}; ported models: "
            + ", ".join(sorted(self))
        )


Models: dict[str, ModelBuilder] = _Registry({
    "surgical_hydra": _lazy_whisper("surgical_hydra"),
})

__all__ = ["ConvolutionSettings", "Models", "SegmentationModel"]
