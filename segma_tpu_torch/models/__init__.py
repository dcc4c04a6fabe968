"""Model registry (counterpart of ``segma_tpu/models/__init__.py``).

Builders take ``(label_encoder, config, device="cuda", generator=None)``
and return a ``SegmentationModel`` with random weights drawn from
``generator``. The ten names of the JAX registry, each served and trained:
the reference's six (the five Whisper variants ``whisperidou``,
``whisperimax``, ``surgical_whisper``, ``hydra_whisper``,
``surgical_hydra``, and ``surgical_hubert_hydra``) and the JAX package's
additions, ``surgical_wavlm_hydra`` (WavLM), ``sincnet_hydra`` (a
learnable band-pass front end), ``conv_vad`` and ``powerset_vad``
(subset-softmax heads).
"""

from __future__ import annotations

from typing import Callable

from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel

ModelBuilder = Callable[..., SegmentationModel]


def _lazy(module: str, builder: str, *name: str) -> ModelBuilder:
    """``module.builder([name,] label_encoder, config, ...)``, the module
    imported at the first build."""

    def build(label_encoder, config, device="cuda", generator=None, **kwargs):
        import importlib

        return getattr(importlib.import_module(module), builder)(
            *name, label_encoder, config, device=device, generator=generator, **kwargs)

    return build


class _Registry(dict):
    """Model registry with a helpful unknown-name error."""

    def __missing__(self, name: str):
        raise KeyError(
            f"unknown model {name!r}; registered models: "
            + ", ".join(sorted(self))
        )


Models: dict[str, ModelBuilder] = _Registry({
    **{name: _lazy("segma_tpu_torch.models.whisper", "build_whisper_model", name) for name in (
        "whisperidou", "whisperimax", "surgical_whisper", "hydra_whisper", "surgical_hydra")},
    "surgical_hubert_hydra": _lazy("segma_tpu_torch.models.hubert", "build_hubert_model",
                                   "surgical_hubert_hydra"),
    "surgical_wavlm_hydra": _lazy("segma_tpu_torch.models.wavlm", "build_wavlm_model",
                                  "surgical_wavlm_hydra"),
    "conv_vad": _lazy("segma_tpu_torch.models.vad", "build_conv_vad"),
    "powerset_vad": _lazy("segma_tpu_torch.models.vad", "build_powerset_vad"),
    "sincnet_hydra": _lazy("segma_tpu_torch.models.sincnet", "build_sincnet_hydra"),
})

__all__ = ["ConvolutionSettings", "Models", "SegmentationModel"]
