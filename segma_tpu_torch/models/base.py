"""Model wrapper: module + receptive-field geometry + objective
(counterpart of ``segma_tpu/models/base.py``).

- hydra models: per-head binary cross-entropy with logits, mean over
  (batch x windows) rows, summed over heads;
- multiclass models: softmax cross-entropy against the multi-hot target
  rows, class weights multiplying the targets, mean over rows. As in the
  JAX package, on raw logits: the reference applies ``cross_entropy`` to
  outputs it has already softmaxed, which the JAX package documents as a
  deviation and the port does not copy;
- powerset models wait for ``powerset_vad``, which is not ported.

Frozen parameters (top-level submodules named in ``frozen_prefixes``) take
no gradient and are left out of the optimizer, the role of ``optax.masked``
over ``trainable_mask``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import ContextManager, Sequence

import torch
from torch import nn

from segma_tpu_torch.config import Config
from segma_tpu_torch.models.geometry import ConvolutionSettings
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

__all__ = [
    "ConvolutionSettings", "SegmentationModel", "bce_with_logits", "hydra_loss", "ieee_f32",
    "softmax_ce_loss", "softmax_ce_loss_per_class",
]
LOSS_TYPES = ("hydra", "multiclass", "powerset")


def ieee_f32(dtype: torch.dtype) -> ContextManager:
    """For a model that computes in f32: cuDNN (the conv stems, HuBERT's
    positional conv, the LSTM) without TF32 while the context is open, the
    caller's flags restored on exit. PyTorch's default lets cuDNN take TF32
    for f32 inputs (``torch.backends.cudnn.allow_tf32``); f32 matmuls
    already run in IEEE f32 by default. Other dtypes: no change."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise numerically-stable binary cross-entropy with logits.

    At logits exactly 0 (zero-bias heads on all-zero features) the gradient
    takes JAX's subgradients, max: 1/2 to each side and |x|: 1, so it is
    ``-targets`` as in the reference; torch's clamp and abs would give
    ``1 - targets``."""
    magnitude = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-magnitude)))


def hydra_loss(
    logits: torch.Tensor, targets: torch.Tensor, class_weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(total, per_label): per-label BCE means over all rows, optionally
    weighted per label, summed across labels."""
    elt = bce_with_logits(logits, targets)
    per_label = elt.reshape(-1, elt.shape[-1]).mean(0)
    if class_weights is not None:
        per_label = per_label * class_weights
    return per_label.sum(), per_label


def softmax_ce_loss(
    logits: torch.Tensor, targets: torch.Tensor, class_weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Softmax cross-entropy against (possibly multi-hot) target rows,
    normalized like ``torch.nn.functional.cross_entropy`` with probabilistic
    targets and optional per-class weights."""
    return softmax_ce_loss_per_class(logits, targets, class_weights)[0]


def softmax_ce_loss_per_class(
    logits: torch.Tensor, targets: torch.Tensor, class_weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(total, per_class) softmax CE; the per-class terms sum to the total:
    each class's summed -t*log p over the number of rows (a mean over rows,
    not over target mass, which would scale with the batch's activity)."""
    logp = torch.log_softmax(logits, dim=-1)
    flat_lp = logp.reshape(-1, logp.shape[-1])
    flat_t = targets.reshape(-1, targets.shape[-1])
    if class_weights is not None:
        flat_t = flat_t * class_weights[None, :]
    per_class = -(flat_t * flat_lp).sum(0) / flat_lp.shape[0]
    return per_class.sum(), per_class


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
    frozen_prefixes: tuple[str, ...] = ()
    class_weights: Sequence[float] | None = None
    loss_type: str = "hydra"  # hydra (per-label BCE) | multiclass (softmax CE)

    def __post_init__(self) -> None:
        if self.loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type must be one of {LOSS_TYPES}, got {self.loss_type!r}")
        for name, p in self.module.named_parameters():
            if name.split(".")[0] in self.frozen_prefixes:
                p.requires_grad_(False)

    @property
    def n_labels(self) -> int:
        return len(self.label_encoder.base_labels)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The encoder's compute dtype (``train.precision``)."""
        return self.module.encoder.dtype

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

    def trainable_parameters(self) -> list[nn.Parameter]:
        """Parameters the optimizer updates (outside ``frozen_prefixes``)."""
        return [p for p in self.module.parameters() if p.requires_grad]

    def split_state(self) -> tuple[dict, dict]:
        """(trainable, frozen) ``state_dict`` entries by top-level prefix."""
        state = self.module.state_dict()
        frozen = {k: v for k, v in state.items() if k.split(".")[0] in self.frozen_prefixes}
        return {k: v for k, v in state.items() if k not in frozen}, frozen

    def apply(self, wav: torch.Tensor) -> torch.Tensor:
        """Forward pass: (B, T) waveforms -> (B, n_windows, n_labels) logits."""
        with torch.inference_mode():
            return self.module(wav)

    def loss(
        self, logits: torch.Tensor, targets: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(total, per_label) training loss for this model's objective;
        ``targets`` are (B, T, n_labels) multi-hot."""
        if self.loss_type == "powerset":
            raise NotImplementedError(
                "the powerset loss is not ported: it waits for the powerset_vad model"
            )
        weights = (
            None if self.class_weights is None
            else torch.as_tensor(self.class_weights, dtype=torch.float32, device=logits.device)
        )
        if self.loss_type == "hydra":
            return hydra_loss(logits, targets, weights)
        return softmax_ce_loss_per_class(logits, targets, weights)

    def inference_transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Raw module outputs -> per-label logits: the identity for hydra and
        multiclass heads."""
        return logits
