"""Model wrapper: module + receptive-field geometry + objective
(counterpart of ``segma_tpu/models/base.py``).

- hydra models: per-head binary cross-entropy with logits, mean over
  (batch x windows) rows, summed over heads;
- multiclass models: softmax cross-entropy against the multi-hot target
  rows, class weights multiplying the targets, mean over rows. As in the
  JAX package, on raw logits: the reference applies ``cross_entropy`` to
  outputs it has already softmaxed, which the JAX package documents as a
  deviation and the port does not copy;
- powerset models: the module's outputs are subset-class logits; the
  multi-hot targets map to class ids through the encoder's bitmask table,
  and the loss is softmax cross-entropy against their one-hot, the mean
  over rows; ``inference_transform`` marginalises the subset
  probabilities back to per-label logits for decode.

Frozen parameters (top-level submodules named in ``frozen_prefixes``) take
no gradient and are left out of the optimizer, the role of ``optax.masked``
over ``trainable_mask``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, ContextManager, Sequence

import numpy as np
import torch
from torch import nn

from segma_tpu_torch import no_tf32
from segma_tpu_torch.config import Config
from segma_tpu_torch.geometry import ConvolutionSettings
from segma_tpu_torch.ops import cached_constant
from segma_tpu_torch.utils.encoders import MultiLabelEncoder, PowersetEncoder

__all__ = [
    "ConvolutionSettings", "SegmentationModel", "bce_with_logits", "hydra_loss", "ieee_f32",
    "no_tf32",
    "softmax_ce_loss", "softmax_ce_loss_per_class", "weighted_index_ce",
]
LOSS_TYPES = ("hydra", "multiclass", "powerset")


def ieee_f32(dtype: torch.dtype) -> ContextManager:
    """For a model that computes in f32: its whole forward (the conv stems,
    HuBERT's positional conv, the GEMMs, the LSTM) and its backward under
    ``no_tf32``. Other dtypes: no change (their f32 parts scope themselves)."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    return no_tf32()


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


def weighted_index_ce(
    logits: torch.Tensor, class_ids: torch.Tensor, class_weights: torch.Tensor
) -> torch.Tensor:
    """Softmax CE of (N, C) logits against class ids, each row weighted by its
    class's weight and the sum over ``max(sum of the rows' weights, 1)``, as
    ``cross_entropy(weight=w, reduction='mean')`` normalises; 0 when no
    row's class carries weight. Backs the powerset ``partial_loss``."""
    logp = torch.log_softmax(logits, dim=-1)
    row_nll = -logp.gather(1, class_ids[:, None])[:, 0]
    row_w = class_weights[class_ids]
    return (row_w * row_nll).sum() / torch.clamp(row_w.sum(), min=1.0)


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
    # hydra (per-label BCE) | multiclass (softmax CE) | powerset (subset CE)
    loss_type: str = "hydra"
    # powerset models: the encoder of the subset classes the module outputs
    powerset: PowersetEncoder | None = None

    def __post_init__(self) -> None:
        if self.loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type must be one of {LOSS_TYPES}, got {self.loss_type!r}")
        if (self.loss_type == "powerset") != (self.powerset is not None):
            raise ValueError("loss_type 'powerset' goes with a PowersetEncoder, and only it")
        self._on_device: dict[tuple[str, torch.device], torch.Tensor] = {}
        for name, p in self.module.named_parameters():
            if name.split(".")[0] in self.frozen_prefixes:
                p.requires_grad_(False)

    @property
    def n_labels(self) -> int:
        return len(self.label_encoder.base_labels)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The module's compute dtype."""
        return self.module.dtype

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
        ``targets`` are (B, T, n_labels) multi-hot.

        Powerset: the total is the subset CE; ``per_label`` is a diagnostic,
        the BCE of the marginalised logits (``inference_transform``) against
        the targets, which the subset CE has no decomposition into."""
        if self.loss_type == "powerset":
            onehot = (self.subset_ids(targets)[..., None] == self._table(
                "classes", logits.device, lambda: np.arange(len(self.powerset)))).float()
            total = softmax_ce_loss(logits, onehot)
            elt = bce_with_logits(self.inference_transform(logits), targets)
            return total, elt.reshape(-1, elt.shape[-1]).mean(0)
        weights = None if self.class_weights is None else self._weights(logits.device)
        if self.loss_type == "hydra":
            return hydra_loss(logits, targets, weights)
        return softmax_ce_loss_per_class(logits, targets, weights)

    def _table(self, name: str, device: torch.device, make: Callable[[], Any]) -> torch.Tensor:
        """The constant ``make()`` on ``device``, copied there once: a
        training step captured in a CUDA graph may copy nothing from the
        host."""
        return cached_constant(self._on_device, (name, torch.device(device)),
                               lambda: torch.as_tensor(make(), device=device))

    def _weights(self, device: torch.device) -> torch.Tensor:
        return self._table("class_weights", device,
                           lambda: np.asarray(self.class_weights, np.float32))

    def subset_ids(self, targets: torch.Tensor) -> torch.Tensor:
        """Powerset: (..., n_labels) multi-hot -> (...) int64 subset class
        ids: the bitmask of the active labels through the encoder's table."""
        n = targets.shape[-1]
        bits = self._table("bits", targets.device, lambda: 2 ** np.arange(n, dtype=np.int64))
        lut = self._table("lut", targets.device,
                          lambda: self.powerset.multihot_lut().astype(np.int64))
        return lut[((targets > 0.5).long() * bits).sum(-1)]

    def single_class_weights(self, device: torch.device) -> torch.Tensor:
        """Powerset: (n_classes,) f32, 1 on the classes of fewer than two
        labels (``partial_loss``'s weights), 0 elsewhere."""
        return self._table("single", device, lambda: np.asarray(
            [1.0 if len(s) < 2 else 0.0 for s in self.powerset.labels], np.float32))

    def inference_transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Raw module outputs -> per-label logits: the identity for hydra and
        multiclass heads. Powerset: the subset softmax times the membership
        matrix (a label's probability is the sum over the subsets holding
        it), clipped to [1e-7, 1 - 1e-7] and taken back to logits."""
        if self.powerset is None:
            return logits
        member = self._table("membership", logits.device, self.powerset.membership_matrix)
        with no_tf32():
            marg = torch.clamp(torch.softmax(logits, dim=-1) @ member, 1e-7, 1 - 1e-7)
        return torch.log(marg) - torch.log1p(-marg)
