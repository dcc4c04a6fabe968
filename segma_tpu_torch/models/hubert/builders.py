"""``surgical_hubert_hydra``: HuBERT encoder + layer-weighted sum + hydra
heads on raw waveforms (counterpart of ``segma_tpu/models/hubert/builders.py``).

- the CNN feature extractor is always frozen: it runs under
  ``torch.no_grad()`` and its parameters take no gradient; the transformer
  trains unless ``freeze_encoder`` is set;
- the weighted reduction runs over the configured layers (every layer by
  default), then dropout 0.5 in training only, then fused hydra heads in f32;
- ``train.remat`` recomputes each transformer layer in the backward pass.

Frame geometry: conv stack (10,3,3,3,3,2,2)/(5,2,2,2,2,2,2) -> rf_step 320,
199 frames per 4 s chunk (strict). When ``model.config.wav_encoder`` exists
(an HF snapshot directory or a torchaudio checkpoint file), the front end and
the transformer are its weights (``hubert/convert.py``); without one they are
random, as in the JAX package.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch
from torch import nn

from segma_tpu_torch import resolve_device, telemetry
from segma_tpu_torch.config import Config
from segma_tpu_torch.convert import load_flax_subtrees
from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel, ieee_f32
from segma_tpu_torch.models.hubert.convert import convert_hubert_params, read_hubert_config
from segma_tpu_torch.models.hubert.encoder import (
    FeatureExtractor,
    HubertEncoderConfig,
    HubertTransformer,
)
from segma_tpu_torch.models.layers import HydraHeads, LayerWeightedSum, dropout
from segma_tpu_torch.models.whisper.builders import init_random_
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

HUBERT_CONV_SETTINGS = ConvolutionSettings(
    kernels=(10, 3, 3, 3, 3, 2, 2),
    strides=(5, 2, 2, 2, 2, 2, 2),
    paddings=(0, 0, 0, 0, 0, 0, 0),
)


class HubertSegModule(nn.Module):
    """(B, T) waveform -> (B, frames, n_labels) logits. A subclass swaps the
    transformer (``transformer_cls``): WavLM's."""

    transformer_cls = HubertTransformer

    def __init__(
        self,
        enc_cfg: HubertEncoderConfig,
        n_labels: int,
        reduction: str = "weighted",
        encoder_layers: tuple[int, ...] = (),
        freeze_encoder: bool = False,
        dropout: float = 0.5,
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
    ) -> None:
        super().__init__()
        self.enc_cfg = enc_cfg
        self.freeze_encoder = freeze_encoder
        self.dropout = dropout
        # 1-indexed layer picks; () = every layer
        self.picks = (
            sorted(i - 1 for i in encoder_layers)
            if encoder_layers
            else list(range(enc_cfg.n_layers))
        )
        self.feature_extractor = FeatureExtractor(enc_cfg, dtype)
        self.dtype = dtype
        self.encoder = self.transformer_cls(enc_cfg, dtype, remat=remat)
        self.layer_mix = LayerWeightedSum(len(self.picks), reduction)
        self.heads = HydraHeads(enc_cfg.hidden_size, n_labels)

    def forward(
        self, wav: torch.Tensor, train: bool = False, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``train=True`` applies dropout with masks from ``generator``."""
        with ieee_f32(self.encoder.dtype):
            with telemetry.span("model.encoder"):
                with torch.no_grad():  # the CNN front end is always frozen
                    feats = self.feature_extractor(wav)
                _, hidden = self.encoder(feats, output_hidden_states=True)
                layer_outputs = hidden[1:]
                stacked = torch.stack([layer_outputs[i] for i in self.picks])
                if self.freeze_encoder:
                    stacked = stacked.detach()
                x = self.layer_mix(stacked)
            if train and self.dropout > 0:
                if generator is None:
                    raise ValueError("training with dropout needs a torch.Generator")
                x = dropout(x, self.dropout, generator)
            with telemetry.span("model.heads"):
                return self.heads(x).float()


def build_hubert_model(
    name: str,
    label_encoder: MultiLabelEncoder,
    config: Config,
    device: str | torch.device | None = "cuda",
    generator: torch.Generator | None = None,
    enc_cfg: HubertEncoderConfig | None = None,
) -> SegmentationModel:
    """Build ``surgical_hubert_hydra`` with random weights from ``generator``
    (seed 0 when None) on ``device``, the encoder's replaced by the snapshot
    at ``model.config.wav_encoder`` when it exists. ``enc_cfg`` overrides the
    encoder's size (HuBERT-base, or the snapshot's)."""
    if name != "surgical_hubert_hydra":
        raise KeyError(f"unknown hubert variant {name!r}")
    dev = resolve_device(device)
    mc = config.model.config
    snapshot = Path(mc.wav_encoder)
    if not snapshot.exists():
        warnings.warn(
            f"hubert snapshot {mc.wav_encoder!r} not found — encoder randomly "
            "initialized (fine for tests and timing, wrong for real training)",
            stacklevel=3,
        )
    if enc_cfg is None:
        enc_cfg = read_hubert_config(snapshot) if snapshot.exists() else HubertEncoderConfig.base()
    dtype = torch.float32 if config.train.precision == "f32" else torch.bfloat16
    module = HubertSegModule(
        enc_cfg=enc_cfg,
        n_labels=len(label_encoder.base_labels),
        reduction=mc.reduction,
        encoder_layers=tuple(mc.encoder_layers or ()),
        freeze_encoder=mc.freeze_encoder,
        dtype=dtype,
        remat=config.train.remat,
    )
    init_random_(module, generator or torch.Generator().manual_seed(0))
    if snapshot.exists():
        _, fe, tr = convert_hubert_params(snapshot)
        load_flax_subtrees(module, {"feature_extractor": fe, "encoder": tr})
    module.to(dev)
    frozen = ("feature_extractor",) + (("encoder",) if mc.freeze_encoder else ())
    return SegmentationModel(
        name=name,
        module=module,
        conv_settings=HUBERT_CONV_SETTINGS,
        label_encoder=label_encoder,
        config=config,
        device=dev,
        frozen_prefixes=frozen,
        class_weights=config.train.class_weights,
    )
