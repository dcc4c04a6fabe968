"""``surgical_wavlm_hydra``: WavLM encoder + layer-weighted sum + hydra
heads on raw waveforms (counterpart of ``segma_tpu/models/wavlm/builders.py``).

HuBERT's model (``models/hubert/builders.py``) with WavLM's transformer: the
front end always frozen, the transformer trainable unless
``freeze_encoder``, the weighted reduction, dropout 0.5 in training, fused
hydra heads in f32, ``train.remat``. Same frame geometry (rf_step 320).
When ``model.config.wav_encoder`` names an HF ``WavLMModel`` snapshot, the
front end and the transformer are its weights (``wavlm/convert.py``), in the
layout its ``config.json`` gives (WavLM-base's, or WavLM-Large's LayerNorm
front end and pre-LayerNorm layers); without one they are random, as in the
JAX package, and ``enc_cfg`` sets the size and layout.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch

from segma_tpu_torch import resolve_device
from segma_tpu_torch.config import Config
from segma_tpu_torch.convert import load_flax_subtrees
from segma_tpu_torch.models.base import SegmentationModel
from segma_tpu_torch.models.hubert.builders import HUBERT_CONV_SETTINGS, HubertSegModule
from segma_tpu_torch.models.wavlm.convert import convert_wavlm_params, read_wavlm_config
from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig, WavLMTransformer
from segma_tpu_torch.models.whisper.builders import init_random_
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

WAVLM_CONV_SETTINGS = HUBERT_CONV_SETTINGS  # the same conv front end
REL_EMBED_STD = 0.02  # flax's normal(0.02) initialiser of rel_attn_embed


class WavLMSegModule(HubertSegModule):
    """(B, T) waveform -> (B, frames, n_labels) logits."""

    transformer_cls = WavLMTransformer


def build_wavlm_model(
    name: str,
    label_encoder: MultiLabelEncoder,
    config: Config,
    device: str | torch.device | None = "cuda",
    generator: torch.Generator | None = None,
    enc_cfg: WavLMEncoderConfig | None = None,
) -> SegmentationModel:
    """Build ``surgical_wavlm_hydra`` with random weights from ``generator``
    (seed 0 when None) on ``device``, the encoder's replaced by the snapshot
    at ``model.config.wav_encoder`` when it exists. ``enc_cfg`` overrides the
    encoder's size (WavLM-base, or the snapshot's)."""
    if name != "surgical_wavlm_hydra":
        raise KeyError(f"unknown wavlm variant {name!r}")
    dev = resolve_device(device)
    mc = config.model.config
    snapshot = Path(mc.wav_encoder)
    if not snapshot.exists():
        warnings.warn(
            f"wavlm snapshot {mc.wav_encoder!r} not found — encoder randomly "
            "initialized (fine for tests and timing, wrong for real training)",
            stacklevel=3,
        )
    if enc_cfg is None:
        enc_cfg = read_wavlm_config(snapshot) if snapshot.exists() else WavLMEncoderConfig.base()
    module = WavLMSegModule(
        enc_cfg=enc_cfg,
        n_labels=len(label_encoder.base_labels),
        reduction=mc.reduction,
        encoder_layers=tuple(mc.encoder_layers or ()),
        freeze_encoder=mc.freeze_encoder,
        dtype=torch.float32 if config.train.precision == "f32" else torch.bfloat16,
        remat=config.train.remat,
    )
    gen = generator or torch.Generator().manual_seed(0)
    init_random_(module, gen)
    with torch.no_grad():
        embed = module.encoder.layers[0].attention.rel_attn_embed
        embed.copy_(torch.randn(embed.shape, generator=gen) * REL_EMBED_STD)
    if snapshot.exists():
        _, fe, tr = convert_wavlm_params(snapshot)
        load_flax_subtrees(module, {"feature_extractor": fe, "encoder": tr})
    module.to(dev)
    frozen = ("feature_extractor",) + (("encoder",) if mc.freeze_encoder else ())
    return SegmentationModel(
        name=name,
        module=module,
        conv_settings=WAVLM_CONV_SETTINGS,
        label_encoder=label_encoder,
        config=config,
        device=dev,
        frozen_prefixes=frozen,
        class_weights=config.train.class_weights,
    )
