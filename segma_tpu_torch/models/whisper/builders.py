"""Whisper-based segmentation models (counterpart of
``segma_tpu/models/whisper/builders.py``).

Of the five variants only ``surgical_hydra`` is ported: weighted tap over
every encoder layer, BiLSTM, per-label hydra heads, truncation to the chunk's
``n_windows`` after the LSTM. The log-mel frontend and the 30 s padding run
on the device (``ops.melspec.whisper_input_features``).
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch
from torch import nn

from segma_tpu_torch import resolve_device
from segma_tpu_torch.config import Config, LSTMConfig
from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel
from segma_tpu_torch.models.layers import BiLSTM, HydraHeads, LayerWeightedSum
from segma_tpu_torch.models.whisper.encoder import WhisperEncoder, WhisperEncoderConfig
from segma_tpu_torch.ops.melspec import whisper_input_features
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

WHISPER_CONV_SETTINGS = ConvolutionSettings(
    kernels=(400, 3, 3), strides=(160, 1, 2), paddings=(200, 1, 1)
)

VARIANTS = {
    # name: (tap, mixer, head, truncation)
    "whisperidou": ("last", None, "mlp", "after_head"),
    "whisperimax": ("last", "lstm", "mlp_stack", "before_lstm"),
    "surgical_whisper": ("weighted", None, "mlp", "after_head"),
    "hydra_whisper": ("last", "lstm", "hydra", "before_lstm"),
    "surgical_hydra": ("weighted", "lstm", "hydra", "after_lstm"),
}
PORTED_VARIANTS = ("surgical_hydra",)


class WhisperSegModule(nn.Module):
    """(B, T) waveform -> (B, n_windows, n_labels) logits (``surgical_hydra``)."""

    def __init__(
        self,
        enc_cfg: WhisperEncoderConfig,
        n_labels: int,
        n_windows: int,
        lstm: LSTMConfig,
        reduction: str = "weighted",
        encoder_layers: tuple[int, ...] = (),
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.enc_cfg = enc_cfg
        self.n_windows = n_windows
        # 1-indexed layer picks; () = every layer
        self.picks = (
            sorted(i - 1 for i in encoder_layers)
            if encoder_layers
            else list(range(enc_cfg.n_layers))
        )
        self.encoder = WhisperEncoder(enc_cfg, dtype)
        self.layer_mix = LayerWeightedSum(len(self.picks), reduction)
        self.lstm_shared = BiLSTM(enc_cfg.d_model, lstm)
        self.heads = HydraHeads(self.lstm_shared.out_features, n_labels)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        feats = whisper_input_features(wav)  # (B, 80, 3000)
        _, hidden = self.encoder(feats, output_hidden_states=True)
        layer_outputs = hidden[1:]  # per-layer outputs, HF indexing
        x = self.layer_mix(torch.stack([layer_outputs[i] for i in self.picks]))
        # truncation after the LSTM: it runs over the padded 1500 frames
        x = self.lstm_shared(x, keep=self.n_windows)
        return self.heads(x).float()


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (on the CPU, so every device gets the
    same numbers): linear and conv weights N(0, 1/fan_in), zero biases, LSTM
    weights uniform in +-1/sqrt(hidden). LayerNorm, the position table and the
    layer weights keep their constructed values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in**-0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LSTM):
                bound = m.hidden_size**-0.5
                for p in m.parameters():
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    return module


def _encoder_cfg_for(encoder_path: str) -> WhisperEncoderConfig:
    """Name-based encoder size; a snapshot directory cannot be loaded yet."""
    if (Path(encoder_path) / "config.json").exists():
        raise NotImplementedError(
            f"loading the Whisper snapshot {encoder_path!r} is not ported yet"
        )
    warnings.warn(
        f"whisper snapshot {encoder_path!r} not found — encoder randomly "
        "initialized (fine for tests and timing, wrong for real predictions)",
        stacklevel=3,
    )
    if "tiny" in encoder_path:
        return WhisperEncoderConfig.tiny()
    return WhisperEncoderConfig.base()


def build_whisper_model(
    name: str,
    label_encoder: MultiLabelEncoder,
    config: Config,
    device: str | torch.device | None = "cuda",
    generator: torch.Generator | None = None,
    enc_cfg: WhisperEncoderConfig | None = None,
) -> SegmentationModel:
    """Build ``name`` with random weights from ``generator`` (seed 0 when
    None) on ``device``. ``enc_cfg`` overrides the name-based encoder size."""
    if name not in VARIANTS:
        raise KeyError(f"unknown whisper variant {name!r}")
    if name not in PORTED_VARIANTS:
        raise NotImplementedError(f"whisper variant {name!r} is not ported yet")
    dev = resolve_device(device)
    mc = config.model.config
    if mc.fast_context:
        raise NotImplementedError("fast_context is not ported yet")
    enc_cfg = enc_cfg or _encoder_cfg_for(mc.encoder)
    n_windows = WHISPER_CONV_SETTINGS.n_windows(
        config.audio.chunk_duration_f, strict=config.audio.strict_frames
    )
    dtype = torch.float32 if config.train.precision == "f32" else torch.bfloat16
    module = WhisperSegModule(
        enc_cfg=enc_cfg,
        n_labels=len(label_encoder.base_labels),
        n_windows=n_windows,
        lstm=mc.lstm,
        reduction=mc.reduction,
        encoder_layers=tuple(mc.encoder_layers or ()),
        dtype=dtype,
    )
    init_random_(module, generator or torch.Generator().manual_seed(0))
    module.to(dev).eval()
    return SegmentationModel(
        name=name,
        module=module,
        conv_settings=WHISPER_CONV_SETTINGS,
        label_encoder=label_encoder,
        config=config,
        device=dev,
    )
