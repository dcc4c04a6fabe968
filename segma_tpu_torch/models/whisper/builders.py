"""Whisper-based segmentation models (counterpart of
``segma_tpu/models/whisper/builders.py``): the five variants as one
composable module over the JAX module's axes, the layer tap (last |
weighted), the mixer (none | BiLSTM), the head (mlp | mlp_stack | hydra)
and the point where the frames are truncated to the chunk's ``n_windows``
(after the head | before the LSTM | after the LSTM; observable through the
bidirectional LSTM).

The log-mel frontend and the 30 s padding run on the device
(``ops.melspec.whisper_input_features``); with ``fast_context`` the encoder
runs on the log-mel of the chunk itself, its position table sliced to the
chunk's frames. The encoder is frozen: it runs without autograd, JAX's
``stop_gradient``. When ``model.config.encoder`` is a Whisper snapshot
directory (config.json and model.safetensors or ``*.bin``), the encoder is
that snapshot's (``whisper/convert.py``); otherwise it is random, sized by
the name.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch
from torch import nn

from segma_tpu_torch import resolve_device
from segma_tpu_torch.config import Config, LSTMConfig
from segma_tpu_torch.convert import load_flax_subtrees
from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel, ieee_f32
from segma_tpu_torch.models.layers import BiLSTM, HydraHeads, LayerWeightedSum, MLPHead, linear
from segma_tpu_torch.models.whisper.encoder import WhisperEncoder, WhisperEncoderConfig
from segma_tpu_torch.ops.melspec import log_mel_spectrogram, whisper_input_features
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
MLP_STACK_WIDTH = 128  # whisperimax: Linear(128) + LeakyReLU, twice


class WhisperSegModule(nn.Module):
    """(B, T) waveform -> (B, n_windows, n_labels) logits.

    Submodules carry the flax scope names, so the weight bridge and the
    optimizer tree see the JAX tree: ``encoder``, ``layer_mix`` (weighted
    tap), ``lstm_shared``, and ``heads`` (hydra), ``classifier`` (an
    ``MLPHead``) or ``linear_0``, ``linear_1`` and ``classifier``
    (whisperimax's stack: the linears compute in ``dtype``, the classifier
    in f32)."""

    def __init__(
        self,
        enc_cfg: WhisperEncoderConfig,
        n_labels: int,
        n_windows: int,
        variant: str,
        lstm: LSTMConfig | None = None,
        reduction: str = "weighted",
        encoder_layers: tuple[int, ...] = (),
        classifier_hidden: int = 256,
        fast_context: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.enc_cfg = enc_cfg
        self.n_windows = n_windows
        self.variant = variant
        self.fast_context = fast_context
        self.tap, self.mixer, self.head, self.trunc = VARIANTS[variant]
        self.encoder = WhisperEncoder(enc_cfg, dtype)
        if self.tap == "weighted":
            # 1-indexed layer picks; () = every layer
            self.picks = (
                sorted(i - 1 for i in encoder_layers)
                if encoder_layers
                else list(range(enc_cfg.n_layers))
            )
            self.layer_mix = LayerWeightedSum(len(self.picks), reduction)
        width = enc_cfg.d_model
        if self.mixer == "lstm":
            if lstm is None:
                raise ValueError(f"{variant} needs model.config.lstm")
            self.lstm_shared = BiLSTM(width, lstm)
            width = self.lstm_shared.out_features
        if self.head == "mlp":
            self.classifier = MLPHead(width, (classifier_hidden,), n_labels, dtype)
        elif self.head == "mlp_stack":
            self.linear_0 = nn.Linear(width, MLP_STACK_WIDTH)
            self.linear_1 = nn.Linear(MLP_STACK_WIDTH, MLP_STACK_WIDTH)
            self.classifier = nn.Linear(MLP_STACK_WIDTH, n_labels)
        else:
            self.heads = HydraHeads(width, n_labels)

    def forward(
        self, wav: torch.Tensor, train: bool = False, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``train=True`` applies the BiLSTM's dropout with masks from
        ``generator``."""
        with ieee_f32(self.encoder.dtype):
            with torch.no_grad():  # the frozen encoder: JAX's stop_gradient
                if self.fast_context:
                    feats = log_mel_spectrogram(wav).transpose(1, 2)  # (B, 80, T/160)
                else:
                    feats = whisper_input_features(wav)  # (B, 80, 3000)
                last, hidden = self.encoder(feats, output_hidden_states=self.tap == "weighted")
            if self.tap == "weighted":
                layer_outputs = hidden[1:]  # per-layer outputs, HF indexing
                x = self.layer_mix(torch.stack([layer_outputs[i] for i in self.picks]))
            else:
                x = last
            if self.trunc == "before_lstm":
                x = x[:, : self.n_windows]
            if self.mixer == "lstm":
                keep = self.n_windows if self.trunc == "after_lstm" else None
                x = self.lstm_shared(x, keep=keep, train=train, generator=generator)
            if self.head == "mlp":
                logits = self.classifier(x)
            elif self.head == "mlp_stack":
                h = x.to(self.encoder.dtype)
                for layer in (self.linear_0, self.linear_1):
                    h = nn.functional.leaky_relu(linear(h, layer))  # slope 0.01, as flax
                logits = self.classifier(h.float())
            else:
                logits = self.heads(x)
            if self.trunc == "after_head":
                logits = logits[:, : self.n_windows]
            return logits.float()


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (on the CPU, so every device gets the
    same numbers): linear and conv weights N(0, 1/fan_in), zero biases, LSTM
    weights uniform in +-1/sqrt(hidden), each ``bias_ih`` then added into its
    ``bias_hh`` and left at zero (``BiLSTM``'s one bias). LayerNorm, the
    position table and the layer weights keep their constructed values."""
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
                for name, p in m.named_parameters():
                    if name.startswith("bias_ih"):
                        getattr(m, name.replace("bias_ih", "bias_hh")).add_(p)
                        p.zero_()
    return module


def _encoder_cfg_for(encoder_path: str) -> WhisperEncoderConfig:
    """The snapshot's config when ``encoder_path`` is one; name-based size
    otherwise (with a warning: the encoder will be random)."""
    # imported here: whisper.convert uses hubert.convert, whose package
    # imports this module
    from segma_tpu_torch.models.whisper.convert import read_encoder_config

    if (Path(encoder_path) / "config.json").exists():
        return read_encoder_config(Path(encoder_path))
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
    None) on ``device``, the encoder's replaced by the snapshot at
    ``model.config.encoder`` when there is one. ``enc_cfg`` overrides the
    encoder's size."""
    if name not in VARIANTS:
        raise KeyError(f"unknown whisper variant {name!r}")
    dev = resolve_device(device)
    mc = config.model.config
    enc_cfg = enc_cfg or _encoder_cfg_for(mc.encoder)
    n_windows = WHISPER_CONV_SETTINGS.n_windows(
        config.audio.chunk_duration_f, strict=config.audio.strict_frames
    )
    dtype = torch.float32 if config.train.precision == "f32" else torch.bfloat16
    module = WhisperSegModule(
        enc_cfg=enc_cfg,
        n_labels=len(label_encoder.base_labels),
        n_windows=n_windows,
        variant=name,
        lstm=getattr(mc, "lstm", None),
        reduction=getattr(mc, "reduction", "weighted"),
        encoder_layers=tuple(getattr(mc, "encoder_layers", ()) or ()),
        classifier_hidden=mc.classifier,
        fast_context=mc.fast_context,
        dtype=dtype,
    )
    init_random_(module, generator or torch.Generator().manual_seed(0))
    if (Path(mc.encoder) / "config.json").exists():
        from segma_tpu_torch.models.whisper.convert import convert_encoder_params

        load_flax_subtrees(module, {"encoder": convert_encoder_params(Path(mc.encoder))[1]})
    module.to(dev).eval()
    return SegmentationModel(
        name=name,
        module=module,
        conv_settings=WHISPER_CONV_SETTINGS,
        label_encoder=label_encoder,
        config=config,
        device=dev,
        frozen_prefixes=("encoder",),  # as the JAX builder: the encoder is frozen
        class_weights=config.train.class_weights,
        loss_type="hydra" if VARIANTS[name][2] == "hydra" else "multiclass",
    )
