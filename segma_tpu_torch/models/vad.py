"""``conv_vad`` and ``powerset_vad``: a convolutional model on the log-mel
frame grid (counterpart of ``segma_tpu/models/vad.py``).

The log-mel runs inside the module (``ops.melspec.log_mel_spectrogram``:
the CUDA kernel for a CUDA tensor, the plain version for a CPU one), then
two convs (k3/s1, k3/s2) to one frame per 320 samples, ``depth`` residual
blocks (LayerNorm, a dilated k3 conv with dilation 2**i, a 1x1 conv), a
final LayerNorm and fused hydra heads in f32. ``powerset_vad`` is the same
trunk with one output per subset class of a ``PowersetEncoder``.

Three of flax's defaults are reproduced exactly:

- ``nn.gelu`` is the tanh approximation;
- ``nn.LayerNorm`` has eps 1e-6 (statistics in f32);
- ``padding="SAME"`` pads ``total = max((ceil(n / s) - 1) * s + k_eff - n,
  0)`` as ``(total // 2, total - total // 2)``: the k3/s2 conv on an even
  frame count pads (0, 1), where ``padding=1`` would shift every output
  frame by one input frame (``same_pads``).

Layers keep flax's automatic names (``Conv_0`` ... ``Conv_{2 depth + 1}``,
``LayerNorm_0`` ... ``LayerNorm_{depth}``, ``HydraHeads_0``), so the weight
bridge maps the JAX tree with no renaming. The compute dtype is
``model.config.dtype``; parameters stay f32 and are cast where used.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segma_tpu_torch import resolve_device
from segma_tpu_torch.config import Config, ConvVADConfig
from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel, ieee_f32
from segma_tpu_torch.models.hubert.encoder import _conv
from segma_tpu_torch.models.layers import HydraHeads
from segma_tpu_torch.models.whisper.builders import init_random_
from segma_tpu_torch.models.whisper.encoder import layer_norm
from segma_tpu_torch.ops.melspec import N_MELS, log_mel_spectrogram
from segma_tpu_torch.utils.encoders import MultiLabelEncoder, PowersetEncoder

CONV_SETTINGS = ConvolutionSettings(
    kernels=(400, 3, 3), strides=(160, 1, 2), paddings=(200, 1, 1)
)
FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


def same_pads(n: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` for ``n`` input frames: (low, high)."""
    k_eff = (kernel - 1) * dilation + 1
    total = max((-(-n // stride) - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """``conv`` on (B, C, T) ``x`` with SAME padding, in ``x``'s dtype."""
    lo, hi = same_pads(x.shape[-1], conv.kernel_size[0], conv.stride[0], conv.dilation[0])
    return _conv(F.pad(x, (lo, hi)), conv)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ConvVADModule(nn.Module):
    """(B, T) waveform -> (B, n_windows, n_labels) logits."""

    def __init__(self, n_labels: int, n_windows: int, hidden: int = 256, depth: int = 4,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.n_windows = n_windows
        self.depth = depth
        self.dtype = dtype
        self.Conv_0 = nn.Conv1d(N_MELS, hidden, 3)
        self.Conv_1 = nn.Conv1d(hidden, hidden, 3, stride=2)
        for i in range(depth):
            setattr(self, f"LayerNorm_{i}", nn.LayerNorm(hidden, eps=FLAX_LN_EPS))
            setattr(self, f"Conv_{2 + 2 * i}", nn.Conv1d(hidden, hidden, 3, dilation=2**i))
            setattr(self, f"Conv_{3 + 2 * i}", nn.Conv1d(hidden, hidden, 1))
        setattr(self, f"LayerNorm_{depth}", nn.LayerNorm(hidden, eps=FLAX_LN_EPS))
        self.HydraHeads_0 = HydraHeads(hidden, n_labels)

    def forward(self, wav: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """No dropout: ``train`` and ``generator`` are taken and unused."""
        with ieee_f32(self.dtype):
            mel = log_mel_spectrogram(wav).to(self.dtype).transpose(1, 2)  # (B, 80, T/160)
            x = gelu(conv_same(mel, self.Conv_0))
            x = gelu(conv_same(x, self.Conv_1)).transpose(1, 2)  # (B, frames, hidden)
            for i in range(self.depth):
                h = layer_norm(x, getattr(self, f"LayerNorm_{i}")).transpose(1, 2)
                h = gelu(conv_same(h, getattr(self, f"Conv_{2 + 2 * i}")))
                x = x + _conv(h, getattr(self, f"Conv_{3 + 2 * i}")).transpose(1, 2)
            x = layer_norm(x, getattr(self, f"LayerNorm_{self.depth}"))
            return self.HydraHeads_0(x)[:, : self.n_windows].float()


def _build(name: str, label_encoder: MultiLabelEncoder, config: Config,
           device: str | torch.device | None, generator: torch.Generator | None,
           ) -> SegmentationModel:
    dev = resolve_device(device)
    mc = config.model.config
    if not isinstance(mc, ConvVADConfig):
        mc = ConvVADConfig()
    powerset = (PowersetEncoder(list(label_encoder.base_labels), max_set_size=mc.max_set_size)
                if name == "powerset_vad" else None)
    n_windows = CONV_SETTINGS.n_windows(
        config.audio.chunk_duration_f, strict=config.audio.strict_frames
    )
    module = ConvVADModule(
        n_labels=len(powerset) if powerset is not None else len(label_encoder.base_labels),
        n_windows=n_windows, hidden=mc.hidden, depth=mc.depth,
        dtype=torch.float32 if mc.dtype == "f32" else torch.bfloat16,
    )
    init_random_(module, generator or torch.Generator().manual_seed(0))
    module.to(dev)
    return SegmentationModel(
        name=name,
        module=module,
        conv_settings=CONV_SETTINGS,
        label_encoder=label_encoder,
        config=config,
        device=dev,
        # as in JAX: powerset_vad's subset CE takes no class weights
        class_weights=None if powerset is not None else config.train.class_weights,
        loss_type="powerset" if powerset is not None else "hydra",
        powerset=powerset,
    )


def build_conv_vad(label_encoder: MultiLabelEncoder, config: Config,
                   device: str | torch.device | None = "cuda",
                   generator: torch.Generator | None = None) -> SegmentationModel:
    """``conv_vad`` with random weights from ``generator`` (seed 0 when None)
    on ``device``."""
    return _build("conv_vad", label_encoder, config, device, generator)


def build_powerset_vad(label_encoder: MultiLabelEncoder, config: Config,
                       device: str | torch.device | None = "cuda",
                       generator: torch.Generator | None = None) -> SegmentationModel:
    """``powerset_vad``: the ``conv_vad`` trunk with one output per subset
    class of at most ``model.config.max_set_size`` labels, trained on the
    subset CE and decoded through the marginal per-label logits."""
    return _build("powerset_vad", label_encoder, config, device, generator)
