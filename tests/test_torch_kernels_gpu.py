"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
torch and numpy only, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from segma_tpu_torch.ops import attention, logmel

LOGMEL_ATOL = 1e-5  # f32 frontend, IEEE FMA in the kernel
FLASH_TOL = 2e-2  # bf16 output rounding against f32 scores


def _cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(4, 480_000), (2, (256 + 7) * 160), (1, 16_001)], ids=["context", "tail", "odd"]
)
def test_logmel_kernel_matches_plain(shape):
    _cuda()
    wav = torch.from_numpy(
        (np.random.default_rng(0).standard_normal(shape) * 0.1).astype(np.float32)
    ).cuda()
    before = logmel.launches
    got = logmel.finish(logmel.log10_mel(wav))
    torch.cuda.synchronize()
    assert logmel.launches == before + 1
    torch.testing.assert_close(got, logmel.log_mel_spectrogram_plain(wav), atol=LOGMEL_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(2, 1500, 8, 64), (2, 199, 8, 64), (3, 65, 2, 64), (1, 1, 2, 64)]
)
def test_flash_kernel_matches_plain(shape):
    _cuda()
    rng = np.random.default_rng(1)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(torch.bfloat16)
        for _ in range(3)
    )
    before = attention.launches
    got = attention.attention_core(q, k, v, sm_scale=64**-0.5)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.attention_plain(q, k, v, 64**-0.5, torch.float32)
    torch.testing.assert_close(got.float(), ref, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take():
    _cuda()
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attn_fwd(q, q, q, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.attention_core(q.float(), q.float(), q.float(), sm_scale=0.1, dtype=torch.float32)


@pytest.mark.gpu
def test_tiny_surgical_hydra_card_matches_cpu():
    """Same random weights, bf16 throughout: card (kernels, cuDNN LSTM)
    against CPU (plain path) at atol 1e-2."""
    _cuda()
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig, SurgicalHydraConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = Config(
        data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"]),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False),
        model=ModelConfig(name="surgical_hydra", config=SurgicalHydraConfig(
            encoder="whisper_tiny_random", encoder_layers=[], reduction="weighted",
            lstm=LSTMConfig(hidden_size=16, num_layers=2, bidirectional=True, dropout=0.5),
            classifier=256,
        )),
    )
    enc_cfg = WhisperEncoderConfig(d_model=128, n_heads=2, n_layers=2, ffn_dim=256)
    models = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for device in ("cuda", "cpu"):
            models.append(Models["surgical_hydra"](
                MultiLabelEncoder(cfg.data.classes), cfg, device=device,
                generator=torch.Generator().manual_seed(0), enc_cfg=enc_cfg,
            ))
    wav = torch.from_numpy(
        (np.random.default_rng(2).standard_normal((2, 64_000)) * 0.1).astype(np.float32)
    )
    got = models[0].apply(wav.cuda()).cpu()
    torch.testing.assert_close(got, models[1].apply(wav), atol=1e-2, rtol=0)
