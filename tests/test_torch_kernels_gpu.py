"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
torch, numpy and chip_smoke.py's log-mel references only, so it runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from chip_smoke import (
    FLASH_F32_BWD_EDGE_S, FLASH_F32_EDGE_S, LOGMEL_BULK_FACTOR, log_mel_float64,
    wide_range_signals,
)
from segma_tpu_torch.ops import attention, logmel

LOGMEL_ATOL = 1e-5  # f32 frontend: 3xTF32 products, f32 sums
FLASH_TOL = 2e-2  # bf16 output rounding against f32 scores
FLASH_BWD_REL = 2e-2  # per tensor, times max(1, max|ref|): P and dS round to bf16
LSE_ATOL = 1e-3
# f32 kernels: the JAX suite's f32 pins against its einsum attention
# (tests/test_ops_attention.py:52 forward 2e-5, :74 gradients 5e-5), the
# gradients per tensor times max(1, max|ref|) as for bf16 (at S = 199 with
# N(0, 1) inputs dq and dk reach |10|); the LSE, a log of sums, at 1e-5
FLASH_F32_ATOL = 2e-5
FLASH_F32_BWD_REL = 5e-5
LSE_F32_ATOL = 1e-5


def _cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _logmel_input(shape, seed, signal_samples=None):
    """White noise at 0.1; with ``signal_samples``, zeros after that many
    samples, as the main path pads its 4 s chunks to the 30 s context."""
    wav = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)
    if signal_samples is not None:
        wav[:, signal_samples:] = 0.0
    return torch.from_numpy(wav).cuda()


# White noise (a flat spectrum: f32 sums in any order hold 1e-5 at these
# sizes), the main path's padded chunks, and the reflect edges (T = 201: one
# frame, both edges in one tile; T = 16001, not a multiple of 160 or 4; T =
# 42080, a partial last tile).
LOGMEL_CASES = {
    "context": ((4, 480_000), None), "tail": ((2, (256 + 7) * 160), None),
    "odd": ((1, 16_001), None), "padded-chunks": ((4, 480_000), 64_000),
    "t201": ((3, 201), None),
    "fast-context": ((2, 64_000), None),  # fast_context: the 4 s chunk itself, 400 frames
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LOGMEL_CASES))
def test_logmel_kernel_matches_plain(case):
    _cuda()
    shape, signal_samples = LOGMEL_CASES[case]
    wav = _logmel_input(shape, 0, signal_samples)
    before = logmel.launches
    got = logmel.finish(logmel.log10_mel(wav))
    torch.cuda.synchronize()
    assert logmel.launches == before + 1
    torch.testing.assert_close(got, logmel.log_mel_spectrogram_plain(wav), atol=LOGMEL_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["white-serving-batch", "tone", "brown", "int16-quiet"])
def test_logmel_kernel_wide_range_against_float64(name):
    """On a signal that spans the 8 decades ``finish`` keeps, two f32
    implementations differ by more than 1e-5 (cancellation in the DFT of a
    loud bin leaks into the quiet ones), so both are held to float64: the
    kernel's error may be at most twice the f32 plain version's own, or 1e-5.
    White noise at the serving batch (64, 480000) is held the same way:
    among its 15.4 M outputs some bins lie far below the mean power by
    chance, where the f32 plain version itself misses 1e-5. On this input
    the kernel reads 3.7e-5 from float64 and the plain version 2.7e-5 (an
    H100; ``pytest -rP`` prints both, PERF.md keeps them)."""
    _cuda()
    if name == "white-serving-batch":
        wav = _logmel_input((64, 480_000), 0)
    else:
        sig = wide_range_signals(8, 2 * 64_000)[name]
        wav = torch.from_numpy(sig.reshape(2, 64_000)).cuda()
    ref = log_mel_float64(wav)
    plain_err = float((logmel.log_mel_spectrogram_plain(wav).double() - ref).abs().max())
    err = float((logmel.finish(logmel.log10_mel(wav)).double() - ref).abs().max())
    print(f"logmel {name} {tuple(wav.shape)} from float64: kernel {err:.3e}, plain {plain_err:.3e}")
    assert err <= max(2 * plain_err, LOGMEL_ATOL), (err, plain_err)


@pytest.mark.gpu
def test_logmel_kernel_two_launches_bitwise_equal():
    """No atomics, and an item's arithmetic does not depend on the block that
    runs it: the same inputs give the same bits."""
    _cuda()
    wav = _logmel_input((8, 480_000), 9)
    assert torch.equal(logmel.log10_mel(wav), logmel.log10_mel(wav))


# The forward's tiling is 128 query rows per work item and 128 keys per tile:
# exact tiles, one past a tile, one short of two tiles, and many work items
# per block (B H = 512).
FLASH_EDGE_SHAPES = [(2, 128, 2, 64), (2, 129, 2, 64), (2, 255, 2, 64), (64, 199, 8, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(2, 1500, 8, 64), (2, 199, 8, 64), (2, 200, 8, 64), (3, 65, 2, 64), (1, 1, 2, 64),
              *FLASH_EDGE_SHAPES]
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
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        attention.attention_core(q.half(), q.half(), q.half(), sm_scale=0.1, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        attention.flash_attn_fwd(*(torch.zeros_like(q, dtype=torch.float16),) * 3, 0.1)
    with pytest.raises(ValueError, match="the others"):
        attention.flash_attn_fwd(q.float(), q, q, 0.1)


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


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(torch.bfloat16)


# The backward's tiling is 128 resident rows per work item and 64 streamed
# rows per tile: one row, one short of, at and one past each tile edge.
FLASH_BWD_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 255, 256)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [(32, 199, 12, 64), (64, 1500, 8, 64), (2, 70, 2, 64),
     *((2, s, 3, 64) for s in FLASH_BWD_EDGE_S)],
    ids=["hubert-train", "many-tiles", "partial-tile", *(f"s{s}" for s in FLASH_BWD_EDGE_S)],
)
def test_flash_backward_kernel_matches_plain(shape):
    _cuda()
    rng = np.random.default_rng(3)
    q, k, v, dout = (_bf16(rng, shape) for _ in range(4))
    out, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    before = attention.bwd_launches
    got = attention.flash_attn_bwd(q, k, v, out, lse, dout, 64**-0.5)
    torch.cuda.synchronize()
    assert attention.bwd_launches == before + 1
    ref = attention.attention_bwd_plain(q, k, v, out, lse, dout, 64**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        limit = FLASH_BWD_REL * max(1.0, float(b.abs().max()))
        assert float((a.float() - b).abs().max()) <= limit, name


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(32, 199, 12, 64), (3, 65, 2, 64), (1, 1, 2, 64), *FLASH_EDGE_SHAPES]
)
def test_flash_forward_lse_output(shape):
    _cuda()
    rng = np.random.default_rng(4)
    q, k, v = (_bf16(rng, shape) for _ in range(3))
    out, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, attention.attention_lse_plain(q, k, 64**-0.5),
                               atol=LSE_ATOL, rtol=0)
    # the output does not change with the LSE written
    torch.testing.assert_close(out, attention.flash_attn_fwd(q, k, v, 64**-0.5), atol=0, rtol=0)


@pytest.mark.gpu
def test_flash_forward_two_launches_bitwise_equal():
    """No atomics, and a work item's arithmetic does not depend on the block
    that runs it: the same inputs give the same bits."""
    _cuda()
    rng = np.random.default_rng(6)
    q, k, v = (_bf16(rng, (64, 1500, 8, 64)) for _ in range(3))
    first = attention.flash_attn_fwd(q, k, v, 64**-0.5)
    assert torch.equal(first, attention.flash_attn_fwd(q, k, v, 64**-0.5))


@pytest.mark.gpu
def test_flash_backward_two_launches_bitwise_equal():
    """Two passes without atomics, each work item's arithmetic independent of
    the block that runs it: the same inputs give the same bits."""
    _cuda()
    rng = np.random.default_rng(7)
    q, k, v, dout = (_bf16(rng, (32, 199, 12, 64)) for _ in range(4))
    out, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    first = attention.flash_attn_bwd(q, k, v, out, lse, dout, 64**-0.5)
    second = attention.flash_attn_bwd(q, k, v, out, lse, dout, 64**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_gradients_reach_qkv_projections_through_the_kernels():
    """A tiny HuBERT on the card: attention_core records FlashAttention, its
    backward launches the backward kernels once per layer, and every q/k/v
    projection gets a finite, non-zero gradient close to the CPU plain
    path's (same weights, f32 master weights, bf16 compute)."""
    _cuda()
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, ModelConfig, SurgicalHubertHydraConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = Config(
        data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"]),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=True),
        model=ModelConfig(name="surgical_hubert_hydra", config=SurgicalHubertHydraConfig(
            wav_encoder="hubert_random", encoder_layers=[], reduction="weighted", classifier=256,
        )),
    )
    enc_cfg = HubertEncoderConfig(hidden_size=128, n_layers=2, n_heads=2, ffn_dim=256,
                                  conv_dim=(64,) * 7, pos_conv_kernel=16, pos_conv_groups=4)
    rng = np.random.default_rng(5)
    wav = torch.from_numpy((rng.standard_normal((2, 64_000)) * 0.1).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 199, 4)) > 0.7).astype(np.float32))
    grads = []
    for device in ("cuda", "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = Models["surgical_hubert_hydra"](
                MultiLabelEncoder(cfg.data.classes), cfg, device=device,
                generator=torch.Generator().manual_seed(0), enc_cfg=enc_cfg,
            )
        before = attention.bwd_launches
        logits = model.module(wav.to(device), train=False)
        loss, _ = model.loss(logits, y.to(device))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert attention.bwd_launches == before + enc_cfg.n_layers
        grads.append({
            n: p.grad.float().cpu() for n, p in model.module.named_parameters()
            if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))
        })
    assert len(grads[0]) == 3 * enc_cfg.n_layers
    for name, g in grads[0].items():
        assert torch.isfinite(g).all() and g.norm() > 0, name
        ref = grads[1][name]
        assert float((g - ref).norm()) <= 5e-2 * float(ref.norm()), name


def _f32(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()


# The f32 kernels' tiling (chip_smoke.FLASH_F32_EDGE_S and
# FLASH_F32_BWD_EDGE_S): the forward 128 query rows per work item (64 per
# consumer), 32 keys per tile; the backward 128 resident rows per work item
# (64 per consumer), 32 streamed rows per tile.


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(2, 1500, 8, 64), (32, 199, 12, 64), (2, 200, 8, 64),
              *((2, s, 3, 64) for s in FLASH_F32_EDGE_S)],
    ids=["whisper-serving", "hubert-train", "fast-context",
         *(f"s{s}" for s in FLASH_F32_EDGE_S)],
)
def test_flash_f32_forward_matches_plain(shape):
    """Output against the f32 plain version and float64, the LSE against
    torch.logsumexp, with and without the LSE bitwise equal; the f32 launch
    count moves, the bf16 one does not."""
    _cuda()
    rng = np.random.default_rng(11)
    q, k, v = (_f32(rng, shape) for _ in range(3))
    before = (attention.launches, attention.launches_f32)
    out = attention.attention_core(q, k, v, sm_scale=64**-0.5, dtype=torch.float32)
    with_lse, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    torch.cuda.synchronize()
    assert (attention.launches, attention.launches_f32) == (before[0], before[1] + 2)
    assert out.dtype == torch.float32 and torch.equal(out, with_lse)
    ref = attention.attention_plain(q, k, v, 64**-0.5, torch.float32)
    torch.testing.assert_close(out, ref, atol=FLASH_F32_ATOL, rtol=0)
    ref64 = attention.attention_plain(q.double(), k.double(), v.double(), 64**-0.5, torch.float64)
    torch.testing.assert_close(out.double(), ref64, atol=FLASH_F32_ATOL, rtol=0)
    torch.testing.assert_close(lse, attention.attention_lse_plain(q, k, 64**-0.5),
                               atol=LSE_F32_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(32, 199, 12, 64), *((2, s, 3, 64) for s in FLASH_F32_BWD_EDGE_S)],
    ids=["hubert-train", *(f"s{s}" for s in FLASH_F32_BWD_EDGE_S)],
)
def test_flash_f32_backward_matches_plain(shape):
    _cuda()
    rng = np.random.default_rng(12)
    q, k, v, dout = (_f32(rng, shape) for _ in range(4))
    out, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    before = (attention.bwd_launches, attention.bwd_launches_f32)
    got = attention.flash_attn_bwd(q, k, v, out, lse, dout, 64**-0.5)
    torch.cuda.synchronize()
    assert (attention.bwd_launches, attention.bwd_launches_f32) == (before[0], before[1] + 1)
    ref = attention.attention_bwd_plain(q, k, v, out, lse, dout, 64**-0.5)
    ref64 = attention.attention_bwd_plain(*(x.double() for x in (q, k, v, out, lse, dout)),
                                          64**-0.5)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, ref64):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        limit = FLASH_F32_BWD_REL * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= limit, name
        assert float((a.double() - c).abs().max()) <= limit, name


@pytest.mark.gpu
def test_flash_f32_kernels_two_launches_bitwise_equal():
    """No atomics and a fixed order of every sum: the same inputs give the
    same bits, forward and backward."""
    _cuda()
    rng = np.random.default_rng(13)
    q, k, v, dout = (_f32(rng, (32, 199, 12, 64)) for _ in range(4))
    out, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    again, lse_again = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    first = attention.flash_attn_bwd(q, k, v, out, lse, dout, 64**-0.5)
    second = attention.flash_attn_bwd(q, k, v, out, lse, dout, 64**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_tiny_f32_models_on_the_card_match_the_cpu_under_default_flags():
    """f32 serving and an f32 train step on the card, with PyTorch's default
    TF32 flags (cuDNN may take TF32): the f32 model keeps its convolutions
    and LSTM in IEEE f32, so its logits and q/k/v gradients match the CPU
    plain path's at the suite's f32 pins (logits 1e-4; gradients 1e-4 x
    max(1, max|ref|)), the f32 kernels run, and the flags are as before
    after each call."""
    _cuda()
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig, SurgicalHubertHydraConfig,
        SurgicalHydraConfig, TrainConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
    from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        classes = ["KCHI", "OCH", "MAL", "FEM"]
        whisper = Config(
            data=DataConfig(classes=classes),
            audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False),
            model=ModelConfig(name="surgical_hydra", config=SurgicalHydraConfig(
                encoder="whisper_tiny_random", encoder_layers=[], reduction="weighted",
                lstm=LSTMConfig(hidden_size=16, num_layers=2, bidirectional=True, dropout=0.5),
                classifier=256,
            )),
            train=TrainConfig(precision="f32"),
        )
        hubert = Config(
            data=DataConfig(classes=classes),
            audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=True),
            model=ModelConfig(name="surgical_hubert_hydra", config=SurgicalHubertHydraConfig(
                wav_encoder="hubert_random", encoder_layers=[], reduction="weighted",
                classifier=256,
            )),
            train=TrainConfig(precision="f32"),
        )
        kw = {
            "surgical_hydra": dict(enc_cfg=WhisperEncoderConfig(d_model=128, n_heads=2,
                                                                n_layers=2, ffn_dim=256)),
            "surgical_hubert_hydra": dict(enc_cfg=HubertEncoderConfig(
                hidden_size=128, n_layers=2, n_heads=2, ffn_dim=256, conv_dim=(64,) * 7,
                pos_conv_kernel=16, pos_conv_groups=4)),
        }
        rng = np.random.default_rng(14)
        wav = torch.from_numpy((rng.standard_normal((2, 64_000)) * 0.1).astype(np.float32))
        y = torch.from_numpy((rng.random((2, 199, 4)) > 0.7).astype(np.float32))
        for cfg in (whisper, hubert):
            name = cfg.model.name
            pair = []
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for device in ("cuda", "cpu"):
                    pair.append(Models[name](MultiLabelEncoder(classes), cfg, device=device,
                                             generator=torch.Generator().manual_seed(0),
                                             **kw[name]))
            before = attention.launches_f32
            got = pair[0].apply(wav.cuda()).cpu()
            torch.cuda.synchronize()
            assert attention.launches_f32 == before + 2, name
            assert torch.backends.cudnn.allow_tf32, name
            torch.testing.assert_close(got, pair[1].apply(wav), atol=1e-4, rtol=0)
        grads = []
        for model, device in zip(pair, ("cuda", "cpu")):  # the HuBERT pair
            loss, _ = model.loss(model.module(wav.to(device), train=False), y.to(device))
            loss.backward()
            grads.append({n: p.grad.cpu() for n, p in model.module.named_parameters()
                          if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))})
        assert torch.backends.cudnn.allow_tf32
        for n, g in grads[0].items():
            ref = grads[1][n]
            assert float((g - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max())), n
    finally:
        torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tone", "brown", "int16-quiet"])
def test_logmel_kernel_bulk_error_is_bounded(name):
    """On the wide-range signals at chip_smoke.py's size (64, 64000), the
    kernel has at most LOGMEL_BULK_FACTOR times as many outputs more than
    1e-5 from float64 as the f32 plain version (chip_smoke.py states why)."""
    _cuda()
    wav = torch.from_numpy(wide_range_signals(8, 64 * 64_000)[name].reshape(64, 64_000)).cuda()
    ref = log_mel_float64(wav)
    plain = int(((logmel.log_mel_spectrogram_plain(wav).double() - ref).abs() > LOGMEL_ATOL).sum())
    got = int(((logmel.finish(logmel.log10_mel(wav)).double() - ref).abs() > LOGMEL_ATOL).sum())
    print(f"logmel {name} (64, 64000): outputs more than {LOGMEL_ATOL} from float64: kernel "
          f"{got}, plain {plain}")
    assert got <= LOGMEL_BULK_FACTOR * plain, (got, plain)
