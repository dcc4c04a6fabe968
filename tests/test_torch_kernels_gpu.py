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
    FLASH_F32_BWD_EDGE_S, FLASH_F32_EDGE_S, LOGMEL_BULK_FACTOR, LSTM_ATOL, LSTM_CUDNN_ATOL,
    log_mel_float64, wide_range_signals,
)
from segma_tpu_torch.ops import attention, logmel, rnn

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
    """Same random weights, bf16 throughout: card (kernels, the LSTM's too)
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


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_flash_forward_launches_per_step_with_and_without_remat(remat):
    """One bf16 train step of a tiny HuBERT on the card: the flash forward
    launches once per layer, and once more per layer under ``train.remat``
    (the layer's forward recomputed in the backward pass); the backward
    once per layer either way; under cuDNN's deterministic algorithms, the
    parameters after the step agree bit for bit."""
    _cuda()
    import dataclasses

    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, ModelConfig, SurgicalHubertHydraConfig, TrainConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
    from segma_tpu_torch.train import deterministic_cudnn, make_optimizer, make_train_step
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = Config(
        data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"]),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=True),
        model=ModelConfig(name="surgical_hubert_hydra", config=SurgicalHubertHydraConfig(
            wav_encoder="hubert_random", encoder_layers=[], reduction="weighted", classifier=256,
        )),
        train=TrainConfig(remat=remat),
    )
    enc_cfg = HubertEncoderConfig(hidden_size=128, n_layers=2, n_heads=2, ffn_dim=256,
                                  conv_dim=(64,) * 7, pos_conv_kernel=16, pos_conv_groups=4)
    rng = np.random.default_rng(5)
    batch = {"x": torch.from_numpy((rng.standard_normal((2, 64_000)) * 0.1).astype(np.float32))
             .cuda(), "y": torch.from_numpy((rng.random((2, 199, 4)) > 0.7).astype(np.float32))
             .cuda()}
    params = {}
    for on in sorted({False, remat}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = Models["surgical_hubert_hydra"](
                MultiLabelEncoder(cfg.data.classes),
                dataclasses.replace(cfg, train=TrainConfig(remat=on)), device="cuda",
                generator=torch.Generator().manual_seed(0), enc_cfg=enc_cfg)
        model.module.dropout = 0.0
        step = make_train_step(model, make_optimizer(model, 1e-3))
        fwd, bwd = attention.launches, attention.bwd_launches
        with deterministic_cudnn(True):
            step(batch, None)
        torch.cuda.synchronize()
        per_layer = 2 if on else 1
        assert attention.launches - fwd == per_layer * enc_cfg.n_layers
        assert attention.bwd_launches - bwd == enc_cfg.n_layers
        params[on] = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    if remat:
        for name, p in params[True].items():
            assert torch.equal(p, params[False][name]), name


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


@pytest.mark.gpu
def test_logmel_kernel_at_the_vad_training_shape():
    """conv_vad and powerset_vad train on (32, 64000): white noise over the
    whole batch, held to float64 as the serving batch is (at most twice the
    f32 plain version's own error, or 1e-5), one launch."""
    _cuda()
    wav = _logmel_input((32, 64_000), 3)
    ref = log_mel_float64(wav)
    before = logmel.launches
    got = logmel.finish(logmel.log10_mel(wav))
    torch.cuda.synchronize()
    assert logmel.launches == before + 1
    plain_err = float((logmel.log_mel_spectrogram_plain(wav).double() - ref).abs().max())
    err = float((got.double() - ref).abs().max())
    print(f"logmel (32, 64000) from float64: kernel {err:.3e}, plain {plain_err:.3e}")
    assert err <= max(2 * plain_err, LOGMEL_ATOL), (err, plain_err)


FAMILY_OVERRIDES = {
    "conv_vad": ["model.config.hidden=32", "model.config.depth=2"],
    "powerset_vad": ["model.config.hidden=32", "model.config.depth=2"],
    "sincnet_hydra": ["model.config.filters=16", "model.config.kernel_size=101",
                      "model.config.hidden=32", "model.config.lstm.hidden_size=16"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAMILY_OVERRIDES))
def test_tiny_conv_families_on_the_card_match_the_cpu(name):
    """conv_vad, powerset_vad and sincnet_hydra at tiny widths in f32, same
    weights on the card and the CPU: logits within 1e-4 * max(1, max|logit|)
    (the f32 pin), log-mel launched once per forward on the conv_vad path
    and never on sincnet's."""
    from pathlib import Path

    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    _cuda()
    repo = Path(__file__).resolve().parent.parent
    cfg = load_config(repo / "segma_tpu_torch/config/default.yml",
                      [f"model.name={name}", "model.config.dtype=f32", "audio.chunk_duration_s=1.0",
                       *FAMILY_OVERRIDES[name]])
    enc = MultiLabelEncoder(cfg.data.classes)
    card = Models[name](enc, cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    cpu = Models[name](enc, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    wav = torch.from_numpy((np.random.default_rng(2).standard_normal((4, 16_000)) * 0.1)
                           .astype(np.float32))
    before = logmel.launches
    got = card.apply(wav.cuda()).cpu()
    assert logmel.launches == before + (0 if name == "sincnet_hydra" else 1)
    ref = cpu.apply(wav)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


# -- epoch dispatch: the training step captured as a CUDA graph and replayed ---------


class _CacheLoader:
    """Fixed device-cache batches, as ``SegmentationDataLoader`` gives them
    under ``train.data_cache=device``."""

    def __init__(self, cache, batches):
        self.device_cache, self.batches, self.data_cache_decision = cache, batches, None

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


class _CacheDatamodule:
    def __init__(self, cache, train, val):
        self.train, self.val = _CacheLoader(cache, train), _CacheLoader(cache, val)

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        return self.val


REPLAY_CASES = {
    # name: (model, precision, remat, grad_accum_steps, steps per epoch)
    "hubert-bf16-remat": ("surgical_hubert_hydra", "bf16", True, 1, 3),
    "hubert-f32-remat": ("surgical_hubert_hydra", "f32", True, 1, 3),
    "hubert-bf16-accum3": ("surgical_hubert_hydra", "bf16", False, 3, 4),
    "whisper-bf16-logmel": ("surgical_hydra", "bf16", False, 1, 3),
}


def _tiny_model(name, train, device="cuda"):
    """(config, model): ``name`` at tiny widths (2 layers of 128) with the
    given ``TrainConfig``, its weights from seed 0."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig, SurgicalHubertHydraConfig,
        SurgicalHydraConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
    from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    if name == "surgical_hubert_hydra":
        mc = SurgicalHubertHydraConfig(wav_encoder="hubert_random", encoder_layers=[],
                                       reduction="weighted", classifier=256)
        kw = dict(enc_cfg=HubertEncoderConfig(hidden_size=128, n_layers=2, n_heads=2,
                                              ffn_dim=256, conv_dim=(64,) * 7,
                                              pos_conv_kernel=16, pos_conv_groups=4))
    else:
        mc = SurgicalHydraConfig(encoder="whisper_tiny_random", encoder_layers=[],
                                 reduction="weighted", classifier=256,
                                 lstm=LSTMConfig(hidden_size=16, num_layers=2,
                                                 bidirectional=True, dropout=0.5))
        kw = dict(enc_cfg=WhisperEncoderConfig(d_model=128, n_heads=2, n_layers=2, ffn_dim=256))
    cfg = Config(data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"]),
                 audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000,
                                   strict_frames=name == "surgical_hubert_hydra"),
                 model=ModelConfig(name=name, config=mc), train=train)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device=device,
                             generator=torch.Generator().manual_seed(0), **kw)
    return cfg, model


def _replay_fit(case, dispatch, tmp_path):
    """Two epochs of a tiny model through ``Trainer.fit`` with dropout on, the
    cosine schedule and a seed, over an int16 device cache; returns (trainer,
    result, launch counts of the fit)."""
    import dataclasses

    from segma_tpu_torch.config import SchedulerConfig, TrainConfig
    from segma_tpu_torch.data.device_cache import DeviceAudioCache
    from segma_tpu_torch.ops import launch_counts
    from segma_tpu_torch.train import Trainer

    name, precision, remat, k, n_steps = REPLAY_CASES[case]
    cfg, model = _tiny_model(name, TrainConfig(
        lr=1e-3, batch_size=2, max_epochs=2, seed=0, precision=precision, remat=remat,
        grad_accum_steps=k, log_every_n_steps=1, dispatch=dispatch, data_cache="device",
        scheduler=SchedulerConfig(type="cosine", warmup_steps=1, min_lr_ratio=0.1)))
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(200_000) * 3000).astype(np.int16)
    cache = DeviceAudioCache(audio, np.zeros(1, np.int32), cfg.audio.chunk_duration_f)

    def batch():
        return {"offsets": rng.integers(0, 200_000 - 64_000, 2).astype(np.int32),
                "y": (rng.random((2, model.n_windows, 4)) > 0.7).astype(np.float32)}

    dm = _CacheDatamodule(cache, [batch() for _ in range(n_steps)], [batch()])
    trainer = Trainer(model=model, config=dataclasses.replace(cfg), run_dir=tmp_path / dispatch)
    before = launch_counts()
    result = trainer.fit(dm)
    torch.cuda.synchronize()
    after = launch_counts()
    return trainer, result, {k: after[k] - before[k] for k in after}


def _step_losses(run_dir):
    import json

    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["train/loss_step"]) for r in records if "train/loss_step" in r]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_epoch_replay_equals_step_dispatch_bitwise(case, tmp_path):
    """``train.dispatch=epoch`` on the card replays a captured CUDA graph of the
    step: with the same seed, dropout on, the cosine rate changing every step
    and two epochs' reseeded generator, the parameters, the capturable AdamW's
    state, every step's loss and the validation metrics equal step
    dispatch's bit for bit, and so do the kernels' launch counts (replays
    counted). HuBERT in bf16 and f32 under remat runs the flash forward with
    its LSE and both backward kernels under replay; k=3 accumulation replays
    both graphs (fold in, fold in and update); the Whisper model runs log-mel
    and the cuDNN LSTM with dropout under replay."""
    _cuda()
    step_t, step_r, step_n = _replay_fit(case, "step", tmp_path)
    epoch_t, epoch_r, epoch_n = _replay_fit(case, "epoch", tmp_path)
    k = REPLAY_CASES[case][3]
    # without accumulation every step updates; with it both kinds of step replay
    assert set(epoch_t.replay.graphs) == ({True} if k == 1 else {False, True})
    assert step_t.replay is None
    assert epoch_n == step_n and sum(step_n.values()) > 0
    assert _step_losses(tmp_path / "epoch") == _step_losses(tmp_path / "step")
    for a, b in zip(step_r["history"], epoch_r["history"], strict=True):
        for key in ("train/loss", "val/loss", "val/f1_score", "lr"):
            assert a[key] == b[key], key
    for name, p in step_t.model.module.named_parameters():
        assert torch.equal(p, dict(epoch_t.model.module.named_parameters())[name]), name
    params = dict(epoch_t.model.module.named_parameters())
    for name, p in step_t.model.module.named_parameters():
        if p.requires_grad:
            a, b = step_t.optimizer.state[p], epoch_t.optimizer.state[params[name]]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a[key], b[key]), (name, key)


ADAMW_STEPS = 5
ADAMW_RESTORE_AFTER = 3  # the card's state goes through optax's tree after this step
# Parameters within ADAMW_REL of the updates' largest sum (the rates so far)
# plus a few ulps of themselves. The two AdamWs differ on their own: the card
# forms the bias corrections in f32, as optax does (1 - 0.999**t loses about
# 1e-7 of 1e-3 * t to rounding), the CPU in double; 8.5e-6 of the sum at
# most on an H100 at these seeds.
ADAMW_REL = 2e-5
ADAMW_ULPS = 4
ADAMW_MOMENT_ULPS = 4  # moments: per tensor, of its largest entry


@pytest.mark.gpu
def test_card_adamw_holds_to_the_cpu_adamw():
    """The card's optimizer (``make_optimizer``: a capturable AdamW whose rate
    is a device tensor that ``set_learning_rate`` fills in place, the one both
    dispatches step with, and which replay is held to bit for bit) against
    the CPU's default AdamW (which the CPU tests hold to optax) on the same
    gradients: five steps with the cosine rate falling 10% to 86% every step,
    the card's state taken through optax's tree (``opt_state_tree``) into a
    fresh optimizer with another rate (``restore_opt_state``) after the third.
    After every step the step counts are equal, both moments agree to a few
    ulps of each tensor's largest entry, and the parameters, which start at
    zero so that an update is read to about 1e-6 of itself, to ADAMW_REL of
    what the updates so far can add up to. A rate stale by one step or off by
    1e-4 of itself, a step count off by one after the restore, or a missing
    bias correction (x0.32 at step 1) fails; a rate error below about 3e-5,
    one ulp among them, is within the two implementations' own rounding."""
    _cuda()
    from segma_tpu_torch.checkpoint import opt_state_tree, restore_opt_state
    from segma_tpu_torch.config import TrainConfig
    from segma_tpu_torch.train import cosine_lr, make_optimizer, set_learning_rate

    lr, eps = 1e-3, float(np.finfo(np.float32).eps)
    models = {dev: _tiny_model("surgical_hubert_hydra", TrainConfig(lr=lr), device=dev)[1]
              for dev in ("cuda", "cpu")}
    named = {dev: [(n, p) for n, p in m.module.named_parameters() if p.requires_grad]
             for dev, m in models.items()}
    with torch.no_grad():
        for pairs in named.values():
            for _, p in pairs:
                p.zero_()
    opts = {dev: make_optimizer(m, lr) for dev, m in models.items()}
    group = opts["cuda"].param_groups[0]
    assert group["capturable"] and group["lr"].is_cuda
    assert not opts["cpu"].param_groups[0]["capturable"]
    rates = [cosine_lr(s, lr, ADAMW_STEPS) for s in range(ADAMW_STEPS)]
    rng = np.random.default_rng(5)
    worst = {"param": (0.0, None), "exp_avg": (0.0, None), "exp_avg_sq": (0.0, None)}
    for i, rate in enumerate(rates):
        for (name, pc), (_, ph) in zip(named["cuda"], named["cpu"], strict=True):
            g = torch.from_numpy((rng.standard_normal(tuple(ph.shape)) * 1e-2).astype(np.float32))
            ph.grad, pc.grad = g, g.cuda()
        for opt in opts.values():
            set_learning_rate(opt, rate)
            opt.step()
        budget = ADAMW_REL * sum(rates[: i + 1])
        for (name, pc), (_, ph) in zip(named["cuda"], named["cpu"], strict=True):
            got, want = pc.detach().cpu().double(), ph.detach().double()
            ratio = float(((got - want).abs() / (budget + ADAMW_ULPS * eps * want.abs())).max())
            if ratio >= worst["param"][0]:
                worst["param"] = (ratio, (i + 1, name))
            sc, sh = opts["cuda"].state[pc], opts["cpu"].state[ph]
            assert sc["step"].is_cuda and float(sc["step"]) == float(sh["step"]) == i + 1
            for key in ("exp_avg", "exp_avg_sq"):
                a, b = sc[key].cpu().double(), sh[key].double()
                ratio = float((a - b).abs().max()) / (ADAMW_MOMENT_ULPS * eps * float(b.abs().max()))
                if ratio >= worst[key][0]:
                    worst[key] = (ratio, (i + 1, name))
        for key, (ratio, where) in worst.items():
            assert ratio <= 1.0, (key, ratio, where)
        if i + 1 == ADAMW_RESTORE_AFTER:
            tree = opt_state_tree(models["cuda"], opts["cuda"])
            opts["cuda"] = make_optimizer(models["cuda"], 0.5)
            restore_opt_state(models["cuda"], opts["cuda"], tree)
            group = opts["cuda"].param_groups[0]
            assert group["capturable"] and group["lr"].is_cuda
            assert float(group["lr"]) == float(np.float32(rate))
    print(f"card AdamW against the CPU's over {ADAMW_STEPS} steps, the largest share of each "
          f"tolerance (step, parameter): {worst}")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 16_001, 600 * 16_000])
def test_adpcm_decode_on_the_card_is_bit_exact(n):
    """The torch decode on the card against the numpy decode, bit for bit:
    int32 cumsums and a scale by 2**-15, as on the CPU."""
    _cuda()
    from segma_tpu_torch.ops.adpcm import adpcm_decode, adpcm_decode_np, adpcm_encode

    rng = np.random.default_rng(n % 97)
    t = np.arange(n) / 16_000
    rows = np.stack([np.sin(2 * np.pi * 440 * t) * 0.5, rng.standard_normal(n) * 0.3])
    data = adpcm_encode(np.clip(rows, -1, 1).astype(np.float32))
    got = adpcm_decode(torch.from_numpy(data).cuda(), n).cpu().numpy()
    np.testing.assert_array_equal(got, adpcm_decode_np(data, n))


@pytest.mark.gpu
def test_packed_logits_equal_single_logits_on_the_card():
    """Files packed into one dispatch give each file's single-dispatch
    logits: the same rows through inner batches of the same shape (three
    files of one 4-chunk bucket, batch 4: one inner batch per file either
    way). A tiny bf16 surgical_hydra through the kernels."""
    _cuda()
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig, SurgicalHydraConfig,
    )
    from segma_tpu_torch.inference import InferencePipeline
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
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cuda",
            generator=torch.Generator().manual_seed(0),
            enc_cfg=WhisperEncoderConfig(d_model=128, n_heads=2, n_layers=2, ffn_dim=256),
        )
    pipe = InferencePipeline(model, batch_size=4, device="cuda")
    rng = np.random.default_rng(8)
    pcms = [(rng.standard_normal(n) * 3_000).astype(np.int16)
            for n in (4 * 63_680, 3 * 63_680 + 9_000, 3 * 63_680 + 40_000)]
    packed = pipe.logits_for_audios_async(pcms, pack_files=3)
    for pcm, (lg, tf) in zip(pcms, packed):
        single = pipe.logits_for_audio(pcm)
        np.testing.assert_array_equal(lg[:tf].float().cpu().numpy(), single)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_registered_ops_equal_the_direct_launch(dtype):
    """Each registered op's CUDA implementation is the kernel: bit-equal to
    the direct ctypes launch, one launch counted per call."""
    _cuda()
    from segma_tpu_torch.ops import launch_counts

    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 199, 8, 64)).astype(np.float32))
               .cuda().to(dtype) for _ in range(3))
    key = "flash_attn_fwd_f32" if dtype == torch.float32 else "flash_attn_fwd"
    before = launch_counts()
    out = attention.flash_fwd_op(q, k, v, 0.125)
    out_lse, lse = attention.flash_fwd_lse_op(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert launch_counts()[key] == before[key] + 2
    direct, (direct_lse_out, direct_lse) = (
        attention.flash_attn_fwd(q, k, v, 0.125),
        attention.flash_attn_fwd(q, k, v, 0.125, with_lse=True))
    assert torch.equal(out, direct) and torch.equal(out_lse, direct_lse_out)
    assert torch.equal(lse, direct_lse)
    wav = _logmel_input((2, 64_000), seed=22)
    before = launch_counts()["logmel"]
    got = logmel.log10_mel(wav)
    torch.cuda.synchronize()
    assert launch_counts()["logmel"] == before + 1
    assert torch.equal(got, logmel.log10_mel_cuda(wav))


@pytest.mark.gpu
def test_tiny_exported_program_on_the_card_launches_the_kernels(tmp_path):
    """A tiny bf16 ``surgical_hydra`` exported for the cuda platform: its
    infer program holds the log-mel, flash-forward and LSTM ops, its run
    launches log-mel once, the flash forward once per layer and the LSTM
    kernel once per LSTM layer, and its logits equal the live pipeline's at
    the same inner batch (both through the LSTM kernel)."""
    _cuda()
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig, SurgicalHydraConfig,
    )
    from segma_tpu_torch.export import ExportedPipeline, export_inference
    from segma_tpu_torch.inference import InferencePipeline
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
    from segma_tpu_torch.ops import launch_counts
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    classes = ["KCHI", "OCH", "MAL", "FEM"]
    cfg = Config(
        data=DataConfig(classes=classes),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False),
        model=ModelConfig(name="surgical_hydra", config=SurgicalHydraConfig(
            encoder="whisper_tiny_random", encoder_layers=[], reduction="weighted",
            lstm=LSTMConfig(hidden_size=16, num_layers=2, bidirectional=True, dropout=0.5),
            classifier=256,
        )),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hydra"](
            MultiLabelEncoder(classes), cfg, device="cuda",
            generator=torch.Generator().manual_seed(0),
            enc_cfg=WhisperEncoderConfig(d_model=128, n_heads=2, n_layers=2, ffn_dim=256))
    out = export_inference(model, tmp_path / "art", buckets=(2,), batch_size=2,
                           platforms=("cuda",), stream_batches=())
    exp = ExportedPipeline.load(out)
    targets = {str(n.target) for n in exp.infer_fns[2].exported.graph.nodes}
    assert {"segma_tpu_torch.log10_mel.default", "segma_tpu_torch.flash_attn_fwd.default",
            "segma_tpu_torch.lstm.default"} <= targets
    wav = (np.random.default_rng(23).standard_normal(100_000) * 3000).astype(np.int16)
    before = launch_counts()
    got = exp.logits_for_audio(wav)
    after = launch_counts()
    assert after["logmel"] == before["logmel"] + 1
    assert after["flash_attn_fwd"] == before["flash_attn_fwd"] + 2
    assert after["lstm_fwd"] == before["lstm_fwd"] + 2
    ref = InferencePipeline(model, batch_size=2).logits_for_audio(wav)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.gpu
def test_kernels_launch_on_the_tensor_s_card():
    """Each kernel on tensors on cuda:1 while the thread's current device is
    cuda:0 (a replica's card, driven from another card's thread): the launch
    sizes its grid, sets its shared memory and takes its stream on the
    tensors' card, and agrees with the plain version there. Needs two cards."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the launch guard is checked on a second card")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g = torch.Generator().manual_seed(3)
    wav = (torch.randn((2, 64_000), generator=g) * 0.1).to(other)
    before = logmel.launches
    got = logmel.log10_mel_cuda(wav)
    assert logmel.launches == before + 1 and got.device == other
    torch.testing.assert_close(got, logmel.log10_mel_plain(wav), atol=LOGMEL_ATOL, rtol=0)
    for dtype, tol, bwd_rel in ((torch.bfloat16, FLASH_TOL, FLASH_BWD_REL),
                                (torch.float32, FLASH_F32_ATOL, FLASH_F32_BWD_REL)):
        q, k, v, dout = (torch.randn((2, 199, 4, 64), generator=g).to(other, dtype)
                         for _ in range(4))
        sm = 0.125
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        assert torch.cuda.current_device() == 0 and out.device == other
        ref = attention.attention_plain(q, k, v, sm, dtype)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        dq, dk, dv = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
        for got_g, ref_g in zip((dq, dk, dv), attention.attention_bwd_plain(
                q, k, v, out, lse, dout, sm)):
            scale = max(1.0, float(ref_g.abs().max()))
            assert float((got_g.float() - ref_g.float()).abs().max()) <= bwd_rel * scale
    lstm = torch.nn.LSTM(64, 16, bidirectional=True, batch_first=True).to(other)
    weights = [getattr(lstm, n) for n in lstm._flat_weights_names]
    x = torch.randn((3, 40, 64), generator=g).to(other)
    with torch.inference_mode():
        before = rnn.launches
        got = rnn.lstm_cuda(x, weights, 1, True)
        assert rnn.launches == before + 1 and got.device == other
        assert torch.cuda.current_device() == 0
        torch.testing.assert_close(got, rnn.lstm_plain(x, weights, 1, True), atol=LSTM_ATOL,
                                   rtol=0)
    torch.cuda.synchronize(other)


# Sequence parallelism's shapes (B, Sq, Skv, H): a seq member's block of
# Whisper's 1500 positions against the gathered keys (seq 2 and 4),
# fast_context's 200 over seq 2, a block that is not a multiple of 64 rows,
# more queries than keys, and a lone query or key.
FLASH_UNEQUAL_SHAPES = [(2, 750, 1500, 8), (2, 375, 1500, 4), (2, 100, 200, 8),
                        (2, 77, 1500, 3), (2, 300, 129, 2), (1, 1, 129, 2), (2, 65, 1, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", FLASH_UNEQUAL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_at_unequal_lengths_matches_plain(dtype, shape):
    """q of (B, Sq, H, 64) against k, v of (B, Skv, H, 64): the output and
    the LSE against the plain versions, one launch of the dtype's kernel,
    and each query row what the same row gives in a call over its block."""
    _cuda()
    b, sq, skv, h = shape
    rng = np.random.default_rng(13)
    q = _f32(rng, (b, sq, h, 64)).to(dtype)
    k, v = (_f32(rng, (b, skv, h, 64)).to(dtype) for _ in range(2))
    key = "launches" if dtype == torch.bfloat16 else "launches_f32"
    before = getattr(attention, key)
    out, lse = attention.flash_attn_fwd(q, k, v, 64**-0.5, with_lse=True)
    torch.cuda.synchronize()
    assert getattr(attention, key) == before + 1
    assert out.shape == q.shape and lse.shape == (b, h, sq)
    tol = FLASH_TOL if dtype == torch.bfloat16 else FLASH_F32_ATOL
    ref = attention.attention_plain(q, k, v, 64**-0.5, torch.float32)
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol if dtype == torch.bfloat16
                               else 0)
    torch.testing.assert_close(lse, attention.attention_lse_plain(q, k, 64**-0.5),
                               atol=LSE_ATOL if dtype == torch.bfloat16 else LSE_F32_ATOL, rtol=0)
    assert torch.equal(out, attention.attention_core(q, k, v, sm_scale=64**-0.5, dtype=dtype))


@pytest.mark.gpu
def test_flash_forward_query_block_is_the_full_call_s_rows():
    """A seq member's query block against all the keys gives, bit for bit,
    the rows that the self-attention call (Sq = Skv) gives them."""
    _cuda()
    rng = np.random.default_rng(14)
    q, k, v = (_f32(rng, (2, 1500, 8, 64)).to(torch.bfloat16) for _ in range(3))
    full = attention.flash_attn_fwd(q, k, v, 0.125)
    block = attention.flash_attn_fwd(q[:, 768:].contiguous(), k, v, 0.125)
    # a work item is 128 query rows: a block that starts on an item boundary
    # computes its rows as the full call does
    assert torch.equal(block, full[:, 768:])


@pytest.mark.gpu
def test_thread_group_on_two_streams_of_one_card():
    """Two members on cuda:0, each on its own stream and thread. Member 1's
    stream runs late (a sleep before each round), so it reads member 0's
    tensors long after member 0's thread has freed them and filled new
    allocations on its own stream: the event wait and ``record_stream``
    must keep the freed memory from reuse until the read is done."""
    _cuda()
    from concurrent.futures import ThreadPoolExecutor

    from segma_tpu_torch.parallel.collectives import ThreadGroup, run_members

    group = ThreadGroup(["cuda:0"] * 2, timeout=120)
    streams = [torch.cuda.Stream(0) for _ in range(2)]
    n, rounds = 1 << 22, 6

    def member(r: int):
        me = group.member(r)
        outs = []
        with torch.cuda.stream(streams[r]):
            for i in range(rounds):
                if r == 1:
                    torch.cuda._sleep(100_000_000)  # about 50 ms of this stream
                x = torch.full((n,), float(10 * i + r), device="cuda")
                outs.append(me.all_gather(x, dim=0))
                total = me.all_reduce_sum(x)
                del x
                # freed blocks go back to this stream's pool at once
                junk = [torch.full((n,), -1.0, device="cuda") for _ in range(4)]
                del junk
                outs.append(total)
            streams[r].synchronize()
        return [o.cpu() for o in outs]

    with ThreadPoolExecutor(2) as pool:
        got = run_members(pool, [lambda r=r: member(r) for r in range(2)], [group])
    for r in range(2):
        for i in range(rounds):
            gathered, total = got[r][2 * i], got[r][2 * i + 1]
            assert torch.equal(gathered[:n], torch.full((n,), 10.0 * i)), (r, i)
            assert torch.equal(gathered[n:], torch.full((n,), 10.0 * i + 1)), (r, i)
            assert torch.equal(total, torch.full((n,), 20.0 * i + 1)), (r, i)


# one rank of a 2-rank NCCL world on its own card: the layers' collectives
# (enter, reduce_sum, gather summed and not) in a forward and backward, run
# eagerly on two sets of inputs, then captured in a CUDA graph and replayed
# on each set; exits 1 unless every replay gives the eager bits
CAPTURE_WORKER = r'''
import faulthandler
import sys

faulthandler.dump_traceback_later(120, exit=True)  # a hung rank shows where it waits
import torch
from segma_tpu_torch.parallel import distributed
from segma_tpu_torch.parallel.collectives import enter, gather, reduce_sum

assert distributed.maybe_init_distributed("cuda")
world = distributed.current_world()
group, rank = world.group, world.rank
bad = []
for dtype in (torch.float32, torch.bfloat16):
    def inputs(seed):
        shared = torch.Generator().manual_seed(seed)  # replicated: x and the loss weights
        own = torch.Generator().manual_seed(seed + 100 * (rank + 1))  # this member's blocks
        x = torch.randn((8, 16), generator=shared)
        c = torch.randn((8, 12), generator=shared)
        k = torch.randn((16, 6), generator=shared)
        w, v = torch.randn((16, 6), generator=own), torch.randn((6, 5), generator=own)
        return [t.to("cuda", dtype) for t in (x, w, v, c, k)]

    static = [t.clone().requires_grad_(i < 3) for i, t in enumerate(inputs(1))]

    def body():
        x, w, v, c, k = static
        for t in (x, w, v):
            t.grad = None
        h = enter(x, group) @ w
        z = reduce_sum((h @ v).float(), group)
        summed = gather(h, group, dim=1, summed=True)  # each member reads its own columns
        kept = gather(h, group, dim=0, summed=False)  # what follows is alike on every member
        loss = ((z ** 2).sum() + (summed * c)[:, rank * 6:(rank + 1) * 6].float().sum()
                + (kept @ k.T).float().sum())
        loss.backward()
        return [z, summed, kept, x.grad, w.grad, v.grad]

    def load(seed):
        with torch.no_grad():
            for t, new in zip(static, inputs(seed)):
                t.copy_(new)

    eager = {}
    for seed in (1, 2):
        load(seed)
        eager[seed] = [t.detach().clone() for t in body()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    for seed in (2, 1, 2):
        load(seed)
        graph.replay()
        torch.cuda.synchronize()
        for i, (got, want) in enumerate(zip(outs, eager[seed])):
            if not torch.equal(got, want):
                bad.append((str(dtype), seed, i))
    del graph, outs  # NCCL keeps a communicator while a graph holds its work
distributed.destroy()
print(f"rank {rank}: captured replays against eager calls, mismatches {bad}", flush=True)
sys.exit(1 if bad else 0)
'''


@pytest.mark.gpu
def test_collectives_captured_in_a_cuda_graph_give_the_eager_bits():
    """In a 2-rank NCCL world, one rank per card: ``enter``, ``reduce_sum``
    and ``gather`` (both ``summed`` cases) in a forward and backward
    captured as a CUDA graph give, replay after replay on new inputs, the
    bits of the same calls made eagerly, in f32 and bf16. Needs two cards:
    NCCL refuses two ranks on one card."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one card")
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CAPTURE_WORKER], cwd=repo, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(repo), "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
        assert "mismatches []" in text, text[-2000:]


# The BiLSTM's kernel path (the input GEMM and csrc/lstm_fwd.cu) at (B, T, I,
# H, layers, bidirectional, keep): serving (Whisper's 1500 positions, whole
# and kept to 199), the truncating variants' 199, odd batches (the last
# cluster's 8 rows not all live) at H 128 and the tests' H 16, and a
# unidirectional H 48 (six units a CTA)
LSTM_CASES = {
    "serving": (64, 1500, 512, 128, 2, True, None),
    "serving-keep199": (64, 1500, 512, 128, 2, True, 199),
    "before-lstm": (64, 199, 512, 128, 2, True, None),
    "b1": (1, 199, 512, 128, 2, True, None),
    "b5": (5, 1500, 512, 128, 2, True, None),
    "b67": (67, 199, 512, 128, 2, True, None),
    "h16-b5": (5, 300, 128, 16, 2, True, None),
    "h16-b67": (67, 199, 128, 16, 2, True, 100),
    "h48-unidirectional": (3, 77, 40, 48, 1, False, None),
}


def _bilstm_pair(i: int, h: int, layers: int, bidir: bool, seed: int):
    """The same random ``BiLSTM`` on the CPU and on the card."""
    import copy

    from segma_tpu_torch.config import LSTMConfig
    from segma_tpu_torch.models.layers import BiLSTM

    cfg = LSTMConfig(hidden_size=h, num_layers=layers, bidirectional=bidir, dropout=0.0)
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        cpu = BiLSTM(i, cfg)
    return cpu, copy.deepcopy(cpu).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_kernel_matches_cudnn_and_the_cpu(case):
    """Under ``inference_mode`` ``BiLSTM`` runs the kernel, one launch a
    layer, within LSTM_ATOL of the CPU's f32 ``torch.lstm`` and within
    LSTM_CUDNN_ATOL of cuDNN's (TF32 off): f32 sums in another order than
    either, the rounding carried through every step; cuDNN itself lies up to
    1.2e-5 from the CPU (chip_smoke.py). Two calls, and the registered op,
    give the same bits."""
    _cuda()
    b, t, i, h, layers, bidir, keep = LSTM_CASES[case]
    cpu, card = _bilstm_pair(i, h, layers, bidir, seed=b + t)
    x = torch.from_numpy(np.random.default_rng(t).standard_normal((b, t, i)).astype(np.float32))
    with torch.inference_mode():
        before = rnn.launches
        got = card(x.cuda(), keep=keep)
        torch.cuda.synchronize()
        assert rnn.launches == before + layers
        cudnn = card.lstm(x.cuda())[0][:, :keep]
        ref = cpu(x, keep=keep)
        assert got.shape == ref.shape == (b, keep or t, (2 if bidir else 1) * h)
        errs = [float((got.cpu() - ref).abs().max()), float((got - cudnn).abs().max()),
                float((cudnn.cpu() - ref).abs().max())]
        print(f"lstm {case}: kernel from the CPU {errs[0]:.3e}, from cuDNN {errs[1]:.3e}; "
              f"cuDNN from the CPU {errs[2]:.3e}")
        assert errs[0] <= LSTM_ATOL and errs[1] <= LSTM_CUDNN_ATOL, errs
        assert torch.equal(got, card(x.cuda(), keep=keep))
        op = rnn.lstm(x.cuda(), card.weights, layers, bidir, False)
        assert torch.equal(op[:, :keep], got)


@pytest.mark.gpu
def test_lstm_call_needing_a_gradient_takes_cudnn():
    """With grad mode on and weights that require a gradient, or with
    ``train=True``, ``BiLSTM`` calls ``torch.lstm`` (cuDNN) and launches no
    kernel; under ``no_grad`` (validation) it takes the kernel."""
    _cuda()
    _, card = _bilstm_pair(64, 16, 2, True, seed=5)
    x = torch.randn((3, 50, 64), generator=torch.Generator().manual_seed(6)).cuda()
    before = rnn.launches
    out = card(x)
    assert rnn.launches == before and out.requires_grad
    assert torch.equal(out, card.lstm(x)[0])
    out.sum().backward()
    assert all(w.grad is not None for w in card.weights if w.requires_grad)
    with torch.no_grad():
        trained = card(x, train=True)
        assert rnn.launches == before
        assert torch.equal(trained, card.lstm(x)[0])
        card(x)
    assert rnn.launches == before + 2


# -- WavLM's gated relative-position bias, fused into the bf16 flash forward --------

WAVLM_ATTN_CASES = {
    "large-serving": (64, 199, 16, 64), "base-serving": (16, 199, 12, 64),
    "t800": (2, 800, 16, 64), "t1500": (2, 1500, 4, 64), "one": (3, 1, 2, 64),
    "t127": (2, 127, 4, 64), "t129": (2, 129, 4, 64), "t256": (2, 256, 3, 64),
}


def _wavlm_inputs(shape, seed):
    """bf16 q, k, v N(0, 1), gates in (1, 3), N(0, 1) rows: a bias as large
    as the scores."""
    b, t, h, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    gate = 1.0 + 2.0 * torch.rand((b, h, t), device="cuda", generator=g)
    return q, k, v, gate, torch.randn((h, 2 * t - 1), device="cuda", generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WAVLM_ATTN_CASES))
def test_wavlm_attn_kernel_matches_plain(case):
    """The bias kernel within the bf16 flash forward's tolerance (FLASH_TOL)
    of the plain version on f32 inputs, one launch a call, the same bits over
    two launches and through the registered op."""
    from segma_tpu_torch.ops import launch_counts

    _cuda()
    shape = WAVLM_ATTN_CASES[case]
    q, k, v, gate, rel = _wavlm_inputs(shape, seed=sum(shape))
    sm = 64**-0.5
    before = launch_counts()["wavlm_attn_fwd"]
    out = attention.wavlm_attn_fwd(q, k, v, gate, rel, sm)
    assert launch_counts()["wavlm_attn_fwd"] == before + 1
    ref = attention.wavlm_attention_plain(q.float(), k.float(), v.float(), gate, rel, sm)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().max()) <= FLASH_TOL * max(1.0, float(ref.abs().max()))
    # without the bias (the rows zeroed) the output moves: the bias is not dropped
    bare = attention.wavlm_attention_plain(q.float(), k.float(), v.float(), gate,
                                           torch.zeros_like(rel), sm)
    if shape[1] > 1:
        assert float((bare - ref).abs().max()) > 10 * FLASH_TOL
    assert torch.equal(out, attention.wavlm_attn_fwd(q, k, v, gate, rel, sm))
    assert torch.equal(out, attention.wavlm_attn_op(q, k, v, gate, rel, sm))


@pytest.mark.gpu
def test_wavlm_attn_kernel_rejects_what_it_does_not_take():
    _cuda()
    q, k, v, gate, rel = _wavlm_inputs((2, 64, 2, 64), seed=1)
    sm = 64**-0.5
    with pytest.raises(ValueError, match="bfloat16"):
        attention.wavlm_attn_fwd(q.float(), k.float(), v.float(), gate, rel, sm)
    with pytest.raises(ValueError, match="rel"):
        attention.wavlm_attn_fwd(q, k, v, gate, rel[:, 1:], sm)
    with pytest.raises(ValueError, match="gate"):
        attention.wavlm_attn_fwd(q, k, v, gate.double(), rel, sm)
    long = (1, attention.WAVLM_MAX_LEN + 1, 1, 64)
    lq = torch.zeros(long, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="length"):
        attention.wavlm_attn_fwd(lq, lq, lq, torch.ones(1, 1, long[1], device="cuda"),
                                 torch.zeros(1, 2 * long[1] - 1, device="cuda"), sm)


HEAD_64 = dict(hidden_size=128, n_heads=2)  # the kernel's head dim


@pytest.mark.gpu
def test_tiny_wavlm_large_layout_on_the_card_takes_the_kernel_unrecorded():
    """A WavLM-Large-layout model at tiny widths (two heads of 64) in bf16 on the
    card: served, one kernel launch a layer, within the bf16 pin (6e-2, as
    tests/test_torch_wavlm.py) of the same model's plain path on the card
    (recorded by autograd: no launch); in f32 no launch."""
    from segma_tpu_torch.ops import launch_counts
    from tests.test_torch_wavlm_large import tiny_model

    _cuda()
    model = tiny_model("bf16", device="cuda", **HEAD_64)
    wav = torch.from_numpy((np.random.default_rng(3).standard_normal((4, 16_000)) * 0.1)
                           .astype(np.float32)).cuda()
    layers = model.module.enc_cfg.n_layers
    before = launch_counts()["wavlm_attn_fwd"]
    served = model.apply(wav)
    assert launch_counts()["wavlm_attn_fwd"] == before + layers
    plain = model.module(wav)
    assert plain.requires_grad and launch_counts()["wavlm_attn_fwd"] == before + layers
    assert float((served - plain.detach()).abs().max()) <= 6e-2
    assert torch.equal(served, model.apply(wav))
    f32 = tiny_model("f32", device="cuda", **HEAD_64)
    f32.apply(wav)
    assert launch_counts()["wavlm_attn_fwd"] == before + 2 * layers
