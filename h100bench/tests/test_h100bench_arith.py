"""The benchmark's operation and byte counts against hand counts at small
shapes."""

import math

import pytest

from h100bench.metrics import flops, roofs


def test_bound_takes_the_larger_side():
    assert roofs.bound_ms(989e12, roofs.PEAK_BF16_FLOPS, 0) == (1000.0, "operations")
    ms, by = roofs.bound_ms(0, roofs.PEAK_BF16_FLOPS, 3.35e12)
    assert by == "bytes" and ms == pytest.approx(1000.0)


def test_flash_forward_counts():
    # b=1, Sq=Skv=2, h=1, d=64: QK^T and PV are 2*2*2*64 each -> 1024 flops;
    # q, k, v read and out written in bf16: 4 * 2 * 64 * 2 = 1024 bytes
    assert roofs.flash_fwd_bound_ms(1, 2, 2, 1, 64) == pytest.approx(
        max(1024 / 989e12, 1024 / 3.35e12) * 1e3)
    # unequal lengths: 4*1*1*3*5*64 flops; (2*3 + 2*5) * 64 * 2 bytes; lse: 3 * 4 more
    assert roofs.flash_fwd_bound_ms(1, 3, 5, 1, 64, lse=True) == pytest.approx(
        max(3840 / 989e12, (2048 + 12) / 3.35e12) * 1e3)
    # the serving shape is operation-bound at 0.298 ms, chip_smoke's figure
    assert roofs.flash_fwd_bound_ms(64, 1500, 1500, 8, 64) == pytest.approx(0.2982, rel=1e-3)


def test_flash_backward_counts():
    # five S x S x D products: 10 * 1 * 1 * 4 * 4 * 64 = 10240 flops;
    # 8 bf16 tensors of 4 x 64 and a 4-entry f32 lse: 8 * 256 * 2 + 16 bytes
    assert roofs.flash_bwd_bound_ms(1, 4, 1, 64) == pytest.approx(
        max(10240 / 989e12, 4112 / 3.35e12) * 1e3)
    assert roofs.flash_bwd_bound_ms(32, 199, 12, 64) == pytest.approx(0.0234, rel=2e-2)


def test_logmel_counts():
    # b=1, t=320: 2 frames of (400 + 2.5*400*log2(400) + 3*201 + 2*391) ops;
    # 320 f32 samples read, 2 x 80 f32 written
    ops = 2 * (400 + 2.5 * 400 * math.log2(400) + 603 + 782)
    assert roofs.logmel_bound_ms(1, 320) == pytest.approx(
        max(ops / 67e12, (1280 + 640) / 3.35e12) * 1e3)
    assert roofs.logmel_bound_ms(64, 480_000) == pytest.approx(0.0550, rel=1e-2)


def test_transformer_and_lstm_counts():
    # s=2, d=3, ffn=5: projections 8*2*9, scores and values 4*4*3, MLP 4*2*3*5
    assert flops.transformer_layer_flops(2, 3, 5) == 144 + 48 + 120
    # one layer, one direction, 3 steps, input 2, hidden 1: 3 * 2 * 4 * (2 + 1)
    assert flops.lstm_flops(3, 2, 1, 1, 1) == 72
    # the second layer of a bidirectional stack reads 2 * hidden
    assert flops.lstm_flops(1, 2, 1, 2, 2) == 2 * 2 * 4 * 3 + 2 * 2 * 4 * 3


def test_whisper_chunk_count_by_hand():
    enc = dict(d_model=4, encoder_layers=1, encoder_attention_heads=1, encoder_ffn_dim=8,
               num_mel_bins=2, max_source_positions=3)
    lstm = dict(hidden_size=1, num_layers=1, bidirectional=False)
    hand = (2 * 6 * 2 * 3 * 4 + 2 * 3 * 4 * 3 * 4 + flops.transformer_layer_flops(3, 4, 8)
            + 2 * 1 * 3 * 4 + 3 * 2 * 4 * (4 + 1) + 2 * 2 * 1 * 2)
    assert flops.whisper_hydra_chunk_flops(enc, lstm, 2, 2) == hand


def test_whisper_base_chunk_is_about_90_gflop():
    enc = dict(d_model=512, encoder_layers=6, encoder_attention_heads=8, encoder_ffn_dim=2048,
               num_mel_bins=80, max_source_positions=1500)
    lstm = dict(hidden_size=128, num_layers=2, bidirectional=True)
    assert flops.whisper_hydra_chunk_flops(enc, lstm, 4, 199) == pytest.approx(90.6e9, rel=1e-2)


def test_hubert_counts_by_hand():
    enc = dict(hidden_size=4, num_hidden_layers=1, num_attention_heads=1, intermediate_size=8,
               conv_dim=[2, 2], conv_kernel=[3, 2], conv_stride=[2, 2],
               num_conv_pos_embeddings=2, num_conv_pos_embedding_groups=2)
    # 9 samples -> 4 -> 2 frames
    assert flops.hubert_frames(enc, 9) == 2
    front = 2 * 4 * 1 * 3 * 2 + 2 * 2 * 2 * 2 * 2
    projection = 2 * 2 * 2 * 4
    pos = 2 * 2 * 2 * 4 * 2
    layers = flops.transformer_layer_flops(2, 4, 8)
    mix_heads = 2 * 1 * 2 * 4 + 2 * 2 * 4 * 3
    assert flops.hubert_hydra_train_crop_flops(enc, 9, 3) == (
        front + 3 * (pos + layers + mix_heads) + 2 * projection)


def test_hubert_base_step_is_about_4_tflop():
    enc = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
               conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
               num_conv_pos_embedding_groups=16)
    assert flops.hubert_frames(enc, 64_000) == 199
    assert 32 * flops.hubert_hydra_train_crop_flops(enc, 64_000, 4) == pytest.approx(
        4.2e12, rel=0.03)
