"""Log-mel parity: the port's plain version against the JAX XLA path and the
Pallas kernel in interpret mode (as tests/test_pallas_melspec.py runs it),
at atol 1e-5. The CUDA kernel is held against the plain version on the card
in tests/test_torch_kernels_gpu.py; here, without the card, its tables (the
TF32 split of the basis, the sparse filterbank), its reflect-in-load index
rule and, in a numpy emulation, its 3xTF32 arithmetic are checked, and both
f32 versions are held to float64 on signals of wide dynamic range."""

from __future__ import annotations

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.ops.melspec import log_mel_spectrogram as jax_log_mel
from segma_tpu.ops.melspec import mel_filterbank as jax_mel_filterbank
from segma_tpu.ops.melspec import whisper_input_features as jax_features
from segma_tpu.ops.pallas_melspec import TILE_F, log_mel_spectrogram_pallas
from segma_tpu_torch.ops import logmel
from segma_tpu_torch.ops.melspec import (
    log_mel_spectrogram,
    mel_filterbank,
    whisper_input_features,
)

ATOL = 1e-5  # the JAX suite's log-mel bar (f32 throughout)

SHAPES = [(2, 16_000), (2, 64_000), (1, (TILE_F + 7) * 160), (1, 480_000)]
SHAPE_IDS = ["1s", "4s", "tile-tail", "30s-context"]


def _wav(shape, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def test_mel_filterbank_matches():
    np.testing.assert_array_equal(mel_filterbank(), jax_mel_filterbank())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_xla(shape):
    wav = _wav(shape)
    ref = np.asarray(jax_log_mel(jnp.asarray(wav)))
    got = log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 160, 80)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_pallas_interpret(shape):
    wav = _wav(shape, seed=1)
    ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wav), interpret=True))
    got = logmel.log_mel_spectrogram_plain(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_padded_chunk_matches_xla():
    """The main path's input: a 4 s chunk followed by zeros to 30 s."""
    wav = np.zeros((2, 480_000), np.float32)
    wav[:, :64_000] = _wav((2, 64_000), seed=2)
    ref = np.asarray(jax_log_mel(jnp.asarray(wav)))
    got = log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("t", [64_000, 480_000, 500_000], ids=["pad", "exact", "trim"])
def test_whisper_input_features(t):
    wav = _wav((1, t), seed=3)
    ref = np.asarray(jax_features(jnp.asarray(wav)))
    got = whisper_input_features(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (1, 80, 3000)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        logmel.log10_mel_cuda(torch.zeros((1, 16_000)))
    before = logmel.launches
    logmel.log10_mel(torch.zeros((1, 16_000)))  # CPU tensor: plain version
    assert logmel.launches == before


# --- the CUDA kernel's tables and arithmetic, checked without the card ------


def test_kernel_basis_is_the_tf32_split_of_the_dft_basis():
    """hi and lo are TF32 values (low 13 mantissa bits zero); hi + lo is the
    f32 basis within 2^-21 of each value (the split keeps about 21 bits); the
    rows are chunks of 40 cos bins then the same 40 sin bins, K-major."""
    hi, lo = logmel.kernel_basis()
    for part in (hi, lo):
        assert part.shape == (2 * logmel.N_BINS, 400)
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    cos_b, sin_b = (b[:, : logmel.N_BINS].T.astype(np.float64) for b in logmel.dft_basis())
    n = logmel.N_CHUNK_BINS
    rows = np.concatenate(
        [np.concatenate([cos_b[c : c + n], sin_b[c : c + n]]) for c in range(0, logmel.N_BINS, n)]
    )
    whole = hi.astype(np.float64) + lo.astype(np.float64)
    assert (np.abs(whole - rows) <= 2.0**-21 * np.abs(rows)).all()
    np.testing.assert_array_equal(hi, logmel.tf32_round(rows.astype(np.float32)))


def test_tf32_round_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # a TF32 ulp at 1
    x = np.array([one + ulp / 2, one + ulp / 2 - np.float32(2.0**-23), -(one + ulp / 2)], np.float32)
    np.testing.assert_array_equal(logmel.tf32_round(x), [one + ulp, one, -(one + ulp)])


def test_sparse_filterbank_reproduces_mel_filterbank():
    """391 weights, each filter one run of at most 14 bins below 200, each bin
    in at most two filters: the bin tables give back the dense filterbank
    exactly."""
    meta, weights = logmel.mel_bin_tables()
    fb = mel_filterbank()
    dense = np.zeros_like(fb)  # the (201, 80) filterbank the bin tables describe
    for (ch, parity, col), w in np.ndenumerate(weights):
        if w != 0:
            dense[ch * logmel.N_CHUNK_BINS + col, meta[ch, parity, col] & 0xFF] = w
    np.testing.assert_array_equal(dense, fb)
    assert np.count_nonzero(fb) == np.count_nonzero(weights) == 391
    assert max(len(w) for _, _, w in logmel.mel_runs()) == 14
    assert (np.count_nonzero(fb, axis=1) <= 2).all()
    firsts = (meta & logmel.MEL_FIRST) != 0
    lasts = (meta & logmel.MEL_LAST) != 0
    assert firsts.sum() == lasts.sum() == 80


def _span_frames(wav: np.ndarray) -> np.ndarray:
    """Frames as the kernel loads them: frame f's sample n is x[160 f + n -
    200], reflected at both ends (index -i reads x[i], T - 1 + i reads
    x[T - 1 - i]), with no padded copy of the waveform."""
    t = wav.shape[1]
    idx = 160 * np.arange(t // 160)[:, None] + np.arange(400)[None, :] - 200
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= t, 2 * (t - 1) - idx, idx)
    assert (idx >= 0).all() and (idx < t).all()
    return wav[:, idx]


@pytest.mark.parametrize("t", [201, 16_001, 42_080])
def test_reflect_in_load_matches_reflect_pad(t):
    wav = _wav((2, t), seed=4)
    ref = logmel._reflect_pad(torch.from_numpy(wav)).unfold(1, 400, 160)[:, : t // 160]
    np.testing.assert_array_equal(_span_frames(wav), ref.numpy())


def _log_mel_float64(wav: np.ndarray) -> np.ndarray:
    return chip_smoke.log_mel_float64(torch.from_numpy(wav)).numpy()


def _wide(name: str) -> np.ndarray:
    if name == "white":
        return _wav((2, 64_000), seed=5)
    return chip_smoke.wide_range_signals(8, 2 * 64_000)[name].reshape(2, 64_000)


WIDE = ["tone", "brown", "int16-quiet"]

# Measured on these inputs on an x86 CPU: the plain version 4.46e-4, 3.06e-5
# and 7.25e-7 from float64 on tone, brown and int16-quiet, XLA 4.46e-4,
# 3.06e-5 and 7.62e-7 (white noise: 1.98e-6 for both). Each is held at twice
# the larger: f32 sums taken in another order (another BLAS blocking) move
# these by tens of percent, not by 2x.
WIDE_F32_TOL = {"tone": 9e-4, "brown": 6.2e-5, "int16-quiet": 1.6e-6}


@pytest.mark.parametrize("name", WIDE)
def test_wide_range_plain_against_float64(name):
    wav = _wide(name)
    got = logmel.log_mel_spectrogram_plain(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, _log_mel_float64(wav), atol=WIDE_F32_TOL[name], rtol=0)


@pytest.mark.parametrize("name", WIDE)
def test_wide_range_xla_against_float64(name):
    wav = _wide(name)
    got = np.asarray(jax_log_mel(jnp.asarray(wav)))
    np.testing.assert_allclose(got, _log_mel_float64(wav), atol=WIDE_F32_TOL[name], rtol=0)


def _rz32(a: np.ndarray) -> np.ndarray:
    """float64 to f32 rounded toward zero, as a tensor-core f32 sum is taken."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def _f32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32).astype(np.float64)


def _log10_mel_3xtf32(
    wav: np.ndarray, large_block: int = 16, restart_small: bool = False, large_sum=_rz32,
    remove_mean: bool = True,
) -> np.ndarray:
    """A numpy emulation of the kernel's arithmetic. Samples split in TF32
    (``split_tf32``, as ``cvt.rna.tf32.f32``); per k-step of 8 samples and
    chunk, the small terms lo B_hi then hi B_lo go into one tensor-core sum,
    the large terms hi B_hi into a fresh one per ``large_block`` samples
    (the kernel: 16), each sum rounded toward zero to f32
    (``large_sum`` for the large terms) at every product; each block's large
    sum joins the chunk's f32 sum on the CUDA cores (round to nearest), the
    small sum at the chunk's end (with ``restart_small``, per block like the
    large one). With ``remove_mean`` (the kernel), each frame's f32 mean is
    taken out of its samples before the split, x - mean rounded in f32 and
    its rounding error carried exactly into the low part (TwoSum), and mean
    x column sum of the basis (``kernel_colsums``) added to each bin at the
    chunk's end. Power, the sparse mel runs in bin order and log10 in f32."""
    b_hi, b_lo = (p.astype(np.float64) for p in logmel.kernel_basis())
    frames = _span_frames(wav).reshape(-1, 400)
    mean = np.zeros((frames.shape[0], 1), np.float32)
    if remove_mean:
        mean = (frames.astype(np.float64).sum(1, keepdims=True) / 400).astype(np.float32)
    xc = frames - mean  # in f32
    err = (frames.astype(np.float64) - mean) - xc  # exact: TwoSum's error term
    hi = logmel.tf32_round(xc)
    a_hi = hi.astype(np.float64)
    a_lo = logmel.tf32_round(((xc - hi).astype(np.float64) + err).astype(np.float32))
    a_lo = a_lo.astype(np.float64)
    colsums = logmel.kernel_colsums().astype(np.float64)
    n = logmel.N_CHUNK_BINS
    power = np.zeros((frames.shape[0], logmel.N_BINS + 1), np.float32)
    for c in range(logmel.N_BINS // n):
        rows = slice(2 * n * c, 2 * n * (c + 1))
        bh, bl = b_hi[rows].T, b_lo[rows].T  # (400, 80): 40 cos, 40 sin
        acc = np.zeros((frames.shape[0], 2 * n))
        sml = np.zeros_like(acc)
        blk = np.zeros_like(acc)
        for k in range(0, 400, 8):
            s = slice(k, k + 8)
            sml = _rz32(sml + a_lo[:, s] @ bh[s])
            sml = _rz32(sml + a_hi[:, s] @ bl[s])
            blk = large_sum(blk + a_hi[:, s] @ bh[s])
            if (k + 8) % large_block == 0:
                acc, blk = _f32(acc + blk), np.zeros_like(blk)
                if restart_small:
                    acc, sml = _f32(acc + sml), np.zeros_like(sml)
        acc = _f32(_f32(acc + sml) + mean.astype(np.float64) * colsums[c])
        acc = acc.astype(np.float32)
        re, im = acc[:, :n], acc[:, n:]
        power[:, n * c : n * (c + 1)] = re * re + im * im
    mel = np.zeros((frames.shape[0], 80), np.float32)
    for m, k0, w in logmel.mel_runs():
        s = np.float32(0.0)
        for i, wi in enumerate(w):
            s = power[:, k0 + i] * wi + s  # one fmaf per bin, in order
        mel[:, m] = s
    return np.log10(np.maximum(mel, np.float32(1e-10))).reshape(wav.shape[0], -1, 80)


@pytest.mark.parametrize("name", ["white", *WIDE])
def test_3xtf32_emulation_meets_the_gpu_bound(name):
    """The kernel's arithmetic, emulated, meets the bound the GPU test holds
    the kernel to on these signals (tests/test_torch_kernels_gpu.py): white
    noise within 1e-5 of the f32 plain version, each wide-range signal within
    max(2 x the plain version's own error, 1e-5) of float64."""
    wav = _wide(name)
    plain = logmel.log_mel_spectrogram_plain(torch.from_numpy(wav)).numpy()
    got = logmel.finish(torch.from_numpy(_log10_mel_3xtf32(wav))).numpy()
    if name == "white":
        np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
        return
    ref = _log_mel_float64(wav)
    assert np.abs(got - ref).max() <= max(2 * np.abs(plain - ref).max(), ATOL)


def test_logmel_bound_is_the_bytes_at_the_serving_shape():
    """chip_smoke.py's bound for the kernel at (64, 480000): the FFT and
    sparse mel need about 2.0 GFLOP (0.030 ms at the f32 peak), less than the
    time to read 122.9 MB and write 61.4 MB at HBM rate (0.055 ms). The
    dense-DFT floors of the kernel's design are reported beside it."""
    b = chip_smoke.logmel_bounds(64, 480_000)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bytes_ms"] == pytest.approx((122_880_000 + 61_440_000) / 3.35e9)
    assert b["fft_ops_ms"] == pytest.approx(0.0299, abs=1e-4)
    assert b["dense_dft_3xtf32_ms"] == pytest.approx(0.3742, abs=1e-4)
    assert b["dense_dft_f32_ms"] == pytest.approx(1.0138, abs=1e-4)


def _bulk_count(got: np.ndarray, ref: np.ndarray) -> int:
    return int((np.abs(got - ref) > ATOL).sum())


@pytest.fixture(scope="module")
def brown_bulk():
    """Brown noise as chip_smoke.py draws it at (64, 64000), its first 4
    rows: (waveform, float64 reference, the f32 plain version's count of
    outputs more than 1e-5 from it)."""
    wav = np.ascontiguousarray(
        chip_smoke.wide_range_signals(8, 64 * 64_000)["brown"].reshape(64, 64_000)[:4])
    ref = _log_mel_float64(wav)
    plain = logmel.log_mel_spectrogram_plain(torch.from_numpy(wav)).numpy()
    return wav, ref, _bulk_count(plain, ref)


def _emulated_count(brown_bulk, **kw) -> int:
    wav, ref, _ = brown_bulk
    return _bulk_count(logmel.finish(torch.from_numpy(_log10_mel_3xtf32(wav, **kw))).numpy(), ref)


def test_large_term_truncations_set_the_bulk_count(brown_bulk):
    """Which accumulator sets how many brown-noise outputs lie more than 1e-5
    from float64 (the kernel without the frame's mean taken out: 2.4x the
    plain version's count on the card), and what the kernel does about it.
    In the emulation with
    truncating sums, without the frame's mean taken out: restarting the
    small-term accumulator per block does not lower the count (one more
    rounding per block); summing the large terms to nearest instead of
    toward zero brings it to the plain version's; a fresh large-term sum per
    8 samples takes out part of the excess (on the card: 12%). With each
    frame's mean taken out first (the kernel), the large terms no longer
    carry the frame's offset, and no output is more than 1e-5 off."""
    _, _, plain = brown_bulk
    no_mean = _emulated_count(brown_bulk, remove_mean=False)
    restarted = _emulated_count(brown_bulk, restart_small=True, remove_mean=False)
    nearest = _emulated_count(brown_bulk, large_sum=_f32, remove_mean=False)
    per8 = _emulated_count(brown_bulk, large_block=8, remove_mean=False)
    kernel = _emulated_count(brown_bulk)
    print(f"brown (4, 64000) outputs more than 1e-5 from float64: plain {plain}, mean kept "
          f"{no_mean}, "
          f"small sum restarted {restarted}, large sums to nearest {nearest}, per 8 samples "
          f"{per8}, kernel (mean out) {kernel}")
    assert no_mean > 1.5 * plain
    assert restarted >= 0.95 * no_mean
    assert nearest <= 1.1 * plain
    assert per8 < no_mean
    assert kernel <= 0.1 * plain


def test_kernel_colsums_carry_the_mean():
    """The column sums of the f32 basis: 200 at bin 0's cos row and -100 at
    bin 1's (the periodic Hann window's spectrum), under 1e-4 elsewhere; the
    DFT of x is the DFT of x - m plus m times them, for any m."""
    sums = logmel.kernel_colsums()
    assert sums.shape == (5, 80)
    cos_sums, sin_sums = sums[:, :40].reshape(-1), sums[:, 40:].reshape(-1)
    assert cos_sums[0] == pytest.approx(200, abs=1e-3)
    assert cos_sums[1] == pytest.approx(-100, abs=1e-3)
    assert np.abs(cos_sums[2:]).max() < 1e-4 and np.abs(sin_sums).max() < 1e-4
    cos_b, sin_b = (b[:, : logmel.N_BINS].astype(np.float64) for b in logmel.dft_basis())
    x = _span_frames(_wav((1, 16_000), seed=6) + np.float32(0.3)).reshape(-1, 400)
    x = x.astype(np.float64)
    m = x.mean(1, keepdims=True)
    for basis, col in ((cos_b, cos_sums), (sin_b, sin_sums)):
        np.testing.assert_allclose((x - m) @ basis + m * col.astype(np.float64), x @ basis,
                                   atol=1e-9 * np.abs(x @ basis).max())
