"""Log-mel parity: the port's plain version against the JAX XLA path and the
Pallas kernel in interpret mode (as tests/test_pallas_melspec.py runs it),
at atol 1e-5. The CUDA kernel is held against the plain version on the card
in tests/test_torch_kernels_gpu.py."""

from __future__ import annotations

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
