"""Whisper encoder parity: the port against the flax encoder with the same
(bridged) weights, every hidden state, in f32.

Tolerance atol 1e-4: two f32 layers of conv, matmul, softmax and LayerNorm
over 1500 positions, summed in other orders by XLA and by PyTorch, leave
differences of a few 1e-6 relative on activations of order 1-10."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.models.whisper.encoder import WhisperEncoder as JaxEncoder
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxEncoderConfig
from segma_tpu.models.whisper.encoder import sinusoidal_positions as jax_positions
from segma_tpu_torch.convert import flax_to_torch
from segma_tpu_torch.models.whisper.encoder import (
    WhisperEncoder,
    WhisperEncoderConfig,
    sinusoidal_positions,
)

TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    PyTorch's thread pool oversubscribed by them slows the LSTM loop tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(params, seed: int):
    """numpy copy of ``params`` with noise on every leaf, so biases and
    LayerNorm parameters are not at their initial zeros and ones."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )


def test_config_sizes_match():
    for name in ("tiny", "base"):
        assert vars(getattr(WhisperEncoderConfig, name)()) == vars(
            getattr(JaxEncoderConfig, name)()
        )


def test_sinusoidal_positions_match():
    np.testing.assert_array_equal(sinusoidal_positions(1500, 64), jax_positions(1500, 64))


def test_hidden_states_match_flax():
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    jenc = JaxEncoder(JaxEncoderConfig(**TINY), dtype=jnp.float32)
    params = _perturbed(
        jenc.init(jax.random.key(0), jnp.asarray(mel), output_hidden_states=True)["params"], 1
    )
    ref_last, ref_hidden = jenc.apply(
        {"params": params}, jnp.asarray(mel), output_hidden_states=True
    )

    enc = WhisperEncoder(WhisperEncoderConfig(**TINY), dtype=torch.float32)
    enc.load_state_dict(flax_to_torch(params), strict=True)
    with torch.inference_mode():
        last, hidden = enc(torch.from_numpy(mel), output_hidden_states=True)
    assert len(hidden) == len(ref_hidden) == TINY["n_layers"] + 1
    for i, (got, ref) in enumerate(zip(hidden, ref_hidden)):
        assert got.shape == (2, 1500, TINY["d_model"]), i
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, err_msg=f"hidden {i}")
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), atol=ATOL)
    # HF indexing: the last entry carries the final LayerNorm
    torch.testing.assert_close(hidden[-1], last)
