"""Building-block parity: BiLSTM (with and without ``keep``),
LayerWeightedSum, HydraHeads and MLPHead against the flax modules with the
same (bridged) weights, in f32 at atol 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.config import LSTMConfig as JaxLSTMConfig
from segma_tpu.models import layers as jl
from segma_tpu_torch.config import LSTMConfig
from segma_tpu_torch.convert import lstm_state
from segma_tpu_torch.models import layers

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    PyTorch's thread pool oversubscribed by them slows the LSTM loop tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(np.float32), params
    )


@pytest.fixture(scope="module")
def bilstm_pair():
    kw = dict(hidden_size=16, num_layers=2, bidirectional=True, dropout=0.0)
    x = _x((2, 50, 8))
    jmod = jl.BiLSTM(JaxLSTMConfig(**kw))
    params = _noisy(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    mod = layers.BiLSTM(8, LSTMConfig(**kw)).eval()
    mod.lstm.load_state_dict(lstm_state(params), strict=True)
    return jmod, params, mod, x


@pytest.mark.parametrize("keep", [None, 20], ids=["full", "keep20"])
def test_bilstm_matches_flax(bilstm_pair, keep):
    jmod, params, mod, x = bilstm_pair
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), keep=keep))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x), keep=keep).numpy()
    assert got.shape == ref.shape == (2, keep or 50, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_bilstm_keep_is_exact_prefix(bilstm_pair):
    _, _, mod, x = bilstm_pair
    with torch.inference_mode():
        full = mod(torch.from_numpy(x))
        kept = mod(torch.from_numpy(x), keep=20)
    assert torch.equal(kept, full[:, :20])


def test_unidirectional_lstm_matches_flax():
    kw = dict(hidden_size=8, num_layers=1, bidirectional=False, dropout=0.0)
    x = _x((3, 12, 5), seed=2)
    jmod = jl.BiLSTM(JaxLSTMConfig(**kw))
    params = _noisy(jmod.init(jax.random.key(1), jnp.asarray(x))["params"], 3)
    mod = layers.BiLSTM(5, LSTMConfig(**kw)).eval()
    mod.lstm.load_state_dict(lstm_state(params, bidirectional=False), strict=True)
    with torch.inference_mode():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("reduction", ["weighted", "average"])
def test_layer_weighted_sum_matches_flax(reduction):
    h = _x((4, 2, 7, 16), seed=4)
    jmod = jl.LayerWeightedSum(n_layers=4, reduction=reduction)
    variables = jmod.init(jax.random.key(0), jnp.asarray(h))
    w = _x((4,), seed=5)
    if reduction == "weighted":
        variables = {"params": {"layer_weights": jnp.asarray(w)}}
    ref = np.asarray(jmod.apply(variables, jnp.asarray(h)))
    mod = layers.LayerWeightedSum(4, reduction)
    with torch.no_grad():
        mod.layer_weights.copy_(torch.from_numpy(w))
    got = mod(torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_layer_weighted_sum_rejects_unknown_reduction():
    with pytest.raises(ValueError, match="reduction"):
        layers.LayerWeightedSum(3, "max")


def test_hydra_heads_match_flax():
    x = _x((2, 9, 32), seed=6)
    jmod = jl.HydraHeads(n_labels=4)
    params = _noisy(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], 7)
    mod = layers.HydraHeads(32, 4)
    with torch.no_grad():
        mod.heads.weight.copy_(torch.from_numpy(params["heads"]["kernel"].T))
        mod.heads.bias.copy_(torch.from_numpy(params["heads"]["bias"]))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, jnp.asarray(x))), atol=ATOL)


def test_mlp_head_matches_flax():
    x = _x((2, 9, 32), seed=8)
    jmod = jl.MLPHead(hidden=(16,), n_out=4)
    params = _noisy(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], 9)
    mod = layers.MLPHead(32, (16,), 4)
    with torch.no_grad():
        for lin, name in ((mod.hidden[0], "Dense_0"), (mod.out, "Dense_1")):
            lin.weight.copy_(torch.from_numpy(params[name]["kernel"].T))
            lin.bias.copy_(torch.from_numpy(params[name]["bias"]))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, jnp.asarray(x))), atol=ATOL)
