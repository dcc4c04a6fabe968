"""Building-block parity: BiLSTM (with and without ``keep``),
LayerWeightedSum, HydraHeads and MLPHead against the flax modules with the
same (bridged) weights, in f32 at atol 1e-5; and the BiLSTM's kernel path
on the CPU (``ops.rnn``): its plain version, its routing and size rules."""

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
from segma_tpu_torch.ops import rnn

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


def test_bilstm_dropout_between_layers_runs_each_layer_alone():
    """``train=True`` with dropout: layer 0, the generator's dropout mask on
    its output, then layer 1, each layer on the LSTM's own weights; with
    ``train=False`` no dropout, the one cuDNN-style call."""
    cfg = LSTMConfig(hidden_size=8, num_layers=2, bidirectional=True, dropout=0.5)
    mod = layers.BiLSTM(5, cfg)
    x = torch.from_numpy(_x((2, 11, 5), seed=12))
    got = mod(x, train=True, generator=torch.Generator().manual_seed(3))
    singles = []
    for layer, width in ((0, 5), (1, 16)):
        single = torch.nn.LSTM(width, 8, bidirectional=True, batch_first=True)
        single.load_state_dict({k.replace(f"_l{layer}", "_l0"): v
                                for k, v in mod.lstm.state_dict().items() if f"_l{layer}" in k})
        singles.append(single)
    with torch.no_grad():
        h = singles[0](x)[0]
        h = layers.dropout(h, 0.5, torch.Generator().manual_seed(3))
        want = singles[1](h)[0]
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6)
        np.testing.assert_array_equal(mod(x).numpy(), mod.lstm(x)[0].numpy())
    with pytest.raises(ValueError, match="Generator"):
        mod(x, train=True)


@pytest.mark.parametrize("train", [False, True], ids=["one_cudnn_call", "per_layer_dropout"])
def test_bf16_model_runs_its_f32_parts_without_tf32(monkeypatch, train):
    """A bf16 ``surgical_hydra`` computes its BiLSTM (one cuDNN call, or one
    ``torch.lstm`` per layer under dropout) and its hydra heads in f32: each
    runs with TF32 off in cuDNN and cuBLAS though the caller allowed both,
    and the caller's flags are back after the forward."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, ModelConfig, SurgicalHydraConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = Config(
        data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"]),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False),
        model=ModelConfig(name="surgical_hydra", config=SurgicalHydraConfig(
            encoder="whisper_tiny_random", encoder_layers=[], reduction="weighted",
            lstm=LSTMConfig(hidden_size=8, num_layers=2, bidirectional=True, dropout=0.5),
            classifier=256, fast_context=True)),
    )
    model = Models["surgical_hydra"](
        MultiLabelEncoder(cfg.data.classes), cfg,
        device="cpu", generator=torch.Generator().manual_seed(0),
        enc_cfg=WhisperEncoderConfig(d_model=32, n_heads=1, n_layers=1, ffn_dim=64))
    assert model.compute_dtype == torch.bfloat16
    seen = []

    def flags(*_):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    module = model.module
    module.lstm_shared.lstm.register_forward_pre_hook(flags)
    module.heads.heads.register_forward_pre_hook(flags)
    real_lstm = torch.lstm

    def lstm(*args):
        flags()
        return real_lstm(*args)

    monkeypatch.setattr(torch, "lstm", lstm)
    caller = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        wav = torch.from_numpy(_x((2, 64_000)) * 0.1)
        with torch.no_grad():
            module(wav, train=train, generator=torch.Generator().manual_seed(1))
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = caller
    # heads, and the LSTM's one call or its two layers
    assert len(seen) == (3 if train else 2) and set(seen) == {(False, False)}
    assert after == (True, True)


# The LSTM's kernel path (ops/rnn.py) on the CPU: the plain version of its
# decomposition, the routing rule, and the size rule

LSTM_PLAIN_CASES = {  # (B, T, I, H, layers, bidirectional)
    "bidirectional-2": (2, 50, 8, 16, 2, True),
    "unidirectional-1": (3, 12, 5, 8, 1, False),
    "odd-h48": (5, 33, 24, 48, 2, True),
    "one-step": (1, 1, 4, 16, 2, True),
}


@pytest.mark.parametrize("case", list(LSTM_PLAIN_CASES))
def test_lstm_plain_matches_torch_lstm(case):
    """The kernel's decomposition, in PyTorch operations (one input GEMM a
    layer with both biases, then the steps, the reverse direction from the
    last), against ``torch.lstm``: the same f32 operations per step in
    another order, over at most 50 steps."""
    b, t, i, h, n_layers, bidir = LSTM_PLAIN_CASES[case]
    torch.manual_seed(t)
    lstm = torch.nn.LSTM(i, h, num_layers=n_layers, bidirectional=bidir, batch_first=True)
    weights = [getattr(lstm, n) for n in lstm._flat_weights_names]
    x = torch.from_numpy(_x((b, t, i), seed=t))
    with torch.no_grad():
        got = rnn.lstm_plain(x, weights, n_layers, bidir)
        np.testing.assert_allclose(got.numpy(), lstm(x)[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("device,hidden,train,needs_grad,want", [
    ("cuda", 128, False, False, True),
    ("cuda", 16, False, False, True),
    ("cuda", 256, False, False, True),
    ("cpu", 128, False, False, False),
    ("cuda", 128, True, False, False),
    ("cuda", 128, False, True, False),
    ("cuda", 24, False, False, False),
    ("cuda", 272, False, False, False),
    ("cuda", 8, False, False, False),
], ids=["serving", "h16", "h256", "cpu", "training", "gradient", "h24", "h272", "h8"])
def test_lstm_kernel_path_rule(device, hidden, train, needs_grad, want):
    assert rnn.kernel_path(torch.device(device), hidden, train, needs_grad) is want


@pytest.mark.parametrize("mode,want", [
    ("inference_mode", False), ("no_grad", False), ("grad", True),
    ("grad_frozen", False), ("grad_frozen_input", True),
])
def test_bilstm_asks_for_the_kernel_without_gradient(monkeypatch, mode, want):
    """``BiLSTM.takes_kernel`` hands ``kernel_path`` whether a gradient is
    wanted: grad mode on and the input or a weight requiring one."""
    mod = layers.BiLSTM(5, LSTMConfig(hidden_size=16, num_layers=2, bidirectional=True,
                                      dropout=0.0))
    seen = []
    monkeypatch.setattr(rnn, "kernel_path", lambda *args: seen.append(args) or False)
    x = torch.from_numpy(_x((2, 7, 5)))
    if mode.startswith("grad_frozen"):
        for w in mod.weights:
            w.requires_grad_(False)
        x.requires_grad_(mode == "grad_frozen_input")
    context = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(
        mode, torch.enable_grad)
    with context():
        mod.takes_kernel(x, False)
    assert seen == [(x.device, 16, False, want)]


@pytest.mark.parametrize("takes", [True, False], ids=["kernel", "torch_lstm"])
def test_bilstm_forward_follows_the_rule(monkeypatch, takes):
    """Where the rule takes the call, ``BiLSTM`` runs ``rnn.lstm_cuda`` (here
    stood in for by the plain version) on its flat weights, and ``keep``
    slices its output; else its own ``torch.lstm`` call."""
    mod = layers.BiLSTM(5, LSTMConfig(hidden_size=16, num_layers=2, bidirectional=True,
                                      dropout=0.0))
    calls = []

    def fake(x, weights, n_layers, bidir):
        calls.append((tuple(x.shape), n_layers, bidir))
        assert all(w is v for w, v in zip(weights, mod.lstm._flat_weights))
        return rnn.lstm_plain(x, weights, n_layers, bidir)

    monkeypatch.setattr(rnn, "lstm_cuda", fake)
    monkeypatch.setattr(mod, "takes_kernel", lambda x, train: takes)
    x = torch.from_numpy(_x((2, 9, 5), seed=3))
    with torch.inference_mode():
        got = mod(x, keep=4)
        ref = mod.lstm(x)[0][:, :4]
    assert calls == ([((2, 9, 5), 2, True)] if takes else [])
    if takes:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("hidden", [8, 24, 264, 512])
def test_lstm_kernel_refuses_an_unsupported_hidden_size_before_any_launch(monkeypatch, hidden):
    """The size rule raises before the library is built or a kernel launched."""
    def never(*_):
        raise AssertionError("reached the kernel library")

    monkeypatch.setattr(rnn._build, "library", never)
    monkeypatch.setattr(rnn, "launch", never)
    lstm = torch.nn.LSTM(4, hidden, batch_first=True)
    with pytest.raises(ValueError, match="hidden size"):
        rnn.lstm_cuda(torch.zeros((1, 3, 4)), list(lstm._flat_weights), 1, False)
    assert not rnn.supports(hidden)


def test_lstm_kernel_refuses_a_cpu_tensor_before_any_launch(monkeypatch):
    def never(*_):
        raise AssertionError("reached the kernel library")

    monkeypatch.setattr(rnn._build, "library", never)
    lstm = torch.nn.LSTM(4, 16, batch_first=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rnn.lstm_cuda(torch.zeros((1, 3, 4)), list(lstm._flat_weights), 1, False)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "grad", "train"])
def test_bilstm_on_the_cpu_is_its_torch_lstm(mode):
    """On the CPU every call is the module's own ``torch.lstm``, bit for bit;
    the registered op's CPU implementation too."""
    mod = layers.BiLSTM(5, LSTMConfig(hidden_size=16, num_layers=2, bidirectional=True,
                                      dropout=0.0))
    x = torch.from_numpy(_x((2, 13, 5), seed=4))
    context = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(
        mode, torch.enable_grad)
    with context():
        got = mod(x, train=mode == "train")
        ref = mod.lstm(x)[0]
        op = rnn.lstm(x, mod.weights, 2, True, mode == "train")
    assert torch.equal(got, ref) and torch.equal(op, ref)
