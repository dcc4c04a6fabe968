"""Whole-model parity: the port's ``surgical_hydra`` against the JAX
``WhisperSegModule`` at tiny widths on (2, 64000) waveforms, with the JAX
params bridged by ``convert.flax_to_torch``.

- f32: atol 1e-4 (f32 sums in other orders through the whole stack);
- bf16: atol 2e-2. Both round every encoder activation to bf16, but at
  other places (flax rounds GELU and the LSTM's recurrent input to bf16,
  the port runs the LSTM in f32), so they differ by a few bf16 ulps of
  logits of order 1.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models.whisper.builders import WhisperSegModule as JaxSegModule
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxEncoderConfig
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.whisper.builders import build_whisper_model
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
ATOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    PyTorch's thread pool oversubscribed by them slows the LSTM loop tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(precision: str) -> list[str]:
    return [
        "model.config.encoder=whisper_tiny_random",
        "model.config.lstm.hidden_size=16",
        f"train.precision={precision}",
    ]


def build_pair(precision: str, seed: int = 0):
    """(jax module, numpy params, port model) sharing the same weights."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", _overrides(precision))
    jmod = JaxSegModule(
        enc_cfg=JaxEncoderConfig(**TINY), n_labels=4, n_windows=199,
        variant="surgical_hydra", lstm=jcfg.model.config.lstm,
        dtype=jnp.float32 if precision == "f32" else jnp.bfloat16,
    )
    params = jmod.init(jax.random.key(seed), jnp.zeros((1, 64_000)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", _overrides(precision))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=WhisperEncoderConfig(**TINY),
        )
    load_flax_params(model.module, params)
    return jmod, params, model


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_logits_match_jax(precision):
    jmod, params, model = build_pair(precision)
    wav = (np.random.default_rng(1).standard_normal((2, 64_000)) * 0.1).astype(np.float32)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 199, 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL[precision])


def test_bridge_covers_every_parameter():
    _, params, model = build_pair("f32")
    assert set(flax_to_torch(params)) == set(model.module.state_dict())


def test_builder_geometry_and_variants():
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", _overrides("bf16"))
    enc = MultiLabelEncoder(cfg.data.classes)
    with pytest.warns(UserWarning, match="randomly"):
        model = Models["surgical_hydra"](enc, cfg, device="cpu")
    assert model.n_windows == 199 and model.n_labels == 4
    assert model.module.encoder.cfg == WhisperEncoderConfig.tiny()
    assert model.module.encoder.dtype == torch.bfloat16
    with pytest.raises(KeyError, match="whisperus"):
        build_whisper_model("whisperus", enc, cfg, device="cpu")
    with pytest.raises(KeyError, match="whisperus"):
        Models["whisperus"]


def test_builder_weights_follow_the_generator():
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", _overrides("bf16"))
    enc = MultiLabelEncoder(cfg.data.classes)
    kw = dict(device="cpu", enc_cfg=WhisperEncoderConfig(**TINY))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = build_whisper_model("surgical_hydra", enc, cfg, generator=torch.Generator().manual_seed(3), **kw)
        b = build_whisper_model("surgical_hydra", enc, cfg, generator=torch.Generator().manual_seed(3), **kw)
        c = build_whisper_model("surgical_hydra", enc, cfg, generator=torch.Generator().manual_seed(4), **kw)
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["heads.heads.weight"], sc["heads.heads.weight"])
