"""The five Whisper variants and ``fast_context`` against the JAX
``WhisperSegModule`` at tiny widths on 1 s chunks (n_windows 49 of the 1500
padded frames, or of the 50 frames of the chunk itself with
``fast_context``), the JAX params bridged by ``convert.flax_to_torch``; and
the multiclass loss against the JAX package's.

- f32: atol 1e-4, the pin of tests/test_torch_surgical_hydra.py;
- bf16: atol 2e-2 there, which is a few bf16 ulps of its logits (|logit|
  below 1). The MLP heads give logits up to |3.4| at these weights, where
  each bf16 side is 0.03 from the f32 model (JAX's and the port's round at
  other places: flax rounds each bias add, GELU and the LSTM to bf16), so
  the pin scales with the logits, 2e-2 * max(1, max|logit|); and the port's
  bf16 logits may be no further from the f32 model's than 1.5 times JAX's
  bf16 logits are;
- the loss and its per-class terms: atol 1e-6.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import base as jax_base
from segma_tpu.models.whisper.builders import WhisperSegModule as JaxSegModule
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxEncoderConfig
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params
from segma_tpu_torch.models import Models, base
from segma_tpu_torch.models.whisper.builders import VARIANTS
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
ATOL = {"f32": 1e-4, "bf16": 2e-2}
N_WINDOWS = 49  # 1 s chunks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(name: str, precision: str = "f32", fast_context: bool = False) -> list[str]:
    extra = [f"model.name={name}", "model.config.encoder=whisper_tiny_random",
             "audio.chunk_duration_s=1.0", f"train.precision={precision}",
             f"model.config.fast_context={str(fast_context).lower()}"]
    if VARIANTS[name][1] == "lstm":
        extra.append("model.config.lstm.hidden_size=16")
    return extra


def build_pair(name: str, precision: str = "f32", fast_context: bool = False, seed: int = 0):
    """(jax module, numpy params, port model) sharing the same weights: the
    JAX init plus N(0, 0.05) noise from numpy seed ``seed``."""
    extra = overrides(name, precision, fast_context)
    mc = jax_load_config(REPO / "segma_tpu/config/default.yml", extra).model.config
    jmod = JaxSegModule(
        enc_cfg=JaxEncoderConfig(**TINY), n_labels=4, n_windows=N_WINDOWS, variant=name,
        reduction=getattr(mc, "reduction", "weighted"), lstm=getattr(mc, "lstm", None),
        classifier_hidden=mc.classifier, fast_context=fast_context,
        dtype=jnp.float32 if precision == "f32" else jnp.bfloat16,
    )
    params = jmod.init(jax.random.key(seed), jnp.zeros((1, 16_000)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=WhisperEncoderConfig(**TINY))
    load_flax_params(model.module, params)
    return jmod, params, model


def _wav(seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((2, 16_000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("fast_context", [False, True], ids=["padded", "fast_context"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_match_jax(name, fast_context, precision):
    jmod, params, model = build_pair(name, precision, fast_context)
    wav = _wav()
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, N_WINDOWS, 4)
    assert got.dtype == np.float32
    if precision == "f32":
        np.testing.assert_allclose(got, ref, atol=ATOL["f32"])
        return
    np.testing.assert_allclose(got, ref, atol=ATOL["bf16"] * max(1.0, float(np.abs(ref).max())))
    truth = np.asarray(jmod.clone(dtype=jnp.float32).apply({"params": params}, jnp.asarray(wav)))
    assert np.abs(got - truth).max() <= 1.5 * np.abs(ref - truth).max()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_bridge_covers_every_parameter(name):
    _, params, model = build_pair(name)
    assert set(flax_to_torch(params)) == set(model.module.state_dict())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_type_follows_the_head(name):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", overrides(name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=WhisperEncoderConfig(**TINY))
    assert model.loss_type == ("hydra" if VARIANTS[name][2] == "hydra" else "multiclass")


def test_average_reduction_keeps_no_parameter():
    """``reduction=average``: no ``layer_mix`` in the JAX tree nor in the
    port's state, and the logits still agree."""
    name = "surgical_whisper"
    extra = [*overrides(name), "model.config.reduction=average"]
    mc = jax_load_config(REPO / "segma_tpu/config/default.yml", extra).model.config
    jmod = JaxSegModule(enc_cfg=JaxEncoderConfig(**TINY), n_labels=4, n_windows=N_WINDOWS,
                        variant=name, reduction="average", classifier_hidden=mc.classifier,
                        dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(0), jnp.zeros((1, 16_000)))["params"])
    assert "layer_mix" not in params
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=WhisperEncoderConfig(**TINY))
    assert not any(k.startswith("layer_mix") for k in model.module.state_dict())
    load_flax_params(model.module, params)
    wav = _wav(2)
    np.testing.assert_allclose(model.apply(torch.from_numpy(wav)).numpy(),
                               np.asarray(jmod.apply({"params": params}, jnp.asarray(wav))),
                               atol=ATOL["f32"])


def test_leaky_relu_slope_is_flax_default():
    """whisperimax's stack uses torch's default slope, which is flax's."""
    x = np.linspace(-3, 3, 13).astype(np.float32)
    ref = np.asarray(fnn.leaky_relu(jnp.asarray(x)))
    got = torch.nn.functional.leaky_relu(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(ref[x < 0], 0.01 * x[x < 0], rtol=1e-6)


def _loss_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (3, 49, 4)).astype(np.float32)
    targets = (rng.random((3, 49, 4)) > 0.6).astype(np.float32)
    targets[0, :10] = 0  # silent rows: they add nothing to the sum, and count in the mean
    weights = np.array([0.4, 1.0, 1.0, 2.0], np.float32)
    return logits, targets, weights


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "class_weights"])
def test_softmax_ce_matches_jax(weighted):
    logits, targets, weights = _loss_inputs()
    w = weights if weighted else None
    ref_total, ref_per = jax_base.softmax_ce_loss_per_class(
        jnp.asarray(logits), jnp.asarray(targets), None if w is None else jnp.asarray(w))
    got_total, got_per = base.softmax_ce_loss_per_class(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got_per.numpy(), np.asarray(ref_per), atol=1e-6)
    assert abs(float(got_total) - float(ref_total)) <= 1e-6
    assert abs(float(base.softmax_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                          None if w is None else torch.from_numpy(w)))
               - float(ref_total)) <= 1e-6


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "class_weights"])
@pytest.mark.parametrize("name", ["whisperidou", "hydra_whisper"])
def test_model_loss_matches_jax(name, weighted):
    """``SegmentationModel.loss`` dispatches on ``loss_type`` as in JAX, with
    ``train.class_weights`` multiplying the targets (multiclass) or the
    per-label terms (hydra)."""
    logits, targets, weights = _loss_inputs(4)
    extra = overrides(name)
    if weighted:
        extra.append(f"train.class_weights=[{','.join(map(str, weights.tolist()))}]")
    from segma_tpu.models import Models as JaxModels
    from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder

    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=WhisperEncoderConfig(**TINY))
    assert model.loss_type == jmodel.loss_type
    ref_total, ref_per = jmodel.loss(jnp.asarray(logits), jnp.asarray(targets))
    got_total, got_per = model.loss(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got_per.numpy(), np.asarray(ref_per), atol=1e-6)
    assert abs(float(got_total) - float(ref_total)) <= 1e-6


def test_powerset_loss_is_named_as_unported():
    _, _, model = build_pair("whisperidou")
    model.loss_type = "powerset"
    with pytest.raises(NotImplementedError, match="powerset"):
        model.loss(torch.zeros(1, 2, 4), torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="loss_type"):
        base.SegmentationModel(name="x", module=model.module, conv_settings=model.conv_settings,
                               label_encoder=model.label_encoder, config=model.config,
                               device=model.device, loss_type="focal")


@pytest.mark.parametrize("fast_context", [False, True], ids=["padded", "fast_context"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_chip_smoke_variant_configs_equal_load_config(name, fast_context):
    """chip_smoke.py builds its configs in code; each is default.yml with the
    per-model YAML and the overrides its docstring names."""
    import chip_smoke

    extra = [f"model.name={name}", "model.config.encoder=/snap/whisper_base",
             "data.dataset_path=/data/smoke", "train.precision=f32", "train.seed=0",
             f"model.config.fast_context={str(fast_context).lower()}"]
    built = chip_smoke.whisper_variant_config(name, "/snap/whisper_base", "/data/smoke",
                                              precision="f32", fast_context=fast_context, seed=0)
    assert built == load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
