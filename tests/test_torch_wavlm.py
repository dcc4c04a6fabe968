"""``surgical_wavlm_hydra`` against the JAX package's ``WavLMSegModule`` at
the tiny widths of tests/test_wavlm.py (hidden 64, 2 layers, 4 heads of 16,
32 buckets out to 80, a front end of 32 channels), the JAX params (init
plus N(0, 0.05) from numpy seed 0) bridged by ``convert.flax_to_torch``.

- the bucket table: exactly JAX's;
- one attention, one layer and the transformer: f32 1e-5, bf16 6e-2, the
  HuBERT port's bf16 pin (tests/test_torch_hubert.py: both sides round
  each GEMM and bias add to bf16, at other places);
- logits: f32 1e-4, bf16 6e-2, as HuBERT's;
- an HF snapshot (``transformers``' ``save_pretrained``, and
  ``chip_smoke.write_wavlm_snapshot``'s) converts to JAX's trees exactly;
- one f32 train step, dropout 0, as flax trees: loss 1e-5, gradients 1e-4,
  updates 1e-5 where a gradient is not within 100 times AdamW's eps of zero
  (tests/test_torch_vad.py);
- ``train.remat`` gives the same loss and gradients bit for bit.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.wavlm.convert import convert_wavlm_params as jax_convert_wavlm
from segma_tpu.models.wavlm.encoder import WavLMAttention as JaxAttention
from segma_tpu.models.wavlm.encoder import WavLMEncoderConfig as JaxEncoderConfig
from segma_tpu.models.wavlm.encoder import WavLMTransformer as JaxTransformer
from segma_tpu.models.wavlm.encoder import WavLMTransformerLayer as JaxLayer
from segma_tpu.models.wavlm.encoder import relative_position_buckets as jax_buckets
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params, torch_to_flax
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.wavlm import WAVLM_CONV_SETTINGS
from segma_tpu_torch.models.wavlm.convert import convert_wavlm_params, read_wavlm_config
from segma_tpu_torch.models.wavlm.encoder import (
    WavLMAttention,
    WavLMEncoderConfig,
    WavLMTransformerLayer,
    relative_position_buckets,
)
from segma_tpu_torch.train import forward_backward, make_optimizer, make_train_step
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_checkpoint import _assert_trees_equal
from tests.test_torch_lstm_train import _leaves
from tests.test_torch_vad import assert_updates_match

REPO = Path(__file__).resolve().parent.parent
TINY = dict(hidden_size=64, n_layers=2, n_heads=4, ffn_dim=128, conv_dim=(32,) * 7,
            pos_conv_kernel=16, pos_conv_groups=4, num_buckets=32, max_distance=80)
ATOL = {"f32": 1e-5, "bf16": 6e-2}
LOGITS_ATOL = {"f32": 1e-4, "bf16": 6e-2}
DTYPE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-3
EXTRA = ["model.name=surgical_wavlm_hydra", "model.config.wav_encoder=missing_wavlm_snapshot",
         "audio.strict_frames=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(params, seed: int = 0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)


def build_pair(precision: str = "f32", *extra: str):
    """(JAX model with its params, port model with the same weights)."""
    overrides = [*EXTRA, f"train.precision={precision}", *extra]
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", overrides)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", overrides)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no snapshot: random encoders, on purpose
        jmodel = JaxModels["surgical_wavlm_hydra"](JaxEncoder(jcfg.data.classes), jcfg)
        model = Models["surgical_wavlm_hydra"](MultiLabelEncoder(cfg.data.classes), cfg,
                                               device="cpu", enc_cfg=WavLMEncoderConfig(**TINY))
    jmodel.module = jmodel.module.clone(enc_cfg=JaxEncoderConfig(**TINY))
    jmodel.params = _noisy(jmodel.init_params(jax.random.key(0)))
    load_flax_params(model.module, jmodel.params)
    return jmodel, model


def _x(shape: tuple[int, ...], seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("length", [1, 7, 49, 199, 400])
@pytest.mark.parametrize("buckets", [(320, 800), (32, 80)])
def test_buckets_equal_jax(length, buckets):
    ours = relative_position_buckets(length, *buckets)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, jax_buckets(length, *buckets))


def _jax_layer_pair(cls, precision: str, **kw):
    jdt, tdt = DTYPE[precision]
    cfg = JaxEncoderConfig(**TINY)
    if cls is JaxAttention:
        jmod = JaxAttention(cfg.hidden_size, cfg.n_heads, cfg.num_buckets, cfg.max_distance,
                            has_relative_position_bias=True, dtype=jdt)
        ours = WavLMAttention(WavLMEncoderConfig(**TINY), has_relative_position_bias=True)
    else:
        jmod = JaxLayer(cfg, has_relative_position_bias=True, dtype=jdt)
        ours = WavLMTransformerLayer(WavLMEncoderConfig(**TINY), has_relative_position_bias=True)
    x = _x((2, 49, 64))
    params = _noisy(jmod.init(jax.random.key(0), jnp.asarray(x, jdt), None)["params"])
    ours.load_state_dict(flax_to_torch(params), strict=True)
    ref_out, ref_bias = jmod.apply({"params": params}, jnp.asarray(x, jdt), None)
    with torch.no_grad():
        out, bias = ours(torch.from_numpy(x).to(tdt), None)
    return (np.asarray(ref_out.astype(jnp.float32)), np.asarray(ref_bias)), (
        out.float().numpy(), bias.numpy())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["attention", "layer"])
def test_attention_and_layer_match_jax(which, precision):
    (ref_out, ref_bias), (out, bias) = _jax_layer_pair(
        JaxAttention if which == "attention" else JaxLayer, precision)
    assert out.shape == ref_out.shape == (2, 49, 64) and bias.shape == (4, 49, 49)
    np.testing.assert_array_equal(bias, ref_bias)  # the gather, as a one-hot product
    np.testing.assert_allclose(out, ref_out, atol=ATOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_transformer_matches_jax(precision):
    jmodel, model = build_pair(precision)
    feats = _x((2, 49, 32), seed=3)
    jdt, _ = DTYPE[precision]
    ref_last, ref_hidden = JaxTransformer(JaxEncoderConfig(**TINY), dtype=jdt).apply(
        {"params": jmodel.params["encoder"]}, jnp.asarray(feats), output_hidden_states=True)
    with torch.no_grad():
        last, hidden = model.module.encoder(torch.from_numpy(feats), output_hidden_states=True)
    assert len(hidden) == len(ref_hidden) == TINY["n_layers"] + 1
    np.testing.assert_allclose(last.float().numpy(), np.asarray(ref_last.astype(jnp.float32)),
                               atol=ATOL[precision])
    for ours, theirs in zip(hidden, ref_hidden):
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                                   atol=ATOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_logits_match_jax(precision):
    jmodel, model = build_pair(precision)
    wav = _x((2, 16_000), seed=1) * 0.1
    ref = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 49, 4)
    np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL[precision])


def test_tree_names_and_geometry():
    jmodel, model = build_pair()
    assert set(flax_to_torch(jmodel.params)) == set(model.module.state_dict())
    _assert_trees_equal(torch_to_flax(model.module), jax.tree.map(np.asarray, jmodel.params))
    attn = jmodel.params["encoder"]["layers_0"]["attention"]
    assert attn["rel_attn_embed"].shape == (32, 4)  # a bare leaf, no .weight
    assert "rel_attn_embed" not in jmodel.params["encoder"]["layers_1"]["attention"]
    assert attn["gru_rel_pos_const"].shape == (1, 4, 1, 1)
    assert model.frozen_prefixes == jmodel.frozen_prefixes == ("feature_extractor",)
    assert WAVLM_CONV_SETTINGS.rf_step == 320 and model.n_windows == 199


def _hf_snapshot(out: Path) -> None:
    from transformers import WavLMConfig, WavLMModel

    cfg = WavLMConfig(
        hidden_size=TINY["hidden_size"], num_hidden_layers=TINY["n_layers"],
        num_attention_heads=TINY["n_heads"], intermediate_size=TINY["ffn_dim"],
        conv_dim=list(TINY["conv_dim"]), conv_kernel=[10, 3, 3, 3, 3, 2, 2],
        conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=TINY["pos_conv_kernel"],
        num_conv_pos_embedding_groups=TINY["pos_conv_groups"],
        num_buckets=TINY["num_buckets"], max_bucket_distance=TINY["max_distance"],
        do_stable_layer_norm=False, feat_extract_norm="group")
    torch.manual_seed(0)
    model = WavLMModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    model.save_pretrained(out)


@pytest.mark.parametrize("writer", ["transformers", "chip_smoke"])
def test_snapshot_converts_as_jax(writer, tmp_path):
    snap = tmp_path / "wavlm"
    if writer == "transformers":
        _hf_snapshot(snap)
    else:
        dims = dict(chip_smoke.HUBERT_BASE, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128, conv_dim=[32] * 7,
                    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                    num_buckets=32, max_bucket_distance=80)
        chip_smoke.write_wavlm_snapshot(snap, seed=3, dims=dims)
    cfg, fe, tr = convert_wavlm_params(snap)
    jcfg, jfe, jtr = jax_convert_wavlm(snap)
    # JAX's config has the base layout's fields; the port's adds the layout
    # keys (feat_extract_norm, conv_bias, stable_layer_norm), here the base's
    assert cfg == read_wavlm_config(snap)
    assert {k: v for k, v in vars(cfg).items() if k in vars(jcfg)} == vars(jcfg)
    assert (cfg.feat_extract_norm, cfg.conv_bias, cfg.stable_layer_norm) == ("group", False, False)
    _assert_trees_equal(fe, jax.tree.map(np.asarray, jfe))
    _assert_trees_equal(tr, jax.tree.map(np.asarray, jtr))
    # a model built on the snapshot holds its tensors
    overrides = [*EXTRA[:1], f"model.config.wav_encoder={snap}", "audio.strict_frames=true"]
    model = Models["surgical_wavlm_hydra"](
        MultiLabelEncoder(["a", "b"]), load_config(
            REPO / "segma_tpu_torch/config/default.yml", overrides), device="cpu")
    tree = torch_to_flax(model.module)
    _assert_trees_equal(tree["encoder"], tr)
    _assert_trees_equal(tree["feature_extractor"], fe)


@pytest.fixture(scope="module")
def one_step():
    jmodel, model = build_pair()
    jmodel.module = jmodel.module.clone(dropout=0.0)
    model.module.dropout = 0.0
    rng = np.random.default_rng(4)
    batch = {"x": (rng.standard_normal((2, 16_000)) * 0.1).astype(np.float32),
             "y": (rng.random((2, 49, 4)) > 0.7).astype(np.float32)}

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(batch["x"]), train=True,
                              rngs={"dropout": jax.random.key(1)})
        return jmodel.loss(logits, jnp.asarray(batch["y"]))[0]

    params = jax.tree.map(jnp.asarray, jmodel.params)
    grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(params))
    opt = jax_make_optimizer(jmodel, LR)
    after, _, loss, _ = jax_make_train_step(jmodel, opt)(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1))
    p_loss, _ = make_train_step(model, make_optimizer(model, LR))(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    return {"grads": grads, "after": jax.tree.map(np.asarray, after), "loss": float(loss),
            "p_loss": float(p_loss), "model": model}


def test_train_step_matches_jax(one_step):
    assert abs(one_step["p_loss"] - one_step["loss"]) <= 1e-5
    model = one_step["model"]
    named = dict(model.module.named_parameters())
    assert all(p.grad is None for n, p in named.items() if n.startswith("feature_extractor."))
    got = dict(_leaves(torch_to_flax(
        model.module, {n: p.grad for n, p in named.items() if p.requires_grad}, moments=True)))
    want = dict(_leaves(one_step["grads"]))
    frozen = {k for k in want if k.startswith("/feature_extractor/")}
    assert set(got) == set(want) - frozen
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], atol=1e-4, err_msg=key)
    assert np.abs(got["/encoder/layers_0/attention/rel_attn_embed"]).max() > 0
    assert_updates_match(torch_to_flax(model.module), one_step["after"], one_step["grads"])


def test_remat_is_bit_equal():
    """``train.remat`` recomputes each layer in the backward pass: the same
    loss and the same gradients, bit for bit (dropout 0)."""
    runs = []
    for remat in ("false", "true"):
        _, model = build_pair("f32", f"train.remat={remat}")
        assert model.module.encoder.remat == (remat == "true")
        model.module.dropout = 0.0
        rng = np.random.default_rng(5)
        wav = torch.from_numpy((rng.standard_normal((2, 16_000)) * 0.1).astype(np.float32))
        y = torch.from_numpy((rng.random((2, 49, 4)) > 0.7).astype(np.float32))
        loss, _ = forward_backward(model, make_optimizer(model, LR), wav, y, None)
        runs.append((loss, {n: p.grad.clone() for n, p in model.module.named_parameters()
                            if p.grad is not None}))
    (loss_a, grads_a), (loss_b, grads_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert set(grads_a) == set(grads_b) and grads_a
    assert all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
