"""HuBERT parity: the port's ``surgical_hubert_hydra`` against the JAX
``HubertSegModule`` at the TINY widths of tests/test_hubert.py, with the JAX
params carried across by ``convert.load_flax_params`` (strict).

- f32: atol 1e-4 (f32 sums in other orders through the whole stack);
- bf16: atol 6e-2. Each op agrees with flax's to one bf16 ulp on the same
  input (a bf16 conv, for one: identical or one ulp apart), but the two round
  at other places (flax rounds a Dense before adding its bias and evaluates
  GELU in bf16 steps), and the noise accumulates through 7 convs, GroupNorm,
  the positional conv and two post-norm layers to about 3 ulps of the logits,
  which are of order 2 (bf16 ulp 1.6e-2). The Whisper bar of 2e-2
  (tests/test_torch_surgical_hydra.py) is for logits of order 1 through a
  shallower front end.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.models.hubert.builders import HubertSegModule as JaxSegModule
from segma_tpu.models.hubert.encoder import FeatureExtractor as JaxFeatureExtractor
from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxEncoderConfig
from segma_tpu.models.hubert.encoder import HubertTransformer as JaxTransformer
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert import HUBERT_CONV_SETTINGS
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
TINY = dict(
    hidden_size=64, n_layers=2, n_heads=2, ffn_dim=128, conv_dim=(32,) * 7,
    pos_conv_kernel=16, pos_conv_groups=4,
)
ATOL = {"f32": 1e-4, "bf16": 6e-2}
DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(precision: str, *extra: str):
    return load_config(
        REPO / "segma_tpu_torch/config/default.yml",
        ["model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
         "audio.strict_frames=true", f"train.precision={precision}", *extra],
    )


def build_pair(precision: str, seed: int = 0):
    """(jax module, numpy params, port model) sharing the same weights."""
    jmod = JaxSegModule(enc_cfg=JaxEncoderConfig(**TINY), n_labels=4, dtype=DTYPE[precision])
    params = jmod.init(jax.random.key(seed), jnp.zeros((1, 16_000)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )
    cfg = port_config(precision)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hubert_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=HubertEncoderConfig(**TINY),
        )
    load_flax_params(model.module, params)
    return jmod, params, model


def _wav(n: int, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((2, n)) * 0.1).astype(np.float32)


def test_feature_extractor_matches_jax():
    _, params, model = build_pair("f32")
    wav = _wav(16_000)
    ref = JaxFeatureExtractor(JaxEncoderConfig(**TINY), dtype=jnp.float32).apply(
        {"params": params["feature_extractor"]}, jnp.asarray(wav)
    )
    with torch.no_grad():
        got = model.module.feature_extractor(torch.from_numpy(wav))
    assert got.shape == ref.shape == (2, 49, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL["f32"])


def test_transformer_hidden_states_match_jax():
    _, params, model = build_pair("f32")
    feats = np.random.default_rng(2).standard_normal((2, 49, 32)).astype(np.float32)
    ref_last, ref_hidden = JaxTransformer(JaxEncoderConfig(**TINY), dtype=jnp.float32).apply(
        {"params": params["encoder"]}, jnp.asarray(feats), output_hidden_states=True
    )
    with torch.no_grad():
        got_last, got_hidden = model.module.encoder(
            torch.from_numpy(feats), output_hidden_states=True
        )
    assert len(got_hidden) == len(ref_hidden) == TINY["n_layers"] + 1
    np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last), atol=ATOL["f32"])
    for ours, theirs in zip(got_hidden, ref_hidden):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL["f32"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_samples", [16_000, 64_000])
def test_logits_match_jax(precision, n_samples):
    jmod, params, model = build_pair(precision)
    wav = _wav(n_samples)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    n_windows = HUBERT_CONV_SETTINGS.n_windows(n_samples, strict=True)
    assert got.shape == ref.shape == (2, n_windows, 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL[precision])


def test_bridge_covers_every_parameter():
    _, params, model = build_pair("f32")
    assert set(flax_to_torch(params)) == set(model.module.state_dict())
    pos = flax_to_torch(params)["encoder.pos_conv.weight"]
    assert pos.shape == (64, 64 // 4, 16)  # (out, in/groups, k)


def test_geometry():
    assert HUBERT_CONV_SETTINGS.rf_step == 320
    assert HUBERT_CONV_SETTINGS.rf_size == 400
    assert HUBERT_CONV_SETTINGS.n_windows(16_000, strict=True) == 49
    assert HUBERT_CONV_SETTINGS.n_windows(64_000, strict=True) == 199
    _, _, model = build_pair("f32")
    assert model.n_windows == 199 and model.n_labels == 4


def test_frozen_partition():
    _, _, model = build_pair("f32")
    assert model.frozen_prefixes == ("feature_extractor",)
    trainable, frozen = model.split_state()
    assert {k.split(".")[0] for k in frozen} == {"feature_extractor"}
    assert {k.split(".")[0] for k in trainable} == {"encoder", "layer_mix", "heads"}
    ids = {id(p) for p in model.trainable_parameters()}
    for name, p in model.module.named_parameters():
        assert (id(p) in ids) == (not name.startswith("feature_extractor."))


def test_freeze_encoder_freezes_the_transformer():
    cfg = port_config("f32", "model.config.freeze_encoder=true")
    with pytest.warns(UserWarning, match="snapshot"):
        model = Models["surgical_hubert_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=HubertEncoderConfig(**TINY),
        )
    assert model.frozen_prefixes == ("feature_extractor", "encoder")
    logits = model.module(torch.from_numpy(_wav(16_000)), train=False)
    logits.sum().backward()
    assert all(p.grad is None for p in model.module.encoder.parameters())
    assert model.module.heads.heads.weight.grad is not None


def test_builder_weights_follow_the_generator():
    cfg = port_config("bf16")
    enc = MultiLabelEncoder(cfg.data.classes)
    kw = dict(device="cpu", enc_cfg=HubertEncoderConfig(**TINY))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a, b, c = (
            Models["surgical_hubert_hydra"](
                enc, cfg, generator=torch.Generator().manual_seed(s), **kw
            )
            for s in (3, 3, 4)
        )
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["heads.heads.weight"], sc["heads.heads.weight"])
    assert a.module.encoder.dtype == torch.bfloat16


def test_dropout_only_in_training():
    _, _, model = build_pair("f32")
    wav = torch.from_numpy(_wav(16_000))
    with torch.no_grad():
        eval_a = model.module(wav)
        eval_b = model.module(wav, train=False)
        tr_a = model.module(wav, train=True, generator=torch.Generator().manual_seed(0))
        tr_b = model.module(wav, train=True, generator=torch.Generator().manual_seed(0))
        tr_c = model.module(wav, train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(eval_a, eval_b)
    torch.testing.assert_close(tr_a, tr_b)
    assert not torch.allclose(tr_a, eval_a) and not torch.allclose(tr_a, tr_c)
    with pytest.raises(ValueError, match="Generator"):
        model.module(wav, train=True)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_f32_model_keeps_cudnn_out_of_tf32(precision):
    """An f32 model runs with cuDNN's TF32 off (its convolutions, on the
    card, would otherwise take TF32 under PyTorch's default flags), and the
    caller's flag is back after the call; a bf16 model leaves it alone."""
    _, _, model = build_pair(precision)
    seen = []
    model.module.feature_extractor.register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        model.apply(torch.from_numpy(_wav(16_000)))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert seen == [precision != "f32"]
