"""Encoder snapshots: the port's safetensors reader and converters against
the ``safetensors`` package and the JAX package's converters, and models
built from a snapshot against JAX's, on tiny random HF snapshots written by
``save_pretrained`` from a config (no download), as tests/test_whisper.py
and tests/test_hubert.py write them.

- the reader equals ``safetensors.numpy.load_file`` on F32, F16 and BF16
  (BF16 widened to f32, which is exact);
- the converted trees equal JAX's leaf for leaf, from model.safetensors in
  F32, F16 and BF16 and from pytorch_model.bin, and from a torchaudio-style
  HuBERT checkpoint file. One leaf differs by design: from a BF16 HuBERT
  snapshot JAX computes the positional conv's weight norm in bf16 (its
  reader keeps bf16), the port in f32 (its reader widens); that kernel is
  held to the float64 weight norm at f32 resolution instead, which JAX's
  misses by far more;
- the logits of a model built from a snapshot agree with the JAX model built
  from it: f32 1e-4, bf16 2e-2 (Whisper) and 6e-2 (HuBERT), the existing
  model tolerances, and the encoder's weights are the snapshot's exactly;
- a checkpoint's frozen fingerprint is JAX's, and serving it over another
  snapshot is refused.
"""

from __future__ import annotations

import shutil
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.checkpoint import frozen_fingerprint as jax_fingerprint
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.hubert.convert import convert_hubert_params as jax_convert_hubert
from segma_tpu.models.whisper.convert import convert_encoder_params as jax_convert_whisper
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_subtrees, torch_to_flax
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.convert import convert_hubert_params
from segma_tpu_torch.models.whisper.convert import convert_encoder_params
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from segma_tpu_torch.utils.safetensors import load_file
from tests.test_torch_checkpoint import HUBERT_TINY, _assert_trees_equal

REPO = Path(__file__).resolve().parent.parent
WHISPER_TINY = dict(d_model=64, n_heads=2, n_layers=2, ffn_dim=128)  # tests/test_whisper.py
ATOL = {("surgical_hydra", "f32"): 1e-4, ("surgical_hydra", "bf16"): 2e-2,
        ("surgical_hubert_hydra", "f32"): 1e-4, ("surgical_hubert_hydra", "bf16"): 6e-2}
FORMATS = ["F32", "F16", "BF16", "bin"]
TORCH_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_whisper(seed: int = 0):
    from transformers import WhisperConfig
    from transformers.models.whisper.modeling_whisper import WhisperEncoder as HFEnc

    cfg = WhisperConfig(
        d_model=WHISPER_TINY["d_model"], encoder_attention_heads=WHISPER_TINY["n_heads"],
        encoder_layers=WHISPER_TINY["n_layers"], encoder_ffn_dim=WHISPER_TINY["ffn_dim"],
        decoder_attention_heads=WHISPER_TINY["n_heads"], decoder_layers=1,
        decoder_ffn_dim=WHISPER_TINY["ffn_dim"], num_mel_bins=80, max_source_positions=1500,
    )
    torch.manual_seed(seed)
    return HFEnc(cfg).eval()


def _hf_hubert(seed: int = 0):
    from transformers import HubertConfig, HubertModel

    cfg = HubertConfig(
        hidden_size=HUBERT_TINY["hidden_size"], num_hidden_layers=HUBERT_TINY["n_layers"],
        num_attention_heads=HUBERT_TINY["n_heads"], intermediate_size=HUBERT_TINY["ffn_dim"],
        conv_dim=list(HUBERT_TINY["conv_dim"]), conv_kernel=[10, 3, 3, 3, 3, 2, 2],
        conv_stride=[5, 2, 2, 2, 2, 2, 2],
        num_conv_pos_embeddings=HUBERT_TINY["pos_conv_kernel"],
        num_conv_pos_embedding_groups=HUBERT_TINY["pos_conv_groups"],
        do_stable_layer_norm=False, feat_extract_norm="group", hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
    )
    torch.manual_seed(seed)
    return HubertModel(cfg).eval()


def _save(hf_model, out: Path, fmt: str) -> Path:
    """An HF snapshot: save_pretrained (safetensors F32 or the .bin pickle),
    or config.json plus model.safetensors in F16 or BF16."""
    from safetensors.torch import save_file

    if fmt in ("F32", "bin"):
        hf_model.save_pretrained(out, safe_serialization=fmt == "F32")
    else:
        out.mkdir(parents=True)
        hf_model.config.to_json_file(out / "config.json")
        state = {k: v.detach().to(TORCH_DTYPES[fmt]).contiguous()
                 for k, v in hf_model.state_dict().items()}
        save_file(state, out / "model.safetensors", metadata={"format": "pt"})
    assert (out / ("pytorch_model.bin" if fmt == "bin" else "model.safetensors")).exists()
    return out


def _perturbed(hf_model, seed: int):
    """The model with N(0, 0.05) from numpy ``seed`` added to every parameter,
    as the suite perturbs JAX's initial weights: HF's init leaves every bias
    and LayerNorm at a constant, where a swapped or dropped leaf would go
    unseen."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in hf_model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape)).astype(np.float32)))
    return hf_model


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{(model, format): snapshot dir}, plus a second Whisper and HuBERT
    snapshot of other weights under format "other"."""
    pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("snapshots")
    out = {}
    for name, make in (("surgical_hydra", _hf_whisper), ("surgical_hubert_hydra", _hf_hubert)):
        hf = _perturbed(make(), 0)
        for fmt in FORMATS:
            out[name, fmt] = _save(hf, root / f"{name}_{fmt}", fmt)
        out[name, "other"] = _save(_perturbed(make(seed=1), 1), root / f"{name}_other", "F32")
    return out


@pytest.mark.parametrize("fmt", ["F32", "F16", "BF16"])
def test_safetensors_reader_matches_the_library(fmt, tmp_path):
    from safetensors.numpy import load_file as lib_load_file
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "w": torch.randn((3, 5, 2), generator=gen).to(TORCH_DTYPES[fmt]),
        "b": torch.randn((7,), generator=gen).to(TORCH_DTYPES[fmt]),
        "scalar": torch.tensor(1.5).to(TORCH_DTYPES[fmt]),
        "empty": torch.zeros((0, 4)).to(TORCH_DTYPES[fmt]),
        "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "mask": torch.tensor([True, False, True]),
    }
    save_file(tensors, tmp_path / "x.safetensors", metadata={"format": "pt"})
    got, want = load_file(tmp_path / "x.safetensors"), lib_load_file(tmp_path / "x.safetensors")
    assert set(got) == set(want) == set(tensors)
    for name, ref in want.items():
        if fmt == "BF16" and name not in ("ids", "mask"):
            assert got[name].dtype == np.float32
            ref = np.asarray(ref, np.float32)
            np.testing.assert_array_equal(got[name], tensors[name].float().numpy())
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, name
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def test_safetensors_reader_refuses_a_torn_file(tmp_path):
    from safetensors.torch import save_file

    save_file({"w": torch.ones(64)}, tmp_path / "x.safetensors")
    blob = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "x.safetensors").write_bytes(blob[:-16])
    with pytest.raises(ValueError, match="does not fit"):
        load_file(tmp_path / "x.safetensors")


@pytest.mark.parametrize("fmt", FORMATS)
def test_whisper_snapshot_converts_as_jax(snapshots, fmt):
    cfg, tree = convert_encoder_params(snapshots["surgical_hydra", fmt])
    jcfg, jtree = jax_convert_whisper(snapshots["surgical_hydra", fmt])
    assert cfg.__dict__ == jcfg.__dict__ and cfg.d_model == WHISPER_TINY["d_model"]
    _assert_trees_equal(tree, jtree)


@pytest.mark.parametrize("fmt", FORMATS)
def test_hubert_snapshot_converts_as_jax(snapshots, fmt):
    snap = snapshots["surgical_hubert_hydra", fmt]
    cfg, fe, tr = convert_hubert_params(snap)
    jcfg, jfe, jtr = jax_convert_hubert(snap)
    assert cfg.__dict__ == jcfg.__dict__ and cfg.hidden_size == HUBERT_TINY["hidden_size"]
    _assert_trees_equal(fe, jfe)
    if fmt == "BF16":
        _assert_trees_equal({**tr, "pos_conv": {"bias": tr["pos_conv"]["bias"]}},
                            {**jtr, "pos_conv": {"bias": jtr["pos_conv"]["bias"]}})
    else:
        _assert_trees_equal(tr, jtr)
    if fmt == "BF16":
        sd = load_file(snap / "model.safetensors")
        g = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"].astype(np.float64)
        v = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"].astype(np.float64)
        exact = (g * v / np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))).transpose(2, 1, 0)
        np.testing.assert_allclose(tr["pos_conv"]["kernel"], exact, rtol=2**-20, atol=1e-7)
        # JAX's bf16 sums of squares are far coarser (17% off on this snapshot)
        jax_err = np.abs(jtr["pos_conv"]["kernel"] - exact).max()
        assert np.abs(tr["pos_conv"]["kernel"] - exact).max() < jax_err / 100


def test_torchaudio_checkpoint_file_converts_as_jax(snapshots, tmp_path, monkeypatch):
    """A single torch checkpoint file with torchaudio's keys (``model.``,
    ``wav2vec2.``, ``encoder.transformer.``, ``weight_g``/``weight_v``). It
    has no config.json, so both sides take HuBERT-base's, here the tiny one."""
    from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxHubertConfig
    from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig

    for cls in (HubertEncoderConfig, JaxHubertConfig):
        monkeypatch.setattr(cls, "base", classmethod(lambda c: c(**HUBERT_TINY)))
    sd = load_file(snapshots["surgical_hubert_hydra", "F32"] / "model.safetensors")
    renamed = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        k = k.replace("parametrizations.weight.original1", "weight_v")
        k = k.replace("feature_projection.", "encoder.feature_projection.")
        k = k.replace("encoder.layers.", "encoder.transformer.layers.")
        k = k.replace("encoder.pos_conv_embed.", "encoder.transformer.pos_conv_embed.")
        k = k.replace("encoder.layer_norm.", "encoder.transformer.layer_norm.")
        renamed["model.wav2vec2." + k] = torch.from_numpy(v.copy())
    torch.save({"state_dict": renamed}, tmp_path / "hubert.ckpt")
    _, fe, tr = convert_hubert_params(tmp_path / "hubert.ckpt")
    _, jfe, jtr = jax_convert_hubert(tmp_path / "hubert.ckpt")
    _assert_trees_equal(fe, jfe)
    _assert_trees_equal(tr, jtr)
    _, fe0, tr0 = convert_hubert_params(snapshots["surgical_hubert_hydra", "F32"])
    _assert_trees_equal({"fe": fe, "tr": tr}, {"fe": fe0, "tr": tr0})


def _overrides(name: str, snapshot: Path, precision: str) -> list[str]:
    if name == "surgical_hydra":
        return [f"model.config.encoder={snapshot}", "model.config.lstm.hidden_size=16",
                f"train.precision={precision}"]
    return ["model.name=surgical_hubert_hydra", f"model.config.wav_encoder={snapshot}",
            "audio.strict_frames=true", f"train.precision={precision}"]


def _pair(name: str, snapshot: Path, precision: str):
    """(JAX model with params, port model, port config) built from the same
    snapshot, the port's other weights (the heads, the layer mix, the LSTM)
    set to JAX's."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml",
                           _overrides(name, snapshot, precision))
    jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    jmodel.params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      _overrides(name, snapshot, precision))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a snapshot build warns of nothing
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    snap_keys = ("encoder",) if name == "surgical_hydra" else ("feature_extractor", "encoder")
    load_flax_subtrees(model.module,
                       {k: v for k, v in jmodel.params.items() if k not in snap_keys})
    return jmodel, model, cfg


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["surgical_hydra", "surgical_hubert_hydra"])
def test_model_from_snapshot_matches_jax(snapshots, name, precision):
    jmodel, model, _ = _pair(name, snapshots[name, "F32"], precision)
    _assert_trees_equal(torch_to_flax(model.module), jmodel.params)
    wav = (np.random.default_rng(1).standard_normal((2, 64_000)) * 0.1).astype(np.float32)
    ref = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, jmodel.params), jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 199, 4)
    np.testing.assert_allclose(got, ref, atol=ATOL[name, precision])


@pytest.mark.parametrize("name", ["surgical_hydra", "surgical_hubert_hydra"])
def test_snapshot_fingerprint_is_jax_and_another_snapshot_is_refused(snapshots, name,
                                                                     tmp_path):
    jmodel, model, cfg = _pair(name, snapshots[name, "F32"], "f32")
    trainable, frozen = ckpt.flax_split(model)
    fingerprint = ckpt.frozen_fingerprint(frozen)
    assert fingerprint == jax_fingerprint(jmodel.split_params(jmodel.params)[1])
    ckpt.save_params(tmp_path / "ck", trainable, {"frozen_fingerprint": fingerprint})
    served = ckpt.load_model_for_inference(cfg, tmp_path / "ck", device="cpu")
    wav = torch.from_numpy(
        (np.random.default_rng(2).standard_normal((1, 64_000)) * 0.1).astype(np.float32))
    assert torch.equal(served.apply(wav), model.apply(wav))
    other = load_config(REPO / "segma_tpu_torch/config/default.yml",
                        _overrides(name, snapshots[name, "other"], "f32"))
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.load_model_for_inference(other, tmp_path / "ck", device="cpu")
    # the same snapshot copied elsewhere is the same frozen tree
    copy = tmp_path / "copy"
    shutil.copytree(snapshots[name, "F32"], copy)
    moved = load_config(REPO / "segma_tpu_torch/config/default.yml",
                        _overrides(name, copy, "f32"))
    ckpt.load_model_for_inference(moved, tmp_path / "ck", device="cpu")
