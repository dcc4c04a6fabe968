"""Reference-checkpoint import: the port's ``convert_reference`` and
``cli/import_checkpoint`` against the JAX package's, for the six reference
variants at tiny widths.

A synthetic reference state_dict (``chip_smoke.reference_state_dict``: a
random snapshot's encoder tensors in the reference's key layout, random
heads and an ``nn.LSTM`` with both biases random, from a numpy seed) is
saved as a plain ``{"state_dict": ...}`` file and imported by both
packages:

- every leaf of the two trees is equal (``np.array_equal``);
- the imported models' logits agree, JAX against port, at the f32 pin
  atol 1e-4 (1 s chunks);
- the imported LSTM equals a ``torch.nn.LSTM`` carrying the reference's two
  original biases, at atol 1e-6;
- the CLI writes a checkpoint that JAX's ``load_params`` reads and the port
  serves over the snapshot of the same encoder, its fingerprint accepted;
- the two packages' ``frozen_fingerprint`` agree; an unsupported model is
  refused with JAX's message.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import segma_tpu.checkpoint as jckpt
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.convert_reference import import_reference_checkpoint as jax_import
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxHubertConfig
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxWhisperConfig
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.cli import import_checkpoint
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert_reference import SUPPORTED_IMPORTS, import_reference_checkpoint
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
LABELS = ["KCHI", "OCH", "MAL", "FEM"]  # data.classes of config/default.yml
LSTM_H = 16
WHISPER_DIMS = dict(d_model=64, encoder_attention_heads=4, encoder_layers=2,
                    encoder_ffn_dim=128, num_mel_bins=80, max_source_positions=1500)
HUBERT_DIMS = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=128, conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                   conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)
WHISPER_TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
HUBERT_TINY = dict(hidden_size=64, n_layers=2, n_heads=2, ffn_dim=128, conv_dim=(32,) * 7,
                   pos_conv_kernel=16, pos_conv_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(name: str, snapshot: str = "reference_import_random") -> list[str]:
    extra = [f"model.name={name}", "audio.chunk_duration_s=1.0", "train.precision=f32",
             "data.classes=[KCHI,OCH,MAL,FEM]"]
    if name == "surgical_hubert_hydra":
        return [*extra, f"model.config.wav_encoder={snapshot}", "audio.strict_frames=true"]
    extra.append(f"model.config.encoder={snapshot}")
    if name in ("whisperimax", "hydra_whisper", "surgical_hydra"):
        extra.append(f"model.config.lstm.hidden_size={LSTM_H}")
    return extra


def _write_reference(tmp: Path, name: str, seed: int = 3):
    """(snapshot dir, .ckpt path, state dict) of a tiny reference model whose
    encoder is the snapshot's."""
    snap = tmp / f"{name}_snapshot"
    if name == "surgical_hubert_hydra":
        enc = chip_smoke.write_hubert_snapshot(snap, seed, HUBERT_DIMS)
    else:
        enc = chip_smoke.write_whisper_snapshot(snap, seed, WHISPER_DIMS)
    sd = chip_smoke.reference_state_dict(name, enc, LABELS, seed + 10, lstm_hidden=LSTM_H)
    return snap, chip_smoke.write_reference_ckpt(tmp / f"{name}.ckpt", sd), sd


def _jax_model(name: str, extra: list[str]):
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    enc_cfg = (JaxHubertConfig(**HUBERT_TINY) if name == "surgical_hubert_hydra"
               else JaxWhisperConfig(**WHISPER_TINY))
    jmodel.module = jmodel.module.clone(enc_cfg=enc_cfg)
    jmodel.init_params(jax.random.key(0))
    return jmodel


def _port_model(name: str, extra: list[str]):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    enc_cfg = (HubertEncoderConfig(**HUBERT_TINY) if name == "surgical_hubert_hydra"
               else WhisperEncoderConfig(**WHISPER_TINY))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                            enc_cfg=enc_cfg)


def _assert_trees_equal(got: dict, want: dict, where: str = "") -> None:
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{where}[{key!r}]")
        else:
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype == np.float32
            assert np.array_equal(got[key], want[key]), f"{where}[{key!r}]"


_IMPORTED: dict[str, dict] = {}


def _imported(name: str, tmp_path_factory) -> dict:
    """Both packages' imports of ``name``'s reference checkpoint, once per
    worker."""
    if name not in _IMPORTED:
        _IMPORTED[name] = _import_both(name, tmp_path_factory.mktemp(name))
    return _IMPORTED[name]


@pytest.fixture(params=SUPPORTED_IMPORTS)
def imported(request, tmp_path_factory):
    return _imported(request.param, tmp_path_factory)


def _import_both(name: str, tmp: Path) -> dict:
    snap, ckpt_path, sd = _write_reference(tmp, name)
    jmodel = _jax_model(name, _overrides(name))
    jparams = jax.tree.map(np.asarray, jax_import(ckpt_path, jmodel))
    model = _port_model(name, _overrides(name))
    params = import_reference_checkpoint(ckpt_path, model)
    return {"name": name, "tmp": tmp, "snapshot": snap, "ckpt": ckpt_path, "sd": sd,
            "jmodel": jmodel, "jparams": jparams, "model": model, "params": params}


def test_import_gives_jax_tree_leaf_for_leaf(imported):
    _assert_trees_equal(imported["params"], imported["jparams"])


def test_imported_logits_match_jax(imported):
    n = 16_000
    wav = (np.random.default_rng(1).standard_normal((2, n)) * 0.1).astype(np.float32)
    ref = np.asarray(imported["jmodel"].apply(imported["jparams"], jnp.asarray(wav)))
    got = imported["model"].apply(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape and got.shape[0] == 2 and got.shape[2] == len(LABELS)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_frozen_fingerprints_agree(imported):
    model = imported["model"]
    frozen = {k: v for k, v in imported["params"].items() if k in model.frozen_prefixes}
    _, jfrozen = imported["jmodel"].split_params(imported["jparams"])
    assert frozen and set(frozen) == set(jfrozen)
    assert ckpt.frozen_fingerprint(frozen) == jckpt.frozen_fingerprint(jfrozen)
    # the module's own frozen tree after the import is the same tree
    assert ckpt.frozen_fingerprint(ckpt.flax_split(model)[1]) == jckpt.frozen_fingerprint(jfrozen)


@pytest.mark.parametrize("name", ["whisperimax", "hydra_whisper", "surgical_hydra"])
def test_imported_lstm_is_the_reference_lstm(name, tmp_path_factory):
    """The port's BiLSTM holds bias_ih + bias_hh in ``bias_hh`` and zero in
    ``bias_ih``; it computes what the reference's ``nn.LSTM`` with its two
    original biases computes."""
    imported = _imported(name, tmp_path_factory)
    model, sd = imported["model"], imported["sd"]
    prefix = "lstm" if name == "whisperimax" else "lstm_shared"
    port = model.module.lstm_shared
    ref = torch.nn.LSTM(port.lstm.input_size, LSTM_H, num_layers=2, bidirectional=True,
                        batch_first=True)
    ref.load_state_dict({k.removeprefix(prefix + "."): torch.from_numpy(v)
                         for k, v in sd.items() if k.startswith(prefix + ".")})
    for n, p in port.lstm.named_parameters():
        if n.startswith("bias_ih"):
            assert not p.any() and not p.requires_grad
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 30, port.lstm.input_size)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), ref(x)[0].numpy(), atol=1e-6)


def test_cli_checkpoint_reads_in_jax_and_serves(imported, tmp_path):
    """The CLI over the snapshot of the checkpoint's own encoder: JAX's
    load_params restores its trainable tree; the port serves it, its
    fingerprint accepted, with the imported model's logits."""
    name, snap = imported["name"], imported["snapshot"]
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", _overrides(name, str(snap)))
    config_path = chip_smoke.write_config(tmp_path / "config.yml", cfg)
    out = import_checkpoint.main(["--ckpt", str(imported["ckpt"]), "--config", str(config_path),
                                  "--out", str(tmp_path / "imported"), "--device", "cpu"])
    meta = ckpt.load_meta(out)
    assert meta["imported_from"] == str(imported["ckpt"]) and meta["model"] == name
    jparams = imported["jparams"]
    jtrainable, jfrozen = imported["jmodel"].split_params(jparams)
    assert meta["frozen_fingerprint"] == jckpt.frozen_fingerprint(jfrozen)
    restored = jax.tree.map(np.asarray, jckpt.load_params(out, jtrainable))
    _assert_trees_equal(restored, jax.tree.map(np.asarray, jtrainable))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        served = ckpt.load_model_for_inference(cfg, out, device="cpu")
    wav = torch.from_numpy((np.random.default_rng(4).standard_normal((2, 16_000)) * 0.1)
                           .astype(np.float32))
    torch.testing.assert_close(served.apply(wav), imported["model"].apply(wav), rtol=0, atol=0)


def test_import_rejects_unsupported_models(tmp_path_factory):
    imported = _imported("whisperidou", tmp_path_factory)
    jmodel = dataclasses.replace(imported["jmodel"], name="conv_vad")
    model = dataclasses.replace(imported["model"], name="conv_vad")
    with pytest.raises(ValueError) as want:
        jax_import("whatever.ckpt", jmodel)
    with pytest.raises(ValueError) as got:
        import_reference_checkpoint("whatever.ckpt", model)
    assert str(got.value) == str(want.value) and "surgical_hydra" in str(got.value)
