"""Checkpoint parity: the port's ``checkpoint.py`` against the JAX
package's on the same weights, at the tiny widths of tests/test_hubert.py
and tests/test_torch_inference.py.

- ``torch_to_flax`` gives back the JAX params tree exactly;
- a checkpoint written by JAX's ``save_params`` loads into the port, whose
  logits then equal those of the same weights loaded by ``flax_to_torch``;
- a checkpoint written by the port is restored by JAX's ``load_params``,
  arrays equal, chunked leaves included;
- ``frozen_fingerprint`` gives the same digest on both sides;
- ``CheckpointManager`` keeps the same directories and ``best.ckpt``;
- ``Trainer.fit`` writes checkpoints, and serving them through
  ``run_inference_on_audios(checkpoint=...)`` gives the RTTMs of the
  trained model passed as ``model=``.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import segma_tpu.checkpoint as jckpt
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxHubertConfig
from segma_tpu.models.whisper import builders as jax_whisper_builders
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxWhisperConfig
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params, torch_to_flax
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.inference import run_inference_on_audios
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.train import Trainer
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
HUBERT_TINY = dict(
    hidden_size=64, n_layers=2, n_heads=2, ffn_dim=128, conv_dim=(32,) * 7,
    pos_conv_kernel=16, pos_conv_groups=4,
)
WHISPER_TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
OVERRIDES = {
    "surgical_hubert_hydra": [
        "model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
        "audio.strict_frames=true", "train.precision=f32",
    ],
    "surgical_hydra": [
        "model.config.encoder=whisper_tiny_random", "model.config.lstm.hidden_size=16",
        "train.precision=f32",
    ],
}
MODELS = list(OVERRIDES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(name: str):
    """The JAX model at tiny width, its params perturbed by N(0, 0.05) from
    numpy seed 0 so no leaf is a constant."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", OVERRIDES[name])
    orig = jax_whisper_builders._encoder_cfg_for
    jax_whisper_builders._encoder_cfg_for = lambda _path: JaxWhisperConfig(**WHISPER_TINY)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    finally:
        jax_whisper_builders._encoder_cfg_for = orig
    if name == "surgical_hubert_hydra":
        jmodel.module = jmodel.module.clone(enc_cfg=JaxHubertConfig(**HUBERT_TINY))
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )
    return jmodel


def _port_model(name: str, seed: int = 0):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", OVERRIDES[name])
    enc_cfg = (HubertEncoderConfig(**HUBERT_TINY) if name == "surgical_hubert_hydra"
               else WhisperEncoderConfig(**WHISPER_TINY))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed), enc_cfg=enc_cfg)


def _assert_trees_equal(got: dict, want: dict, where: str = "") -> None:
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{where}[{key!r}]")
        else:
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, where + key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where}[{key!r}]")


def _wav() -> torch.Tensor:
    return torch.from_numpy((np.random.default_rng(1).standard_normal((2, 64_000)) * 0.1)
                            .astype(np.float32))


@pytest.mark.parametrize("name", MODELS)
def test_torch_to_flax_gives_back_the_jax_tree(name):
    jmodel = _jax_model(name)
    model = _port_model(name)
    load_flax_params(model.module, jmodel.params)
    _assert_trees_equal(torch_to_flax(model.module), jmodel.params)
    assert model.frozen_prefixes == jmodel.frozen_prefixes


@pytest.mark.parametrize("name", MODELS)
def test_jax_checkpoint_loads_into_the_port(name, tmp_path):
    """JAX's save_params writes the trainable tree; the port restores it over
    a model whose trainable weights differ, and then gives the logits of the
    same weights loaded whole by flax_to_torch, bit for bit."""
    jmodel = _jax_model(name)
    trainable, _ = jmodel.split_params(jmodel.params)
    jckpt.save_params(tmp_path / "ck", trainable, {"epoch": 3, "score": 0.5})
    ref = _port_model(name)
    load_flax_params(ref.module, jmodel.params)
    model = _port_model(name, seed=7)
    load_flax_params(model.module, jmodel.params)
    for key, p in model.module.named_parameters():  # trainable weights made different
        if key.split(".")[0] not in model.frozen_prefixes:
            torch.nn.init.normal_(p)
    template, _ = ckpt.flax_split(model)
    ckpt.load_trainable(model, ckpt.load_params(tmp_path / "ck", template))
    assert ckpt.load_meta(tmp_path / "ck") == {"epoch": 3, "score": 0.5}
    wav = _wav()
    assert torch.equal(model.apply(wav), ref.apply(wav))


@pytest.mark.parametrize("name", MODELS)
def test_port_checkpoint_restores_in_jax(name, tmp_path):
    jmodel = _jax_model(name)
    model = _port_model(name)
    load_flax_params(model.module, jmodel.params)
    trainable, _ = ckpt.flax_split(model)
    ckpt.save_params(tmp_path / "ck", trainable, {"epoch": 1, "score": 0.25, "monitor": "val/loss"})
    template, _ = jmodel.split_params(jmodel.params)
    restored = jckpt.load_params(tmp_path / "ck", jax.tree.map(np.zeros_like, template))
    _assert_trees_equal(jax.tree.map(np.asarray, restored), template)
    assert jckpt.checkpoint_is_loadable(tmp_path / "ck")
    assert jckpt.load_meta(tmp_path / "ck")["score"] == 0.25


def test_chunked_leaves_cross_both_ways(monkeypatch, tmp_path):
    """Leaves above MAX_CHUNK_SIZE bytes are split into flat chunks. With the
    limit lowered to 1 KB on both sides, each side reads the other's chunks."""
    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.standard_normal((40, 30)).astype(np.float32)},
            "b": rng.standard_normal(7).astype(np.float32)}
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    ckpt.save_params(tmp_path / "port", tree)
    assert b"__msgpack_chunked_array__" in (tmp_path / "port" / "params.msgpack").read_bytes()
    _assert_trees_equal(jckpt.load_params(tmp_path / "port", tree), tree)
    jckpt.save_params(tmp_path / "jax", tree)
    _assert_trees_equal(ckpt.load_params(tmp_path / "jax", tree), tree)


def test_load_params_refuses_a_mismatch_and_a_torn_blob(tmp_path):
    tree = {"a": np.zeros((2, 3), np.float32)}
    ckpt.save_params(tmp_path / "ck", tree)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params(tmp_path / "ck", {"a": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError, match="keys"):
        ckpt.load_params(tmp_path / "ck", {"b": np.zeros((2, 3), np.float32)})
    blob = (tmp_path / "ck" / "params.msgpack").read_bytes()
    (tmp_path / "ck" / "params.msgpack").write_bytes(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="corrupted"):
        ckpt.load_params(tmp_path / "ck", tree)
    assert not ckpt.checkpoint_is_loadable(tmp_path / "ck")


@pytest.mark.parametrize("name", MODELS)
def test_frozen_fingerprint_matches_jax(name):
    jmodel = _jax_model(name)
    model = _port_model(name)
    load_flax_params(model.module, jmodel.params)
    _, jfrozen = jmodel.split_params(jmodel.params)
    _, frozen = ckpt.flax_split(model)
    assert frozen and ckpt.frozen_fingerprint(frozen) == jckpt.frozen_fingerprint(jfrozen)


@pytest.mark.parametrize("mode,top_k", [("min", 2), ("max", 1), ("min", -1)])
def test_checkpoint_manager_keeps_what_jax_keeps(tmp_path, mode, top_k):
    scores = [0.9, 0.4, 0.7, 0.3, 0.35, 0.8]
    tree = {"w": np.arange(4, dtype=np.float32)}
    managers = {
        "jax": jckpt.CheckpointManager(tmp_path / "jax", "val/loss", mode, top_k),
        "port": ckpt.CheckpointManager(tmp_path / "port", "val/loss", mode, top_k),
    }
    for epoch, score in enumerate(scores):
        for m in managers.values():
            m.step(epoch, score, tree, {"monitor": "val/loss"})
    listed = {k: sorted(p.name for p in (tmp_path / k).iterdir()) for k in managers}
    assert listed["port"] == listed["jax"]
    assert ((tmp_path / "port" / "best.ckpt").resolve().name
            == (tmp_path / "jax" / "best.ckpt").resolve().name)
    assert ckpt.load_meta(tmp_path / "port" / "last")["epoch"] == len(scores) - 1
    # a manager opened on an existing directory adopts its checkpoints as JAX's does
    again = ckpt.CheckpointManager(tmp_path / "port", "val/loss", mode, top_k)
    jagain = jckpt.CheckpointManager(tmp_path / "jax", "val/loss", mode, top_k)
    assert again.best_score == jagain.best_score
    assert [p.name for _, p in again.kept] == [p.name for _, p in jagain.kept]


def test_checkpoint_manager_refuses_save_top_k_zero(tmp_path):
    with pytest.raises(ValueError, match="save_top_k=0"):
        jckpt.CheckpointManager(tmp_path / "jax", save_top_k=0)
    with pytest.raises(ValueError, match="save_top_k=0"):
        ckpt.CheckpointManager(tmp_path / "port", save_top_k=0)


def test_resolve_checkpoint_follows_run_dirs_and_links(tmp_path):
    m = ckpt.CheckpointManager(tmp_path / "run" / "checkpoints")
    m.step(0, 0.5, {"w": np.ones(2, np.float32)}, {})
    m.step(1, 0.2, {"w": np.ones(2, np.float32)}, {})
    best = tmp_path / "run" / "checkpoints" / "epoch=01-val_loss=0.200"
    for path in (tmp_path / "run", tmp_path / "run" / "checkpoints" / "best.ckpt", best):
        assert ckpt.resolve_checkpoint(path) == best.resolve()
        assert ckpt.resolve_checkpoint(path) == jckpt.resolve_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_checkpoint(tmp_path / "nowhere")


def _tiny_hubert(monkeypatch) -> None:
    """Models built from a config alone (load_model_for_inference) get the
    tiny HuBERT."""
    monkeypatch.setattr(HubertEncoderConfig, "base", classmethod(lambda cls: cls(**HUBERT_TINY)))


def test_inference_refuses_a_frozen_tree_that_drifted(monkeypatch, tmp_path):
    _tiny_hubert(monkeypatch)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      [*OVERRIDES["surgical_hubert_hydra"], "train.seed=3"])
    model = ckpt.build_model(cfg, device="cpu")
    trainable, frozen = ckpt.flax_split(model)
    ckpt.save_params(tmp_path / "ck", trainable,
                     {"frozen_fingerprint": ckpt.frozen_fingerprint(frozen)})
    served = ckpt.load_model_for_inference(cfg, tmp_path / "ck", device="cpu")
    wav = _wav()
    assert torch.equal(served.apply(wav), model.apply(wav))
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.load_model_for_inference(cfg, tmp_path / "ck", seed=4, device="cpu")


def test_fit_writes_checkpoints_that_serve_as_the_trained_model(monkeypatch, tmp_path):
    """Trainer.fit in f32 on the CPU writes the checkpoints; serving the run
    directory (its best.ckpt) rebuilds the frozen front end from train.seed,
    overlays the trained weights and writes the RTTMs of the trained model
    itself, with equal logits."""
    _tiny_hubert(monkeypatch)
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(
        REPO / "segma_tpu_torch/config/default.yml",
        [*OVERRIDES["surgical_hubert_hydra"], f"data.dataset_path={root}",
         "audio.chunk_duration_s=1.0", "train.batch_size=4", "train.seed=0",
         "train.dataloader.num_workers=1", "train.save_top_k=1"],
    )
    model = ckpt.build_model(cfg, device="cpu")
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
    history = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", max_epochs=2,
                      device="cpu").fit(dm)["history"]
    ckdir = tmp_path / "run" / "checkpoints"
    kept = sorted(p.name for p in ckdir.glob("epoch=*"))
    best_epoch = min(range(2), key=lambda e: history[e]["val/loss"])
    assert kept == [f"epoch={best_epoch:02d}-val_loss={history[best_epoch]['val/loss']:.3f}"]
    assert (ckdir / "best.ckpt").resolve().name == kept[0]
    meta = ckpt.load_meta(ckdir / "last")
    assert meta["epoch"] == 1 and meta["monitor"] == "val/loss"
    assert meta["frozen_fingerprint"] == ckpt.frozen_fingerprint(ckpt.flax_split(model)[1])
    # serve the last epoch's weights both ways: the model in memory, and the checkpoint
    wavs = root / "wav"
    model_files = run_inference_on_audios(cfg, wavs, None, tmp_path / "model", model=model,
                                          device="cpu", batch_size=4)
    served = ckpt.load_model_for_inference(cfg, ckdir / "last", device="cpu")
    wav = torch.from_numpy(chip_smoke.wide_range_signals(0, 32_000)["tone"].reshape(2, 16_000))
    assert torch.equal(served.apply(wav), model.apply(wav))
    ckpt_files = run_inference_on_audios(cfg, wavs, ckdir / "last", tmp_path / "ckpt",
                                         device="cpu", batch_size=4)
    assert ckpt_files == model_files and model_files
    for path in model_files:
        got = (tmp_path / "ckpt" / "raw_rttm" / f"{path.stem}.rttm").read_text()
        assert got == (tmp_path / "model" / "raw_rttm" / f"{path.stem}.rttm").read_text()
    # the run directory resolves to best.ckpt
    run_inference_on_audios(cfg, wavs, tmp_path / "run", tmp_path / "best", device="cpu",
                            batch_size=4)
    assert sorted(p.name for p in (tmp_path / "best" / "raw_rttm").iterdir()) == sorted(
        f"{p.stem}.rttm" for p in model_files)


def test_inference_refuses_model_and_checkpoint_together(tmp_path):
    model = _port_model("surgical_hubert_hydra")
    (tmp_path / "wav").mkdir()
    with pytest.raises(ValueError, match="not both"):
        run_inference_on_audios(model.config, tmp_path / "wav", tmp_path / "ck", tmp_path / "out",
                                model=model, device="cpu")


def test_jax_loads_a_checkpoint_that_port_training_wrote(monkeypatch, tmp_path):
    """The port's fit output restores in JAX: every trainable leaf of a
    checkpoint from ``Trainer.fit`` is read back by JAX's load_params into
    the JAX model's own trainable template."""
    _tiny_hubert(monkeypatch)
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(
        REPO / "segma_tpu_torch/config/default.yml",
        [*OVERRIDES["surgical_hubert_hydra"], f"data.dataset_path={root}",
         "audio.chunk_duration_s=1.0", "train.batch_size=4", "train.seed=0",
         "train.dataloader.num_workers=1"],
    )
    model = ckpt.build_model(cfg, device="cpu")
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    Trainer(model=model, config=cfg, run_dir=tmp_path / "run", max_epochs=1,
            device="cpu").fit(SegmentationDataLoader(ds, model.label_encoder, cfg,
                                                     model.conv_settings))
    jmodel = _jax_model("surgical_hubert_hydra")
    template, _ = jmodel.split_params(jmodel.params)
    path = jckpt.resolve_checkpoint(tmp_path / "run")
    restored = jax.tree.map(np.asarray, jckpt.load_params(path, template))
    _assert_trees_equal(restored, ckpt.flax_split(model)[0])
    logits = jmodel.apply({**jax.tree.map(jnp.asarray, restored),
                           **jmodel.split_params(jmodel.params)[1]}, jnp.asarray(_wav().numpy()))
    assert np.isfinite(np.asarray(logits)).all()
