"""The device audio cache (``train.data_cache``) and epoch dispatch
(``train.dispatch=epoch``) against the JAX package's, on the CPU:

- ``DeviceAudioCache.build`` gives JAX's ``host_flat`` and ``bases`` on the
  same files: a generated dataset, a file shorter than a crop, a file that
  holds fewer samples than its metadata says, PCM16 beside a stereo file
  (an f32 buffer);
- the sampler in offsets mode draws JAX's offsets and labels from the same
  seed, and the crops the cache gathers are the host sampler's waveforms bit
  for bit, under f32 and int16 transport;
- ``auto`` resolves as JAX's, note for note: within the budget, over it,
  jointly over the train and val subsets, past the int32 offset range, with
  little host RAM; ``device`` past the int32 range and an unknown value
  raise; a batch of the other mode raises ``BatchContractError``;
- at the tiny HuBERT widths of tests/test_torch_checkpoint.py (f32; dropout
  0.5, and 0 where JAX is the other side, whose dropout stream torch cannot
  reproduce): two epochs through the device cache end bit-equal to the host path,
  with PCM16 and with f32 sources, and under int16 transport; epoch
  dispatch (on the CPU the captured graph's plain loop) ends bit-equal to
  step dispatch with the cosine schedule and k=3 accumulation, and so does
  a run resumed at ``mini_step`` 1; a preemption under epoch dispatch saves
  the completed epoch; the port's epoch dispatch and JAX's ``make_epoch_fn``
  on the same weights agree within JAX's own tolerances
  (``tests/test_device_cache.py``: losses at rtol 1e-5, F1 at 1e-4);
- dispatch errors: epoch dispatch without a device cache names how
  ``data_cache`` resolved, and a bad value raises.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import wave
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import segma_tpu.data.device_cache as jax_device_cache
import segma_tpu.data.loaders as jax_loaders
from segma_tpu.data.file_dataset import DatasetSubset as JaxSubset
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.data import SegmaFileDataset as JaxDataset
from segma_tpu.data import SegmentationDataLoader as JaxLoader
from segma_tpu.models.hubert.builders import HUBERT_CONV_SETTINGS as JAX_CS
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import torch_to_flax
from segma_tpu_torch.data import (
    BatchContractError,
    DataLoaderError,
    DatasetSubset,
    DeviceAudioCache,
    SegmaFileDataset,
    SegmentationDataLoader,
)
from segma_tpu_torch.data import loaders
from segma_tpu_torch.models.hubert import HUBERT_CONV_SETTINGS
from segma_tpu_torch.train import Trainer, WaveformSource, device_waveform, eval_step
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_checkpoint import REPO
from tests.test_torch_resume import _setup
from tests.test_torch_train_accum import _fit, _held, _jax_fit, _overrides, _trainable_tensors
from tests.test_torch_train_loop import _rewrite_24bit

LR = 1e-3
CHUNK_F = 16_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path: Path, samples: np.ndarray, channels: int = 1) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(samples.astype("<i2").tobytes())


def _subsets(durations: list[int], uris: list[str]):
    d = np.array([(n, n) for n in durations],
                 dtype=[("audio_duration_f", "i8"), ("annotated_duration_f", "i8")])
    return (DatasetSubset(uris=uris, durations=d, indexes=[None] * len(uris)),
            JaxSubset(uris=uris, durations=d, indexes=[None] * len(uris)))


def _layout(kind: str, tmp_path: Path, synthetic_dataset: Path):
    """(port subset, JAX subset, dataset root) of one layout case."""
    if kind == "dataset":
        cfg = jax_load_config(REPO / "segma_tpu/config/default.yml", [
            f"data.dataset_path={synthetic_dataset}",
            "data.classes=[male,female,key_child,other_child]"])
        jds = JaxDataset.from_config(cfg)
        jds.load(use_cache=False)
        s = jds.train
        return (DatasetSubset(uris=s.uris, durations=s.durations, indexes=s.indexes), s,
                synthetic_dataset)
    wav = tmp_path / "wav"
    wav.mkdir()
    rng = np.random.default_rng(0)
    nxt = np.full(20_000, 999, np.int16)
    if kind == "short":
        _write(wav / "a.wav", (np.arange(1000) % 77).astype(np.int16))
        _write(wav / "b.wav", nxt)
        return (*_subsets([1000, 20_000], ["a", "b"]), tmp_path)
    if kind == "truncated":  # metadata claims 20,000 samples, the file holds 18,000
        _write(wav / "a.wav", (np.arange(18_000) % 77).astype(np.int16) + 1)
        _write(wav / "b.wav", nxt)
        return (*_subsets([20_000, 20_000], ["a", "b"]), tmp_path)
    _write(wav / "m.wav", rng.integers(-2000, 2000, 16_000))  # mixed: PCM16 and stereo
    _write(wav / "s.wav", rng.integers(-2000, 2000, 32_000), channels=2)
    return (*_subsets([16_000, 16_000], ["m", "s"]), tmp_path)


@pytest.mark.parametrize("kind", ["dataset", "short", "truncated", "mixed"])
def test_build_equals_jax(kind, tmp_path, synthetic_dataset):
    subset, jsubset, root = _layout(kind, tmp_path, synthetic_dataset)
    got = DeviceAudioCache.build(subset, root, CHUNK_F)
    want = jax_device_cache.DeviceAudioCache.build(jsubset, root, CHUNK_F)
    assert got.host_flat.dtype == want.host_flat.dtype
    assert (got.host_flat.dtype == np.float32) == (kind == "mixed")
    np.testing.assert_array_equal(got.host_flat, want.host_flat)
    np.testing.assert_array_equal(got.bases, want.bases)
    assert got.bases.dtype == np.int32 and got.nbytes == want.nbytes
    assert DeviceAudioCache.plan_nbytes(subset, root, CHUNK_F) == got.nbytes
    got.place("cpu")
    # the last crop the sampler can draw in the first file: its samples, then
    # zeros where the file is short of the slot, never the next file's
    start = max(0, int(subset.durations["audio_duration_f"][0]) - CHUNK_F - 1)
    crop = got.gather(torch.tensor([start], dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(crop, got.host_flat[start:start + CHUNK_F])
    if kind in ("short", "truncated"):
        assert not (crop == 999).any() and crop[-1] == 0


def _configs(root: Path, *extra: str):
    over = ["model.name=surgical_hubert_hydra", "audio.strict_frames=true",
            f"data.dataset_path={root}", "audio.chunk_duration_s=1.0", "train.batch_size=4",
            "train.seed=0", "train.dataloader.num_workers=1", *extra]
    return (load_config(REPO / "segma_tpu_torch/config/default.yml", over),
            jax_load_config(REPO / "segma_tpu/config/default.yml", over))


def _loaders(root: Path, *extra: str):
    """(port datamodule, JAX datamodule) over the same dataset and config."""
    cfg, jcfg = _configs(root, *extra)
    ds, jds = SegmaFileDataset.from_config(cfg), JaxDataset.from_config(jcfg)
    ds.load(use_cache=False)
    jds.load(use_cache=False)
    return (SegmentationDataLoader(ds, MultiLabelEncoder(cfg.data.classes), cfg,
                                   HUBERT_CONV_SETTINGS),
            JaxLoader(jds, JaxEncoder(jcfg.data.classes), jcfg, JAX_CS))


@pytest.fixture
def dataset(tmp_path):
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 2, 1), 8.0)
    return root


@pytest.mark.parametrize("transport", ["f32", "int16"])
def test_offsets_equal_jax_and_crops_equal_the_host_path(dataset, transport):
    dm, jdm = _loaders(dataset, "train.data_cache=device", f"train.transport={transport}")
    host, _ = _loaders(dataset, "train.data_cache=host", f"train.transport={transport}")
    for which in ("train_dataloader", "val_dataloader"):
        pl, jl, hl = getattr(dm, which)(), getattr(jdm, which)(), getattr(host, which)()
        assert pl.data_cache_decision is None and hl.device_cache is None
        cache = pl.device_cache
        np.testing.assert_array_equal(cache.host_flat, jl.device_cache.host_flat)
        cache.place("cpu")
        for epoch in (0, 1):
            for ldr in (pl, jl, hl):
                ldr.set_epoch(epoch)
            for pb, jb, hb in zip(pl, jl, hl, strict=True):
                assert set(pb) == set(jb) == {"offsets", "y"}
                for k in ("offsets", "y"):
                    assert pb[k].dtype == jb[k].dtype
                    np.testing.assert_array_equal(pb[k], jb[k])
                np.testing.assert_array_equal(pb["y"], hb["y"])
                crops = cache.gather(torch.from_numpy(pb["offsets"]))
                if transport == "int16":  # the raw PCM16 crops themselves
                    assert torch.equal(crops, torch.from_numpy(hb["x"]))
                assert torch.equal(device_waveform(crops), device_waveform(torch.from_numpy(hb["x"])))


def _plan_bytes(dm_cfg_root: Path) -> tuple[int, int]:
    cfg, _ = _configs(dm_cfg_root)
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    return tuple(DeviceAudioCache.plan_nbytes(s, dm_cfg_root, cfg.audio.chunk_duration_f)
                 for s in (ds.train, ds.val))


@pytest.mark.parametrize("case", ["within", "over", "joint", "int32", "low_ram"])
def test_auto_resolves_as_jax(monkeypatch, dataset, case):
    train_b, val_b = _plan_bytes(dataset)
    budget = {"over": 1e-9, "joint": (train_b + val_b / 2) / 1e9}.get(case, 12.0)
    if case == "low_ram":
        for mod in (loaders, jax_loaders):
            monkeypatch.setattr(mod, "_mem_available_bytes", lambda: 1000)
    if case == "int32":
        for cls in (DeviceAudioCache, jax_device_cache.DeviceAudioCache):
            real = cls.plan.__func__

            def huge(c, *a, _real=real, **k):
                any_f32, paths, bases, slots, _ = _real(c, *a, **k)
                return any_f32, paths, bases, slots, 2**31

            monkeypatch.setattr(cls, "plan", classmethod(huge))
    # fixed-point: YAML reads "1e-09" as a string
    dm, jdm = _loaders(dataset, "train.data_cache=auto",
                       f"train.device_cache_budget_gb={budget:.12f}")
    want_device = {"within": (True, True), "joint": (True, False)}.get(case, (False, False))
    for which, device in zip(("train_dataloader", "val_dataloader"), want_device):
        pl, jl = getattr(dm, which)(), getattr(jdm, which)()
        assert pl.data_cache_decision == jl.data_cache_decision
        assert pl.data_cache_decision.startswith(f"auto -> {'device' if device else 'host'}")
        assert (pl.device_cache is not None) == (jl.device_cache is not None) == device
    if case == "int32":
        for mod in (dm, jdm):
            mod.config.train.data_cache = "device"
            with pytest.raises((DataLoaderError, jax_loaders.DataLoaderError), match="int32"):
                mod.train_dataloader()


def test_bad_data_cache_value_and_batch_contract(dataset):
    dm, _ = _loaders(dataset, "train.data_cache=device")
    dm.config.train.data_cache = "hbm"
    with pytest.raises(DataLoaderError, match="data_cache"):
        dm.train_dataloader()
    dm.config.train.data_cache = "device"
    loader = dm.train_dataloader()
    loader.device_cache.place("cpu")
    loader.set_epoch(0)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(loader)).items()}
    with pytest.raises(BatchContractError, match="offsets"):
        WaveformSource()(batch)  # a step without a cache, given offsets
    host = {"x": torch.zeros(4, CHUNK_F), "y": batch["y"]}
    with pytest.raises(BatchContractError, match="'x'"):
        WaveformSource(loader.device_cache)(host)
    assert WaveformSource(loader.device_cache)(batch).shape == (4, CHUNK_F)
    with pytest.raises(BatchContractError):  # before the model runs
        eval_step(SimpleNamespace(module=None), host, WaveformSource(loader.device_cache))


# -- trajectories at the tiny HuBERT widths --------------------------------------------


def _replace_train(cfg, **fields):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **fields))


def _trainable(result: dict, trainer: Trainer) -> dict[str, torch.Tensor]:
    names = [n for n, p in trainer.model.module.named_parameters() if p.requires_grad]
    return {n: result["params"][n] for n in names}


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b) and a
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _records(run_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("sources", ["pcm16", "one_24bit"])
def test_device_cache_trajectory_equals_the_host_path(monkeypatch, tmp_path, sources):
    """Two epochs over the device cache end bit-equal to the host path, with
    an int16 buffer (PCM16 sources; and against int16 transport) and an f32
    one (one 24-bit source)."""
    cfg, ds = _setup(monkeypatch, tmp_path)
    if sources == "one_24bit":
        _rewrite_24bit(tmp_path / "data" / "wav" / f"{ds.train.uris[0]}.wav")
    runs = {}
    for tag, fields in (("host", {"data_cache": "host"}), ("device", {"data_cache": "device"}),
                        ("host16", {"data_cache": "host", "transport": "int16"})):
        trainer, result = _fit(_replace_train(cfg, **fields), ds, tmp_path / tag, 2, dropout=0.5)
        runs[tag] = (trainer, result)
    device_t = runs["device"][0]
    assert device_t.train_source.cache is not None
    assert device_t.train_source.cache.host_flat.dtype == (
        np.int16 if sources == "pcm16" else np.float32)
    assert runs["host"][0].train_source.cache is None
    assert any("device_cache_mb" in r for r in _records(tmp_path / "device"))
    for tag in ("host", "host16"):
        trainer, result = runs[tag]
        _assert_bit_equal(_trainable(result, trainer), _trainable(runs["device"][1], device_t))
        for a, b in zip(result["history"], runs["device"][1]["history"], strict=True):
            assert (a["train/loss"], a["val/loss"], a["val/f1_score"]) == (
                b["train/loss"], b["val/loss"], b["val/f1_score"])


K = 3


def test_epoch_dispatch_equals_step_dispatch_with_cosine_accumulation_and_resume(
        monkeypatch, tmp_path):
    """The plain loop of epoch dispatch against step dispatch: the cosine
    rate set per micro-step, k=3 accumulation across the epoch boundary (4
    micro-steps per epoch), dropout on; and epoch dispatch resumed from
    ``last/`` at ``mini_step`` 1."""
    cfg, ds = _setup(monkeypatch, tmp_path, [
        "train.scheduler.type=cosine", "train.scheduler.warmup_steps=2",
        "train.scheduler.min_lr_ratio=0.1", f"train.grad_accum_steps={K}",
        "train.log_every_n_steps=1", "train.data_cache=device"])
    epoch_cfg = _replace_train(cfg, dispatch="epoch")
    t_step, step = _fit(cfg, ds, tmp_path / "step", 2, dropout=0.5)
    t_epoch, epoch = _fit(epoch_cfg, ds, tmp_path / "epoch", 2, dropout=0.5)
    _fit(epoch_cfg, ds, tmp_path / "first", 1, dropout=0.5)
    last = tmp_path / "first" / "checkpoints" / "last"
    assert int(ckpt.msgpack_restore((last / "opt_state.msgpack").read_bytes())["mini_step"]) == 1
    t_res, resumed = _fit(epoch_cfg, ds, tmp_path / "resumed", 2, resume_from=last, dropout=0.5)
    assert t_epoch.replay is not None and t_step.replay is None
    assert [h["epoch"] for h in resumed["history"]] == [1]
    for trainer, result in ((t_epoch, epoch), (t_res, resumed)):
        _assert_bit_equal(_trainable(result, trainer), _trainable(step, t_step))
        assert (trainer.accum.mini_step, trainer.accum.gradient_step) == (2, 2)
    for a, b in zip(step["history"], epoch["history"], strict=True):
        for key in ("train/loss", "val/loss", "val/f1_score", "lr"):
            assert a[key] == b[key], key
    steps = [[(r["step"], r["train/loss_step"]) for r in _records(tmp_path / tag)
              if "train/loss_step" in r] for tag in ("step", "epoch")]
    assert len(steps[0]) == 8 and steps[0] == steps[1]


def test_epoch_dispatch_preempt_saves_the_completed_epoch(monkeypatch, tmp_path):
    """A signal during an epoch under epoch dispatch is honoured at its end:
    the epoch counts as completed, ``last/`` holds it, and a resume starts
    at the next epoch."""
    cfg, ds = _setup(monkeypatch, tmp_path, ["train.dispatch=epoch"])
    model = ckpt.build_model(cfg, device="cpu")
    dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
    trainer = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", device="cpu")
    real = trainer._train_epoch_replay

    def with_signal(loader):
        out = real(loader)
        trainer._handle_preempt_signal(signal.SIGTERM, None)
        return out

    trainer._train_epoch_replay = with_signal
    result = trainer.fit(dm)
    assert result["interrupted"] is True and result["history"] == []
    last = tmp_path / "run" / "checkpoints" / "last"
    assert ckpt.load_meta(last)["epoch"] == 0
    records = _records(tmp_path / "run")
    assert {"preempted_at_epoch": 0, "epoch_completed": True}.items() <= next(
        r for r in records if "preempted_at_epoch" in r).items()
    _, resumed = _fit(cfg, ds, tmp_path / "run2", 2, resume_from=last)
    assert [h["epoch"] for h in resumed["history"]] == [1]


def test_epoch_dispatch_matches_jax_make_epoch_fn(monkeypatch, tmp_path):
    """The port's epoch dispatch and JAX's (one ``lax.scan`` per epoch), from
    the same weights, dropout 0, cosine rates, two epochs: JAX's own step-vs-
    scan tolerances on the losses and F1, and the parameters as
    tests/test_torch_train_accum.py holds a fit to JAX's."""
    extra = ["train.dispatch=epoch", "train.data_cache=device", "train.scheduler.type=cosine",
             "train.scheduler.warmup_steps=2"]
    cfg, ds = _setup(monkeypatch, tmp_path, extra)
    init = ckpt.build_model(cfg, device="cpu")
    trainable = [n for n, p in init.module.named_parameters() if p.requires_grad]
    jt, jres = _jax_fit([*_overrides(tmp_path / "data", 1), *extra], tmp_path / "data",
                        tmp_path / "jax", 2, torch_to_flax(init.module))
    assert jt.epoch_fn is not None and jt.val_epoch_fn is not None
    t, res = _fit(cfg, ds, tmp_path / "port", 2, dropout=0.0)
    assert t.replay is not None
    for a, b in zip(res["history"], jres["history"], strict=True):
        for key, rtol in (("train/loss", 1e-5), ("val/loss", 1e-5), ("val/f1_score", 1e-4)):
            np.testing.assert_allclose(a[key], b[key], rtol=rtol, err_msg=key)
    want = _trainable_tensors(jres["params"], init.frozen_prefixes)
    noise = {n: np.ones(want[n].shape, bool) if n.endswith("k_proj.bias")
             else np.zeros(want[n].shape, bool) for n in trainable}
    n_updates = 2 * 4  # 2 epochs of 4 steps: the noise entries within one lr per update
    _held({n: res["params"][n] for n in trainable}, {n: want[n] for n in trainable}, noise,
          n_updates * LR, "port epoch dispatch against JAX's")


def test_dispatch_errors(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path, ["train.dispatch=epoch"])
    model = ckpt.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        Trainer(model=model, config=_replace_train(cfg, dispatch="batch"),
                run_dir=tmp_path / "bad", device="cpu")
    with pytest.raises(ValueError, match="data_cache=device"):
        Trainer(model=model, config=_replace_train(cfg, data_cache="host"),
                run_dir=tmp_path / "host", device="cpu")
    small = _replace_train(cfg, device_cache_budget_gb=1e-9)  # auto resolves to the host
    dm = SegmentationDataLoader(ds, model.label_encoder, small, model.conv_settings)
    trainer = Trainer(model=model, config=small, run_dir=tmp_path / "auto", device="cpu")
    with pytest.raises(ValueError, match="resolved auto -> host"):
        trainer.fit(dm)
    assert any(r.get("data_cache_train", "").startswith("auto -> host")
               for r in _records(tmp_path / "auto"))
