"""The training loop's switches against the JAX package's, at the tiny
HuBERT widths of tests/test_torch_checkpoint.py on the CPU:

- ``cosine_lr`` equals JAX's at every step of a schedule with warmup and a
  floor;
- a fit with the cosine schedule, k=3 accumulation and
  ``val_every_n_epochs=2`` over 3 epochs (dropout 0, the same initial
  weights on both sides) against JAX's ``Trainer.fit``: the same epochs
  validate, the same epochs refresh ``last/`` and score a checkpoint, the
  same learning rates are logged, the LR set before each micro-step is
  ``cosine_lr`` of the global micro-step, and the trainable parameters
  agree at atol 1e-5 (the attention's k biases, whose gradient is rounding
  noise, within one lr per update: 4 lr);
- the port's ``binary_auroc_np`` equals JAX's exactly, with ties and with
  a label without positives; a fit with ``validation_metric=auroc``
  monitors ``val/auroc``, which equals the AUROC of the trained model's
  validation scores, and ``roc`` writes the figure;
- the RSS watchdog with a tiny limit stops after epoch 0, interrupted;
- ``train.profiler`` writes a trace of the epoch after the first and logs
  ``profile_dir``;
- ``debug_nans`` raises ``FloatingPointError`` on the silent batch of
  tests/test_torch_train.py, before any update, and names the step;
- under a seed, cuDNN's deterministic algorithms hold inside ``fit`` and
  the caller's flags come back after it; unseeded, nothing changes;
- int16 transport: batches equal JAX's int16 batches and, after
  ``device_waveform``, the f32 batches bit for bit; a non-PCM16 source
  falls back to f32; a fit with int16 ends bit-equal to one with f32;
- remat: the gradients equal the non-remat ones, ``torch.utils.checkpoint``
  runs once per layer under autograd and never in evaluation, and a fit
  with remat ends bit-equal to one without;
- every training key of the JAX schema loads at a value away from its
  default (the device cache's and epoch dispatch's among them); ``Config.save``
  is read back by both packages' ``load_config``.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import threading
import warnings
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import segma_tpu.checkpoint as jckpt
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.data import SegmaFileDataset as JaxDataset
from segma_tpu.data import SegmentationDataLoader as JaxLoader
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.hubert.builders import HUBERT_CONV_SETTINGS as JAX_CS
from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxEncoderConfig
from segma_tpu.ops.metrics import binary_auroc_np as jax_auroc
from segma_tpu.ops.metrics import roc_curve_np as jax_roc
from segma_tpu.train import cosine_lr as jax_cosine_lr
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params, torch_to_flax
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert import HUBERT_CONV_SETTINGS
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.ops.metrics import binary_auroc_np, roc_curve_np
from segma_tpu_torch.train import (
    Trainer,
    cosine_lr,
    device_waveform,
    eval_step,
    get_metric,
    make_optimizer,
    make_train_step,
)
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_checkpoint import HUBERT_TINY, REPO
from tests.test_torch_resume import _setup
from tests.test_torch_train_accum import (
    NAME,
    _fit,
    _held,
    _jax_fit,
    _overrides,
    _trainable_tensors,
)

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replace_train(cfg, **fields):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **fields))


def _trainable(result: dict, trainer: Trainer) -> dict[str, torch.Tensor]:
    names = [n for n, p in trainer.model.module.named_parameters() if p.requires_grad]
    return {n: result["params"][n] for n in names}


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b) and a
    for name in a:
        assert torch.equal(a[name], b[name]), name


# -- the cosine schedule and the validation cadence, against JAX ---------------------


@pytest.mark.parametrize("total,warmup,floor", [(20, 2, 0.1), (12, 0, 0.0), (7, 7, 0.5),
                                                 (5, 9, 0.2)])
def test_cosine_lr_equals_jax(total, warmup, floor):
    for step in range(total + 3):
        assert cosine_lr(step, 3e-4, total, warmup, floor) == jax_cosine_lr(
            step, 3e-4, total, warmup, floor)


def _record_manager(monkeypatch, manager_cls, calls: list):
    step, refresh = manager_cls.step, manager_cls.refresh_last

    def recording_step(self, epoch, *args, **kwargs):
        calls.append(("step", epoch))
        return step(self, epoch, *args, **kwargs)

    def recording_refresh(self, epoch, *args, **kwargs):
        calls.append(("refresh", epoch))
        return refresh(self, epoch, *args, **kwargs)

    monkeypatch.setattr(manager_cls, "step", recording_step)
    monkeypatch.setattr(manager_cls, "refresh_last", recording_refresh)


def test_cosine_accumulation_and_val_cadence_match_jax(monkeypatch, tmp_path):
    extra = ["train.grad_accum_steps=3", "train.scheduler.type=cosine",
             "train.scheduler.warmup_steps=2", "train.scheduler.min_lr_ratio=0.1",
             "train.val_every_n_epochs=2"]
    cfg, ds = _setup(monkeypatch, tmp_path, extra)
    root = tmp_path / "data"
    init = ckpt.build_model(cfg, device="cpu")
    trainable = [n for n, p in init.module.named_parameters() if p.requires_grad]
    port_calls, jax_calls, lrs = [], [], []
    _record_manager(monkeypatch, ckpt.CheckpointManager, port_calls)
    _record_manager(monkeypatch, jckpt.CheckpointManager, jax_calls)

    def wrap(trainer, step):
        def recorded(batch, generator):
            lrs.append((trainer.global_step, trainer.optimizer.param_groups[0]["lr"]))
            return step(batch, generator)
        return recorded

    trainer, result = _fit(cfg, ds, tmp_path / "port", 3, dropout=0.0, wrap=wrap)
    jt, jres = _jax_fit([*_overrides(root), *extra[1:]], root, tmp_path / "jax", 3,
                        torch_to_flax(init.module))

    assert port_calls == jax_calls == [("refresh", 0), ("step", 1), ("step", 2)]
    for ours, theirs in zip(result["history"], jres["history"], strict=True):
        assert ours["epoch"] == theirs["epoch"]
        assert ("val/loss" in ours) == ("val/loss" in theirs) == (ours["epoch"] != 0)
        assert ours["lr"] == theirs["lr"]
    n = trainer.global_step // 3  # micro-steps per epoch
    assert [s for s, _ in lrs] == list(range(3 * n))
    for s, lr in lrs:
        assert lr == float(np.float32(cosine_lr(s, cfg.train.lr, 3 * n, 2, 0.1)))
    assert lrs[0][1] < lrs[1][1] == float(np.float32(cfg.train.lr)) > lrs[-1][1]
    assert trainer.accum.gradient_step == 3 * n // 3
    want = _trainable_tensors(jres["params"], init.frozen_prefixes)
    noise = {k: np.ones(want[k].shape, bool) if k.endswith("k_proj.bias")
             else np.zeros(want[k].shape, bool) for k in trainable}
    _held({k: result["params"][k] for k in trainable}, {k: want[k] for k in trainable}, noise,
          trainer.accum.gradient_step * LR, "cosine, k=3, val every 2")


# -- AUROC and ROC ---------------------------------------------------------------------


def test_auroc_and_roc_equal_jax():
    rng = np.random.default_rng(3)
    scores = np.round(rng.random((500, 4)), 1).astype(np.float32)  # many ties
    targets = (rng.random((500, 4)) > 0.5).astype(np.float32)
    targets[:, 2] = 0.0  # no positives: 0.5
    targets[:, 3] = 1.0  # no negatives: 0.5
    got, want = binary_auroc_np(scores, targets), jax_auroc(scores, targets)
    np.testing.assert_array_equal(got, want)
    assert got[2] == got[3] == 0.5 and 0.3 < got[0] < 0.7
    perfect = binary_auroc_np(targets[:, :2] + 0.1 * scores[:, :2], targets[:, :2])
    np.testing.assert_array_equal(perfect, [1.0, 1.0])
    for i in range(2):
        for a, b in zip(roc_curve_np(scores[:, i], targets[:, i]),
                        jax_roc(scores[:, i], targets[:, i])):
            np.testing.assert_array_equal(a, b)
    assert get_metric("auroc") == ("max", "val/auroc")


def test_fit_monitors_auroc(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path, [
        "train.validation_metric=auroc", "train.extra_val_metrics=[loss,f1_score,auroc,roc]"])
    trainer, result = _fit(cfg, ds, tmp_path / "run", 1)
    h = result["history"][0]
    labels = cfg.data.classes
    assert trainer.monitor == "val/auroc" and trainer.mode == "max"
    assert {"val/auroc", "val/f1_score", "val/loss"} <= set(h)
    assert all(f"val/auroc_{lb}" in h for lb in labels)
    assert result["best_score"] == h["val/auroc"]
    assert "val_auroc=" in Path(result["best_path"]).name
    probs, targets = [], []
    loader = SegmentationDataLoader(ds, trainer.model.label_encoder,
                                    _replace_train(cfg, data_cache="host"),
                                    trainer.model.conv_settings).val_dataloader()
    loader.set_epoch(0)
    for batch in loader:
        probs.append(eval_step(trainer.model, trainer._put(batch))[3].numpy())
        targets.append(batch["y"].reshape(-1, len(labels)))
    auroc = binary_auroc_np(np.concatenate(probs), np.concatenate(targets))
    assert h["val/auroc"] == float(auroc.mean())
    assert [h[f"val/auroc_{lb}"] for lb in labels] == [float(a) for a in auroc]
    assert (tmp_path / "run" / "roc_latest.png").stat().st_size > 0


# -- watchdog, profiler, debug_nans, determinism -----------------------------------------


def test_rss_watchdog_stops_at_epoch_0(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path, ["train.host_rss_limit_gb=1e-6"])
    trainer, result = _fit(cfg, ds, tmp_path / "run", 3)
    assert result["interrupted"] is True
    assert [h["epoch"] for h in result["history"]] == [0]
    assert ckpt.load_meta(tmp_path / "run" / "checkpoints" / "last")["epoch"] == 0
    records = [json.loads(ln) for ln in (tmp_path / "run" / "metrics.jsonl").read_text()
               .splitlines()]
    stop = [r for r in records if "recycle_at_epoch" in r]
    assert len(stop) == 1 and stop[0]["recycle_at_epoch"] == 0 and stop[0]["host_rss_gb"] > 0
    cfg_off = _replace_train(cfg, host_rss_limit_gb=0.0)
    assert not _fit(cfg_off, ds, tmp_path / "off", 1)[1]["interrupted"]


def test_profiler_traces_the_second_epoch(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path, ["train.profiler=simple"])
    _fit(cfg, ds, tmp_path / "run", 2)
    profile = tmp_path / "run" / "profile"
    trace = json.loads((profile / "epoch_1.json").read_text())
    assert trace["traceEvents"]
    assert sorted(p.name for p in profile.iterdir()) == ["epoch_1.json", "spans_epoch_1.jsonl"]
    spans = [json.loads(ln) for ln in (profile / "spans_epoch_1.jsonl").read_text().splitlines()]
    assert "train.step" in {s["name"] for s in spans}
    records = [json.loads(ln) for ln in (tmp_path / "run" / "metrics.jsonl").read_text()
               .splitlines()]
    assert [r["profile_dir"] for r in records if "profile_dir" in r] == [str(profile)]


def _silent_model(n_layers: int = 12):
    """The port's tiny HuBERT at JAX's initial weights (zero biases), f32,
    dropout 0, as tests/test_torch_train.py's silent batch uses it."""
    extra = ["model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
             "audio.strict_frames=true", "audio.chunk_duration_s=1.0", "train.precision=f32"]
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    tiny = dict(HUBERT_TINY, n_layers=n_layers)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels[NAME](JaxEncoder(jcfg.data.classes), jcfg)
        cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                          [*extra, "train.debug_nans=true", "train.seed=0"])
        model = Models[NAME](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=HubertEncoderConfig(**tiny))
    jmodel.module = jmodel.module.clone(enc_cfg=JaxEncoderConfig(**tiny), dropout=0.0)
    load_flax_params(model.module, jax.tree.map(np.asarray,
                                                jmodel.init_params(jax.random.key(0))))
    model.module.dropout = 0.0
    batch = {"x": np.zeros((2, 16_000), np.float32),
             "y": (np.random.default_rng(0).random((2, 49, 4)) > 0.7).astype(np.float32)}
    return cfg, model, batch


class _OneBatch:
    """A loader of one fixed batch per epoch."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return 1

    def __iter__(self):
        yield self.batch

    def set_epoch(self, epoch):
        pass


class _Datamodule:
    def __init__(self, batch):
        self.loader = _OneBatch(batch)

    def train_dataloader(self):
        return self.loader

    def val_dataloader(self):
        return self.loader


def test_debug_nans_raises_on_the_silent_batch(tmp_path):
    cfg, model, batch = _silent_model()
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    step = make_train_step(model, make_optimizer(model, LR), debug_nans=True)
    with pytest.raises(FloatingPointError, match="non-finite"):
        step({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert all(torch.equal(p, before[n]) for n, p in model.module.named_parameters())
    trainer = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", device="cpu")
    with pytest.raises(FloatingPointError, match="train step 1: non-finite"):
        trainer.fit(_Datamodule(batch))
    quiet = make_train_step(model, make_optimizer(model, LR))  # debug_nans off: no check
    quiet({k: torch.from_numpy(v) for k, v in batch.items()}, None)


@pytest.mark.parametrize("seeded", [True, False])
def test_cudnn_deterministic_inside_a_seeded_fit(monkeypatch, tmp_path, seeded):
    cfg, ds = _setup(monkeypatch, tmp_path)
    if not seeded:
        cfg = _replace_train(cfg, seed=None)
    cudnn = torch.backends.cudnn
    seen = []

    def wrap(trainer, step):
        def flagged(batch, generator):
            seen.append((cudnn.deterministic, cudnn.benchmark))
            return step(batch, generator)
        return flagged

    caller = (cudnn.deterministic, cudnn.benchmark)
    cudnn.benchmark = True
    try:
        _fit(cfg, ds, tmp_path / "run", 1, wrap=wrap)
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = caller
    assert seen and set(seen) == {(True, False) if seeded else (False, True)}


# -- int16 transport -------------------------------------------------------------------


def _rewrite_24bit(path: Path) -> None:
    """The same samples as a 24-bit PCM WAV (not PCM16)."""
    with wave.open(str(path)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32) << 8
    raw = np.stack([(pcm >> s) & 0xFF for s in (0, 8, 16)], 1).astype(np.uint8).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16_000)
        w.writeframes(raw)


@pytest.mark.parametrize("sources", ["pcm16", "one_24bit"])
def test_int16_transport_batches(tmp_path, sources):
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    if sources == "one_24bit":
        _rewrite_24bit(root / "wav" / f"{(root / 'train.txt').read_text().split()[0]}.wav")
    extra = ["model.name=surgical_hubert_hydra", "audio.strict_frames=true",
             f"data.dataset_path={root}", "audio.chunk_duration_s=1.0", "train.batch_size=4",
             "train.seed=0", "train.dataloader.num_workers=1", "train.data_cache=host"]
    loaders = {}
    for transport in ("f32", "int16"):
        cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                          [*extra, f"train.transport={transport}"])
        ds = SegmaFileDataset.from_config(cfg)
        ds.load(use_cache=False)
        loaders[transport] = SegmentationDataLoader(
            ds, MultiLabelEncoder(cfg.data.classes), cfg, HUBERT_CONV_SETTINGS).train_dataloader()
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml",
                           [*extra, "train.transport=int16"])
    jds = JaxDataset.from_config(jcfg)
    jds.load(use_cache=False)
    jloader = JaxLoader(jds, JaxEncoder(jcfg.data.classes), jcfg, JAX_CS).train_dataloader()
    n_int16 = 0
    for epoch in (0, 1):
        for ldr in (*loaders.values(), jloader):
            ldr.set_epoch(epoch)
        for f32, i16, jb in zip(loaders["f32"], loaders["int16"], jloader, strict=True):
            assert f32["x"].dtype == np.float32
            assert i16["x"].dtype == jb["x"].dtype
            np.testing.assert_array_equal(i16["x"], jb["x"])
            np.testing.assert_array_equal(i16["y"], f32["y"])
            x = device_waveform(torch.from_numpy(i16["x"]))
            assert x.dtype == torch.float32
            assert torch.equal(x, torch.from_numpy(f32["x"]))
            n_int16 += i16["x"].dtype == np.int16
    if sources == "pcm16":
        assert n_int16 == 2 * len(loaders["f32"])
    else:
        assert n_int16 < 2 * len(loaders["f32"])  # the 24-bit file's batches fall back


def test_int16_transport_fit_equals_f32(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path)
    t32, r32 = _fit(cfg, ds, tmp_path / "f32", 1)
    t16, r16 = _fit(_replace_train(cfg, transport="int16"), ds, tmp_path / "int16", 1)
    _assert_bit_equal(_trainable(r16, t16), _trainable(r32, t32))
    assert r16["history"][0]["val/loss"] == r32["history"][0]["val/loss"]


# -- remat -----------------------------------------------------------------------------


def test_remat_gradients_equal_and_checkpoint_on_the_path(monkeypatch):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", [
        "model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
        "audio.strict_frames=true", "audio.chunk_duration_s=1.0", "train.precision=f32"])
    calls = []
    original = torch.utils.checkpoint.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return original(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((2, 16_000)) * 0.1).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 49, 4)) > 0.7).astype(np.float32))
    grads = {}
    for remat in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = Models[NAME](MultiLabelEncoder(cfg.data.classes),
                                 _replace_train(cfg, remat=remat), device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 enc_cfg=HubertEncoderConfig(**HUBERT_TINY))
        assert model.module.encoder.remat is remat
        model.module.dropout = 0.0
        n = len(calls)
        loss, _ = model.loss(model.module(x, train=True), y)
        loss.backward()
        assert len(calls) - n == (HUBERT_TINY["n_layers"] if remat else 0)
        grads[remat] = {k: p.grad for k, p in model.module.named_parameters()
                        if p.grad is not None}
        with torch.no_grad():
            model.module(x)
        model.apply(x)
        assert len(calls) - n == (HUBERT_TINY["n_layers"] if remat else 0)
    assert calls == [False] * HUBERT_TINY["n_layers"]  # use_reentrant=False
    _assert_bit_equal(grads[True], grads[False])


def test_remat_fit_equals_plain(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path)
    t0, r0 = _fit(cfg, ds, tmp_path / "plain", 1)
    t1, r1 = _fit(_replace_train(cfg, remat=True), ds, tmp_path / "remat", 1)
    assert t1.model.module.encoder.remat
    _assert_bit_equal(_trainable(r1, t1), _trainable(r0, t0))


# -- config ----------------------------------------------------------------------------


@pytest.mark.parametrize("override,field,value", [
    ("train.grad_accum_steps=3", "grad_accum_steps", 3),
    ("train.scheduler.type=cosine", "scheduler.type", "cosine"),
    ("train.scheduler.warmup_steps=5", "scheduler.warmup_steps", 5),
    ("train.scheduler.min_lr_ratio=0.1", "scheduler.min_lr_ratio", 0.1),
    ("train.transport=int16", "transport", "int16"),
    ("train.remat=true", "remat", True),
    ("train.profiler=simple", "profiler", "simple"),
    ("train.debug_nans=true", "debug_nans", True),
    ("train.host_rss_limit_gb=0", "host_rss_limit_gb", 0),
    ("train.val_every_n_epochs=2", "val_every_n_epochs", 2),
    ("train.validation_metric=auroc", "validation_metric", "auroc"),
    ("train.extra_val_metrics=[loss,auroc,roc]", "extra_val_metrics", ["loss", "auroc", "roc"]),
    ("train.dispatch=epoch", "dispatch", "epoch"),
    ("train.data_cache=device", "data_cache", "device"),
    ("train.device_cache_budget_gb=4.0", "device_cache_budget_gb", 4.0),
])
def test_ported_training_options_load(tmp_path, override, field, value):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", [override])
    node = cfg.train
    for part in field.split("."):
        node = getattr(node, part)
    assert node == value
    cfg.save(tmp_path / "config.yml")
    assert load_config(tmp_path / "config.yml") == cfg
    jcfg = jax_load_config(tmp_path / "config.yml")
    jnode = jcfg.train
    for part in field.split("."):
        jnode = getattr(jnode, part)
    assert jnode == value


def test_sigterm_handler_installed_in_fit_and_restored(monkeypatch, tmp_path):
    """From the main thread, ``fit`` installs its SIGTERM handler for the
    loop and gives the caller's back; from another thread it installs none."""
    cfg, ds = _setup(monkeypatch, tmp_path)
    seen = []

    def wrap(trainer, step):
        def probed(batch, generator):
            seen.append(signal.getsignal(signal.SIGTERM) == trainer._handle_preempt_signal)
            return step(batch, generator)
        return probed

    caller = signal.getsignal(signal.SIGTERM)
    if threading.current_thread() is threading.main_thread():
        _fit(cfg, ds, tmp_path / "main", 1, wrap=wrap)
        assert seen and all(seen)
        assert signal.getsignal(signal.SIGTERM) is caller
    seen.clear()
    worker = threading.Thread(target=_fit, args=(cfg, ds, tmp_path / "thread", 1),
                              kwargs={"wrap": wrap})
    worker.start()
    worker.join()
    assert seen and not any(seen)
    assert signal.getsignal(signal.SIGTERM) is caller
