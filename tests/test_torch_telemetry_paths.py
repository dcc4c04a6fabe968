"""Spans and counters where the work happens, on the CPU at tiny widths:

- serving (``run_inference_on_audios``) over a long file (segments of 512
  chunks) and a short one: the chunk counters equal the files' needs and
  the bucket arithmetic, every file has its spans, nested as documented;
- the model step: ``model.logmel``, ``model.encoder``, ``model.bilstm`` and
  ``model.heads`` of a ``surgical_hydra`` forward;
- a tiny ``Trainer.fit``: one ``train.loader_wait`` and one ``train.step``
  per step (and one wait that finds the loader's end), the step's children,
  the epoch's spans and counters, and with ``train.profiler`` set the
  profiled epoch's spans written beside its trace.
"""

from __future__ import annotations

import json
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

import chip_smoke
from segma_tpu_torch import inference as tinf
from segma_tpu_torch import telemetry
from segma_tpu_torch.config import load_config
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.train import Trainer
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
DEFAULT = REPO / "segma_tpu_torch/config/default.yml"
SEGMENT = 512  # InferencePipeline.max_bucket_chunks


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_store():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.clear()
    yield
    telemetry.clear()
    torch.set_num_threads(n)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def test_serving_spans_and_chunk_counters(tmp_path):
    cfg = load_config(DEFAULT, ["model.name=conv_vad", "model.config.hidden=32",
                                "model.config.depth=2", "model.config.dtype=f32",
                                "audio.chunk_duration_s=1.0"])
    model = Models["conv_vad"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    wavs = tmp_path / "wav"
    wavs.mkdir()
    stride = tinf.InferencePipeline(model, device="cpu").chunkyfier.chunk_stride
    lengths = {"long": (SEGMENT + 40) * stride + 3_000, "short": 5 * stride + 200}
    pipe = tinf.InferencePipeline(model, batch_size=16, device="cpu")
    needed, padded, shipped = {}, {}, 0
    chunk_f = pipe.chunkyfier.chunk_duration_f
    for stem, n in lengths.items():
        chip_smoke.write_wav(wavs / f"{stem}.wav", n)
        _, frames = pipe._n_frames(torch.zeros(n).numpy())
        needed[stem] = -(-frames // pipe.chunkyfier.n_windows)
        segments = [min(SEGMENT, needed[stem] - s) for s in range(0, needed[stem], SEGMENT)]
        padded[stem] = sum(_pow2(s) - s for s in segments)
        shipped += sum((_pow2(s) * stride + chunk_f) * 2 for s in segments)  # int16
    assert len(range(0, needed["long"], SEGMENT)) == 2 and needed["short"] <= SEGMENT

    with telemetry.recording() as rec:
        done = tinf.run_inference_on_audios(cfg, wavs, None, tmp_path / "out", model=model,
                                            batch_size=16, device="cpu", mesh="off")
    assert sorted(p.stem for p in done) == ["long", "short"]
    c = rec.counters
    assert c["serve.chunks_real"] == sum(needed.values())
    assert c["serve.chunks_padded"] == sum(padded.values())
    assert c["serve.bytes_to_device"] == shipped

    names = Counter(s.name for s in rec.spans)
    assert names["serve.queue_wait"] == 3  # two files and the end
    assert names["serve.dispatch"] == 2 and names["serve.segment"] == 3
    by_id = {s.id: s for s in rec.spans}
    for stem in lengths:
        mine = [s for s in rec.spans if s.attrs.get("file") == stem]
        assert Counter(s.name for s in mine) == Counter(
            ["serve.load", "serve.dispatch", "serve.finish", "serve.write"])
        finish = next(s for s in mine if s.name == "serve.finish")
        write = next(s for s in mine if s.name == "serve.write")
        assert write.parent == finish.id
        load = next(s for s in mine if s.name == "serve.load")
        assert load.thread != finish.thread  # the prefetch thread
    for s in rec.named("serve.segment"):
        assert by_id[s.parent].name == "serve.dispatch"
    main = {s.thread for s in rec.named("serve.queue_wait")}
    assert main == {s.thread for s in rec.named("serve.dispatch")}
    # off, nothing is recorded and the totals go on
    before = telemetry.counts()["serve.chunks_real"]
    tinf.run_inference_on_audios(cfg, wavs, None, tmp_path / "again", model=model,
                                 batch_size=16, device="cpu", mesh="off")
    assert telemetry.recorded().spans == []
    assert telemetry.counts()["serve.chunks_real"] == before + sum(needed.values())


def test_model_step_spans():
    overrides = ["model.name=surgical_hydra", "model.config.encoder=whisper_tiny_random",
                 "model.config.lstm.hidden_size=8", "audio.chunk_duration_s=1.0",
                 "train.precision=f32"]
    cfg = load_config(DEFAULT, overrides)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=WhisperEncoderConfig(d_model=16, n_heads=2, n_layers=1, ffn_dim=32))
    with telemetry.recording() as rec:
        model.apply(torch.zeros(2, cfg.audio.chunk_duration_f))
    assert [s.name for s in rec.spans] == ["model.logmel", "model.encoder", "model.bilstm",
                                           "model.heads"]
    assert all(s.parent is None for s in rec.spans)
    assert rec.named("model.bilstm")[0].cuda_ns is None  # no card: no device time


def test_trainer_spans_counters_and_profiled_epoch(tmp_path):
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(DEFAULT, [
        "model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
        "audio.strict_frames=true", f"data.dataset_path={root}", "audio.chunk_duration_s=1.0",
        "train.batch_size=4", "train.seed=0", "train.dataloader.num_workers=1",
        "train.precision=f32", "train.log_every_n_steps=2", "train.profiler=on"])
    enc = MultiLabelEncoder(cfg.data.classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hubert_hydra"](enc, cfg, device="cpu", enc_cfg=HubertEncoderConfig(
            hidden_size=16, n_layers=1, n_heads=2, ffn_dim=32, conv_dim=(8,) * 7,
            pos_conv_kernel=8, pos_conv_groups=2))
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    loader = SegmentationDataLoader(ds, enc, cfg, model.conv_settings)
    run_dir = tmp_path / "run"
    with telemetry.recording() as rec:
        Trainer(model=model, config=cfg, run_dir=run_dir, max_epochs=2, device="cpu").fit(loader)
    steps = len(loader.train_dataloader())
    assert steps >= 2
    names = Counter(s.name for s in rec.spans)
    assert names["train.step"] == 2 * steps
    assert names["train.put"] == 2 * (steps + 1)  # and validation's one stacked upload
    assert names["train.loader_wait"] == 2 * (steps + 1)
    assert names["train.log"] == 2 * steps // 2
    assert names["train.validate"] == 2 and names["train.checkpoint"] == 2
    by_id = {s.id: s for s in rec.spans}
    for s in rec.named("train.step"):
        children = [c.name for c in rec.spans if c.parent == s.id]
        assert children == ["train.forward_backward", "train.optimizer"]
    for s in rec.named("model.encoder"):
        assert by_id[s.parent].name in ("train.forward_backward", "train.validate")
    # the profiled epoch (the second) wrote its spans beside its trace
    prof = run_dir / "profile"
    assert (prof / "epoch_1.json").is_file()
    lines = [json.loads(ln) for ln in (prof / "spans_epoch_1.jsonl").read_text().splitlines()]
    assert Counter(d["name"] for d in lines)["train.step"] == steps
    assert [d["start_ns"] for d in lines] == sorted(d["start_ns"] for d in lines)
    assert all({"name", "start_ns", "end_ns", "thread", "id", "parent"} <= set(d) for d in lines)
