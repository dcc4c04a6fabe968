"""Exported artifacts of the port (``segma_tpu_torch/export.py``) on the CPU,
against the port's live pipeline and against the JAX package's artifacts.

- The counterparts of ``tests/test_export.py``: layout, live parity (bit
  for bit: the same ops on the same device), long files over the largest
  bucket, ADPCM, stereo, thresholds, a newer format, the predict CLI, the
  bucket plan, incompatible flags, ``reference_tail``, trimmable stream
  batches, the flagship ``surgical_hydra``.
- The trace-safe caches: every module-level or per-object tensor cache of
  the port, first used under a ``torch.export`` trace in a fresh process,
  keeps no traced tensor (an eager call afterwards equals a never-traced
  twin's, and a second export works). After ``export_inference`` the live
  model's LSTM holds its own parameters.
- JAX's ``export_inference(platforms=("cpu",))`` on the same weights, for
  conv_vad and tiny ``surgical_hydra``: f32 logits within 1e-4 x max(1,
  max|logit|), intervals equal except on frames whose logit lies within
  LOGITS_ATOL of the threshold's; ``_bucket_plan`` equal to JAX's over needs
  1 to 1100; the manifest's keys JAX's plus ``programs``; a JAX artifact
  directory refused by name.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import segma_tpu.export as jexport
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.whisper import builders as jax_builders
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxEncoderConfig
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import export as texport
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params
from segma_tpu_torch.export import ExportedPipeline, _bucket_plan, export_inference
from segma_tpu_torch.inference import InferencePipeline, default_thresholds
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
VAD = ["model.name=conv_vad", "model.config.hidden=32", "model.config.depth=1",
       "model.config.dtype=f32", "audio.chunk_duration_s=1.0"]
HYDRA = ["model.config.encoder=whisper_tiny_random", "model.config.lstm.hidden_size=16",
         "train.precision=f32", "audio.chunk_duration_s=1.0"]
TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
LOGITS_RTOL = 1e-4  # port against JAX, f32: times max(1, max |logit|)
LOGITS_ATOL = 1e-4  # frames this close to the threshold's logit may flip
PROGRAMS = {"infer_2.pt2", "decode_2.pt2", "infer_4.pt2", "decode_4.pt2", "stream.pt2",
            "stream_int16.pt2", "stream_batch2.pt2", "stream_batch4.pt2", "stream_batch8.pt2"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(overrides: list[str], name: str, enc_cfg: dict | None = None, seed: int = 0):
    """(JAX model with params, port model) with the same perturbed weights."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", overrides)
    orig = jax_builders._encoder_cfg_for
    if enc_cfg is not None:
        jax_builders._encoder_cfg_for = lambda _path: JaxEncoderConfig(**enc_cfg)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    finally:
        jax_builders._encoder_cfg_for = orig
    params = jmodel.init_params(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    jmodel.params = jax.tree.map(jax.numpy.asarray, params)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", overrides)
    extra = {} if enc_cfg is None else {"enc_cfg": WhisperEncoderConfig(**enc_cfg)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu", **extra)
    load_flax_params(model.module, params)
    return jmodel, model


@pytest.fixture(scope="module")
def vad_pair():
    return _pair(VAD, "conv_vad")


@pytest.fixture(scope="module")
def vad_model(vad_pair):
    return vad_pair[1]


@pytest.fixture(scope="module")
def artifact(vad_model, tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("artifact") / "conv_vad"
    export_inference(vad_model, out, buckets=(2, 4), batch_size=4, transport="int16",
                     platforms=("cpu",))
    return out


@pytest.fixture(scope="module")
def exp(artifact) -> ExportedPipeline:
    return ExportedPipeline.load(artifact, device="cpu")


def _int16(n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 3000).astype(np.int16)


def _live(model) -> InferencePipeline:
    return InferencePipeline(model, batch_size=4, device="cpu")


def test_artifact_layout(artifact):
    assert {p.name for p in artifact.iterdir()} == {"manifest.json", "cpu"}
    assert {p.name for p in (artifact / "cpu").iterdir()} == PROGRAMS


def test_exported_logits_match_live_pipeline(vad_model, exp):
    wav = _int16(50_000, 0)
    ref = _live(vad_model).logits_for_audio(wav)
    got = exp.logits_for_audio(wav)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)  # the same ops on the same device


def test_exported_segment_matches_live_intervals(vad_model, exp):
    wav = _int16(33_000, 1)
    thr = default_thresholds(vad_model.label_encoder.base_labels)
    live = _live(vad_model)
    lg, tf = live.logits_for_audio_async(wav)
    ref = sorted(live.decode_intervals(lg, thr, valid_frames=tf))
    assert exp.segment(wav) == ref and ref


def test_exported_long_file_segments_over_largest_bucket(vad_model, exp):
    """A file of more chunks than the largest bucket (4) runs in several
    dispatches; the logits are still the live pipeline's."""
    wav = _int16(10 * 16_000, 2)
    ref = _live(vad_model).logits_for_audio(wav)
    got = exp.logits_for_audio(wav)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_exported_adpcm_artifact(vad_model, tmp_path):
    """ADPCM transport: prepare() encodes, the programs decode the bytes."""
    out = export_inference(vad_model, tmp_path / "adpcm", buckets=(4,), batch_size=4,
                           transport="adpcm", platforms=("cpu",), stream_batches=())
    exp = ExportedPipeline.load(out, device="cpu")
    from segma_tpu_torch.ops.adpcm import adpcm_encode_audio

    wav = _int16(40_000, 3)
    ref = _live(vad_model).logits_for_audio(adpcm_encode_audio(wav))
    np.testing.assert_array_equal(exp.logits_for_audio(exp.prepare(wav)), ref)


def test_segment_accepts_channel_major_audio(exp):
    """(channels, n) arrays are downmixed, as the WAV reader's are."""
    mono = (np.random.default_rng(4).standard_normal(33_000) * 0.2).astype(np.float32)
    ref = exp.segment(mono)
    assert exp.segment(mono[None]) == ref
    assert exp.segment(np.stack([mono, mono])) == ref


def test_manifest_carries_tuned_thresholds(vad_model, tmp_path):
    thr = {lbl: {"lower_bound": 0.3 + 0.1 * i, "upper_bound": 1.0}
           for i, lbl in enumerate(vad_model.label_encoder.base_labels)}
    out = export_inference(vad_model, tmp_path / "thr", thresholds=thr, buckets=(2,),
                           platforms=("cpu",), stream_batches=())
    assert ExportedPipeline.load(out, device="cpu").manifest["thresholds"] == thr


def test_newer_format_version_rejected(artifact, tmp_path):
    clone = tmp_path / "newer"
    shutil.copytree(artifact, clone)
    m = json.loads((clone / "manifest.json").read_text())
    m["format_version"] = 999
    (clone / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="newer"):
        ExportedPipeline.load(clone, device="cpu")


def test_missing_platform_and_card_refused(artifact, tmp_path):
    """A platform the artifact lacks is refused by name; loading (the card
    by default) and a cuda export need a card."""
    clone = tmp_path / "cuda_only"
    shutil.copytree(artifact, clone)
    m = json.loads((clone / "manifest.json").read_text())
    m["platforms"] = ["cuda"]
    (clone / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="no cpu programs"):
        ExportedPipeline.load(clone, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ExportedPipeline.load(artifact)
        with pytest.raises(RuntimeError, match="CUDA"):
            export_inference(object(), tmp_path / "x")
    with pytest.raises(ValueError, match="platforms"):
        export_inference(object(), tmp_path / "x", platforms=("tpu",))


def test_prepare_stereo_int16_scale(exp):
    """(2, n) int16: the downmix goes back to [-1, 1] before the transport
    encodes it."""
    mono16 = _int16(33_000, 5)
    assert exp.segment(np.stack([mono16, mono16])) == exp.segment(mono16)


def test_predict_cli_from_artifact(vad_model, synthetic_dataset, tmp_path):
    """``inference.main --artifact`` writes the live path's RTTMs and logits
    dumps, byte for byte and bit for bit."""
    from segma_tpu_torch.inference import main as predict_main
    from segma_tpu_torch.inference import run_inference_on_audios

    artifact_dir = export_inference(vad_model, tmp_path / "cli", buckets=(8, 32), batch_size=8,
                                    platforms=("cpu",), stream_batches=())
    live_out = tmp_path / "live"
    run_inference_on_audios(
        config=vad_model.config, wavs=synthetic_dataset / "wav", checkpoint=None,
        output=live_out, uris=synthetic_dataset / "test.txt", model=vad_model,
        dump_logits=True, batch_size=8, device="cpu",
    )
    art_out = tmp_path / "art"
    predict_main(["--artifact", str(artifact_dir), "--wavs", str(synthetic_dataset / "wav"),
                  "--uris", str(synthetic_dataset / "test.txt"), "--output", str(art_out),
                  "--save-logits", "--device", "cpu"])
    live_rttms = sorted((live_out / "raw_rttm").glob("*.rttm"))
    assert len(live_rttms) == 5
    for rttm in live_rttms:
        assert (art_out / "raw_rttm" / rttm.name).read_text() == rttm.read_text()
    live_npz = sorted((live_out / "logits").glob("*.npz"))
    assert len(live_npz) == 5
    for npz in live_npz:
        a, b = np.load(npz), np.load(art_out / "logits" / npz.name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_bucket_plan_minimizes_transfer():
    assert _bucket_plan(60, [8, 32, 128, 512]) == [32, 32]
    assert _bucket_plan(127, [8, 32, 128, 512]) == [128]
    assert _bucket_plan(88, [8, 32, 128, 512]) == [32, 32, 32]
    assert _bucket_plan(3, [2, 4]) == [4]
    assert _bucket_plan(600, [8, 32, 128, 512]) == [512, 32, 32, 32]
    assert _bucket_plan(8, [8, 32]) == [8]
    assert _bucket_plan(1, [8, 32]) == [8]


@pytest.mark.parametrize("buckets", [(8, 32, 128, 512), (2, 4), (8, 32), (3, 7, 50), (16,)])
def test_bucket_plan_equals_jax(buckets):
    for needed in range(1, 1101):
        assert _bucket_plan(needed, list(buckets)) == jexport._bucket_plan(needed, list(buckets))


def test_bucket_plan_dispatch_logits_match_live(vad_model, exp):
    """A 3-chunk file with buckets (2, 4) runs one padded dispatch of 4."""
    wav = _int16(45_000, 6)
    ref = _live(vad_model).logits_for_audio(wav)
    calls = []

    class _Rec:
        def __init__(self, n, program):
            self.n, self.program = n, program

        def call(self, seg):
            calls.append(self.n)
            return self.program.call(seg)

    recording = ExportedPipeline(**{**vars(exp), "infer_fns": {
        n: _Rec(n, p) for n, p in exp.infer_fns.items()}})
    np.testing.assert_array_equal(recording.logits_for_audio(wav), ref)
    assert calls == [4]


def test_artifact_cli_rejects_incompatible_flags(tmp_path):
    from segma_tpu_torch.inference import main as predict_main

    base = ["--artifact", str(tmp_path), "--wavs", str(tmp_path), "--output", str(tmp_path)]
    for extra in (["--transport", "mulaw"], ["--checkpoint", "some.ckpt"],
                  ["--pack-files", "2"], ["model.name=conv_vad"],
                  ["--config", "cfg.yml"]):
        with pytest.raises(SystemExit):
            predict_main([*base, *extra])


@pytest.fixture(scope="module")
def hydra_pair():
    return _pair(HYDRA, "surgical_hydra", enc_cfg=TINY)


@pytest.fixture(scope="module")
def hydra_artifacts(hydra_pair, tmp_path_factory):
    """(port artifact, JAX artifact) of tiny surgical_hydra, bucket 2."""
    jmodel, model = hydra_pair
    root = tmp_path_factory.mktemp("hydra")
    walls: dict[str, float] = {}
    port = export_inference(model, root / "torch", buckets=(2,), batch_size=2,
                            platforms=("cpu",), stream_batches=(2,), walls=walls)
    jdir = jexport.export_inference(jmodel, root / "jax", buckets=(2,), batch_size=2,
                                    platforms=("cpu",), stream_batches=())
    return port, jdir, walls


def test_whisper_flagship_exports_and_matches_live(hydra_pair, hydra_artifacts):
    """surgical_hydra (Whisper encoder, BiLSTM, hydra heads) through an
    artifact: logits and intervals the live pipeline's, bit for bit; its
    programs hold the log-mel, flash-forward and LSTM ops; the live model's
    LSTM keeps its own parameters."""
    _, model = hydra_pair
    port, _, walls = hydra_artifacts
    assert set(walls) == {f"cpu/{n}" for n in ("infer_2.pt2", "decode_2.pt2", "stream.pt2",
                                               "stream_int16.pt2", "stream_batch2.pt2")}
    wav = _int16(30_000, 7)
    live = InferencePipeline(model, batch_size=2, device="cpu")
    thr = default_thresholds(model.label_encoder.base_labels)
    lg, tf = live.logits_for_audio_async(wav)
    ref = sorted(live.decode_intervals(lg, thr, valid_frames=tf))
    exp = ExportedPipeline.load(port, device="cpu")
    np.testing.assert_array_equal(exp.logits_for_audio(wav), lg[:tf].numpy())
    assert exp.segment(wav) == ref
    targets = {str(n.target) for n in exp.infer_fns[2].exported.graph.nodes}
    assert {"segma_tpu_torch.log10_mel.default", "segma_tpu_torch.flash_attn_fwd.default",
            "segma_tpu_torch.lstm.default"} <= targets
    lstm = model.module.lstm_shared.lstm
    assert all(w is getattr(lstm, n) for w, n in zip(lstm._flat_weights, lstm._flat_weights_names))
    assert all(isinstance(w, torch.nn.Parameter) for w in lstm._flat_weights)


def _frames(intervals, labels, n: int, step: int) -> np.ndarray:
    mask = np.zeros((n, len(labels)), bool)
    for s, e, label in intervals:
        mask[s // step : e // step, labels.index(label)] = True
    return mask


@pytest.mark.parametrize("which", ["conv_vad", "surgical_hydra"])
def test_artifact_matches_jax_artifact(which, vad_pair, artifact, hydra_pair, hydra_artifacts,
                                       tmp_path_factory):
    """The port's CPU artifact against JAX's on the same weights: logits
    within 1e-4 x max(1, max|logit|), intervals equal off the threshold."""
    if which == "conv_vad":
        jmodel = vad_pair[0]
        jdir = jexport.export_inference(jmodel, tmp_path_factory.mktemp("jvad") / "a",
                                        buckets=(2, 4), batch_size=4, platforms=("cpu",),
                                        stream_batches=())
        port, wav = artifact, _int16(50_000, 8)
    else:
        port, jdir, _ = hydra_artifacts
        wav = _int16(30_000, 9)
    exp = ExportedPipeline.load(port, device="cpu")
    jexp = jexport.ExportedPipeline.load(jdir)
    got, ref = exp.logits_for_audio(wav), jexp.logits_for_audio(wav)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_RTOL * max(1.0, np.abs(ref).max()))
    labels, step = exp.labels, exp.manifest["rf_step"]
    n = got.shape[0]
    mine, theirs = (_frames(p.segment(wav), labels, n, step) for p in (exp, jexp))
    decided = np.abs(got) > LOGITS_ATOL  # default thresholds: 0.5, logit 0
    np.testing.assert_array_equal(mine[decided], theirs[decided])
    with pytest.raises(ValueError, match="JAX artifact"):
        ExportedPipeline.load(jdir, device="cpu")


def test_manifest_schema_is_stable(artifact, hydra_artifacts):
    """The manifest's keys are JAX's plus ``programs``; format 1."""
    _, jdir, _ = hydra_artifacts
    manifest = json.loads((artifact / "manifest.json").read_text())
    jax_keys = set(json.loads((jdir / "manifest.json").read_text()))
    assert set(manifest) == jax_keys | {"programs"}
    assert manifest["format_version"] == 1 and manifest["programs"] == "torch.export"
    assert manifest["platforms"] == ["cpu"]


def test_reference_tail_mode_roundtrips_through_artifact(tmp_path):
    """audio.reference_tail=true is carried by the manifest: the zero-padded
    tail chunk's frames are the live pipeline's."""
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      [*VAD, "audio.reference_tail=true"])
    model = Models["conv_vad"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    out = export_inference(model, tmp_path / "tail", buckets=(2, 4), batch_size=4,
                           platforms=("cpu",), stream_batches=())
    exp = ExportedPipeline.load(out, device="cpu")
    assert exp.manifest["reference_tail"] is True
    wav = _int16(16_000 + 15_680 + 5_000, 10)
    ref = _live(model).logits_for_audio(wav)
    got = exp.logits_for_audio(wav)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_stream_batches_trimmable(vad_model, tmp_path):
    """stream_batches=() ships the single-chunk stream programs only."""
    out = export_inference(vad_model, tmp_path / "lean", buckets=(2,), batch_size=2,
                           platforms=("cpu",), stream_batches=())
    exp = ExportedPipeline.load(out, device="cpu")
    assert exp.supports_streaming and not exp.stream_batch_fns
    assert exp.manifest["stream_batches"] == []
    assert not list(out.glob("cpu/stream_batch*.pt2"))
    from segma_tpu_torch.streaming import ChunkForwardBatcher

    with pytest.raises(ValueError, match="re-export"):
        ChunkForwardBatcher.from_exported(exp)


def test_streaming_over_artifact_matches_live(vad_model, exp):
    """A stream session over the artifact finalises the live streaming
    path's intervals, through the single and the batched programs."""
    from segma_tpu_torch.streaming import ChunkForwardBatcher, StreamingSegmenter

    audio = _int16(40_000, 11)
    pushes = [audio[o : o + 7_000] for o in range(0, len(audio), 7_000)]

    def run(seg):
        for p in pushes:
            seg.push(p)
        seg.flush()
        return seg.intervals

    ref = run(StreamingSegmenter(vad_model))
    assert run(exp.streaming_segmenter()) == ref and ref
    batcher = ChunkForwardBatcher.from_exported(exp, window_ms=1.0)
    assert run(exp.streaming_segmenter(forward_fn=batcher)) == ref
    f32 = [p.astype(np.float32) / 32768.0 for p in pushes]
    seg = StreamingSegmenter.from_exported(exp)
    for p in f32:
        seg.push(p)
    seg.flush()
    assert seg.intervals == ref


# -- the trace-safe caches, each first used under a trace in a fresh process ----

REPAIR_SCRIPT = r"""
import json, sys, traceback, warnings
import numpy as np, torch
torch.set_num_threads(1)
from torch import nn
from segma_tpu_torch.config import load_config
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
REPO = sys.argv[1]
VAD = ["model.config.hidden=32", "model.config.depth=1", "model.config.dtype=f32",
       "audio.chunk_duration_s=1.0"]


def build(overrides, name, **kw):
    cfg = load_config(REPO + "/segma_tpu_torch/config/default.yml", overrides)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu", **kw)


class Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def export(fn, x):
    with torch.no_grad():
        return torch.export.export(Fn(fn), (x,), strict=False)


def same(a, b):
    return bool(torch.equal(a, b)) and float(a.double().sum()) == float(b.double().sum())


def check(fn, x, fresh):
    # the cache's first use traced, then an eager call and a second export
    ep1 = export(fn, x)
    eager = fn(x)
    ep2 = export(fn, x)
    return (same(eager, fresh(x)) and same(ep1.module()(x), eager)
            and same(ep2.module()(x), eager))


def whisper_logmel():
    kw = dict(enc_cfg=WhisperEncoderConfig(d_model=64, n_heads=4, n_layers=2, ffn_dim=128))
    ov = ["model.config.encoder=whisper_tiny_random", "model.config.lstm.hidden_size=16",
          "train.precision=f32"]
    model, twin = build(ov, "surgical_hydra", **kw), build(ov, "surgical_hydra", **kw)
    twin.module.load_state_dict(model.module.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64000)).astype(np.float32))
    return check(model.module, x, twin.apply)


def logmel_kernel_tables():
    from segma_tpu_torch.ops import logmel
    return check(lambda x: x + logmel._kernel_tables(x.device)[3].sum(), torch.ones(3),
                 lambda x: x + torch.from_numpy(logmel.kernel_colsums()).sum())


def adpcm_scale_table():
    from segma_tpu_torch.ops import adpcm
    pcm = (np.random.default_rng(1).standard_normal((1, 640)) * 3000).astype(np.int16)
    return check(lambda d: adpcm.adpcm_decode(d, 640), torch.from_numpy(adpcm.adpcm_encode(pcm)),
                 lambda d: torch.from_numpy(adpcm.adpcm_decode_np(d.numpy(), 640)))


def powerset_tables():
    ov = ["model.name=powerset_vad", *VAD]
    model, twin = build(ov, "powerset_vad"), build(ov, "powerset_vad")
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 49, 11)).astype(np.float32))
    return check(model.inference_transform, logits, twin.inference_transform)


def wavlm_buckets():
    from segma_tpu_torch.models.wavlm.encoder import WavLMAttention, WavLMEncoderConfig
    cfg = WavLMEncoderConfig(hidden_size=64, n_heads=4, num_buckets=32, max_distance=64)
    att, twin = WavLMAttention(cfg, True), WavLMAttention(cfg, True)
    return check(lambda x: att.bucket_onehot(8, x.device).sum(0) + x, torch.ones(32),
                 lambda x: twin.bucket_onehot(8, x.device).sum(0) + x)


def pipeline_thresholds():
    from segma_tpu_torch.inference import InferencePipeline, default_thresholds
    model = build(["model.name=conv_vad", *VAD], "conv_vad")
    pipe, twin = (InferencePipeline(model, device="cpu") for _ in range(2))
    thr = default_thresholds(model.label_encoder.base_labels)
    return check(lambda x: x + pipe._threshold_vector(thr), torch.ones(4),
                 lambda x: x + twin._threshold_vector(thr))


results = {}
for case in (whisper_logmel, logmel_kernel_tables, adpcm_scale_table, powerset_tables,
             wavlm_buckets, pipeline_thresholds):
    try:
        results[case.__name__] = bool(case())
    except Exception:
        results[case.__name__] = traceback.format_exc()[-1500:]
print("RESULTS", json.dumps(results))
"""
REPAIR_CASES = ("whisper_logmel", "logmel_kernel_tables", "adpcm_scale_table", "powerset_tables",
                "wavlm_buckets", "pipeline_thresholds")


@pytest.fixture(scope="module")
def repairs() -> dict:
    """Every cache's first use in one fresh process, under a trace."""
    proc = subprocess.run([sys.executable, "-c", REPAIR_SCRIPT, str(REPO)], cwd=REPO,
                          capture_output=True, text=True, timeout=900,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert "RESULTS" in proc.stdout, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.split("RESULTS", 1)[1])


@pytest.mark.parametrize("case", REPAIR_CASES)
def test_cache_keeps_no_traced_tensor(case, repairs):
    """The cache's first use is under a trace: afterwards an eager call
    equals a never-traced twin's, bit for bit, and both exports give the
    eager result (a fake tensor left in a cache fails each of these)."""
    assert repairs[case] is True, repairs[case]


def test_program_is_plain_module_call(exp):
    """A loaded program runs outside autograd and returns device tensors."""
    grid = exp.infer_fns[2].call(np.zeros((1, exp.manifest["chunk_duration_f"]
                                           + 2 * exp.manifest["chunk_stride"]), np.int16))
    assert isinstance(grid, torch.Tensor) and not grid.requires_grad
    assert grid.shape == (2 * exp.manifest["n_windows"], len(exp.labels))
    assert texport.PROGRAMS == "torch.export"
