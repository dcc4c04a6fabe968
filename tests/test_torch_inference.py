"""Inference pipeline parity: chunk geometry, the packed and mask decodes,
the golden RTTM, and a tiny-width ``run_inference_on_audios`` over the
synthetic fixture against segma_tpu's with the same weights."""

from __future__ import annotations

import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import segma_tpu.inference as jinf
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.base import ConvolutionSettings as JaxConvolutionSettings
from segma_tpu.models.whisper import builders as jax_builders
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxEncoderConfig
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxMultiLabelEncoder
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.geometry import ConvolutionSettings
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "decode.rttm"
FRAME_CS = ConvolutionSettings((320,), (320,), (0,))
LABELS = ("KCHI", "OCH", "MAL", "FEM")
TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
OVERRIDES = [
    "model.config.encoder=whisper_tiny_random",
    "model.config.lstm.hidden_size=16",
    "train.precision=f32",
]
LOGITS_ATOL = 1e-4  # f32 tiny model, as in test_torch_surgical_hydra.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    PyTorch's thread pool oversubscribed by them slows the LSTM loop tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model with params, port model) with the same tiny f32 weights."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", OVERRIDES)
    orig = jax_builders._encoder_cfg_for
    jax_builders._encoder_cfg_for = lambda _path: JaxEncoderConfig(**TINY)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmodel = JaxModels["surgical_hydra"](JaxMultiLabelEncoder(jcfg.data.classes), jcfg)
    finally:
        jax_builders._encoder_cfg_for = orig
    params = jmodel.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )
    jmodel.params = jax.tree.map(jax.numpy.asarray, params)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", OVERRIDES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=WhisperEncoderConfig(**TINY),
        )
    load_flax_params(model.module, params)
    return jmodel, model


# -- geometry -------------------------------------------------------------------


def test_chunkyfier_invariants():
    ck = tinf.Chunkyfier(128, 64_000, FRAME_CS)
    assert (ck.n_windows, ck.missing_n_frames, ck.chunk_stride) == (199, 320, 63_680)
    whisper = ConvolutionSettings((400, 3, 3), (160, 1, 2), (200, 1, 1))
    assert (whisper.rf_step, whisper.effective_step) == (320, 321)
    assert whisper.n_windows(64_000, strict=False) == 199


@pytest.mark.parametrize("chunk_f", [16_000, 64_000])
def test_chunkyfier_and_bucket_sweep_match_jax(chunk_f):
    ck = tinf.Chunkyfier(64, chunk_f, FRAME_CS)
    jck = jinf.Chunkyfier(64, chunk_f, JaxConvolutionSettings((320,), (320,), (0,)))
    for attr in ("n_windows", "missing_n_frames", "chunk_stride"):
        assert getattr(ck, attr) == getattr(jck, attr)
    rng = np.random.default_rng(0)
    lengths = [0, 1, 399, 400, 401, chunk_f - 1, chunk_f, chunk_f + 400]
    lengths += list(rng.integers(0, 40 * chunk_f, size=200))
    for n in lengths:
        n = int(n)
        assert ck.get_n_fitting_chunks(n) == jck.get_n_fitting_chunks(n), n
        for strict in (False, True):
            for ref_tail in (False, True):
                assert ck.total_frames(n, strict, ref_tail) == jck.total_frames(
                    n, strict, ref_tail
                ), (n, strict, ref_tail)
        assert tinf._bucket(n) == jinf._bucket(n)
        assert tinf.decode_capacity(n + 1) == jinf.decode_capacity(n + 1)
    for i in range(5):
        assert ck.batch_end_i_coverage(i) == jck.batch_end_i_coverage(i)
        assert ck.chunk_end_i_coverage(i) == jck.chunk_end_i_coverage(i)


# -- decode ---------------------------------------------------------------------


def test_packed_and_mask_decode_match_jax(models):
    jmodel, model = models
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    thr = tinf.default_thresholds(LABELS)
    rng = np.random.default_rng(21)
    for t in (1, 7, 199, 996):
        logits = (rng.standard_normal((t, 4)) * 2).astype(np.float32)
        ref = jpipe.decode_intervals(logits, thr)
        assert pipe.decode_intervals(logits, thr) == ref, t
        starts, ends = pipe.decode_boundaries(logits, thr)
        jstarts, jends = jpipe.decode_boundaries(logits, thr)
        np.testing.assert_array_equal(starts, jstarts)
        np.testing.assert_array_equal(ends, jends)
        # bucketed grid + valid_frames: padding rows that would fire if unmasked
        grid = np.concatenate([logits, np.full((64, 4), 9.0, np.float32)])
        assert pipe.decode_intervals(grid, thr, valid_frames=t) == ref, t


def test_decode_capacity_overflow_falls_back_like_jax(models):
    jmodel, model = models
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    thr = tinf.default_thresholds(LABELS)
    t = 4096  # alternating frames: more runs than the packed capacity
    logits = np.where((np.arange(t) % 2 == 0)[:, None], 5.0, -5.0).astype(np.float32)
    logits = logits * np.ones((1, 4), np.float32)
    packed = tinf._decode_packed(
        torch.from_numpy(logits), torch.full((4,), 0.5), t, tinf.decode_capacity(t)
    )
    assert tinf.unpack_run_intervals(
        packed.numpy(), tinf.decode_capacity(t), LABELS, FRAME_CS
    ) is None
    got = pipe.decode_intervals(logits, thr)
    assert got == jpipe.decode_intervals(logits, thr)
    assert len(got) == 4 * (t // 2)


def _golden_logits() -> np.ndarray:
    t = np.arange(500)[:, None]
    phase = np.array([0.0, 1.3, 2.1, 4.0])[None, :]
    return (3.0 * np.sin(t / 17.0 + phase) - 1.0).astype(np.float32)


def test_golden_rttm_byte_identical(tmp_path, models):
    enc = MultiLabelEncoder(list(LABELS))
    mask = 1.0 / (1.0 + np.exp(-_golden_logits())) > 0.5
    out = tinf.write_intervals(
        tinf.create_intervals(mask, FRAME_CS, enc), Path("x/golden_uri.wav"), tmp_path
    )
    assert out.read_bytes() == GOLDEN.read_bytes()
    # the device decode path writes the same bytes
    pipe = tinf.InferencePipeline(models[1], batch_size=4, device="cpu")
    intervals = pipe.decode_intervals(_golden_logits(), tinf.default_thresholds(LABELS))
    out2 = tinf.write_intervals(
        sorted(intervals, key=lambda iv: LABELS.index(iv[2])), Path("x/golden_uri.wav"),
        tmp_path / "packed",
    )
    assert out2.read_bytes() == GOLDEN.read_bytes()


def test_postprocess_and_threshold_vector_match_jax():
    rng = np.random.default_rng(5)
    intervals = [
        (int(s), int(s + d), str(rng.choice(LABELS)))
        for s, d in zip(rng.integers(0, 100_000, 50), rng.integers(1, 8_000, 50))
    ]
    for gap, dur in ((0, 0), (3_200, 0), (0, 4_000), (1_600, 2_000)):
        assert tinf.postprocess_intervals(intervals, dur, gap) == jinf.postprocess_intervals(
            intervals, dur, gap
        )
    thr = {label: {"lower_bound": 0.1 * (i + 1)} for i, label in enumerate(reversed(LABELS))}
    np.testing.assert_array_equal(
        tinf.threshold_vector(LABELS, thr), jinf.threshold_vector(LABELS, thr)
    )
    pcm = (rng.standard_normal(4_000) * 3_000).astype(np.int16)
    np.testing.assert_array_equal(tinf.mulaw_compress(pcm), jinf.mulaw_compress(pcm))


# -- pipeline -------------------------------------------------------------------


def test_logits_match_jax_with_remainder_and_segments(models):
    """5-chunk file -> bucket 8: inner batches of 3 leave a remainder of 2;
    max_bucket_chunks=2 segments the file and re-buckets the rows."""
    jmodel, model = models
    pcm = (np.random.default_rng(3).standard_normal(5 * 63_680 + 20_000) * 3_000).astype(np.int16)
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=3)
    ref = jpipe.logits_for_audio(pcm)
    for kw in ({"batch_size": 3}, {"batch_size": 64, "max_bucket_chunks": 2}):
        pipe = tinf.InferencePipeline(model, device="cpu", **kw)
        got = pipe.logits_for_audio(pcm)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL)
    dev, total = tinf.InferencePipeline(
        model, device="cpu", max_bucket_chunks=2
    ).logits_for_audio_async(pcm)
    assert dev.shape[0] == tinf._bucket(dev.shape[0]) >= total
    # the f32 and mu-law transports expand on the device as JAX does
    pipe = tinf.InferencePipeline(model, batch_size=8, device="cpu")
    np.testing.assert_allclose(
        pipe.logits_for_audio(pcm.astype(np.float32) / 32768.0), ref, atol=LOGITS_ATOL
    )
    mu = tinf.mulaw_compress(pcm)
    np.testing.assert_allclose(
        pipe.logits_for_audio(mu), jpipe.logits_for_audio(mu), atol=LOGITS_ATOL
    )


def _thresholds_away_from(probs: np.ndarray, min_margin: float) -> dict[str, dict[str, float]]:
    """Per label, a threshold in the widest gap between the middle 80% of
    ``probs`` (T, L), asserted to lie more than ``min_margin`` from every frame."""
    thr = {}
    for li, label in enumerate(LABELS):
        p = np.sort(probs[:, li])
        mid = p[int(0.1 * len(p)) : int(0.9 * len(p)) + 1]
        gaps = np.diff(mid)
        i = int(np.argmax(gaps))
        assert gaps[i] / 2 > min_margin, (label, gaps[i])
        thr[label] = {"lower_bound": float((mid[i] + mid[i + 1]) / 2), "upper_bound": 1.0}
    return thr


def test_run_inference_on_audios_matches_jax(models, synthetic_dataset, tmp_path):
    """Same RTTMs wherever no frame's probability lies near its threshold:
    the thresholds are placed more than 10x the measured port-vs-JAX
    probability difference away from every frame."""
    jmodel, model = models
    uris = tmp_path / "uris.txt"
    uris.write_text("0000\n0004\n0009\n")
    wavs = synthetic_dataset / "wav"
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    paths = [wavs / f"{u}.wav" for u in ("0000", "0004", "0009")]
    refs, gots = [], []
    for path in paths:
        pcm = tinf._load_mono(path)
        refs.append(jpipe.logits_for_audio(pcm))
        gots.append(pipe.logits_for_audio(pcm))
        np.testing.assert_allclose(gots[-1], refs[-1], atol=LOGITS_ATOL)
    ref_p, got_p = (1.0 / (1.0 + np.exp(-np.concatenate(x))) for x in (refs, gots))
    thr = _thresholds_away_from(ref_p, max(10 * float(np.abs(ref_p - got_p).max()), 1e-6))
    jax_files = jinf.run_inference_on_audios(
        jmodel.config, wavs, None, tmp_path / "jax", uris=uris, thresholds=thr,
        model=jmodel, mesh="off", batch_size=4,
    )
    files = tinf.run_inference_on_audios(
        model.config, wavs, None, tmp_path / "torch", uris=uris, thresholds=thr,
        model=model, device="cpu", batch_size=4,
    )
    assert files == jax_files == paths
    for path in files:
        got = (tmp_path / "torch" / "raw_rttm" / f"{path.stem}.rttm").read_text()
        ref = (tmp_path / "jax" / "raw_rttm" / f"{path.stem}.rttm").read_text()
        assert got == ref and got.strip(), path.name


def test_infer_file_writes_rttm(models, synthetic_dataset, tmp_path):
    _, model = models
    pipe = tinf.InferencePipeline(model, batch_size=8, device="cpu")
    path = sorted((synthetic_dataset / "wav").glob("*.wav"))[0]
    intervals = tinf.infer_file(path, pipe, tmp_path, min_duration_s=0.1, merge_gap_s=0.1)
    lines = (tmp_path / "raw_rttm" / f"{path.stem}.rttm").read_text().splitlines()
    assert len(lines) == len(intervals) > 0
    assert all(e - s >= 1_600 for s, e, _ in intervals)


def test_entry_points_raise_without_cuda(models, monkeypatch, synthetic_dataset, tmp_path):
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = model.config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.run_inference_on_audios(
            cfg, synthetic_dataset / "wav", None, tmp_path, model=model
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.InferencePipeline(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Models["surgical_hydra"](MultiLabelEncoder(cfg.data.classes), cfg)
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        tinf.run_inference_on_audios(cfg, synthetic_dataset / "wav", "ckpt", tmp_path, device="cpu")


def test_config_matches_jax():
    over = ["model.name=surgical_hydra", "model.config.encoder_layers=[1,3]", "audio.chunk_duration_s=2.0"]
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", over)
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", over)
    assert vars(cfg.audio) == vars(jcfg.audio)
    assert cfg.audio.chunk_duration_f == jcfg.audio.chunk_duration_f == 32_000
    assert cfg.data.classes == jcfg.data.classes
    assert cfg.train.precision == jcfg.train.precision
    mc, jmc = cfg.model.config, jcfg.model.config
    for key in ("encoder", "encoder_layers", "reduction", "classifier", "fast_context"):
        assert getattr(mc, key) == getattr(jmc, key), key
    for key in ("hidden_size", "num_layers", "bidirectional", "dropout"):
        assert getattr(mc.lstm, key) == getattr(jmc.lstm, key), key
