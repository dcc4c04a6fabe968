"""Serving ``surgical_hubert_hydra``: the port's ``InferencePipeline`` and
``run_inference_on_audios`` against segma_tpu's with the same tiny f32
weights (the widths of tests/test_hubert.py). HuBERT's frame step is 320
samples with no padding (``strict_frames``), so its chunk geometry differs
from Whisper's, which tests/test_torch_inference.py serves."""

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
from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxEncoderConfig
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxMultiLabelEncoder
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
TINY = dict(
    hidden_size=64, n_layers=2, n_heads=2, ffn_dim=128, conv_dim=(32,) * 7,
    pos_conv_kernel=16, pos_conv_groups=4,
)
OVERRIDES = [
    "model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
    "audio.strict_frames=true", "train.precision=f32",
]
LOGITS_ATOL = 1e-4  # f32 through the whole stack (tests/test_torch_hubert.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model with params, port model) with the same tiny f32 weights."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", OVERRIDES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels["surgical_hubert_hydra"](JaxMultiLabelEncoder(jcfg.data.classes), jcfg)
    jmodel.module = jmodel.module.clone(enc_cfg=JaxEncoderConfig(**TINY))
    params = jmodel.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
    )
    jmodel.params = jax.tree.map(jax.numpy.asarray, params)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", OVERRIDES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hubert_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=HubertEncoderConfig(**TINY),
        )
    load_flax_params(model.module, params)
    return jmodel, model


def test_chunk_geometry_matches_jax(models):
    jmodel, model = models
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    for attr in ("n_windows", "missing_n_frames", "chunk_stride"):
        assert getattr(pipe.chunkyfier, attr) == getattr(jpipe.chunkyfier, attr), attr
    assert pipe.chunkyfier.n_windows == 199


def test_logits_match_jax_with_remainder_and_segments(models):
    """5-chunk file -> bucket 8: inner batches of 3 leave a remainder of 2;
    max_bucket_chunks=2 segments the file."""
    jmodel, model = models
    pcm = (np.random.default_rng(3).standard_normal(5 * 63_680 + 20_000) * 3_000).astype(np.int16)
    ref = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=3).logits_for_audio(pcm)
    for kw in ({"batch_size": 3}, {"batch_size": 64, "max_bucket_chunks": 2}):
        got = tinf.InferencePipeline(model, device="cpu", **kw).logits_for_audio(pcm)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL)


def test_run_inference_on_audios_matches_jax(models, synthetic_dataset, tmp_path):
    """Same RTTMs wherever no frame's probability lies near its threshold:
    each threshold sits in the widest gap of the middle 80% of JAX's
    probabilities, more than 10x the port-vs-JAX difference from every frame."""
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
    margin = max(10 * float(np.abs(ref_p - got_p).max()), 1e-6)
    thr = {}
    for li, label in enumerate(model.label_encoder.base_labels):
        p = np.sort(ref_p[:, li])
        mid = p[int(0.1 * len(p)) : int(0.9 * len(p)) + 1]
        gaps = np.diff(mid)
        i = int(np.argmax(gaps))
        assert gaps[i] / 2 > margin, (label, gaps[i])
        thr[label] = {"lower_bound": float((mid[i] + mid[i + 1]) / 2), "upper_bound": 1.0}
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
