"""Multi-file packing and the prefetching predict loop of the port against the
JAX package's, on conv_vad (hidden 32, depth 2, 1 s chunks, the JAX params
bridged by ``convert.flax_to_torch``), on the CPU.

- ``logits_for_audios_async`` over files of mixed lengths (three chunk
  buckets, one file long enough to go in segments), dtypes (int16, f32,
  mu-law int8, ADPCM) and pack sizes: JAX's logits at the f32 pin 1e-4, and
  the port's own single-file logits at 1e-5 (the same rows, in other inner
  batches);
- ``run_inference_on_audios(pack_files=3)``, whose producer thread decodes
  ahead: the same RTTMs as JAX's, byte for byte, with thresholds placed more
  than 10x the port-vs-JAX probability difference away from every frame; a
  corrupt file is reported and skipped as JAX skips it, and the output keeps
  the files' order;
- the predict CLI with ``--transport adpcm --pack-files 3`` writes what
  ``run_inference_on_audios`` writes with those arguments.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import segma_tpu.inference as jinf
import segma_tpu.ops.adpcm as jadpcm
from segma_tpu_torch import checkpoint
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.config import load_config
from segma_tpu_torch.ops.adpcm import adpcm_encode_audio
from tests.test_torch_vad import REPO, build_pair, overrides

LOGITS_ATOL = 1e-4  # f32, the suite's pin (tests/test_torch_hubert.py)
PACKED_ATOL = 1e-5  # packed against single, both the port's f32 plain path
STRIDE = 15_680  # conv_vad's chunk stride at 1 s chunks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return build_pair("conv_vad")


def _mixed_audios() -> list:
    rng = np.random.default_rng(31)
    lengths = (2 * STRIDE + 900, 3 * STRIDE + 5_000, 2 * STRIDE + 4_000, 7 * STRIDE + 300,
               200, 9 * STRIDE + 1_000, 3 * STRIDE + 10, 20 * STRIDE)
    pcms = [(rng.standard_normal(n) * 4_000).astype(np.int16) for n in lengths]
    audios: list = list(pcms)
    audios[2] = pcms[2].astype(np.float32) / 32768.0  # shares a bucket with pcms[0]
    audios[6] = tinf.mulaw_compress(pcms[6])
    audios[3] = adpcm_encode_audio(pcms[3])
    return audios


@pytest.mark.parametrize("pack_files", [2, 3, 8])
def test_packed_logits_match_jax_and_single(pair, pack_files):
    jmodel, model = pair
    audios = _mixed_audios()
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu", max_bucket_chunks=16)
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4, max_bucket_chunks=16)
    jaudios = [jadpcm.AdpcmAudio(a.data, a.n_samples) if hasattr(a, "n_samples") else a
               for a in audios]
    outs = pipe.logits_for_audios_async(audios, pack_files=pack_files)
    jouts = jpipe.logits_for_audios_async(jaudios, pack_files=pack_files)
    assert len(outs) == len(audios)
    for i, ((lg, tf), (jlg, jtf), audio) in enumerate(zip(outs, jouts, audios)):
        assert tf == jtf, i
        if tf == 0:
            assert lg is None and jlg is None
            continue
        got = lg[:tf].numpy()
        np.testing.assert_allclose(got, np.asarray(jlg[:jtf]), atol=LOGITS_ATOL, err_msg=str(i))
        np.testing.assert_allclose(got, pipe.logits_for_audio(audio), atol=PACKED_ATOL,
                                   err_msg=str(i))
        assert lg.shape[0] == jlg.shape[0]  # the same bucketed grid


def _write_wav(path: Path, pcm: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.astype("<i2").tobytes())


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory) -> Path:
    """Seven int16 WAVs of 1.5 to 9 s and one corrupt file among them."""
    root = tmp_path_factory.mktemp("packing") / "wav"
    root.mkdir()
    rng = np.random.default_rng(5)
    for i, n in enumerate((24_000, 70_000, 40_000, 144_000, 33_000, 90_000, 51_000)):
        t = np.arange(n) / 16_000
        env = (np.sin(2 * np.pi * t / (1.1 + 0.3 * i)) > 0).astype(np.float64)
        sig = 0.4 * np.sin(2 * np.pi * (300 + 60 * i) * t) * env + 0.05 * rng.standard_normal(n)
        _write_wav(root / f"{i:04d}.wav", (np.clip(sig, -1, 1) * 32767).astype(np.int16))
    (root / "0003b.wav").write_bytes(b"RIFF\x00\x00\x00\x00not a wave file")
    return root


def _thresholds(jmodel, model, wavs: list[Path]) -> dict:
    """Per label, a threshold more than 10x the port-vs-JAX probability
    difference away from every frame of ``wavs``."""
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    pcms = [tinf._load_mono(p) for p in wavs]
    ref_p = 1 / (1 + np.exp(-np.concatenate([jpipe.logits_for_audio(p) for p in pcms])))
    got_p = 1 / (1 + np.exp(-np.concatenate([pipe.logits_for_audio(p) for p in pcms])))
    margin = max(10 * float(np.abs(ref_p - got_p).max()), 1e-6)
    thr = {}
    for li, label in enumerate(model.label_encoder.base_labels):
        p = np.sort(ref_p[:, li])
        mid = p[int(0.1 * len(p)) : int(0.9 * len(p)) + 1]
        gaps = np.diff(mid)
        i = int(np.argmax(gaps))
        assert gaps[i] / 2 > margin, (label, gaps[i])
        thr[label] = {"lower_bound": float((mid[i] + mid[i + 1]) / 2), "upper_bound": 1.0}
    return thr


def test_packed_prefetch_run_matches_jax(pair, wav_dir, tmp_path, capsys):
    jmodel, model = pair
    good = sorted(p for p in wav_dir.glob("*.wav") if p.stem != "0003b")
    thr = _thresholds(jmodel, model, good)
    jax_files = jinf.run_inference_on_audios(
        jmodel.config, wav_dir, None, tmp_path / "jax", thresholds=thr, model=jmodel,
        mesh="off", batch_size=4, pack_files=3,
    )
    files = tinf.run_inference_on_audios(
        model.config, wav_dir, None, tmp_path / "torch", thresholds=thr, model=model,
        device="cpu", batch_size=4, pack_files=3,
    )
    assert files == jax_files == good
    out = capsys.readouterr().out
    assert "SKIPPED" in out and "0003b.wav" in out and "1/8 files failed" in out
    order = [ln.split("'")[1] for ln in out.splitlines() if "inference for" in ln]
    assert order[-len(good):] == [p.stem for p in good]  # finished in the files' order
    for path in files:
        got = (tmp_path / "torch" / "raw_rttm" / f"{path.stem}.rttm").read_text()
        ref = (tmp_path / "jax" / "raw_rttm" / f"{path.stem}.rttm").read_text()
        assert got == ref and got.strip(), path.name
    # packed and unpacked runs of the port write the same RTTMs
    tinf.run_inference_on_audios(model.config, wav_dir, None, tmp_path / "single",
                                 thresholds=thr, model=model, device="cpu", batch_size=4)
    for path in files:
        assert ((tmp_path / "single" / "raw_rttm" / f"{path.stem}.rttm").read_text()
                == (tmp_path / "torch" / "raw_rttm" / f"{path.stem}.rttm").read_text())


def test_predict_cli_takes_adpcm_and_pack_files(wav_dir, tmp_path):
    over = overrides("conv_vad")
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", over)
    model = checkpoint.build_model(cfg, device="cpu")
    trainable, frozen = checkpoint.flax_split(model)
    checkpoint.save_params(tmp_path / "ck", trainable,
                           {"frozen_fingerprint": checkpoint.frozen_fingerprint(frozen)})
    wavs = tmp_path / "wav"
    shutil.copytree(wav_dir, wavs)
    (wavs / "0003b.wav").unlink()
    thr = tinf.default_thresholds(model.label_encoder.base_labels)
    (tmp_path / "thr.yml").write_text(yaml.dump(thr))
    tinf.main(["--config", str(REPO / "segma_tpu_torch/config/default.yml"), "--wavs",
               str(wavs), "--checkpoint", str(tmp_path / "ck"), "--output",
               str(tmp_path / "cli"), "--thresholds", str(tmp_path / "thr.yml"),
               "--batch-size", "4", "--device", "cpu", "--transport", "adpcm",
               "--pack-files", "3", *over])
    files = tinf.run_inference_on_audios(
        cfg, wavs, None, tmp_path / "api", thresholds=thr, model=model, device="cpu",
        batch_size=4, transport="adpcm", pack_files=3,
    )
    assert len(files) == 7
    for path in files:
        got = (tmp_path / "cli" / "raw_rttm" / f"{path.stem}.rttm").read_text()
        assert got == (tmp_path / "api" / "raw_rttm" / f"{path.stem}.rttm").read_text()
