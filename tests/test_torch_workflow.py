"""The reference workflow through the port's CLIs against the JAX package's:
predict (``inference.main`` with ``--save-logits``) -> tune -> evaluate, on
the synthetic fixture with a tiny f32 Whisper snapshot and a checkpoint of
the trainable weights, in-process on the CPU.

- both predict CLIs write the same RTTMs, byte for byte, with thresholds
  placed more than 10x the port-vs-JAX probability difference away from
  every frame (as tests/test_torch_inference.py does), and logits that JAX's
  ``tune.load_pred_logits`` reads and that agree at the f32 pin 1e-4;
- ``tune.run_tuning`` and ``tune.main`` give JAX's thresholds on the same
  logits, and the YAML byte for byte;
- ``eval_model_output`` gives JAX's scores within 1e-12 and the same
  ``fscore.csv`` byte for byte, with and without UEM; ``frame_f1`` equals
  JAX's; ``evaluate.main`` writes the same file as JAX's;
- ``--artifact`` beside ``--config`` is refused (one source); ``--transport adpcm``
  and ``--pack-files``, which raised until the host data path was ported,
  now run: with ``--pack-files 2`` the RTTMs equal the unpacked run's byte
  for byte, and ADPCM (lossy) writes an RTTM for every file.
"""

from __future__ import annotations

import shutil
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import segma_tpu.checkpoint as jckpt
import segma_tpu.evaluate as jeval
import segma_tpu.inference as jinf
import segma_tpu.tune as jtune
import segma_tpu.utils.cache
from segma_tpu.annotation import AudioAnnotation as JaxAnnotation
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.structs.interval import Intervals as JaxIntervals
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch import evaluate as teval
from segma_tpu_torch import inference as tinf
from segma_tpu_torch import tune as ttune
from segma_tpu_torch.annotation import AudioAnnotation
from segma_tpu_torch.config import load_config
from segma_tpu_torch.structs.interval import Intervals
from tests.test_torch_snapshots import _hf_whisper, _perturbed, _save

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "segma_tpu" / "config" / "default.yml"  # both packages read it
LABELS = ["male", "female", "key_child", "other_child"]  # scripts/generate_data.py
URIS = ("0005", "0006", "0008")  # three of the fixture's val files
LOGITS_ATOL = 1e-4  # f32 tiny model, as in test_torch_inference.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def predicted(tmp_path_factory, synthetic_dataset):
    """Both predict CLIs over three val files: {side: output dir}, plus the
    dataset root and the overrides."""
    pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("workflow")
    snap = _save(_perturbed(_hf_whisper(), 0), root / "whisper_snapshot", "F32")
    overrides = [f"model.config.encoder={snap}", "model.config.lstm.hidden_size=16",
                 "train.precision=f32", "train.seed=3", f"data.classes=[{','.join(LABELS)}]"]
    jcfg = jax_load_config(CONFIG, overrides)
    from segma_tpu.models import Models as JaxModels
    from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder

    jmodel = JaxModels["surgical_hydra"](JaxEncoder(jcfg.data.classes), jcfg)
    params = jax.tree.map(np.asarray, jmodel.init_params(jckpt.init_key_for_seed(3)))
    trainable, frozen = jmodel.split_params(params)
    rng = np.random.default_rng(0)
    trainable = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), trainable)
    jckpt.save_params(root / "ck", trainable,
                      {"frozen_fingerprint": jckpt.frozen_fingerprint(frozen)})
    jmodel.params = {**trainable, **frozen}

    (root / "uris.txt").write_text("".join(u + "\n" for u in URIS))
    wavs = synthetic_dataset / "wav"
    cfg = load_config(CONFIG, overrides)
    model = ckpt.load_model_for_inference(cfg, root / "ck", device="cpu")
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    refs, gots = [], []
    for uri in URIS:
        pcm = tinf._load_mono(wavs / f"{uri}.wav")
        refs.append(jpipe.logits_for_audio(pcm))
        gots.append(pipe.logits_for_audio(pcm))
        np.testing.assert_allclose(gots[-1], refs[-1], atol=LOGITS_ATOL)
    ref_p, got_p = (1.0 / (1.0 + np.exp(-np.concatenate(x))) for x in (refs, gots))
    margin = max(10 * float(np.abs(ref_p - got_p).max()), 1e-6)
    thresholds = {}
    for li, label in enumerate(LABELS):
        p = np.sort(ref_p[:, li])
        mid = p[int(0.1 * len(p)) : int(0.9 * len(p)) + 1]
        gaps = np.diff(mid)
        i = int(np.argmax(gaps))
        assert gaps[i] / 2 > margin, (label, gaps[i])
        thresholds[label] = {"lower_bound": float((mid[i] + mid[i + 1]) / 2), "upper_bound": 1.0}
    (root / "thr.yml").write_text(yaml.dump(thresholds))

    args = ["--config", str(CONFIG), "--wavs", str(wavs), "--uris", str(root / "uris.txt"),
            "--checkpoint", str(root / "ck"), "--thresholds", str(root / "thr.yml"),
            "--batch-size", "4", "--save-logits", *overrides]
    orig = segma_tpu.utils.cache.enable_compilation_cache
    segma_tpu.utils.cache.enable_compilation_cache = lambda *a, **k: None  # keep the suite's
    try:
        jinf.main([*args, "--output", str(root / "jax"), "--mesh", "off"])
    finally:
        segma_tpu.utils.cache.enable_compilation_cache = orig
    tinf.main([*args, "--output", str(root / "torch"), "--device", "cpu"])
    return {"jax": root / "jax", "torch": root / "torch", "data": synthetic_dataset,
            "overrides": overrides, "root": root, "pipe": pipe}


def test_predict_cli_matches_jax(predicted):
    for uri in URIS:
        got = (predicted["torch"] / "raw_rttm" / f"{uri}.rttm").read_text()
        ref = (predicted["jax"] / "raw_rttm" / f"{uri}.rttm").read_text()
        assert got == ref and got.strip(), uri
    got = jtune.load_pred_logits(predicted["torch"] / "logits", LABELS, set(URIS))
    ref = jtune.load_pred_logits(predicted["jax"] / "logits", LABELS, set(URIS))
    assert set(got) == set(ref) == set(URIS)
    for uri in URIS:
        assert got[uri].shape == ref[uri].shape and got[uri].dtype == np.float32
        np.testing.assert_allclose(got[uri], ref[uri], atol=LOGITS_ATOL)
        # the dump is the pipeline's own logits, bit for bit
        pcm = tinf._load_mono(predicted["data"] / "wav" / f"{uri}.wav")
        np.testing.assert_array_equal(got[uri], predicted["pipe"].logits_for_audio(pcm))
    assert ttune.load_pred_logits(predicted["torch"] / "logits", LABELS, set(URIS)).keys() == \
        got.keys()


@pytest.mark.parametrize("precision", [0.1, 0.01])
def test_tuning_matches_jax(predicted, tmp_path, precision):
    logits = predicted["torch"] / "logits"
    got = ttune.run_tuning(predicted["data"], logits, LABELS, precision, tmp_path / "torch")
    ref = jtune.run_tuning(predicted["data"], logits, LABELS, precision, tmp_path / "jax")
    assert got == ref
    assert ((tmp_path / "torch" / "best_thresholds.yml").read_bytes()
            == (tmp_path / "jax" / "best_thresholds.yml").read_bytes())


def test_tune_main_matches_jax(predicted, tmp_path):
    cfg_path = tmp_path / "config.yml"
    cfg_d = yaml.safe_load(CONFIG.read_text())
    cfg_d["data"]["classes"] = LABELS
    cfg_path.write_text(yaml.dump(cfg_d))
    args = ["--config", str(cfg_path), "--val-ds", str(predicted["data"]),
            "--val-logits", str(predicted["torch"] / "logits")]
    ttune.main([*args, "--output", str(tmp_path / "torch")])
    jtune.main([*args, "--output", str(tmp_path / "jax")])
    got = (tmp_path / "torch" / "best_thresholds.yml").read_text()
    assert got == (tmp_path / "jax" / "best_thresholds.yml").read_text()
    assert set(yaml.safe_load(got)) == set(LABELS)


@pytest.mark.parametrize("uem", [False, True])
def test_evaluation_matches_jax(predicted, tmp_path, uem):
    truth = predicted["data"] / "rttm"
    pred = predicted["torch"] / "raw_rttm"
    uem_p = predicted["data"] / "uem" if uem else None
    got = teval.eval_model_output(truth, pred, LABELS, tmp_path / "torch.csv", uem_p)
    ref = jeval.eval_model_output(truth, pred, LABELS, tmp_path / "jax.csv", uem_p)
    assert set(got) == set(ref)
    for key in ref:
        assert abs(got[key] - ref[key]) <= 1e-12, key
        assert 0.0 <= got[key] <= 1.0 or key == "DER", key
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert teval.frame_f1(truth, pred, LABELS) == jeval.frame_f1(truth, pred, LABELS)
    assert teval.load_uem_dir(predicted["data"] / "uem") == jeval.load_uem_dir(
        predicted["data"] / "uem")


def test_evaluate_main_matches_jax(predicted, tmp_path):
    pred = {}
    for side, main in (("torch", teval.main), ("jax", jeval.main)):
        pred[side] = tmp_path / side / "raw_rttm"
        shutil.copytree(predicted["torch"] / "raw_rttm", pred[side])
        main(["--gt", str(predicted["data"] / "rttm"), "--pred", str(pred[side]), "-c",
              str(CONFIG), "--frame-f1", f"data.classes=[{','.join(LABELS)}]"])
    got = (tmp_path / "torch" / "fscore.csv").read_text()
    assert got == (tmp_path / "jax" / "fscore.csv").read_text()
    assert got.splitlines()[-1].startswith("TOTAL")


@pytest.mark.parametrize("flag,value", [
    ("--artifact", "export_dir"), ("--transport", "adpcm"), ("--pack-files", "2"),
])
def test_unported_cli_flags_raise(predicted, flag, value):
    out = predicted["root"] / f"unported{flag}"
    args = ["--config", str(CONFIG), "--wavs", str(predicted["data"] / "wav"), "--output",
            str(out), "--device", "cpu", flag, value, *predicted["overrides"]]
    if flag == "--artifact":  # ported: with --config it is refused, one source only
        with pytest.raises(SystemExit):
            tinf.main(args)
        assert not out.exists()
        return
    # ported since: the same run as the fixture's, through the flag
    root = predicted["root"]
    tinf.main([*args, "--uris", str(root / "uris.txt"), "--checkpoint", str(root / "ck"),
               "--thresholds", str(root / "thr.yml"), "--batch-size", "4"])
    for uri in URIS:
        got = (out / "raw_rttm" / f"{uri}.rttm").read_text()
        if flag == "--pack-files":
            assert got == (predicted["torch"] / "raw_rttm" / f"{uri}.rttm").read_text(), uri
        else:  # ADPCM is lossy: an RTTM of well-formed lines
            assert all(AudioAnnotation.from_rttm(ln).duration_s > 0 for ln in got.splitlines())


def test_predict_cli_needs_a_config(predicted):
    with pytest.raises(SystemExit):
        tinf.main(["--wavs", str(predicted["data"] / "wav"), "--output", "out"])


def test_annotation_and_intervals_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        start, dur = float(rng.uniform(0, 100)), float(rng.uniform(0, 5))
        ours = AudioAnnotation("uri", start, dur, "KCHI")
        theirs = JaxAnnotation("uri", start, dur, "KCHI")
        for attr in ("start_time_ms", "end_time_ms", "duration_ms", "start_time_f",
                     "duration_f", "end_time_f"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert (str(ours), repr(ours)) == (str(theirs), repr(theirs))
    items = [(float(a), float(a + b), str(c)) for a, b, c in zip(
        rng.uniform(0, 50, 40), rng.uniform(0, 3, 40), rng.choice(LABELS, 40))]
    ours, theirs = Intervals(items[:30]), JaxIntervals(items[:30])
    for item in items[30:]:
        ours.add(item)
        theirs.add(item)
    assert list(ours) == list(theirs) and len(ours) == len(theirs) < len(items)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert repr(Intervals([(0, 1, "a")])) == repr(JaxIntervals([(0, 1, "a")]))
