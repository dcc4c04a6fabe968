"""The four model families the JAX package added (``surgical_wavlm_hydra``,
``sincnet_hydra``, ``conv_vad``, ``powerset_vad``) at tiny widths: their
checkpoints against the JAX package's, and their TF32 scopes.

- the port's own weights as a flax tree (``torch_to_flax``) have the paths,
  shapes and dtypes of JAX's ``init_params`` tree;
- a checkpoint JAX's ``save_params`` writes loads into the port, whose
  logits then equal the same weights loaded whole, bit for bit, and a
  checkpoint the port writes is restored by JAX's ``load_params`` exactly;
- ``load_model_for_inference`` serves a port checkpoint as the model it
  was written from, bit for bit;
- an f32 model's whole forward runs with TF32 off for cuDNN and cuBLAS,
  and a bf16 model's f32 parts (heads, BiLSTM) do, whatever the caller set,
  and the caller's flags are back afterwards.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import segma_tpu.checkpoint as jckpt
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.wavlm.encoder import WavLMEncoderConfig as JaxWavLMConfig
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params, torch_to_flax
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_checkpoint import _assert_trees_equal
from tests.test_torch_wavlm import TINY as WAVLM_TINY

REPO = Path(__file__).resolve().parent.parent
OVERRIDES = {
    "surgical_wavlm_hydra": ["model.config.wav_encoder=missing_wavlm_snapshot",
                             "audio.strict_frames=true", "train.precision=f32"],
    "sincnet_hydra": ["model.config.filters=16", "model.config.kernel_size=101",
                      "model.config.hidden=32", "model.config.lstm.hidden_size=16",
                      "model.config.dtype=f32"],
    "conv_vad": ["model.config.hidden=32", "model.config.depth=2", "model.config.dtype=f32"],
    "powerset_vad": ["model.config.hidden=32", "model.config.depth=2", "model.config.dtype=f32"],
}
NAMES = list(OVERRIDES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extra(name: str) -> list[str]:
    return [f"model.name={name}", "audio.chunk_duration_s=1.0", *OVERRIDES[name]]


def _jax_model(name: str, perturb: bool = True):
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", _extra(name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    if name == "surgical_wavlm_hydra":
        jmodel.module = jmodel.module.clone(enc_cfg=JaxWavLMConfig(**WAVLM_TINY))
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    jmodel.params = (jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape))
                                  .astype(np.float32), params) if perturb else params)
    return jmodel


def _port_model(name: str, seed: int = 0):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", _extra(name))
    kw = {"enc_cfg": WavLMEncoderConfig(**WAVLM_TINY)} if name == "surgical_wavlm_hydra" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed), **kw)


def _shapes(tree: dict, prefix: str = "") -> dict[str, tuple]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_shapes(value, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = (np.asarray(value).shape, np.asarray(value).dtype)
    return out


def _wav() -> torch.Tensor:
    return torch.from_numpy((np.random.default_rng(1).standard_normal((2, 16_000)) * 0.1)
                            .astype(np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_port_tree_has_jax_s_paths_and_shapes(name):
    jtree = _jax_model(name, perturb=False).params
    tree = torch_to_flax(_port_model(name).module)
    assert _shapes(tree) == _shapes(jtree)


@pytest.mark.parametrize("name", NAMES)
def test_jax_checkpoint_loads_into_the_port_and_back(name, tmp_path):
    jmodel = _jax_model(name)
    trainable, _ = jmodel.split_params(jmodel.params)
    jckpt.save_params(tmp_path / "jax", trainable, {"epoch": 2, "score": 0.5})
    ref = _port_model(name)
    load_flax_params(ref.module, jmodel.params)
    model = _port_model(name, seed=7)
    load_flax_params(model.module, jmodel.params)
    for key, p in model.module.named_parameters():  # trainable weights made different
        if key.split(".")[0] not in model.frozen_prefixes:
            torch.nn.init.normal_(p)
    template, _ = ckpt.flax_split(model)
    ckpt.load_trainable(model, ckpt.load_params(tmp_path / "jax", template))
    wav = _wav()
    assert torch.equal(model.apply(wav), ref.apply(wav))
    # and back: the port's checkpoint restores in JAX, arrays equal
    ckpt.save_params(tmp_path / "port", ckpt.flax_split(model)[0], {"epoch": 3})
    restored = jckpt.load_params(tmp_path / "port", jax.tree.map(np.zeros_like, trainable))
    _assert_trees_equal(jax.tree.map(np.asarray, restored), trainable)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_serves_the_model_it_was_written_from(name, tmp_path, monkeypatch):
    model = _port_model(name, seed=0)
    with torch.no_grad():
        for key, p in model.module.named_parameters():  # as if trained
            if key.split(".")[0] not in model.frozen_prefixes:
                p.add_(0.01)
    trainable, frozen = ckpt.flax_split(model)
    meta = {"epoch": 0}
    if frozen:
        meta["frozen_fingerprint"] = ckpt.frozen_fingerprint(frozen)
    ckpt.save_params(tmp_path / "ck", trainable, meta)
    if name == "surgical_wavlm_hydra":
        from segma_tpu_torch.models.wavlm import encoder

        monkeypatch.setattr(encoder.WavLMEncoderConfig, "base",
                            classmethod(lambda cls: cls(**WAVLM_TINY)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        served = ckpt.load_model_for_inference(model.config, tmp_path / "ck", seed=0,
                                               device="cpu")
    wav = _wav()
    assert torch.equal(served.apply(wav), model.apply(wav))


# each family's first compute module (the trunk; conv_vad's log-mel, which is
# no module) and its f32 parts
TRUNK = {"surgical_wavlm_hydra": "feature_extractor", "sincnet_hydra": "sinc",
         "conv_vad": "log_mel_spectrogram", "powerset_vad": "log_mel_spectrogram"}
F32_PARTS = {"surgical_wavlm_hydra": ["heads.heads"],
             "sincnet_hydra": ["heads.heads", "lstm_shared.lstm"],
             "conv_vad": ["HydraHeads_0.heads"], "powerset_vad": ["HydraHeads_0.heads"]}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_f32_parts_run_outside_tf32(name, precision, monkeypatch):
    extra = _extra(name)
    extra = [e.replace("=f32", f"={precision}") for e in extra]
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    kw = {"enc_cfg": WavLMEncoderConfig(**WAVLM_TINY)} if name == "surgical_wavlm_hydra" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu", **kw)
    assert model.compute_dtype == (torch.float32 if precision == "f32" else torch.bfloat16)
    seen: dict[str, tuple[bool, bool]] = {}

    def hook(label):
        def record(*_):
            seen.setdefault(label, (torch.backends.cudnn.allow_tf32,
                                    torch.backends.cuda.matmul.allow_tf32))
        return record

    for label in [TRUNK[name], *F32_PARTS[name]]:
        if label == "log_mel_spectrogram":
            from segma_tpu_torch.models import vad

            def log_mel(wav, real=vad.log_mel_spectrogram, record=hook(label)):
                record()
                return real(wav)

            monkeypatch.setattr(vad, "log_mel_spectrogram", log_mel)
        else:
            model.module.get_submodule(label).register_forward_pre_hook(hook(label))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        model.apply(_wav())
        after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert after == (True, True)
    trunk = seen.pop(TRUNK[name])
    assert trunk == ((False, False) if precision == "f32" else (True, True))
    assert seen == dict.fromkeys(F32_PARTS[name], (False, False))


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_family_configs_equal_load_config(name, precision):
    """chip_smoke.py builds its configs in code; each is default.yml with the
    per-model YAML and the overrides its docstring names."""
    import chip_smoke

    extra = [f"model.name={name}", "data.dataset_path=/data/smoke", "train.seed=0",
             f"train.max_epochs={chip_smoke.TRAIN_EPOCHS}", "train.dataloader.num_workers=1",
             "train.extra_val_metrics=[loss,partial_loss,auroc]"]
    if name == "surgical_wavlm_hydra":
        extra += ["audio.strict_frames=true", "model.config.wav_encoder=/snap/wavlm",
                  f"train.precision={precision}"]
    else:
        extra.append(f"model.config.dtype={precision}")
    built = chip_smoke.family_config(name, "/data/smoke", "/snap/wavlm", precision,
                                     extra_val_metrics=["loss", "partial_loss", "auroc"])
    assert built == load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    assert chip_smoke._with_precision(built, "f32") == load_config(
        REPO / "segma_tpu_torch/config/default.yml",
        [e.replace(f"={precision}", "=f32") for e in extra])


@pytest.mark.parametrize("name", NAMES)
def test_bf16_backward_runs_outside_tf32(name):
    """A bf16 model's train step computes its f32 parts' gradients (the
    heads here) with TF32 off too, whatever the caller set."""
    from segma_tpu_torch.train import forward_backward, make_optimizer

    extra = [e.replace("=f32", "=bf16") for e in _extra(name)]
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    kw = {"enc_cfg": WavLMEncoderConfig(**WAVLM_TINY)} if name == "surgical_wavlm_hydra" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu", **kw)
    seen = []
    heads = model.module.get_submodule(F32_PARTS[name][0])
    heads.register_full_backward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = torch.from_numpy((np.random.default_rng(2).random((2, 49, 4)) > 0.6)
                             .astype(np.float32))
        forward_backward(model, make_optimizer(model, 1e-3), _wav(), y, torch.Generator())
        after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert seen == [(False, False)] and after == (True, True)


def test_registry_has_the_jax_registry_s_names():
    assert sorted(Models) == sorted(JaxModels) and len(Models) == 10
    with pytest.raises(KeyError, match="registered models"):
        Models["not_a_model"]
