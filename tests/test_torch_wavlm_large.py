"""WavLM-Large's layout in the port (``surgical_wavlm_hydra`` with a
LayerNorm conv front end, conv biases and pre-LayerNorm layers), held to
the plain f32 reference ``tests/plain_wavlm.py`` (written from HF's
``WavLMModel``, importing nothing of the port) at hidden 64, 4 heads, 3
layers, on seeded random weights with a relative-position table of N(0, 1)
and gate constants of 1 + N(0, 0.5), so that the bias moves the scores as
much as q.k does. Both layouts (Large's, and the base models' group norm
and post-norm layers), 1 s and 4 s windows (49 and 199 frames).

Tolerances, each with its reason and each failed by the planted fault (the
relative-position bias left out of the reference), which
``test_bias_fault_fails_every_tolerance`` checks:

- LOGITS_ATOL 1e-4: f32 on both sides, sums in other orders (the port's
  attention adds the bias to scores of q scaled first, the reference scales
  the product), HuBERT's and WavLM's f32 logits pin (tests/test_torch_wavlm.py);
- HIDDEN_ATOL 1e-4: the same, per hidden state;
- GRAD_ATOL 1e-4 x max(1, max|g|): one step's gradients, WavLM's f32 pin
  against JAX (tests/test_torch_wavlm.py), relative to the leaf's scale.

Also: HF snapshots of the Large layout (WavLM and HuBERT, written by
``transformers`` at tiny widths) convert and run as HF runs them; a
``config.json`` with a layout the port cannot build is refused, naming the
key; which attention path is taken (the op only on the card, in bf16,
unrecorded: on the CPU the op's plain version stands in for the kernel when
the path is forced); ``run_inference_on_audios`` serves the model and
``Trainer.fit`` trains it.
"""

from __future__ import annotations

import json
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import torch_to_flax
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.convert import read_hubert_config
from segma_tpu_torch.models.wavlm import encoder as wavlm_encoder
from segma_tpu_torch.models.wavlm.convert import convert_wavlm_params, read_wavlm_config
from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig
from segma_tpu_torch.ops import attention
from segma_tpu_torch.train import forward_backward, make_optimizer
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests import plain_wavlm

REPO = Path(__file__).resolve().parent.parent
LAYOUTS = {
    "large": dict(feat_extract_norm="layer", conv_bias=True, stable_layer_norm=True),
    "base": dict(feat_extract_norm="group", conv_bias=False, stable_layer_norm=False),
}
TINY = dict(hidden_size=64, n_layers=3, n_heads=4, ffn_dim=128, conv_dim=(32,) * 7,
            pos_conv_kernel=16, pos_conv_groups=4)
SAMPLES = {49: 16_000, 199: 64_000}  # frames: samples of the window
LOGITS_ATOL = 1e-4
HIDDEN_ATOL = 1e-4
GRAD_ATOL = 1e-4
EXTRA = ["model.name=surgical_wavlm_hydra", "model.config.wav_encoder=missing_wavlm_snapshot",
         "audio.strict_frames=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_keys(cfg: WavLMEncoderConfig) -> dict:
    """The reference's config (HF's keys) of an encoder config."""
    return dict(hidden_size=cfg.hidden_size, num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads, intermediate_size=cfg.ffn_dim,
                conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernels),
                conv_stride=list(cfg.conv_strides), num_conv_pos_embeddings=cfg.pos_conv_kernel,
                num_conv_pos_embedding_groups=cfg.pos_conv_groups, num_buckets=cfg.num_buckets,
                max_bucket_distance=cfg.max_distance, feat_extract_norm=cfg.feat_extract_norm,
                conv_bias=cfg.conv_bias, do_stable_layer_norm=cfg.stable_layer_norm,
                layer_norm_eps=1e-5)


def tiny_model(precision: str = "f32", layout: str = "large", device: str = "cpu",
               seed: int = 0, **dims):
    """``surgical_wavlm_hydra`` at TINY widths (``dims`` over them) in
    ``layout``, every weight moved by N(0, 0.05) from seed ``seed``, the
    relative-position table N(0, 1) and the gate constants 1 + N(0, 0.5)."""
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      [*EXTRA, f"train.precision={precision}"])
    enc_cfg = WavLMEncoderConfig(**{**TINY, **LAYOUTS[layout], **dims})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no snapshot: random encoder, on purpose
        model = Models["surgical_wavlm_hydra"](MultiLabelEncoder(cfg.data.classes), cfg,
                                               device="cpu", enc_cfg=enc_cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.module.named_parameters():
            if name.endswith("rel_attn_embed"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif name.endswith("gru_rel_pos_const"):
                p.copy_(1.0 + 0.5 * torch.randn(p.shape, generator=gen))
            else:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    model.module.to(device)
    model.device = torch.device(device)
    return model


def _wav(frames: int, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((2, SAMPLES[frames])) * 0.1).astype(np.float32))


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.module.state_dict().items()}


@pytest.mark.parametrize("frames", sorted(SAMPLES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_logits_and_hidden_states_match_plain(layout, frames):
    model = tiny_model(layout=layout)
    wav = _wav(frames)
    enc = hf_keys(model.module.enc_cfg)
    with torch.no_grad():
        ref_states = plain_wavlm.hidden_states(_state(model), enc, wav)
        ref = plain_wavlm.logits(_state(model), enc, wav)
        _, states = model.module.encoder(model.module.feature_extractor(wav),
                                         output_hidden_states=True)
    got = model.apply(wav)
    assert got.shape == ref.shape == (2, frames, 4)
    assert len(states) == len(ref_states) == TINY["n_layers"] + 1
    for ours, theirs in zip(states, ref_states):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=HIDDEN_ATOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=LOGITS_ATOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_step_gradients_match_plain(layout):
    """One f32 step's gradients (dropout 0) against autograd through the
    reference, the port's loss on both sides' logits; the front end takes
    none."""
    model = tiny_model(layout=layout)
    model.module.dropout = 0.0
    wav = _wav(49, seed=4)
    y = torch.from_numpy((np.random.default_rng(5).random((2, 49, 4)) > 0.7).astype(np.float32))
    forward_backward(model, make_optimizer(model, 1e-3), wav, y, None)
    named = dict(model.module.named_parameters())
    sd = {k: v.detach().clone().requires_grad_(not k.startswith("feature_extractor."))
          for k, v in named.items()}
    loss = model.loss(plain_wavlm.logits(sd, hf_keys(model.module.enc_cfg), wav), y)[0]
    loss.backward()
    got = {n: p.grad for n, p in named.items() if p.grad is not None}
    assert set(got) == {n for n in named if not n.startswith("feature_extractor.")}
    assert float(got["encoder.layers.0.attention.rel_attn_embed"].abs().max()) > 0
    for name, g in got.items():
        want = sd[name].grad
        assert float((g - want).abs().max()) <= GRAD_ATOL * max(1.0, float(want.abs().max())), name


def test_bias_fault_fails_every_tolerance():
    """The reference with its relative-position bias left out lies beyond
    each tolerance of this file from the port: logits, hidden states, and
    the gradients."""
    model = tiny_model()
    wav = _wav(199)
    enc = hf_keys(model.module.enc_cfg)
    with torch.no_grad():
        got = model.apply(wav)
        fault = plain_wavlm.logits(_state(model), enc, wav, bias=False)
        _, states = model.module.encoder(model.module.feature_extractor(wav),
                                         output_hidden_states=True)
        fault_states = plain_wavlm.hidden_states(_state(model), enc, wav, bias=False)
    assert float((got - fault).abs().max()) > 100 * LOGITS_ATOL
    assert float((states[-1] - fault_states[-1]).abs().max()) > 100 * HIDDEN_ATOL
    model.module.dropout = 0.0
    y = torch.from_numpy((np.random.default_rng(5).random((2, 199, 4)) > 0.7).astype(np.float32))
    forward_backward(model, make_optimizer(model, 1e-3), wav, y, None)
    named = dict(model.module.named_parameters())
    sd = {k: v.detach().clone().requires_grad_(True) for k, v in named.items()}
    model.loss(plain_wavlm.logits(sd, enc, wav, bias=False), y)[0].backward()
    worst = 0.0
    for name, p in named.items():
        if p.grad is not None:  # the table and the gates take none without the bias
            want = sd[name].grad if sd[name].grad is not None else torch.zeros_like(p.grad)
            gap = float((p.grad - want).abs().max()) / max(1.0, float(want.abs().max()))
            worst = max(worst, gap)
    assert worst > 10 * GRAD_ATOL


def _hf_snapshot(out: Path, kind: str) -> dict:
    """A tiny HF snapshot of the Large layout, its weights moved from HF's
    init; returns the model's f32 hidden states of ``_wav(49)``."""
    import transformers

    cls = {"wavlm": (transformers.WavLMConfig, transformers.WavLMModel),
           "hubert": (transformers.HubertConfig, transformers.HubertModel)}[kind]
    extra = dict(num_buckets=320, max_bucket_distance=800) if kind == "wavlm" else {}
    cfg = cls[0](hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
                 conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                 conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4, feat_extract_norm="layer", conv_bias=True,
                 do_stable_layer_norm=True, **extra)
    torch.manual_seed(0)
    model = cls[1](cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("rel_attn_embed.weight"):
                p.copy_(torch.randn(p.shape))
            else:
                p.add_(torch.randn(p.shape) * 0.05)
        states = model(_wav(49), output_hidden_states=True).hidden_states
    model.save_pretrained(out)
    return states


@pytest.mark.parametrize("kind", ["wavlm", "hubert"])
def test_large_layout_snapshot_builds_and_runs_as_hf(kind, tmp_path):
    """A Large-layout ``config.json`` and state dict (``transformers``'
    ``save_pretrained``) are read with their layout keys, convert (the
    LayerNorm front end, the conv biases) and give HF's hidden states."""
    snap = tmp_path / kind
    hf_states = _hf_snapshot(snap, kind)
    read = read_wavlm_config if kind == "wavlm" else read_hubert_config
    cfg = read(snap)
    assert (cfg.feat_extract_norm, cfg.conv_bias, cfg.stable_layer_norm) == ("layer", True, True)
    if kind == "wavlm":
        _, fe, tr = convert_wavlm_params(snap)
        assert set(fe) == {f"conv_{i}" for i in range(7)} | {f"layer_norm_{i}" for i in range(7)}
        assert all(set(fe[f"conv_{i}"]) == {"kernel", "bias"} for i in range(7))
    name = "surgical_wavlm_hydra" if kind == "wavlm" else "surgical_hubert_hydra"
    overrides = [f"model.name={name}", f"model.config.wav_encoder={snap}",
                 "audio.strict_frames=true", "train.precision=f32"]
    model = Models[name](MultiLabelEncoder(["a", "b"]), load_config(
        REPO / "segma_tpu_torch/config/default.yml", overrides), device="cpu")
    assert model.module.enc_cfg == cfg
    if kind == "wavlm":
        tree = torch_to_flax(model.module)
        for key in ("conv_0", "layer_norm_6"):
            for leaf, value in fe[key].items():
                np.testing.assert_array_equal(tree["feature_extractor"][key][leaf], value)
    with torch.no_grad():
        wav = _wav(49)
        _, states = model.module.encoder(model.module.feature_extractor(wav),
                                         output_hidden_states=True)
    assert len(states) == len(hf_states) == 4
    for ours, theirs in zip(states, hf_states):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=HIDDEN_ATOL)


@pytest.mark.parametrize("key,value", [("feat_extract_norm", "batch"),
                                       ("do_stable_layer_norm", "yes"), ("conv_bias", 1)])
@pytest.mark.parametrize("read", [read_wavlm_config, read_hubert_config])
def test_unknown_layout_is_refused_naming_the_key(read, key, value, tmp_path):
    dims = dict(chip_smoke.WAVLM_BASE, **{key: value})
    (tmp_path / "config.json").write_text(json.dumps(dims))
    with pytest.raises(ValueError, match=key):
        read(tmp_path)
    with pytest.raises(ValueError, match="feat_extract_norm"):
        WavLMEncoderConfig(feat_extract_norm="batch")


def test_kernel_path_only_on_the_card_in_bf16_unrecorded():
    def x(is_cuda=True, dtype=torch.bfloat16, length=199):
        return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=(64, length, 1024))

    path = attention.wavlm_kernel_path
    assert path(x(), 64, recorded=False)
    assert not path(x(), 64, recorded=True)  # training
    assert not path(x(dtype=torch.float32), 64, recorded=False)
    assert not path(x(is_cuda=False), 64, recorded=False)
    assert not path(x(), 16, recorded=False)
    assert path(x(length=attention.WAVLM_MAX_LEN), 64, recorded=False)
    with pytest.raises(ValueError, match="WAVLM_MAX_LEN"):  # no silent plain path on the card
        path(x(length=attention.WAVLM_MAX_LEN + 1), 64, recorded=False)
    assert not path(x(length=attention.WAVLM_MAX_LEN + 1), 64, recorded=True)
    assert not path(x(is_cuda=False, length=attention.WAVLM_MAX_LEN + 1), 64, recorded=False)


def test_cpu_never_calls_the_op(monkeypatch):
    def refuse(*args):
        raise AssertionError("the op was called on the CPU")

    monkeypatch.setattr(wavlm_encoder, "wavlm_attn_op", refuse)
    model = tiny_model("bf16")
    model.apply(_wav(49))
    model.module(_wav(49)).sum().backward()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forced_op_path_equals_the_plain_path(layout, monkeypatch):
    """With the kernel's path forced on the CPU, the op's plain version runs
    once a layer on the gathered (H, 2T - 1) rows, and the logits are the
    plain path's: the rows, their gather and the op's arguments are right."""
    model = tiny_model(layout=layout)
    wav = _wav(199)
    plain = model.apply(wav)
    calls = []
    op = wavlm_encoder.wavlm_attn_op

    def counted(q, k, v, gate, rel, sm_scale):
        b, t, h, d = q.shape
        assert gate.shape == (b, h, t) and rel.shape == (h, 2 * t - 1)
        calls.append(t)
        return op(q, k, v, gate, rel, sm_scale)

    monkeypatch.setattr(wavlm_encoder, "wavlm_kernel_path", lambda x, hd, recorded: not recorded)
    monkeypatch.setattr(wavlm_encoder, "wavlm_attn_op", counted)
    fused = model.apply(wav)
    assert calls == [199] * TINY["n_layers"]
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-5)


def test_relative_position_row_is_the_table_s_diagonals():
    for length in (1, 49, 199, 500):
        table = wavlm_encoder.relative_position_buckets(length)
        row = wavlm_encoder.relative_position_row(length)
        i, j = np.meshgrid(np.arange(length), np.arange(length), indexing="ij")
        np.testing.assert_array_equal(row[length - 1 + j - i], table)
    rel = torch.randn(3, 2 * 7 - 1)
    bias = attention.relative_bias(rel, 7)
    assert bias.shape == (3, 7, 7) and torch.equal(bias[:, 2, 5], rel[:, 6 + 3])


def test_served_by_run_inference_on_audios(tmp_path):
    """A 3-chunk WAV and a 1 s one through the serving entry: the long one's
    logits are the plain reference's over the serving grid (chunks every 199
    x 320 samples, the strict tail), and both get their RTTMs."""
    from segma_tpu_torch import inference

    model = tiny_model()
    n = 2 * 63_680 + 64_000 + 9_000
    pcm = (np.random.default_rng(7).standard_normal(n) * 3000).astype(np.int16)
    got = inference.InferencePipeline(model, batch_size=2, device="cpu").logits_for_audio(pcm)
    frames = 3 * 199 + (9_320 - 320) // 321 + 1  # the serving grid's strict tail
    audio = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    audio = torch.nn.functional.pad(audio, (0, 3 * 63_680 + 64_000 - n))
    windows = torch.stack([audio[c * 63_680: c * 63_680 + 64_000] for c in range(4)])
    with torch.no_grad():
        ref = plain_wavlm.logits(_state(model), hf_keys(model.module.enc_cfg), windows)
    ref = ref.reshape(-1, 4)[:frames].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    chip_smoke.write_wav(wavs / "long.wav", n, seed=1)
    chip_smoke.write_wav(wavs / "short.wav", 16_000, seed=2)
    done = inference.run_inference_on_audios(model.config, wavs, None, tmp_path / "out",
                                             model=model, batch_size=2, device="cpu")
    assert sorted(p.stem for p in done) == ["long", "short"]
    assert {p.stem for p in (tmp_path / "out" / "raw_rttm").glob("*.rttm")} == {"long", "short"}


def test_trained_by_trainer_fit(tmp_path):
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.train import Trainer

    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      [*EXTRA, f"data.dataset_path={root}", "audio.chunk_duration_s=1.0",
                       "train.batch_size=4", "train.seed=0", "train.dataloader.num_workers=1",
                       "train.precision=f32", "train.log_every_n_steps=2"])
    enc = MultiLabelEncoder(cfg.data.classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_wavlm_hydra"](enc, cfg, device="cpu", enc_cfg=WavLMEncoderConfig(
            **TINY, **LAYOUTS["large"]))
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    result = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", max_epochs=1,
                     device="cpu").fit(SegmentationDataLoader(ds, enc, cfg, model.conv_settings))
    history = result["history"]
    assert len(history) == 1
    assert np.isfinite([history[0]["train/loss"], history[0]["val/loss"]]).all()
    after = model.module.state_dict()
    assert not torch.equal(after["encoder.layers.0.attention.rel_attn_embed"],
                           before["encoder.layers.0.attention.rel_attn_embed"])
    assert torch.equal(after["feature_extractor.layer_norm_0.weight"],
                       before["feature_extractor.layer_norm_0.weight"])
