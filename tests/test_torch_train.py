"""Training parity: the port's train step, scheduler, early stopping, metrics
and loader against the JAX package's, and a CPU ``Trainer.fit`` smoke run.

One train step runs ``surgical_hubert_hydra`` at the TINY widths of
tests/test_hubert.py in f32 with dropout 0 (JAX's dropout stream cannot be
reproduced in torch) on both sides, from the same weights and batch:

- loss and per-label loss at atol 1e-5;
- every gradient at atol 1e-4 (f32 sums in other orders through the stack);
- every parameter after one AdamW step at atol 1e-5. A parameter whose
  gradient is zero in exact arithmetic (the attention's k bias: softmax is
  invariant to a shift shared by all keys) carries only rounding noise
  (|grad| below ``NOISE_GRAD``) on each side; Adam's first step normalises
  that noise to an update of about +-lr, in a direction neither side
  controls, so those entries are held to |delta| <= lr.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.data import SegmaFileDataset as JaxDataset
from segma_tpu.data import SegmentationDataLoader as JaxLoader
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.hubert.encoder import HubertEncoderConfig as JaxEncoderConfig
from segma_tpu.ops import metrics as jax_metrics
from segma_tpu.train import EarlyStopping as JaxEarlyStopping
from segma_tpu.train import ReduceLROnPlateau as JaxPlateau
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch.config import ConfigError, load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.ops import metrics
from segma_tpu_torch.train import (
    EarlyStopping,
    ReduceLROnPlateau,
    Trainer,
    make_optimizer,
    make_train_step,
)
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
TINY = dict(
    hidden_size=64, n_layers=2, n_heads=2, ffn_dim=128, conv_dim=(32,) * 7,
    pos_conv_kernel=16, pos_conv_groups=4,
)
LR = 1e-3
NOISE_GRAD = 1e-6
FIXTURE_CLASSES = "[male,female,key_child,other_child]"  # scripts/generate_data.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HUBERT = ["model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing_hubert_snapshot",
          "audio.strict_frames=true"]


def _step_both(tiny: dict, perturb: bool, silent: bool):
    """One f32 train step, dropout 0, on both sides from the same weights
    and batch, drawn from numpy seed 0: JAX's initial weights (zero biases),
    plus N(0, 0.05) noise if ``perturb``; a (2, 16000) waveform, all zeros
    if ``silent``; random targets. Returns (JAX (params before, grads,
    params after, loss, per_label), port model after its step, port (loss,
    per_label))."""
    extra = [*HUBERT, "audio.chunk_duration_s=1.0", "train.precision=f32"]
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels["surgical_hubert_hydra"](JaxEncoder(jcfg.data.classes), jcfg)
    jmodel.module = jmodel.module.clone(enc_cfg=JaxEncoderConfig(**tiny), dropout=0.0)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    if perturb:
        params = jax.tree.map(
            lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params
        )
    x = np.zeros((2, 16_000), np.float32)
    if not silent:
        x = (rng.standard_normal((2, 16_000)) * 0.1).astype(np.float32)
    y = (rng.random((2, 49, 4)) > 0.7).astype(np.float32)

    def loss_fn(p):
        return jmodel.loss(jmodel.apply(p, jnp.asarray(x), train=True,
                                        rngs={"dropout": jax.random.key(1)}), jnp.asarray(y))[0]

    grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(params))
    opt = jax_make_optimizer(jmodel, LR)
    step = jax_make_train_step(jmodel, opt)
    new, _, loss, per_label = step(jax.tree.map(jnp.asarray, params), opt.init(params),
                                   {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jax.random.key(1))
    jax_out = (params, grads, jax.tree.map(np.asarray, new), float(loss), np.asarray(per_label))

    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hubert_hydra"](
            MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
            enc_cfg=HubertEncoderConfig(**tiny),
        )
    load_flax_params(model.module, params)
    model.module.dropout = 0.0
    port_step = make_train_step(model, make_optimizer(model, LR))
    p_loss, p_per_label = port_step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, None)
    return jax_out, model, (float(p_loss), p_per_label.numpy())


@pytest.fixture(scope="module")
def one_step():
    return _step_both(TINY, perturb=True, silent=False)


def test_train_step_loss_matches_jax(one_step):
    (_, _, _, loss, per_label), _, (p_loss, p_per_label) = one_step
    assert abs(p_loss - loss) <= 1e-5
    np.testing.assert_allclose(p_per_label, per_label, atol=1e-5)


def test_train_step_gradients_match_jax(one_step):
    (_, grads, _, _, _), model, _ = one_step
    ref = flax_to_torch(grads)
    named = dict(model.module.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        if name.startswith("feature_extractor."):
            assert p.grad is None  # frozen: no gradient at all
            assert not ref[name].abs().max() > 0  # stop_gradient on the JAX side
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-4, err_msg=name)


def test_train_step_updates_match_jax(one_step):
    (before, grads, after, _, _), model, _ = one_step
    before, grads, after = flax_to_torch(before), flax_to_torch(grads), flax_to_torch(after)
    state = model.module.state_dict()
    n_noise = 0
    for name, got in state.items():
        if name.startswith("feature_extractor."):
            assert torch.equal(got, before[name]) and torch.equal(after[name], before[name])
            continue
        noise = grads[name].abs() < NOISE_GRAD
        n_noise += int(noise.sum())
        np.testing.assert_allclose(got[~noise].numpy(), after[name][~noise].numpy(), atol=1e-5,
                                   err_msg=name)
        assert ((got - before[name])[noise].abs() <= LR * (1 + 1e-3)).all(), name
    # the k biases (64 per layer) and a few entries whose gradient is tiny
    assert n_noise <= 2 * TINY["hidden_size"] * TINY["n_layers"]


@pytest.mark.parametrize("n_layers", [2, 12])
def test_silent_batch_gradients_explode_as_in_jax(n_layers):
    """An all-zero waveform through freshly initialised weights (zero
    biases) gives exactly-zero activations everywhere; each post-norm
    LayerNorm's backward then scales the gradient by about 1/sqrt(eps). The
    reference does the same: at 2 layers the gradients reach ~1e12 on both
    sides and agree relative to their size; at 12 (HuBERT-base's depth) they
    overflow f32 on both sides, in the same tensors."""
    (_, grads, after, loss, _), model, (p_loss, _) = _step_both(
        dict(TINY, n_layers=n_layers), perturb=False, silent=True)
    assert abs(p_loss - loss) <= 1e-5
    ref, ref_after = flax_to_torch(grads), flax_to_torch(after)
    biggest = 0.0
    for name, p in model.module.named_parameters():
        if name.startswith("feature_extractor."):
            continue
        got, want = p.grad, ref[name]
        # which entries cross f32's limit at the edge of overflow is rounding
        assert bool(torch.isfinite(got).all()) == bool(torch.isfinite(want).all()), name
        assert (bool(torch.isfinite(p.detach()).all())
                == bool(torch.isfinite(ref_after[name]).all())), name
        ok = torch.isfinite(want) & torch.isfinite(got)
        if ok.any():
            scale = float(want[ok].abs().max())
            assert float((got[ok] - want[ok]).abs().max()) <= 1e-5 * max(scale, 1.0), name
            biggest = max(biggest, scale)
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model.module.parameters()
                 if p.grad is not None)
    if n_layers == 2:
        assert finite and biggest > 1e9
    else:
        assert not finite


def test_plateau_and_early_stopping_decisions_match_jax():
    values = [1.0, 0.9, 0.95, 0.95, 0.9, 0.95, 0.97, 0.99, 0.8, 0.8, 0.8, 0.8, 0.81, 0.7]
    for mode in ("min", "max"):
        ours, theirs = ReduceLROnPlateau(mode, 2), JaxPlateau(mode, 2)
        assert [ours.step(v) for v in values] == [theirs.step(v) for v in values]
        assert ours.scale == pytest.approx(theirs.scale)
        ours, theirs = EarlyStopping(mode, 3), JaxEarlyStopping(mode, 3)
        assert [ours.step(v) for v in values] == [theirs.step(v) for v in values]


def test_binary_counts_and_f1_match_jax():
    rng = np.random.default_rng(5)
    probs = rng.random((300, 4)).astype(np.float32)
    targets = (rng.random((300, 4)) > 0.6).astype(np.float32)
    targets[:, 3] = 0  # a label with no positives
    probs[:, 3] = 0.1  # ... and no predictions: F1 0 by zero_division
    ref = jax_metrics.binary_counts(jnp.asarray(probs), jnp.asarray(targets))
    got = metrics.binary_counts(torch.from_numpy(probs), torch.from_numpy(targets))
    for k in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(
        metrics.f1_from_counts(got).numpy(),
        jax_metrics.f1_from_counts({k: np.asarray(v) for k, v in ref.items()}), rtol=1e-15,
    )


def test_loader_batches_match_jax_bit_for_bit(synthetic_dataset):
    extra = [*HUBERT, f"data.dataset_path={synthetic_dataset}", f"data.classes={FIXTURE_CLASSES}",
             "audio.chunk_duration_s=1.0", "train.batch_size=4", "train.seed=0",
             "train.dataloader.num_workers=1", "data.dataset_multiplier=0.3"]
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", [*extra, "train.data_cache=host"])
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    from segma_tpu.models.hubert.builders import HUBERT_CONV_SETTINGS as JAX_CS
    from segma_tpu_torch.models.hubert import HUBERT_CONV_SETTINGS

    jds, ds = JaxDataset.from_config(jcfg), SegmaFileDataset.from_config(cfg)
    jds.load(use_cache=False)
    ds.load(use_cache=False)
    jdm = JaxLoader(jds, JaxEncoder(jcfg.data.classes), jcfg, JAX_CS)
    dm = SegmentationDataLoader(ds, MultiLabelEncoder(cfg.data.classes), cfg, HUBERT_CONV_SETTINGS)
    for which in ("train_dataloader", "val_dataloader"):
        jl, pl = getattr(jdm, which)(), getattr(dm, which)()
        assert len(jl) == len(pl) > 0
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            for jb, pb in zip(jl, pl, strict=True):
                assert set(pb) == {"x", "y"} and pb["y"].shape[1] == 49
                for k in ("x", "y"):
                    assert pb[k].dtype == jb[k].dtype
                    np.testing.assert_array_equal(pb[k], jb[k])


def _fit_config(root: Path, *extra: str):
    return load_config(
        REPO / "segma_tpu_torch/config/default.yml",
        [*HUBERT, f"data.dataset_path={root}", "audio.chunk_duration_s=1.0",
         "train.batch_size=4", "train.seed=0", "train.dataloader.num_workers=1",
         "train.precision=f32", "train.log_every_n_steps=2", *extra],
    )


def test_trainer_fit_smoke_on_cpu(tmp_path):
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = _fit_config(root)
    enc = MultiLabelEncoder(cfg.data.classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hubert_hydra"](enc, cfg, device="cpu",
                                                enc_cfg=HubertEncoderConfig(**TINY))
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    frozen = {k: v.clone() for k, v in model.split_state()[1].items()}
    result = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", max_epochs=2,
                     device="cpu").fit(SegmentationDataLoader(ds, enc, cfg, model.conv_settings))
    history = result["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert np.isfinite([h["train/loss"], h["val/loss"]]).all()
        assert 0.0 <= h["val/f1_score"] <= 1.0
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(ln) for ln in lines]
    assert any("val/f1_score" in r for r in records)
    assert any("train/loss_step" in r for r in records)
    assert all(torch.equal(v, frozen[k]) for k, v in model.split_state()[1].items())
    # a checkpoint per epoch (the default save_top_k of 5 keeps both), last/, best.ckpt
    ckdir = tmp_path / "run" / "checkpoints"
    assert len(list(ckdir.glob("epoch=*"))) == 2
    assert (ckdir / "last" / "params.msgpack").exists() and (ckdir / "best.ckpt").is_symlink()


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = _fit_config(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models["surgical_hubert_hydra"](MultiLabelEncoder(cfg.data.classes), cfg,
                                                device="cpu", enc_cfg=HubertEncoderConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model=model, config=cfg, run_dir=tmp_path / "run")


@pytest.mark.parametrize("which", ["surgical_hubert_hydra", "surgical_hydra"])
def test_chip_smoke_configs_equal_default_yml(which):
    """chip_smoke.py builds its configs in code; they are default.yml with
    the overrides their docstrings name."""
    if which == "surgical_hubert_hydra":
        extra = ["model.name=surgical_hubert_hydra", "audio.strict_frames=true", "train.seed=0",
                 f"train.max_epochs={chip_smoke.TRAIN_EPOCHS}",
                 "train.dataloader.num_workers=1", "data.dataset_path=/data/smoke"]
        built = chip_smoke.surgical_hubert_hydra_config("/data/smoke")
    else:
        extra = ["model.name=surgical_hydra", "model.config.encoder=whisper_base_random"]
        built = chip_smoke.surgical_hydra_config()
    assert built == load_config(REPO / "segma_tpu_torch/config/default.yml", extra)


@pytest.mark.parametrize(
    "override",
    ["train.dispatch=epoch", "train.data_cache=device", "train.grad_accum_steps=2",
     "train.scheduler.type=cosine", "train.transport=int16", "train.remat=true",
     "train.extra_val_metrics=[loss,auroc]", "train.validation_metric=auroc"],
)
def test_unported_training_options_raise(tmp_path, override):
    with pytest.raises(ConfigError, match=override.split("=")[0].split(".")[-1]):
        _fit_config(tmp_path, override)
