"""Training a model with a trainable BiLSTM against the JAX package's train
step, and the LSTM's one bias.

A flax ``OptimizedLSTMCell`` has one bias per gate; ``torch.nn.LSTM`` has
two, ``bias_ih`` and ``bias_hh``. The port keeps the flax bias in
``bias_hh`` and ``bias_ih`` at zero, out of the optimizer: were both to
train, each AdamW step would move their sum twice as far as optax moves
the flax bias, and decay each half.

One f32 train step, LSTM dropout 0, of ``surgical_hydra`` and
``whisperimax`` at tiny widths on 1 s chunks, from the same weights and
batch on both sides (numpy seed 0), compared as flax trees
(``torch_to_flax``: the LSTM bias is the sum of the two):

- loss and per-label loss at atol 1e-5;
- every trainable gradient at atol 1e-4; the frozen encoder takes none;
- every parameter after one AdamW step at atol 1e-5.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import segma_tpu.checkpoint as jckpt
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as JaxEncoderConfig
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params, torch_to_flax
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.train import Trainer, make_optimizer, make_train_step
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
TINY = dict(d_model=64, n_heads=4, n_layers=2, ffn_dim=128)
LR = 1e-3
LSTM_MODELS = ["surgical_hydra", "whisperimax"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(name: str) -> list[str]:
    return [f"model.name={name}", "model.config.encoder=whisper_tiny_random",
            "model.config.lstm.hidden_size=16", "model.config.lstm.dropout=0.0",
            "audio.chunk_duration_s=1.0", "train.precision=f32"]


def _models(name: str):
    """(JAX model with its params, port model with the same weights): the
    JAX init plus N(0, 0.05) noise from numpy seed 0."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", _overrides(name))
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", _overrides(name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=WhisperEncoderConfig(**TINY))
    jmodel.module = jmodel.module.clone(enc_cfg=JaxEncoderConfig(**TINY))
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    load_flax_params(model.module, jmodel.params)
    return jmodel, model


def _batch(seed: int = 1) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"x": (rng.standard_normal((2, 16_000)) * 0.1).astype(np.float32),
            "y": (rng.random((2, 49, 4)) > 0.7).astype(np.float32)}


def _jax_step(jmodel, opt, params, opt_state, batch):
    step = jax_make_train_step(jmodel, opt)
    new, new_state, loss, per_label = step(
        jax.tree.map(jnp.asarray, params), opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    return jax.tree.map(np.asarray, new), new_state, float(loss), np.asarray(per_label)


@pytest.fixture(scope="module", params=LSTM_MODELS)
def one_step(request):
    name = request.param
    jmodel, model = _models(name)
    batch = _batch()

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(batch["x"]), train=True,
                              rngs={"dropout": jax.random.key(1)})
        return jmodel.loss(logits, jnp.asarray(batch["y"]))[0]

    grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(jax.tree.map(jnp.asarray, jmodel.params)))
    opt = jax_make_optimizer(jmodel, LR)
    after, _, loss, per_label = _jax_step(jmodel, opt, jmodel.params, opt.init(jmodel.params),
                                          batch)
    p_loss, p_per_label = make_train_step(model, make_optimizer(model, LR))(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    return {"name": name, "before": jmodel.params, "grads": grads, "after": after,
            "loss": loss, "per_label": per_label, "model": model,
            "p_loss": float(p_loss), "p_per_label": p_per_label.numpy()}


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", np.asarray(value)


def test_train_step_loss_matches_jax(one_step):
    assert abs(one_step["p_loss"] - one_step["loss"]) <= 1e-5
    np.testing.assert_allclose(one_step["p_per_label"], one_step["per_label"], atol=1e-5)


def test_train_step_gradients_match_jax(one_step):
    model = one_step["model"]
    named = dict(model.module.named_parameters())
    assert all(p.grad is None for n, p in named.items() if not p.requires_grad)
    got = dict(_leaves(torch_to_flax(
        model.module, {n: p.grad for n, p in named.items() if p.requires_grad}, moments=True)))
    want = dict(_leaves(one_step["grads"]))
    frozen = {k for k in want if k.startswith("/encoder/")}
    assert set(got) == set(want) - frozen
    assert all(not np.abs(want[k]).max() > 0 for k in frozen)  # stop_gradient in JAX
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], atol=1e-4, err_msg=key)


def test_train_step_updates_match_jax(one_step):
    """The updated weights as the flax tree: the LSTM's bias compared is the
    sum of its two, which moves as optax moves the flax cell's one bias."""
    got = dict(_leaves(torch_to_flax(one_step["model"].module)))
    want = dict(_leaves(one_step["after"]))
    before = dict(_leaves(one_step["before"]))
    assert set(got) == set(want)
    for key, value in got.items():
        if key.startswith("/encoder/"):
            assert np.array_equal(value, before[key]) and np.array_equal(want[key], before[key])
            continue
        np.testing.assert_allclose(value, want[key], atol=1e-5, err_msg=key)
    lstm_biases = [k for k in got if k.startswith("/lstm_shared/") and k.endswith("/bias")]
    assert lstm_biases and all(np.abs(got[k] - before[k]).max() > 0 for k in lstm_biases)


@pytest.mark.parametrize("name", LSTM_MODELS)
def test_input_biases_stay_out_of_the_optimizer(name):
    _, model = _models(name)
    lstm = model.module.lstm_shared.lstm
    biases = {n: p for n, p in lstm.named_parameters() if n.startswith("bias_ih")}
    assert len(biases) == 2 * lstm.num_layers
    trainable = {id(p) for p in model.trainable_parameters()}
    assert not any(id(p) in trainable for p in biases.values())
    assert all(id(p) in trainable for n, p in lstm.named_parameters() if n.startswith("bias_hh"))
    state = model.module.state_dict()
    assert all(not state[f"lstm_shared.lstm.{n}"].any() for n in biases)


def test_jax_optimizer_state_restores_and_steps_alike(tmp_path):
    """JAX steps ``surgical_hydra`` once and writes last/ with optax's state,
    whose LSTM moments are those of the flax cell's one bias (the layout a
    checkpoint of either package has always had); the port restores it into
    ``bias_hh`` alone, and one more step on each side agrees."""
    jmodel, model = _models("surgical_hydra")
    batch = _batch(2)
    opt = jax_make_optimizer(jmodel, LR)
    params1, state1, _, _ = _jax_step(jmodel, opt, jmodel.params, opt.init(jmodel.params), batch)
    trainable1, _ = jmodel.split_params(params1)
    jckpt.CheckpointManager(tmp_path / "ck").step(
        0, 0.5, trainable1, {"monitor": "val/loss"}, opt_state=state1)
    last = tmp_path / "ck" / "last"
    ckpt.load_trainable(model, ckpt.load_params(last, ckpt.flax_split(model)[0]))
    optimizer = make_optimizer(model, LR)
    assert ckpt.load_opt_state(last, model, optimizer)
    lstm = model.module.lstm_shared.lstm
    assert all(p not in optimizer.state for n, p in lstm.named_parameters()
               if n.startswith("bias_ih"))
    params2, _, _, _ = _jax_step(jmodel, opt, params1, state1, batch)
    make_train_step(model, optimizer)({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    got, want = dict(_leaves(torch_to_flax(model.module))), dict(_leaves(params2))
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key], atol=1e-5, err_msg=key)
    assert all(not p.any() for n, p in lstm.named_parameters() if n.startswith("bias_ih"))


def test_fit_keeps_input_biases_zero_and_serves(tmp_path):
    """``whisperimax`` (multiclass loss) trains one epoch on the CPU through
    ``Trainer.fit``: finite losses, ``bias_ih`` exactly zero afterwards, and
    the checkpoint serves the trained model's logits."""
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", [
        "model.name=whisperimax", "model.config.encoder=whisper_tiny_random",
        "model.config.lstm.hidden_size=16", "model.config.fast_context=true",
        f"data.dataset_path={root}", "audio.chunk_duration_s=1.0", "train.batch_size=4",
        "train.seed=0", "train.dataloader.num_workers=1", "train.precision=f32"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = ckpt.build_model(cfg, device="cpu")
    assert model.loss_type == "multiclass"
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    history = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", max_epochs=1,
                      device="cpu").fit(SegmentationDataLoader(ds, model.label_encoder, cfg,
                                                               model.conv_settings))["history"]
    assert np.isfinite([history[0]["train/loss"], history[0]["val/loss"]]).all()
    lstm = model.module.lstm_shared.lstm
    assert all(not p.any() for n, p in lstm.named_parameters() if n.startswith("bias_ih"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        served = ckpt.load_model_for_inference(cfg, tmp_path / "run" / "checkpoints" / "last",
                                               device="cpu")
    wav = torch.from_numpy(_batch(3)["x"])
    assert torch.equal(served.apply(wav), model.apply(wav))
