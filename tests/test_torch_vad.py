"""``conv_vad`` and ``powerset_vad`` against the JAX package's
``ConvVADModule`` at hidden 32, depth 2, on 1 s chunks, the JAX params
(init plus N(0, 0.05) from numpy seed 0) bridged by ``convert.flax_to_torch``;
the powerset encoder, loss and validation statistics against JAX's.

The log-mel runs through the port's plain version and JAX's XLA path.

- logits, f32: atol 1e-4, the suite's f32 pin (tests/test_torch_hubert.py);
- logits, bf16: 2e-2 * max(1, max|logit|), and no further from the f32
  model than 1.5 times JAX's bf16 logits are, the Whisper variants' pin
  (tests/test_torch_whisper_variants.py): both sides round each conv, GELU
  and bias add to bf16 at other places, about 2 ulps of logits of order 2;
- at an even (100) and an odd (101) count of log-mel frames: flax's SAME
  padding of the k3/s2 conv is (0, 1) on the first, (1, 1) on the second,
  so a port with symmetric padding misses the first by a frame;
- the powerset loss, its per-label diagnostic, ``inference_transform`` and
  ``weighted_index_ce``: atol 1e-6 (f32 sums in other orders), the
  marginal logits, which reach |7|, at rtol 1e-6 too;
- one train step as flax trees: the loss at 1e-5, gradients at 1e-4,
  updated weights at 1e-5, the pins of tests/test_torch_lstm_train.py,
  except where a gradient is within 100 times AdamW's eps of zero
  (``assert_updates_match``: there the step is held within the learning
  rate);
- one validation batch's ``partial_loss`` at 1e-6, its subset counts exactly.
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
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models import base as jax_base
from segma_tpu.train import make_eval_step as jax_make_eval_step
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu.utils.encoders import PowersetEncoder as JaxPowersetEncoder
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params, torch_to_flax
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models import Models, base
from segma_tpu_torch.models.vad import CONV_SETTINGS, same_pads
from segma_tpu_torch.train import (
    Trainer, eval_step, forward_backward, make_optimizer, make_train_step,
)
from segma_tpu_torch.utils.encoders import MultiLabelEncoder, PowersetEncoder
from tests.test_torch_lstm_train import _leaves

REPO = Path(__file__).resolve().parent.parent
NAMES = ["conv_vad", "powerset_vad"]
LR = 1e-3
# an even and an odd count of log-mel frames: 100 and 101
N_SAMPLES = {"even": 16_000, "odd": 16_160}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(name: str, precision: str = "f32", *extra: str) -> list[str]:
    return [f"model.name={name}", "model.config.hidden=32", "model.config.depth=2",
            f"model.config.dtype={precision}", "audio.chunk_duration_s=1.0", *extra]


def build_pair(name: str, precision: str = "f32"):
    """(JAX model with its params, port model with the same weights)."""
    extra = overrides(name, precision)
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    load_flax_params(model.module, jmodel.params)
    return jmodel, model


def _wav(n: int, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((2, n)) * 0.1).astype(np.float32)


def _targets(shape: tuple[int, ...], seed: int = 2) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) > 0.6).astype(np.float32)


@pytest.mark.parametrize("frames", list(N_SAMPLES))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax(name, precision, frames):
    jmodel, model = build_pair(name, precision)
    wav = _wav(N_SAMPLES[frames])
    ref = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    n_classes = 11 if name == "powerset_vad" else 4  # 1 + 4 + 6 subsets of at most 2
    assert got.shape == ref.shape == (2, 49, n_classes)
    assert got.dtype == np.float32
    if precision == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-4)
        return
    np.testing.assert_allclose(got, ref, atol=2e-2 * max(1.0, float(np.abs(ref).max())))
    f32 = jmodel.module.clone(dtype=jnp.float32)
    truth = np.asarray(f32.apply({"params": jmodel.params}, jnp.asarray(wav)))
    assert np.abs(got - truth).max() <= 1.5 * np.abs(ref - truth).max()


def test_same_padding_is_flax_s():
    assert same_pads(100, 3, 2) == (0, 1)  # even frames: not (1, 1)
    assert same_pads(101, 3, 2) == (1, 1)
    assert same_pads(100, 3, 1) == (1, 1)
    for d in (1, 2, 4, 8):
        assert same_pads(100, 3, 1, d) == (d, d)
    assert same_pads(200, 1) == (0, 0)


@pytest.mark.parametrize("name", NAMES)
def test_tree_and_names_are_flax_s(name):
    jmodel, model = build_pair(name)
    assert set(flax_to_torch(jmodel.params)) == set(model.module.state_dict())
    got = dict(_leaves(torch_to_flax(model.module)))
    want = dict(_leaves(jmodel.params))
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert {k.split("/")[1] for k in got} == {f"Conv_{i}" for i in range(6)} | {
        f"LayerNorm_{i}" for i in range(3)} | {"HydraHeads_0"}
    assert model.conv_settings == CONV_SETTINGS and model.n_windows == 49


@pytest.mark.parametrize("max_set_size", [1, 2, 3])
def test_powerset_encoder_matches_jax(max_set_size):
    labels = ["KCHI", "OCH", "MAL", "FEM"]
    ours, theirs = PowersetEncoder(labels, max_set_size), JaxPowersetEncoder(labels, max_set_size)
    assert ours.labels == theirs.labels and len(ours) == len(theirs)
    assert ours.base_labels == theirs.base_labels
    assert ours.n_single_classes == theirs.n_single_classes == 5
    np.testing.assert_array_equal(ours.multihot_lut(), theirs.multihot_lut())
    np.testing.assert_array_equal(ours.membership_matrix(), theirs.membership_matrix())
    for subset in [(), ("MAL",), ("FEM", "KCHI"), ("OCH", "MAL", "FEM")]:
        assert ours.transform(subset) == theirs.transform(subset)
    assert ours.inv_transform(3) == theirs.inv_transform(3)
    with pytest.raises(KeyError):
        ours.transform(("DOG",))


def test_powerset_objective_matches_jax():
    jmodel, model = build_pair("powerset_vad")
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (2, 49, 11)).astype(np.float32)
    targets = _targets((2, 49, 4))
    ref_total, ref_per = jmodel.loss(jnp.asarray(logits), jnp.asarray(targets))
    got_total, got_per = model.loss(torch.from_numpy(logits), torch.from_numpy(targets))
    assert abs(float(got_total) - float(ref_total)) <= 1e-6
    np.testing.assert_allclose(got_per.numpy(), np.asarray(ref_per), atol=1e-6)
    np.testing.assert_allclose(
        model.inference_transform(torch.from_numpy(logits)).numpy(),
        np.asarray(jmodel.inference_transform(jnp.asarray(logits))), rtol=1e-6, atol=1e-6)
    flat = logits.reshape(-1, 11)
    ids = rng.integers(0, 11, flat.shape[0])
    w = (np.arange(11) < 5).astype(np.float32)
    ref = jax_base.weighted_index_ce(jnp.asarray(flat), jnp.asarray(ids), jnp.asarray(w))
    got = base.weighted_index_ce(torch.from_numpy(flat), torch.from_numpy(ids),
                                 torch.from_numpy(w))
    assert abs(float(got) - float(ref)) <= 1e-6
    zero = base.weighted_index_ce(torch.from_numpy(flat), torch.from_numpy(ids),
                                  torch.zeros(11))
    assert float(zero) == 0.0


def test_powerset_model_needs_its_encoder():
    _, model = build_pair("powerset_vad")
    assert model.loss_type == "powerset" and len(model.powerset) == 11
    assert model.class_weights is None
    with pytest.raises(ValueError, match="powerset"):
        base.SegmentationModel(name="x", module=model.module, conv_settings=model.conv_settings,
                               label_encoder=model.label_encoder, config=model.config,
                               device=model.device, loss_type="powerset")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_compute_dtype_is_the_model_s(name, precision):
    """conv_vad has no encoder: its compute dtype is model.config.dtype, and a
    training step (``forward_backward`` reads ``compute_dtype``) runs."""
    _, model = build_pair(name, precision)
    assert not hasattr(model.module, "encoder")
    assert model.compute_dtype == (torch.float32 if precision == "f32" else torch.bfloat16)
    y = torch.from_numpy(_targets((2, 49, 4)))
    loss, per_label = forward_backward(model, make_optimizer(model, LR),
                                       torch.from_numpy(_wav(16_000)), y, None)
    assert torch.isfinite(loss) and per_label.shape == (4,)


def _batch(seed: int = 1) -> dict[str, np.ndarray]:
    return {"x": _wav(16_000, seed), "y": _targets((2, 49, 4), seed + 1)}


@pytest.fixture(scope="module", params=NAMES)
def one_step(request):
    name = request.param
    jmodel, model = build_pair(name)
    batch = _batch()

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(batch["x"]), train=True,
                              rngs={"dropout": jax.random.key(1)})
        return jmodel.loss(logits, jnp.asarray(batch["y"]))[0]

    params = jax.tree.map(jnp.asarray, jmodel.params)
    grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(params))
    opt = jax_make_optimizer(jmodel, LR)
    new, _, loss, per_label = jax_make_train_step(jmodel, opt)(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1))
    p_loss, p_per_label = make_train_step(model, make_optimizer(model, LR))(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    return {"grads": grads, "after": jax.tree.map(np.asarray, new), "loss": float(loss),
            "per_label": np.asarray(per_label), "model": model, "p_loss": float(p_loss),
            "p_per_label": p_per_label.numpy()}


def test_train_step_matches_jax(one_step):
    assert abs(one_step["p_loss"] - one_step["loss"]) <= 1e-5
    np.testing.assert_allclose(one_step["p_per_label"], one_step["per_label"], atol=1e-5)
    model = one_step["model"]
    named = dict(model.module.named_parameters())
    got = dict(_leaves(torch_to_flax(model.module, {n: p.grad for n, p in named.items()},
                                     moments=True)))
    want = dict(_leaves(one_step["grads"]))
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], atol=1e-4, err_msg=key)
    assert_updates_match(torch_to_flax(model.module), one_step["after"], one_step["grads"])


def assert_updates_match(got_tree: dict, want_tree: dict, grads: dict) -> None:
    """Updated weights at 1e-5 where JAX's gradient is at least 100 times
    AdamW's eps; elsewhere within the learning rate. A first AdamW step moves
    a weight by lr * g / (|g| + eps): for |g| near eps (1e-8) that is any
    fraction of lr, set by the gradient's last digits, which two f32 sums in
    other orders do not share."""
    got, grad = dict(_leaves(got_tree)), dict(_leaves(grads))
    for key, value in dict(_leaves(want_tree)).items():
        steep = np.abs(grad[key]) >= 100 * 1e-8
        np.testing.assert_allclose(got[key][steep], value[steep], atol=1e-5, err_msg=key)
        assert np.abs(got[key] - value).max() <= LR, key


def test_validation_batch_matches_jax():
    """One powerset_vad validation batch: the loss, the per-label scores (the
    sigmoid of the marginal logits, N x 4), the F1 counts, and the subset
    statistics of the partial_* metrics, against JAX's eval step."""
    jmodel, model = build_pair("powerset_vad")
    batch = _batch(5)
    ref = jax_make_eval_step(jmodel)(jax.tree.map(jnp.asarray, jmodel.params),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    r_total, r_per, r_counts, r_probs, (r_pl, r_sc, r_sp, r_ids) = jax.tree.map(np.asarray, ref)
    loss, per_label, counts, probs, subset = eval_step(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    p_loss, s_counts, s_probs, s_ids = subset
    assert abs(float(loss) - float(r_total)) <= 1e-5
    np.testing.assert_allclose(per_label.numpy(), r_per, atol=1e-5)
    assert probs.shape == (2 * 49, 4)
    np.testing.assert_allclose(probs.numpy(), r_probs, atol=1e-5)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(counts[k].numpy(), r_counts[k])
        np.testing.assert_array_equal(s_counts[k].numpy(), r_sc[k])
    assert abs(float(p_loss) - float(r_pl)) <= 1e-6
    np.testing.assert_allclose(s_probs.numpy(), r_sp, atol=1e-6)
    np.testing.assert_array_equal(s_ids.numpy(), r_ids)


def test_eval_scores_are_the_marginals():
    """The validation scores of a powerset model are the marginal per-label
    probabilities, not the sigmoid of its 11 subset logits."""
    _, model = build_pair("powerset_vad")
    batch = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    probs = eval_step(model, batch)[3]
    logits = model.apply(batch["x"])
    expect = torch.sigmoid(model.inference_transform(logits)).reshape(-1, 4)
    torch.testing.assert_close(probs, expect, rtol=0, atol=1e-6)


def test_fit_emits_partial_metrics(tmp_path):
    """powerset_vad trains one epoch on the CPU through ``Trainer.fit`` with
    partial_loss, f1_score and auroc asked for: finite val/partial_*."""
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", overrides(
        "powerset_vad", "f32", f"data.dataset_path={root}", "train.batch_size=4",
        "train.seed=0", "train.dataloader.num_workers=1",
        "train.extra_val_metrics=[loss,partial_loss,f1_score,auroc]"))
    model = Models["powerset_vad"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        history = Trainer(model=model, config=cfg, run_dir=tmp_path / "run", max_epochs=1,
                          device="cpu").fit(SegmentationDataLoader(
                              ds, model.label_encoder, cfg, model.conv_settings))["history"]
    metrics = history[0]
    partial = {k: v for k, v in metrics.items() if k.startswith("val/partial_")}
    assert set(partial) == {"val/partial_loss", "val/partial_f1_score", "val/partial_auroc"}
    assert np.isfinite(list(partial.values()) + [metrics["val/loss"], metrics["val/auroc"]]).all()
    assert set(k for k in metrics if k.startswith("val/loss_")) == {
        f"val/loss_{c}" for c in chip_smoke.TRAIN_CLASSES}
