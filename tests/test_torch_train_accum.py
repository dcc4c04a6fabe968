"""Gradient accumulation (``train.grad_accum_steps``) against the JAX
package's ``optax.MultiSteps``, at the tiny HuBERT widths of
tests/test_torch_checkpoint.py, f32, dropout 0 (JAX's dropout stream cannot
be reproduced in torch):

- k=3 over 3 micro-batches from the same weights: the parameters stay put
  on micro-steps 1 and 2 (bit for bit) and after the update agree at atol
  1e-5, the accumulated gradients at atol 1e-4 (the pins of
  tests/test_torch_lstm_train.py for one step); the entries whose gradient
  is rounding noise (the attention's k bias, |grad| below ``NOISE_GRAD``)
  are held to |delta| <= lr, as in tests/test_torch_train.py;
- the port's ``last/`` optimizer tree has the layout of the one JAX writes
  (``MultiStepsState`` through flax's ``to_state_dict``);
- resume in the middle of an accumulation (4 micro-steps per epoch, k=3:
  ``mini_step`` 1 after epoch 0), in both directions: a port ``last/``
  continued by JAX's ``Trainer.fit``, and a JAX ``last/`` continued by the
  port's, each against the other package's uninterrupted 2 epochs at the
  tolerances above (the noise entries at two updates' worth, 2 lr);
- a ``last/`` of the other layout (k=1 read with k=3) resumes with fresh
  moments and a warning, in both packages.
"""

from __future__ import annotations

import dataclasses
import warnings

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segma_tpu.checkpoint as jckpt
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.data import SegmaFileDataset as JaxDataset
from segma_tpu.data import SegmentationDataLoader as JaxLoader
from segma_tpu.train import Trainer as JaxTrainer
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.convert import flax_to_torch, load_flax_params, torch_to_flax
from segma_tpu_torch.train import GradAccumulation, make_optimizer, make_train_step
from tests.test_torch_checkpoint import OVERRIDES, REPO, _jax_model, _port_model
from tests.test_torch_resume import _setup

LR = 1e-3
K = 3
NOISE_GRAD = 1e-6  # as tests/test_torch_train.py
PARAM_ATOL = 1e-5
GRAD_ATOL = 1e-4
NAME = "surgical_hubert_hydra"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n: int) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(0)
    return [{"x": (rng.standard_normal((2, 64_000)) * 0.1).astype(np.float32),
             "y": (rng.random((2, 199, 4)) > 0.7).astype(np.float32)} for _ in range(n)]


def _layout(tree):
    """A tree's structure with (shape, dtype) at each leaf."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return (a.shape, str(a.dtype))


def _held(got: dict, want: dict, noise: dict, noise_bound: float, where: str) -> None:
    """Trainable tensors by name: atol PARAM_ATOL, the noise entries within
    ``noise_bound``."""
    assert set(got) == set(want), where
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        mask = noise.get(name, np.zeros(w.shape, bool))
        np.testing.assert_allclose(g[~mask], w[~mask], atol=PARAM_ATOL, err_msg=f"{where} {name}")
        assert (np.abs(g - w)[mask] <= noise_bound * (1 + 1e-3)).all(), f"{where} {name}"


def test_accumulation_matches_optax_multisteps():
    jmodel = _jax_model(NAME)
    jmodel.module = jmodel.module.clone(dropout=0.0)
    opt = jax_make_optimizer(jmodel, LR, grad_accum_steps=K)
    jstep = jax_make_train_step(jmodel, opt)
    params, state = jax.tree.map(jnp.asarray, jmodel.params), opt.init(jmodel.params)

    model = _port_model(NAME)
    load_flax_params(model.module, jmodel.params)
    model.module.dropout = 0.0
    optimizer = make_optimizer(model, LR)
    accum = GradAccumulation(model, K)
    step = make_train_step(model, optimizer, accum)
    mean_grads: dict[str, torch.Tensor] = {}
    adam_step = optimizer.step

    def recording_step(*args, **kwargs):  # the mean AdamW receives
        mean_grads.update({n: p.grad.clone() for n, p in model.module.named_parameters()
                           if p.grad is not None})
        return adam_step(*args, **kwargs)

    optimizer.step = recording_step
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    trainable = [n for n, p in model.module.named_parameters() if p.requires_grad]
    for i, batch in enumerate(_batches(K)):
        params, state, _, _ = jstep(params, state, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.key(1))
        step({k: torch.from_numpy(v) for k, v in batch.items()}, None)
        jstate = jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))
        tree = ckpt.opt_state_tree(model, optimizer, accum)
        assert _layout(tree) == _layout(jstate)
        assert int(tree["mini_step"]) == int(jstate["mini_step"]) == (i + 1) % K
        assert int(tree["gradient_step"]) == int(jstate["gradient_step"]) == (i + 1) // K
        now = {n: p.detach() for n, p in model.module.named_parameters()}
        if i < K - 1:  # the first micro-steps change nothing, on both sides
            assert all(torch.equal(now[n], before[n]) for n in now)
            np.testing.assert_array_equal(
                np.asarray(params["heads"]["heads"]["kernel"]),
                np.asarray(jmodel.params["heads"]["heads"]["kernel"]))
            acc = flax_to_torch({k: v for k, v in tree["acc_grads"].items()
                                 if k not in model.frozen_prefixes}, moments=True)
            jacc = flax_to_torch({k: v for k, v in jstate["acc_grads"].items()
                                  if k not in model.frozen_prefixes}, moments=True)
            for name in trainable:
                np.testing.assert_allclose(acc[name].numpy(), jacc[name].numpy(),
                                           atol=GRAD_ATOL, err_msg=f"acc {i} {name}")
            assert float(np.abs(acc["heads.heads.weight"].numpy()).max()) > 0
            for leaf in jax.tree.leaves(tree["acc_grads"]["feature_extractor"]):
                assert not leaf.any()  # frozen: zeros, as documented
    assert not any(a.any() for a in accum.acc)  # zeroed after the update
    want = flax_to_torch(jax.tree.map(np.asarray, params))
    noise = {n: (mean_grads[n].abs() < NOISE_GRAD).numpy() for n in trainable}
    assert sum(int(m.sum()) for m in noise.values()) <= 2 * 64 * 2  # the k biases and a few
    _held({n: now[n] for n in trainable}, {n: want[n] for n in trainable}, noise, LR,
          "after the update")
    frozen = [n for n in now if n not in trainable]
    assert frozen and all(torch.equal(now[n], before[n]) for n in frozen)


def _jax_fit(cfg_overrides, root, run_dir, max_epochs, init_tree, resume_from=None):
    """JAX's Trainer.fit on the tiny HuBERT from ``init_tree``, dropout 0."""
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", cfg_overrides)
    jmodel = _jax_model(NAME)
    jmodel.module = jmodel.module.clone(dropout=0.0)
    jmodel.params = jax.tree.map(jnp.asarray, init_tree)
    ds = JaxDataset.from_config(jcfg)
    ds.load(use_cache=False)
    dm = JaxLoader(dataset=ds, label_encoder=jmodel.label_encoder, config=jcfg,
                   conv_settings=jmodel.conv_settings)
    trainer = JaxTrainer(model=jmodel, config=jcfg, run_dir=run_dir, max_epochs=max_epochs)
    result = trainer.fit(dm, resume_from=resume_from)
    return trainer, result


def _overrides(root, k: int = K) -> list[str]:
    return [*OVERRIDES[NAME], f"data.dataset_path={root}", "audio.chunk_duration_s=1.0",
            "train.batch_size=4", "train.seed=0", "train.dataloader.num_workers=1",
            f"train.grad_accum_steps={k}", "wandb.offline=true"]


def _fit(cfg, ds, run_dir, max_epochs, resume_from=None, dropout=None, wrap=None):
    """A CPU ``Trainer.fit`` of ``checkpoint.build_model(cfg)``, its dropout
    set to ``dropout`` when given; ``wrap(trainer, step)`` may replace the
    train step."""
    from segma_tpu_torch.data import SegmentationDataLoader
    from segma_tpu_torch.train import Trainer

    model = ckpt.build_model(cfg, device="cpu")
    if dropout is not None:
        model.module.dropout = dropout
    dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
    trainer = Trainer(model=model, config=cfg, run_dir=run_dir, max_epochs=max_epochs,
                      device="cpu")
    if wrap is not None:
        trainer.train_step = wrap(trainer, trainer.train_step)
    return trainer, trainer.fit(dm, resume_from=resume_from)


def _trainable_tensors(tree: dict, frozen: tuple[str, ...]) -> dict[str, torch.Tensor]:
    return flax_to_torch({k: v for k, v in jax.tree.map(np.asarray, tree).items()
                          if k not in frozen})


@pytest.mark.parametrize("first", ["port", "jax"])
def test_cross_resume_in_the_middle_of_an_accumulation(monkeypatch, tmp_path, first):
    """Epoch 0 of 4 micro-steps in one package leaves ``mini_step`` 1 in
    ``last/``; the other package resumes it for epoch 1 and must land on the
    first package's uninterrupted 2 epochs."""
    cfg, ds = _setup(monkeypatch, tmp_path, [f"train.grad_accum_steps={K}"])
    root = tmp_path / "data"
    init = ckpt.build_model(cfg, device="cpu")
    init_tree = torch_to_flax(init.module)
    frozen = init.frozen_prefixes
    trainable = [n for n, p in init.module.named_parameters() if p.requires_grad]
    jover = _overrides(root)
    if first == "port":
        t_full, full = _fit(cfg, ds, tmp_path / "full", 2, dropout=0.0)
        _fit(cfg, ds, tmp_path / "first", 1, dropout=0.0)
        last = tmp_path / "first" / "checkpoints" / "last"
        meta_tree = ckpt.msgpack_restore((last / "opt_state.msgpack").read_bytes())
        assert int(meta_tree["mini_step"]) == 1 and int(meta_tree["gradient_step"]) == 1
        jt, jres = _jax_fit(jover, root, tmp_path / "second", 2, init_tree, resume_from=last)
        assert [h["epoch"] for h in jres["history"]] == [1]
        jstate = jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            jckpt.load_opt_state(tmp_path / "second" / "checkpoints" / "last",
                                 jt.optimizer.init(jt.model.params))))
        assert int(jstate["mini_step"]) == 2 and int(jstate["gradient_step"]) == 2
        got = _trainable_tensors(jres["params"], frozen)
        want = {n: full["params"][n] for n in trainable}
    else:
        jt_full, jfull = _jax_fit(jover, root, tmp_path / "full", 2, init_tree)
        _jax_fit(jover, root, tmp_path / "first", 1, init_tree)
        last = tmp_path / "first" / "checkpoints" / "last"
        t_res, res = _fit(cfg, ds, tmp_path / "second", 2, resume_from=last, dropout=0.0)
        assert [h["epoch"] for h in res["history"]] == [1]
        assert (t_res.accum.mini_step, t_res.accum.gradient_step) == (2, 2)
        got = {n: res["params"][n] for n in trainable}
        want = _trainable_tensors(jfull["params"], frozen)
    noise = {n: np.ones(want[n].shape, bool) if n.endswith("k_proj.bias")
             else np.zeros(want[n].shape, bool) for n in trainable}
    _held({n: got[n] for n in trainable}, {n: want[n] for n in trainable}, noise, 2 * LR,
          f"{first} then the other")


def test_other_layout_resumes_fresh(monkeypatch, tmp_path):
    """A ``last/`` written with k=1 read by a k=3 run (and the other way)
    restores no optimizer state, with a warning, in the port as in JAX."""
    cfg1, ds = _setup(monkeypatch, tmp_path)
    _fit(cfg1, ds, tmp_path / "k1", 1)
    cfg3 = dataclasses.replace(cfg1, train=dataclasses.replace(cfg1.train, grad_accum_steps=K))
    _fit(cfg3, ds, tmp_path / "k3", 1)
    for run, other_k in (("k1", K), ("k3", 1)):
        last = tmp_path / run / "checkpoints" / "last"
        model = ckpt.build_model(cfg3 if other_k == K else cfg1, device="cpu")
        optimizer = make_optimizer(model, LR)
        accum = GradAccumulation(model, other_k) if other_k > 1 else None
        with warnings.catch_warnings(record=True):
            assert not ckpt.load_opt_state(last, model, optimizer, accum)
        assert not optimizer.state
        jmodel = _jax_model(NAME)
        template = jax_make_optimizer(jmodel, LR, grad_accum_steps=other_k).init(jmodel.params)
        assert jckpt.load_opt_state(last, template) is None
