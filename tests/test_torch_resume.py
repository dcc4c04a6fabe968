"""Exact resume: the port's optimizer and train state in ``last/`` against
the JAX package's, at the tiny HuBERT widths of tests/test_torch_checkpoint.py.

- a ``last/`` written by port training restores in JAX: ``load_opt_state``
  into ``make_optimizer(...).init(params)`` gives the port's optax tree leaf
  for leaf, ``load_train_state`` the port's counters;
- a ``last/`` written by JAX after one step restores in the port, and one
  more step on each side agrees as ``test_train_step_updates_match_jax``
  does (atol 1e-5; the entries whose gradient is rounding noise within lr);
- 1 epoch plus a resume of 1 gives the trainable parameters of 2
  uninterrupted epochs bit for bit, with the same loss;
- a torn or missing optimizer or train state resumes fresh with a warning,
  and ``find_resumable`` and ``recover_last_dir`` pick what JAX picks.
"""

from __future__ import annotations

import shutil
import warnings
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import segma_tpu.checkpoint as jckpt
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_to_torch, load_flax_params
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.train import Trainer, make_optimizer, make_train_step
from tests.test_torch_checkpoint import (
    OVERRIDES,
    REPO,
    _assert_trees_equal,
    _jax_model,
    _port_model,
    _tiny_hubert,
)

LR = 1e-3
NOISE_GRAD = 1e-6  # as tests/test_torch_train.py
NAME = "surgical_hubert_hydra"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(monkeypatch, tmp_path, extra=()):
    """(config, dataset) for a tiny HuBERT f32 run on the CPU: 2 train files
    of 8 s, 1 s crops, batch 4, one loader worker."""
    _tiny_hubert(monkeypatch)
    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    cfg = load_config(
        REPO / "segma_tpu_torch/config/default.yml",
        [*OVERRIDES[NAME], f"data.dataset_path={root}", "audio.chunk_duration_s=1.0",
         "train.batch_size=4", "train.seed=0", "train.dataloader.num_workers=1", *extra],
    )
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    return cfg, ds


def _fit(cfg, ds, run_dir: Path, max_epochs: int, resume_from=None):
    model = ckpt.build_model(cfg, device="cpu")
    dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
    trainer = Trainer(model=model, config=cfg, run_dir=run_dir, max_epochs=max_epochs,
                      device="cpu")
    return trainer, trainer.fit(dm, resume_from=resume_from)


def test_port_last_restores_in_jax(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path, ["train.scheduler.patience=0"])
    trainer, result = _fit(cfg, ds, tmp_path / "run", 2)
    last = tmp_path / "run" / "checkpoints" / "last"
    assert sorted(p.name for p in last.iterdir()) == [
        "meta.yaml", "opt_state.msgpack", "params.msgpack", "train_state.yaml"]
    assert not any((p / "opt_state.msgpack").exists()
                   for p in (tmp_path / "run" / "checkpoints").glob("epoch=*"))
    jmodel = _jax_model(NAME)
    template = jax_make_optimizer(jmodel, cfg.train.lr).init(jmodel.params)
    restored = jckpt.load_opt_state(last, template)
    assert restored is not None
    got = jax.tree.map(np.asarray, flax.serialization.to_state_dict(restored))
    want = ckpt.opt_state_tree(trainer.model, trainer.optimizer)
    _assert_trees_equal(got, want)
    adam = got["inner_state"]["inner_state"]["0"]
    assert int(adam["count"]) == trainer.global_step > 0
    assert float(np.abs(adam["mu"]["heads"]["heads"]["kernel"]).max()) > 0
    assert adam["mu"]["feature_extractor"]["conv_0"] == {"kernel": {}}
    assert jckpt.load_train_state(last) == trainer._train_state()
    assert float(got["inner_state"]["hyperparams"]["learning_rate"]) == np.float32(
        cfg.train.lr * trainer.scheduler.scale)
    assert result["best_path"] == str(trainer.ckpt.best_path)
    assert result["best_score"] == trainer.ckpt.best_score


def _jax_step(jmodel, opt, params, opt_state, batch):
    step = jax_make_train_step(jmodel, opt)
    new, new_state, _, _ = step(jax.tree.map(jnp.asarray, params), opt_state,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.key(1))
    return jax.tree.map(np.asarray, new), new_state


def test_jax_last_restores_in_port_and_steps_alike(tmp_path):
    """JAX takes a step (dropout 0) and writes last/ with its optimizer
    state; the port restores it; one more step on each side agrees."""
    jmodel = _jax_model(NAME)
    jmodel.module = jmodel.module.clone(dropout=0.0)
    rng = np.random.default_rng(0)
    batch = {"x": (rng.standard_normal((2, 64_000)) * 0.1).astype(np.float32),
             "y": (rng.random((2, 199, 4)) > 0.7).astype(np.float32)}
    opt = jax_make_optimizer(jmodel, LR)
    params1, state1 = _jax_step(jmodel, opt, jmodel.params, opt.init(jmodel.params), batch)
    trainable1, _ = jmodel.split_params(params1)
    train_state = {"scheduler": {"best": 0.5, "bad_epochs": 1, "scale": 0.1},
                   "early_stopping": {"best": 0.5, "bad_epochs": 1}}
    jckpt.CheckpointManager(tmp_path / "ck").step(
        0, 0.5, trainable1, {"monitor": "val/loss"}, opt_state=state1, train_state=train_state)
    last = tmp_path / "ck" / "last"

    model = _port_model(NAME, seed=7)
    load_flax_params(model.module, params1)  # the frozen front end; last/ holds the rest
    for name, p in model.module.named_parameters():
        if p.requires_grad:
            torch.nn.init.normal_(p)
    ckpt.load_trainable(model, ckpt.load_params(last, ckpt.flax_split(model)[0]))
    model.module.dropout = 0.0
    optimizer = make_optimizer(model, 5.0)  # the restored state sets the rate
    assert ckpt.load_opt_state(last, model, optimizer)
    assert ckpt.load_train_state(last) == train_state
    assert optimizer.param_groups[0]["lr"] == float(np.float32(LR))
    _assert_trees_equal(ckpt.opt_state_tree(model, optimizer),
                        jax.tree.map(np.asarray, flax.serialization.to_state_dict(state1)))

    params2, state2 = _jax_step(jmodel, opt, params1, state1, batch)
    make_train_step(model, optimizer)({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    before, after = flax_to_torch(params1), flax_to_torch(params2)
    jstate2 = flax.serialization.to_state_dict(state2)["inner_state"]["inner_state"]["0"]
    got_tree = ckpt.opt_state_tree(model, optimizer)["inner_state"]["inner_state"]["0"]
    assert int(got_tree["count"]) == int(jstate2["count"]) == 2
    trainable = [k for k in jstate2["mu"] if k not in model.frozen_prefixes]
    moments = {key: (flax_to_torch({k: jax.tree.map(np.asarray, jstate2[key][k])
                                    for k in trainable}, moments=True),
                     flax_to_torch({k: got_tree[key][k] for k in trainable}, moments=True))
               for key in ("mu", "nu")}
    state = model.module.state_dict()
    n_noise = 0
    for name, p in model.module.named_parameters():
        if not p.requires_grad:
            assert torch.equal(state[name], before[name]), name
            continue
        grad = p.grad
        noise = grad.abs() < NOISE_GRAD
        n_noise += int(noise.sum())
        np.testing.assert_allclose(state[name][~noise].numpy(), after[name][~noise].numpy(),
                                   atol=1e-5, err_msg=name)
        assert ((state[name] - before[name])[noise].abs() <= LR * (1 + 1e-3)).all(), name
        for key, (want_m, got_m) in moments.items():
            np.testing.assert_allclose(got_m[name].numpy(), want_m[name].numpy(), atol=1e-5,
                                       err_msg=f"{key} {name}")
    assert n_noise <= 2 * 64 * 2  # the k biases and a few tiny entries


def test_resume_is_trajectory_exact(monkeypatch, tmp_path):
    """1 epoch, then a fresh Trainer and model resumed from last/ for 1 more:
    the trainable parameters of 2 uninterrupted epochs, bit for bit (dropout
    on: each epoch's masks come from (seed, epoch)), the same epoch-1 loss,
    learning rate and counters."""
    cfg, ds = _setup(monkeypatch, tmp_path, ["train.scheduler.patience=0"])
    t_full, full = _fit(cfg, ds, tmp_path / "full", 2)
    _fit(cfg, ds, tmp_path / "first", 1)
    t_res, res = _fit(cfg, ds, tmp_path / "second", 2,
                      resume_from=tmp_path / "first" / "checkpoints" / "last")
    assert [h["epoch"] for h in res["history"]] == [1]
    assert res["history"][0]["train/loss"] == full["history"][1]["train/loss"]
    assert res["history"][0]["val/loss"] == full["history"][1]["val/loss"]
    assert res["history"][0]["lr"] == full["history"][1]["lr"]
    trainable = [n for n, p in t_full.model.module.named_parameters() if p.requires_grad]
    assert trainable
    for name in trainable:
        np.testing.assert_array_equal(res["params"][name].numpy(), full["params"][name].numpy(),
                                      err_msg=name)
    assert t_res._train_state() == t_full._train_state()
    assert t_res.global_step == t_full.global_step
    _assert_trees_equal(ckpt.opt_state_tree(t_res.model, t_res.optimizer),
                        ckpt.opt_state_tree(t_full.model, t_full.optimizer))


def test_torn_or_missing_state_resumes_fresh(monkeypatch, tmp_path):
    cfg, ds = _setup(monkeypatch, tmp_path)
    _fit(cfg, ds, tmp_path / "run", 1)
    last = tmp_path / "run" / "checkpoints" / "last"
    model = ckpt.build_model(cfg, device="cpu")
    optimizer = make_optimizer(model, cfg.train.lr)
    # a blob of another tree (JAX's own load_opt_state refuses it too)
    (last / "opt_state.msgpack").write_bytes(ckpt.to_msgpack({"inner_state": {}}))
    (last / "train_state.yaml").write_text("- not\n- a mapping\n")
    with warnings.catch_warnings(record=True):
        assert not ckpt.load_opt_state(last, model, optimizer)
        assert ckpt.load_train_state(last) == {}
    assert not optimizer.state and optimizer.param_groups[0]["lr"] == float(np.float32(cfg.train.lr))
    jtemplate = jax_make_optimizer(_jax_model(NAME), LR).init(_jax_model(NAME).params)
    assert jckpt.load_opt_state(last, jtemplate) is None
    assert jckpt.load_train_state(last) == {}
    (last / "opt_state.msgpack").unlink()
    (last / "train_state.yaml").unlink()
    assert not ckpt.load_opt_state(last, model, optimizer)
    assert ckpt.load_train_state(last) == {}


def _tree(root: Path, torn_last: bool, stranded_old: bool, torn_meta: bool) -> Path:
    """A checkpoints/ dir written by the port's manager over 3 epochs, then
    damaged: last/ torn, or moved to .last.old; epoch 2's meta.yaml torn."""
    m = ckpt.CheckpointManager(root, save_top_k=-1)
    tree = {"w": np.arange(3, dtype=np.float32)}
    for epoch, score in enumerate((0.5, 0.4, 0.3)):
        m.step(epoch, score, tree, {"monitor": "val/loss"})
    if torn_meta:
        (root / "epoch=02-val_loss=0.300" / "meta.yaml").write_text("epoch: [unclosed\n")
    if torn_last:
        blob = (root / "last" / "params.msgpack").read_bytes()
        (root / "last" / "params.msgpack").write_bytes(blob[: len(blob) // 2])
    if stranded_old:
        (root / "last").rename(root / ".last.old")
    return root


@pytest.mark.parametrize("torn_last,stranded_old,torn_meta", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, False, True), (True, True, False), (False, True, True),
])
def test_find_resumable_picks_what_jax_picks(tmp_path, torn_last, stranded_old, torn_meta):
    picks = {}
    for side, find in (("jax", jckpt.find_resumable), ("port", ckpt.find_resumable)):
        root = _tree(tmp_path / side, torn_last, stranded_old, torn_meta)
        found = find(root)
        picks[side] = (None if found is None else found.relative_to(root).as_posix(),
                       sorted(p.name for p in root.iterdir()))
    assert picks["port"] == picks["jax"]
    if stranded_old and not torn_last:
        assert picks["port"][0] == "last"


def test_recover_last_dir_and_stale_tmp_as_jax(tmp_path):
    """A stranded .last.old is adopted; a stale .last.tmp holding an old
    opt_state.msgpack never reaches a last/ written without one."""
    tree = {"w": np.ones(2, np.float32)}
    listings = {}
    for side, mod in (("jax", jckpt), ("port", ckpt)):
        root = tmp_path / side
        m = mod.CheckpointManager(root)
        m.step(0, 0.5, tree, {}, opt_state={"count": np.zeros((), np.int32)},
               train_state={"scheduler": {"best": 0.5}})
        shutil.copytree(root / "last", root / ".last.tmp")
        m.step(1, 0.4, tree, {})
        (root / "last").rename(root / ".last.old")
        assert mod.recover_last_dir(root) == root / "last"
        assert m.last_path == root / "last"
        m.refresh_last(2, tree, {"monitor": "val/loss"})
        listings[side] = (sorted(p.name for p in root.iterdir()),
                          sorted(p.name for p in (root / "last").iterdir()),
                          mod.load_meta(root / "last"))
    assert listings["port"] == listings["jax"]
    assert listings["port"][1] == ["meta.yaml", "params.msgpack"]
    assert listings["port"][2] == {"monitor": "val/loss", "epoch": 2}
