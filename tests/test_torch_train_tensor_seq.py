"""Training under tensor and sequence parallelism, on the CPU: real
processes joined by ``torch.distributed`` over gloo, one rank per mesh
device, against JAX's mesh step on its 8 virtual devices and against the
port's meshless step.

Tiny models in f32 with dropout 0 (tests/test_torch_tensor_seq.py's widths
and noisy JAX weights, bridged by ``convert.flax_to_torch``), one gloo world
per group of scenarios:

- world A, 8 ranks at (2, 2, 2): Whisper ``surgical_hydra`` (JAX's
  ``tp_model`` of tests/test_parallel.py, the encoder's time axis over
  ``seq``, the layer mix trained on each member's time block);
- world B, 4 ranks: HuBERT at (2, 1, 2), at (1, 1, 4) with heads that do
  not divide over ``model`` but features that do, WavLM at (2, 1, 2).

Each scenario's first step (``Trainer.train_step``): the loss against JAX's
step over the same mesh at rtol 1e-5, and against the meshless step; the
gradients, gathered from the members' blocks, against the meshless step's
at 1e-4 and the updates at 1e-5 where the gradient is steep (the train-step
pins); a k=2 accumulation cycle's update likewise against the meshless
cycle's; the gathered tree equal to the ranks' blocks put together; every
replicated parameter bit-identical on every rank after three steps; the
frozen fingerprint the whole model's.

Fits through the CLI's ``run_training`` as a 2-rank (1, 1, 2) world (tiny
HuBERT): the checkpoint is JAX's whole tree, read by JAX's ``load_params``
and ``load_opt_state``; a run resumed at (1, 1, 2) ends bit for bit where
the uninterrupted run ends, and resumed on one process, meshless, near it;
an epoch of k=2 accumulation cycles near the meshless one;
``train.dispatch=epoch`` from the device cache (the captured step's plain
version) bit for bit where step dispatch ends, with and without k=2
accumulation, and within JAX's pins of JAX's ``make_epoch_fn`` over the
same mesh. ``parallel.mesh.check_dispatch`` refuses epoch dispatch only
over gloo ranks on cards. The loader: every rank of a data coordinate takes
JAX's ``_loader`` batches of process (data, d).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from segma_tpu.checkpoint import load_opt_state as jax_load_opt_state
from segma_tpu.checkpoint import load_params as jax_load_params
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.data import SegmaFileDataset as JaxDataset
from segma_tpu.data import SegmentationDataLoader as JaxLoader
from segma_tpu.parallel.mesh import make_mesh as jax_make_mesh
from segma_tpu.parallel.mesh import shard_batch as jax_shard_batch
from segma_tpu.parallel.sharding import shard_params as jax_shard_params
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import checkpoint
from segma_tpu_torch.config import load_config
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.parallel import distributed
from segma_tpu_torch.parallel.sharding import param_shardings, torch_dim
from segma_tpu_torch.train import GradAccumulation, make_optimizer, make_train_step
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_tensor_seq import HUBERT_TINY, WAVLM_TINY, WHISPER_TINY, _pair

REPO = Path(__file__).resolve().parent.parent
PORT_DEFAULT = REPO / "segma_tpu_torch/config/default.yml"
JAX_DEFAULT = REPO / "segma_tpu/config/default.yml"
LR = 1e-3
STEPS = 3  # steps after which every replicated parameter is compared across ranks
WAIT_S = 240  # a process's wall, after which the test fails
CLASSES = "data.classes=[KCHI,OCH,MAL,FEM]"  # chip_smoke.TRAIN_CLASSES
WIDTHS = {"surgical_hydra": WHISPER_TINY, "surgical_hubert_hydra": HUBERT_TINY,
          "surgical_wavlm_hydra": WAVLM_TINY}
# (label, model name, (data, seq, model), global batch): world A, then world B
WORLD_A = [("whisper_2x2x2", "surgical_hydra", (2, 2, 2), 8)]
WORLD_B = [("hubert_2x1x2", "surgical_hubert_hydra", (2, 1, 2), 4),
           ("hubert_1x1x4", "surgical_hubert_hydra", (1, 1, 4), 2),
           ("wavlm_2x1x2", "surgical_wavlm_hydra", (2, 1, 2), 4)]
FIT = ["model.name=surgical_hubert_hydra", "model.config.wav_encoder=missing", CLASSES,
       "train.batch_size=4", "train.seed=0", "train.lr=0.001", "train.dataloader.num_workers=1",
       "train.log_every_n_steps=0", "train.data_cache=host", "train.precision=f32",
       "train.extra_val_metrics=[loss,f1_score,auroc]", "audio.chunk_duration_s=1.0",
       "audio.strict_frames=true"]
MESH_2 = ["mesh.data=1", "mesh.model=2"]
STEPS_PER_EPOCH = 4  # the fits' 4 train files of 4 s in 1 s crops, 4 a batch

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.environ["SEGMA_REPO"])
from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
from segma_tpu_torch.parallel import distributed

mode, out = sys.argv[1], sys.argv[2]
spec = json.loads(open(os.path.join(out, "spec.json")).read())
assert distributed.maybe_init_distributed(device="cpu"), "the world did not start"
world = distributed.current_world()
default = os.path.join(os.environ["SEGMA_REPO"], "segma_tpu_torch/config/default.yml")


def encoder_config(name, widths):
    if name == "surgical_hydra":
        from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig as T
    elif name == "surgical_hubert_hydra":
        T = HubertEncoderConfig
    else:
        from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig as T
    return T(**{k: tuple(v) if isinstance(v, list) else v for k, v in widths.items()})


if mode == "steps":
    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.train import Trainer
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    for sc in spec["scenarios"]:
        label, name = sc["label"], sc["name"]
        d, s, m = sc["shape"]
        cfg = load_config(default, [*sc["overrides"], f"mesh.data={d}", f"mesh.seq={s}",
                                    f"mesh.model={m}", "train.lr=0.001"])
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=encoder_config(name, sc["widths"]))
        model.module.load_state_dict(torch.load(os.path.join(out, f"{label}_start.pt")))
        if hasattr(model.module, "dropout"):
            model.module.dropout = 0.0
        trainer = Trainer(model, cfg, os.path.join(out, label), device="cpu")
        coord = trainer.mesh.coordinate
        assert coord == tuple(np.unravel_index(world.rank, (d, s, m))), coord
        batches = np.load(os.path.join(out, f"{label}_batches.npz"))
        n = len(batches["x0"]) // d
        rows = slice(coord[0] * n, (coord[0] + 1) * n)

        def local(i):
            return {k: torch.from_numpy(batches[f"{k}{i}"][rows]) for k in ("x", "y")}

        named = [(k, p) for k, p in trainer.model.module.named_parameters() if p.requires_grad]
        loss, per_label = trainer.train_step(local(0), trainer.generator)
        grads = trainer.blocks.gather({k: p.grad for k, p in named})
        params = trainer.blocks.gather({k: p.detach() for k, p in named})
        dump = {"loss": loss.numpy()[None], "per_label": per_label.numpy(),
                "coordinate": np.asarray(coord), "fp": np.asarray(trainer.frozen_fp or ""),
                **{"grad:" + k: v.numpy().copy() for k, v in grads.items()},
                **{"param:" + k: v.numpy().copy() for k, v in params.items()},
                **{"block:" + k: p.detach().numpy().copy() for k, p in named}}
        for i in range(1, spec["steps"]):
            trainer.train_step(local(i), trainer.generator)
        dump.update({"after:" + k: p.detach().numpy().copy() for k, p in named})
        # a k=2 accumulation cycle from the same start: one update, of the
        # two micro-batches' mean gradient over the data group
        model.module.load_state_dict(torch.load(os.path.join(out, f"{label}_start.pt")))
        cfg_k = load_config(default, [*sc["overrides"], f"mesh.data={d}", f"mesh.seq={s}",
                                      f"mesh.model={m}", "train.grad_accum_steps=2"])
        trainer = Trainer(model, cfg_k, os.path.join(out, label + "_k2"), device="cpu")
        for i in range(2):
            trainer.train_step(local(i), trainer.generator)
        cycle = trainer.blocks.gather({k: p.detach() for k, p in
                                       trainer.model.module.named_parameters() if p.requires_grad})
        dump.update({"cycle:" + k: v.numpy().copy() for k, v in cycle.items()})
        np.savez(os.path.join(out, f"{label}_rank{world.rank}.npz"), **dump)
elif mode == "fits":
    # the CLI builds HuBERT-base: these fits take the tiny widths
    HubertEncoderConfig.base = classmethod(lambda cls: encoder_config(
        "surgical_hubert_hydra", spec["widths"]))
    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.cli.train import run_training
    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.train import Trainer

    build, replay = checkpoint.build_model, Trainer._train_epoch_replay
    calls = []

    def counted(self, loader):  # the epochs that ran through EpochReplay
        calls.append(1)
        return replay(self, loader)

    Trainer._train_epoch_replay = counted
    results, replays = {}, {}
    for tag, extra, resume, dropout in spec["runs"]:
        def built(cfg, *args, _dropout=dropout, **kwargs):
            model = build(cfg, *args, **kwargs)
            if _dropout is not None:
                model.module.dropout = _dropout
            return model

        checkpoint.build_model = built
        calls.clear()
        cfg = load_config(default, extra)
        r = run_training(cfg, [], resume_from=resume, run_id=tag, output=spec["root"],
                         device="cpu")
        results[tag] = [{k: v for k, v in h.items() if "time" not in k and k != "samples_per_s"}
                        for h in r["history"]]
        replays[tag] = len(calls)
    print("FITS " + json.dumps({"rank": world.rank, "results": results, "replays": replays}),
          flush=True)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(out: Path, mode: str, n: int, spec: dict) -> list[str]:
    """The worker as ``n`` ranks of a gloo world (torchrun's variables on a
    free port), each waited on with a timeout; returns each rank's output,
    after asserting that every rank exited 0."""
    (out / "spec.json").write_text(json.dumps(spec))
    script = out / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = []
    for r in range(n):
        env = {**os.environ, "SEGMA_REPO": str(REPO), "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, str(script), mode, str(out)], env=env,
                                      cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
              for r, (p, text) in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return outs


# -- the collectives' backward ------------------------------------------------------


def _members_grads(n: int, grad: str) -> list[dict[str, np.ndarray]]:
    """An MLP block split over ``n`` members (threads of one process on the
    CPU, a ``ThreadGroup``; ``SOLO`` for one): a column-parallel layer on
    ``enter(x)``, a row-parallel one summed by ``reduce_sum``, the column
    block also ``gather``-ed; each member's gradients of x and of its
    blocks. ``"keep"`` (``summed=False``): the loss of the gathered tensor
    is the same on every member; ``"sum"``: each member's loss reads its own
    columns of it, and the members' losses add up to the whole one."""
    from concurrent.futures import ThreadPoolExecutor

    from segma_tpu_torch.parallel.collectives import (
        SOLO, ThreadGroup, enter, gather, reduce_sum, run_members,
    )

    rng = np.random.default_rng(5)
    x0, w0, v0, c0 = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((4, 6), (6, 8), (8, 5), (4, 8)))
    group = ThreadGroup(["cpu"] * n) if n > 1 else None
    width = 8 // n

    def member(rank: int) -> dict[str, np.ndarray]:
        g = group.member(rank) if group is not None else SOLO
        cols = slice(rank * width, (rank + 1) * width)
        x = torch.from_numpy(x0).requires_grad_()
        w = torch.from_numpy(w0[:, cols]).requires_grad_()
        v = torch.from_numpy(v0[cols]).requires_grad_()
        h = enter(x, g) @ w
        z = reduce_sum(h @ v, g)
        full = gather(h, g, dim=1, summed=grad == "sum")
        c = torch.from_numpy(c0)
        side = (full * c).sum() if grad == "keep" else (full * c)[:, cols].sum()
        ((z ** 2).sum() + side).backward()
        return {"x": x.grad.numpy(), "w": w.grad.numpy(), "v": v.grad.numpy()}

    if group is None:
        return [member(0)]
    with ThreadPoolExecutor(n) as pool:
        return run_members(pool, [lambda r=r: member(r) for r in range(n)], [group])


@pytest.mark.parametrize("grad", ["sum", "keep"])
@pytest.mark.parametrize("n", [2, 4])
def test_collectives_backward_gives_each_member_the_whole_gradient(n, grad):
    """Over thread members the gradient of the replicated input is the whole
    one, on every member, and each member's weight gradients are the whole
    model's blocks: ``enter`` sums over the group, ``reduce_sum`` passes the
    gradient on, ``gather`` keeps the member's block (summed first with
    ``"sum"``)."""
    (whole,) = _members_grads(1, "keep" if grad == "keep" else "sum")
    width = 8 // n
    for rank, got in enumerate(_members_grads(n, grad)):
        cols = slice(rank * width, (rank + 1) * width)
        np.testing.assert_allclose(got["x"], whole["x"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["w"], whole["w"][:, cols], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["v"], whole["v"][cols], rtol=1e-5, atol=1e-5)


# -- one step per scenario -----------------------------------------------------------


def _overrides(name: str) -> list[str]:
    base = ["audio.chunk_duration_s=1.0", "train.precision=f32", "train.lr=0.001"]
    if name == "surgical_hydra":
        return [*base, "model.name=surgical_hydra", "model.config.encoder=missing_tiny",
                "model.config.lstm={hidden_size: 16, num_layers: 1, bidirectional: true, "
                "dropout: 0.0}"]
    return [*base, f"model.name={name}", "model.config.wav_encoder=missing",
            "audio.strict_frames=true"]


def _batches(n_rows: int, seed: int) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [{"x": (rng.standard_normal((n_rows, 16_000)) * 0.1).astype(np.float32),
             "y": (rng.random((n_rows, 49, 4)) > 0.6).astype(np.float32)}
            for _ in range(STEPS)]


def _jax_mesh_loss(jmodel, shape: tuple[int, int, int], batch: dict) -> tuple[float, np.ndarray]:
    """JAX's train step over the (data, seq, model) mesh of the first
    d * s * m virtual devices: (loss, per_label)."""
    d, s, m = shape
    mesh = jax_make_mesh(devices=jax.devices()[: d * s * m], data=d, seq=s, model=m)
    jm = jmodel.with_module(jmodel.module.clone(mesh=mesh)) if s > 1 else jmodel
    opt = jax_make_optimizer(jm, LR)
    params = jax_shard_params(jax.tree.map(jnp.array, jmodel.params), mesh)
    _, _, loss, per_label = jax_make_train_step(jm, opt)(
        params, jax.jit(opt.init)(params), jax_shard_batch(batch, mesh), jax.random.key(0))
    return float(loss), np.asarray(per_label)


def _meshless(model, batches: list[dict]) -> dict:
    """The port's one-process step over the whole first batch, and a k=2
    accumulation cycle over the first two with the mean of their
    gradients, from the model's weights (restored after each)."""
    start = {k: v.clone() for k, v in model.module.state_dict().items()}
    torch_batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches[:2]]
    named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
    grads = []
    for b in torch_batches:
        opt = make_optimizer(model, LR)
        loss, per_label = make_train_step(model, opt)(b, None)
        grads.append({n: p.grad.numpy().copy() for n, p in named})
        if not len(grads) - 1:
            out = {"loss": float(loss), "per_label": per_label.numpy(), "grads": grads[0],
                   "params": {n: p.detach().numpy().copy() for n, p in named}}
        model.module.load_state_dict(start)
    opt = make_optimizer(model, LR)
    step = make_train_step(model, opt, accum=GradAccumulation(model, 2))
    for b in torch_batches:
        step(b, None)
    out["cycle"] = {n: p.detach().numpy().copy() for n, p in named}
    out["cycle_grads"] = {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}
    model.module.load_state_dict(start)
    return out


def _scenarios(tmp: Path, scenarios: list, n: int) -> dict:
    out = {}
    spec = {"steps": STEPS, "scenarios": []}
    for label, name, shape, rows in scenarios:
        jmodel, model = _pair(name)
        if name != "surgical_hydra":  # HuBERT's and WavLM's dropout on the mixed layers
            jmodel.module = jmodel.module.clone(dropout=0.0)
            model.module.dropout = 0.0
        batches = _batches(rows, seed=len(out) + 11)
        torch.save(model.module.state_dict(), tmp / f"{label}_start.pt")
        np.savez(tmp / f"{label}_batches.npz",
                 **{f"{k}{i}": b[k] for i, b in enumerate(batches) for k in ("x", "y")})
        spec["scenarios"].append({"label": label, "name": name, "shape": shape,
                                  "overrides": _overrides(name),
                                  "widths": WIDTHS[name]})
        frozen = checkpoint.flax_split(model)[1]
        out[label] = {"model": model, "shape": shape,
                      "jax": _jax_mesh_loss(jmodel, shape, batches[0]),
                      "meshless": _meshless(model, batches),
                      "fp": checkpoint.frozen_fingerprint(frozen) if frozen else ""}
    _world(tmp, "steps", n, spec)
    for label in out:
        out[label]["ranks"] = [dict(np.load(tmp / f"{label}_rank{r}.npz")) for r in range(n)]
    return out


@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    return _scenarios(tmp_path_factory.mktemp("world_a"), WORLD_A, 8)


@pytest.fixture(scope="module")
def world_b(tmp_path_factory):
    return _scenarios(tmp_path_factory.mktemp("world_b"), WORLD_B, 4)


def _prefixed(arrays: dict, prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _scenario(world_a, world_b, label: str) -> dict:
    return world_a[label] if label in world_a else world_b[label]


LABELS = [s[0] for s in WORLD_A + WORLD_B]


@pytest.fixture
def run(request, label):
    world = "world_a" if label in dict((s[0], s) for s in WORLD_A) else "world_b"
    return request.getfixturevalue(world)[label]


@pytest.mark.parametrize("label", LABELS)
def test_loss_equals_jax_mesh_step_and_meshless_step(run, label):
    """Every rank's loss is its data group's mean: JAX's loss over the same
    mesh at rtol 1e-5, the meshless step's at 1e-5."""
    jloss, jper = run["jax"]
    for r, got in enumerate(run["ranks"]):
        loss = float(got["loss"][0])
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["per_label"], jper, rtol=1e-5, atol=1e-6)
        assert abs(loss - run["meshless"]["loss"]) <= 1e-5
        np.testing.assert_allclose(got["per_label"], run["meshless"]["per_label"], atol=1e-5)


@pytest.mark.parametrize("label", LABELS)
def test_gradients_and_updates_equal_the_meshless_step(run, label):
    """The gradients gathered from the members' blocks at 1e-4, the updated
    weights at 1e-5 where the gradient is at least 100 times AdamW's eps and
    within the learning rate elsewhere, on every rank."""
    want = run["meshless"]
    for r, got in enumerate(run["ranks"]):
        grads, params = _prefixed(got, "grad:"), _prefixed(got, "param:")
        assert set(grads) == set(want["grads"])
        for name, g in grads.items():
            np.testing.assert_allclose(g, want["grads"][name], atol=1e-4,
                                       err_msg=f"rank {r} {name}")
        _assert_updates(params, want["params"], want["grads"], f"rank {r}")


def _assert_updates(got: dict, want: dict, grads: dict, what: str) -> None:
    """Updated weights at 1e-5 where the gradient is at least 100 times
    AdamW's eps, within the learning rate elsewhere (there a first update
    is set by the gradient's last digits)."""
    for name, g in grads.items():
        steep = np.abs(g) >= 100 * 1e-8
        np.testing.assert_allclose(got[name][steep], want[name][steep], atol=1e-5,
                                   err_msg=f"{what} {name}")
        assert np.abs(got[name] - want[name]).max() <= LR, f"{what} {name}"


@pytest.mark.parametrize("label", LABELS)
def test_accumulation_cycle_equals_the_meshless_cycle(run, label):
    """A k=2 ``GradAccumulation`` cycle (the mean over the data group at the
    emitting micro-step) makes the meshless cycle's update, on every rank."""
    want = run["meshless"]
    for r, got in enumerate(run["ranks"]):
        _assert_updates(_prefixed(got, "cycle:"), want["cycle"], want["cycle_grads"],
                        f"rank {r}")


@pytest.mark.parametrize("label", LABELS)
def test_gathered_tree_is_the_ranks_blocks_put_together(run, label):
    """The gathered weights bit-equal to the model ranks' blocks
    concatenated along each sharded dimension, and the same on every rank;
    HuBERT's and WavLM's trainable transformers hold sharded parameters
    (Whisper's sharded encoder is frozen: its trainable leaves are all
    replicated)."""
    shape = run["shape"]
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    dims = {n: torch_dim(spec) for n, spec in param_shardings(run["model"].module).items()}
    ranks = run["ranks"]
    sharded = 0
    for name, whole in _prefixed(ranks[0], "param:").items():
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r]["param:" + name], whole, err_msg=name)
        if dims.get(name) is None:
            continue
        sharded += 1
        for d in range(shape[0]):
            for s in range(shape[1]):
                blocks = [ranks[r]["block:" + name] for r in grid[d, s]]
                np.testing.assert_array_equal(np.concatenate(blocks, dims[name]), whole,
                                              err_msg=name)
    assert (sharded > 0) == (label != "whisper_2x2x2")


@pytest.mark.parametrize("label", LABELS)
def test_replicated_leaves_are_bit_identical_on_every_rank(run, label):
    """After STEPS steps every parameter that no rule shards holds the same
    bits on every rank, and each sharded block on the ranks of one model
    coordinate; every rank's coordinate is make_mesh's."""
    shape = run["shape"]
    ranks = run["ranks"]
    dims = {n: torch_dim(spec) for n, spec in param_shardings(run["model"].module).items()}
    for r, got in enumerate(ranks):
        assert tuple(got["coordinate"]) == np.unravel_index(r, shape)
    for name in _prefixed(ranks[0], "after:"):
        for r, got in enumerate(ranks):
            twin = ranks[r % shape[2]] if dims.get(name) is not None else ranks[0]
            np.testing.assert_array_equal(got["after:" + name], twin["after:" + name],
                                          err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("label", LABELS)
def test_frozen_fingerprint_is_the_whole_model_s(run, label):
    """Taken before the member's blocks (the Whisper encoder is frozen and
    sharded), as JAX takes it before placing the parameters."""
    for got in run["ranks"]:
        assert str(got["fp"]) == run["fp"]


# -- fits through the CLI ------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("tp_data") / "ds"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (4, 2, 1), 4.0)
    return root


@pytest.fixture(scope="module")
def tiny_hubert():
    """``HubertEncoderConfig.base`` at the tiny widths, as the fits' workers
    patch it: ``build_model`` then builds the tiny HuBERT."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(HubertEncoderConfig, "base", classmethod(lambda cls: cls(**HUBERT_TINY)))
        yield


def _fit_cfg(dataset: Path, *extra: str) -> list[str]:
    return [*FIT, f"data.dataset_path={dataset}", *extra]


def _dispatch_cfg(dataset: Path, dispatch: str, *extra: str) -> list[str]:
    """A (1, 1, 2) fit from the device cache under ``dispatch``, each
    step's loss logged."""
    return _fit_cfg(dataset, *MESH_2, "train.data_cache=device", "train.log_every_n_steps=1",
                    f"train.dispatch={dispatch}", *extra)


# (tag, dispatch, extra overrides, dropout): the dispatch pairs of the fits'
# world, from the device cache: two epochs with dropout 0 (the epoch run is
# also held to JAX's make_epoch_fn, whose dropout stream torch cannot
# reproduce), and an epoch of k=2 accumulation cycles with the model's own
# dropout (each replay draws the eager step's masks)
DISPATCH_RUNS = [("dispatch_step", "step", ["train.max_epochs=2"], 0.0),
                 ("dispatch_epoch", "epoch", ["train.max_epochs=2"], 0.0),
                 ("k2_step", "step", ["train.max_epochs=1", "train.grad_accum_steps=2"], None),
                 ("k2_epoch", "epoch", ["train.max_epochs=1", "train.grad_accum_steps=2"], None)]


@pytest.fixture(scope="module")
def fits(tmp_path_factory, dataset, tiny_hubert):
    """A 2-rank (1, 1, 2) world's fits: two epochs, one epoch and its
    resume to two, a k=2 accumulation epoch, and ``DISPATCH_RUNS``; then,
    on this process meshless, the same two epochs, the accumulation epoch,
    and the one-epoch mesh run resumed; and JAX's fit of the epoch-dispatch
    run (``make_epoch_fn``) over its (1, 1, 2) mesh of virtual devices."""
    tmp = tmp_path_factory.mktemp("tp_fits")
    root = tmp / "runs"
    half = root / "half" / "checkpoints" / "last"
    spec = {"root": str(root), "widths": HUBERT_TINY,
            "runs": [["full", _fit_cfg(dataset, *MESH_2, "train.max_epochs=2"), None, None],
                     ["half", _fit_cfg(dataset, *MESH_2, "train.max_epochs=1"), None, None],
                     ["resumed", _fit_cfg(dataset, *MESH_2, "train.max_epochs=2"), str(half),
                      None],
                     ["accum", _fit_cfg(dataset, *MESH_2, "train.max_epochs=1",
                                        "train.grad_accum_steps=2"), None, None],
                     *([tag, _dispatch_cfg(dataset, dispatch, *extra), None, dropout]
                       for tag, dispatch, extra, dropout in DISPATCH_RUNS)]}
    outs = _world(tmp, "fits", 2, spec)
    by_rank = {}
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("FITS "))
        rec = json.loads(line[len("FITS "):])
        by_rank[rec["rank"]] = rec
    from segma_tpu_torch.cli.train import run_training

    alone = tmp / "alone"
    meshless = {}
    # run_training links models/last/best.ckpt under the working directory
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        for tag, extra, resume in (
                ("full", _fit_cfg(dataset, *MESH_2, "train.max_epochs=2"), None),
                ("accum", _fit_cfg(dataset, *MESH_2, "train.max_epochs=1",
                                   "train.grad_accum_steps=2"), None),
                ("resumed", _fit_cfg(dataset, *MESH_2, "train.max_epochs=2"), str(half))):
            cfg = load_config(PORT_DEFAULT, extra)
            meshless[tag] = run_training(cfg, [], resume_from=resume, run_id=tag,
                                         output=str(alone), device="cpu")
    return {"root": root, "alone": alone, "ranks": by_rank, "meshless": meshless,
            "jax": _jax_epoch_fit(dataset, tmp / "jax")}


def _jax_epoch_fit(dataset: Path, run_dir: Path) -> dict:
    """JAX's ``Trainer.fit`` of the ``dispatch_epoch`` run: ``make_epoch_fn``
    over the (1, 1, 2) mesh of the first two virtual devices (the
    parameters placed by ``shard_params``, the epoch's offsets and labels
    over ``data``), from the port's initial weights, dropout 0. Returns the
    per-step losses and the trainable tree."""
    from segma_tpu.train import Trainer as JaxTrainer
    from segma_tpu_torch.convert import torch_to_flax

    extra = _dispatch_cfg(dataset, "epoch", "train.max_epochs=2")
    init = checkpoint.build_model(load_config(PORT_DEFAULT, extra), device="cpu")
    jcfg = jax_load_config(JAX_DEFAULT, extra)
    jmodel, _ = _pair("surgical_hubert_hydra")
    jmodel.module = jmodel.module.clone(dropout=0.0)
    jmodel.params = jax.tree.map(jnp.asarray, torch_to_flax(init.module))
    ds = JaxDataset.from_config(jcfg)
    ds.load(use_cache=False)
    dm = JaxLoader(dataset=ds, label_encoder=jmodel.label_encoder, config=jcfg,
                   conv_settings=jmodel.conv_settings)
    mesh = jax_make_mesh(devices=jax.devices()[:2], data=1, seq=1, model=2)
    trainer = JaxTrainer(model=jmodel, config=jcfg, run_dir=run_dir, mesh=mesh, max_epochs=2)
    result = trainer.fit(dm)
    assert trainer.epoch_fn is not None
    trainable, _ = jmodel.split_params(result["params"])
    return {"steps": _step_losses(run_dir),
            "params": _flat(jax.tree.map(np.asarray, trainable))}


def _step_losses(run_dir: Path) -> list[tuple[int, float]]:
    records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["train/loss_step"]) for r in records if "train/loss_step" in r]


def _last(root: Path, run: str) -> Path:
    return root / run / "checkpoints" / "last"


def _tree(path: Path) -> dict:
    return checkpoint.msgpack_restore((path / "params.msgpack").read_bytes())


def _flat(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def test_fit_ranks_agree_and_the_checkpoint_is_jax_s_whole_tree(fits):
    """Both ranks log the same metrics; ``last/`` holds the whole trainable
    tree (JAX's ``load_params`` reads it against the tiny JAX model's
    trainable params) and optax's state (JAX's ``load_opt_state`` restores
    it against its optimizer's init)."""
    a, b = fits["ranks"][0]["results"], fits["ranks"][1]["results"]
    assert a == b and len(a["full"]) == 2
    jmodel, _ = _pair("surgical_hubert_hydra")
    trainable, _ = jmodel.split_params(jmodel.params)
    last = _last(fits["root"], "full")
    restored = jax_load_params(last, trainable)
    got = _flat(_tree(last))
    want = _flat(jax.tree.map(np.asarray, restored))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    q = got["/encoder/layers_0/attention/q_proj/kernel"]
    assert q.shape == (HUBERT_TINY["hidden_size"],) * 2  # whole, not one rank's half
    opt = jax_make_optimizer(jmodel, LR)
    state = jax_load_opt_state(last, opt.init(jmodel.params))
    assert state is not None


def test_fit_resumed_on_the_mesh_ends_bit_for_bit_as_the_uninterrupted_run(fits):
    root = fits["root"]
    for name in ("params.msgpack", "opt_state.msgpack"):
        assert (_last(root, "resumed") / name).read_bytes() == (
            _last(root, "full") / name).read_bytes(), name
    results = fits["ranks"][0]["results"]
    assert results["resumed"] == results["full"][1:]


def _near(got: dict, want: dict, updates: int, what: str) -> None:
    """Every leaf within 1e-4, but an attention's k bias: its gradient is
    zero in exact arithmetic (the softmax does not see it), so AdamW moves
    it by the sign of rounding noise, up to the learning rate an update."""
    assert set(got) == set(want)
    for k, v in want.items():
        atol = updates * LR if k.endswith("k_proj/bias") else 1e-4
        np.testing.assert_allclose(got[k], v, atol=atol, err_msg=f"{what} {k}")


def test_fit_on_the_mesh_is_near_the_meshless_fit(fits):
    """The two-epoch mesh run, the meshless run and the mesh's one-epoch
    checkpoint resumed meshless on one process end near each other
    (``_near``); the epoch of k=2 accumulation cycles too."""
    root, alone = fits["root"], fits["alone"]
    mesh = _flat(_tree(_last(root, "full")))
    n = len(fits["ranks"][0]["results"]["full"]) * STEPS_PER_EPOCH
    for run in ("full", "resumed"):
        _near(_flat(_tree(_last(alone, run))), mesh, n, run)
    _near(_flat(_tree(_last(alone, "accum"))), _flat(_tree(_last(root, "accum"))),
          STEPS_PER_EPOCH // 2, "accum")


@pytest.mark.parametrize("pair", ["dispatch", "k2"])
def test_epoch_dispatch_on_the_mesh_equals_step_dispatch_bit_for_bit(fits, pair):
    """In the (1, 1, 2) gloo world, epoch dispatch (``EpochReplay``'s body
    run eagerly: the captured graph's plain version) ends where step
    dispatch does from the device cache: each logged step loss, both
    ranks' epoch metrics and ``last/``'s ``params.msgpack`` and
    ``opt_state.msgpack`` bytes; the ``k2`` pair with dropout on and k=2
    accumulation cycles (the data group's mean on the updating
    micro-step)."""
    root = fits["root"]
    step, epoch = f"{pair}_step", f"{pair}_epoch"
    for rank in (0, 1):
        got = fits["ranks"][rank]
        assert got["replays"][epoch] == len(got["results"][epoch]) > 0
        assert got["replays"][step] == 0
        assert got["results"][epoch] == got["results"][step]
    assert fits["ranks"][0]["results"][epoch] == fits["ranks"][1]["results"][epoch]
    steps = _step_losses(root / step)
    assert len(steps) == STEPS_PER_EPOCH * len(fits["ranks"][0]["results"][step])
    assert _step_losses(root / epoch) == steps
    for name in ("params.msgpack", "opt_state.msgpack"):
        assert (_last(root, epoch) / name).read_bytes() == (_last(root, step) / name).read_bytes()


def test_epoch_dispatch_on_the_mesh_equals_jax_make_epoch_fn(fits):
    """The (1, 1, 2) world's epoch-dispatch fit against JAX's ``make_epoch_fn``
    over the same mesh from the same weights: each step's loss at rtol 1e-5
    (JAX's own step-vs-scan pin, tests/test_device_cache.py), the final
    trainable tree within ``_near``'s rule."""
    got = _step_losses(fits["root"] / "dispatch_epoch")
    want = fits["jax"]["steps"]
    assert [s for s, _ in got] == [s for s, _ in want] and len(got) == 2 * STEPS_PER_EPOCH
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], rtol=1e-5)
    _near(_flat(_tree(_last(fits["root"], "dispatch_epoch"))), fits["jax"]["params"],
          len(got), "epoch dispatch against JAX's make_epoch_fn")


@pytest.mark.parametrize("backend, device, refused",
                         [("gloo", "cuda", True), ("nccl", "cuda", False), ("gloo", "cpu", False)])
def test_check_dispatch_refuses_epoch_dispatch_only_over_gloo_on_cards(backend, device, refused):
    """Epoch dispatch over seq or model above 1 is refused for gloo ranks on
    cards, and only there: NCCL on cards captures the layers' collectives,
    gloo on the CPU runs the epoch eagerly; step dispatch, and epoch
    dispatch over a data-only mesh, pass everywhere. The message says why
    and what trains the mesh instead."""
    from segma_tpu_torch.parallel.mesh import EPOCH_GLOO_CARD, check_dispatch

    epoch = load_config(PORT_DEFAULT, ["train.dispatch=epoch"])
    step = load_config(PORT_DEFAULT, ["train.dispatch=step"])
    for shape in ((1, 1, 2), (1, 2, 1), (2, 2, 2), (1, 1, 4)):
        if refused:
            with pytest.raises(ValueError) as e:
                check_dispatch(epoch, shape, backend, device)
            assert EPOCH_GLOO_CARD in str(e.value) and "gloo ranks on cards" in str(e.value)
        else:
            check_dispatch(epoch, shape, backend, device)
        check_dispatch(step, shape, backend, device)
    check_dispatch(epoch, (4, 1, 1), backend, device)
    for words in ("a gloo collective", "waits on the host", "a graph cannot hold it",
                  "NCCL refuses two ranks on one card", "train.dispatch=step"):
        assert words in EPOCH_GLOO_CARD, words
    assert "Queue" not in EPOCH_GLOO_CARD


# -- the loader ----------------------------------------------------------------------


class _TimedSampler:
    """A sampler whose batches say which worker drew them and when, after a
    random sleep: the threads finish in an order of their own."""

    def __init__(self, worker: int, fail_at: int | None = None) -> None:
        self.worker, self.n, self.fail_at = worker, 0, fail_at
        self.rng = np.random.default_rng(worker)

    def sample_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        import time

        if self.n == self.fail_at:
            raise OSError("disk gone")
        time.sleep(float(self.rng.uniform(0.0, 0.01)))
        self.n += 1
        return {"x": np.full((batch_size,), 100 * self.worker + self.n)}


@pytest.mark.parametrize("workers", [1, 3, 4])
def test_prefetching_loader_yields_its_workers_batches_in_a_fixed_order(workers):
    """With several sampler threads the batches come round-robin, worker 0
    first and its share's remainder last, whichever thread is quicker, so
    two ranks of a data coordinate with the same seeds take the same
    sequence; a failing worker fails the epoch."""
    from segma_tpu_torch.data import PrefetchingLoader

    def drawn(fail_at=None):
        samplers = [_TimedSampler(w, fail_at if w == workers - 1 else None)
                    for w in range(workers)]
        loader = PrefetchingLoader(samplers[0], 2, 10, extra_samplers=samplers[1:])
        return [int(b["x"][0]) for b in loader]

    shares = [10 // workers] * workers
    shares[0] += 10 - sum(shares)
    want = [100 * w + i + 1 for i in range(max(shares)) for w in range(workers) if i < shares[w]]
    assert drawn() == drawn() == want
    with pytest.raises(RuntimeError, match="worker failed"):
        drawn(fail_at=1)


def test_ranks_of_a_coordinate_take_the_same_batches_with_several_workers(dataset, monkeypatch):
    """Under (1, 1, 4) the four ranks' loaders, each with
    ``num_workers=4``, give one sequence of offsets and labels: every rank
    of a data coordinate stacks the same epoch."""
    from segma_tpu_torch.models.hubert.builders import HUBERT_CONV_SETTINGS as CS

    cfg = load_config(PORT_DEFAULT, [*_fit_cfg(dataset), "train.data_cache=device",
                                     "train.dataloader.num_workers=4", "mesh.data=1",
                                     "mesh.model=4"])
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    epochs = []
    for r in range(4):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        loader = SegmentationDataLoader(ds, MultiLabelEncoder(cfg.data.classes), cfg,
                                        CS).train_dataloader()
        loader.set_epoch(1)
        epochs.append([(b["offsets"].tolist(), b["y"].tobytes()) for b in loader])
    assert len(epochs[0]) == STEPS_PER_EPOCH
    assert all(e == epochs[0] for e in epochs[1:])


SAVE_CACHE = r'''
import sys
sys.path.insert(0, sys.argv[2])
from segma_tpu_torch.config import load_config
from segma_tpu_torch.data import SegmaFileDataset

ds = SegmaFileDataset.from_config(load_config(sys.argv[2] + "/segma_tpu_torch/config/default.yml",
                                              ["data.dataset_path=" + sys.argv[1]]))
ds.load(use_cache=False)
for _ in range(300):
    ds.save_cache()
ds.load_cache()
'''


def test_ranks_save_the_dataset_cache_at_once(dataset, tmp_path):
    """The ranks of a world load the dataset in one working directory, and
    each saves its metadata cache: two processes saving it over and over at
    once both end, and the cache reads back."""
    procs = [subprocess.Popen([sys.executable, "-c", SAVE_CACHE, str(dataset), str(REPO)],
                              cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]


def test_rank_batches_are_their_data_coordinate_s(dataset, monkeypatch):
    """Under (2, 1, 2) ranks 2d and 2d + 1 both take JAX's ``_loader``
    batches of process (2, d), on the host path, and their device caches
    hold that process's files."""
    extra = [*_fit_cfg(dataset), "train.seed=3", "mesh.data=2", "mesh.model=2"]
    jcfg = jax_load_config(JAX_DEFAULT, extra)
    cfgs = {m: load_config(PORT_DEFAULT, [*extra, f"train.data_cache={m}"])
            for m in ("host", "device")}
    from segma_tpu.models.hubert.builders import HUBERT_CONV_SETTINGS as JAX_CS
    from segma_tpu_torch.models.hubert.builders import HUBERT_CONV_SETTINGS as CS

    jds, ds = JaxDataset.from_config(jcfg), SegmaFileDataset.from_config(cfgs["host"])
    jds.load(use_cache=False)
    ds.load(use_cache=False)
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    for r in range(4):
        d = r // 2
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda d=d: d)
        assert distributed.data_process(cfgs["host"]) == (d, 2)
        jl = JaxLoader(jds, JaxEncoder(jcfg.data.classes), jcfg, JAX_CS).train_dataloader()
        dm = SegmentationDataLoader(ds, MultiLabelEncoder(cfgs["host"].data.classes),
                                    cfgs["host"], CS)
        pl = dm.train_dataloader()
        dev = SegmentationDataLoader(ds, MultiLabelEncoder(cfgs["device"].data.classes),
                                     cfgs["device"], CS).train_dataloader()
        assert (dm.rank, dm.world) == (d, 2) and len(jl) == len(pl) > 0
        assert len(dev.device_cache.bases) == len(ds.train.uris[d::2])
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            for jb, pb in zip(jl, pl, strict=True):
                assert pb["x"].shape[0] == 2  # batch_size / data
                for k in ("x", "y"):
                    np.testing.assert_array_equal(pb[k], jb[k])
