"""Multi-process data-parallel training of the port, on the CPU: real
processes joined by ``torch.distributed`` over gloo (``parallel.distributed``
from torchrun's environment), mirroring tests/test_multihost.py.

conv_vad (hidden 32, depth 2, 1 s chunks, f32, the JAX params bridged by
``convert.flax_to_torch``):

- one step of a 2-rank world, each rank on half of a global batch of 8,
  equals the one-process step over the whole batch and JAX's step over its
  8-device mesh: loss 1e-5, gradients 1e-4, updates 1e-5 (the train-step
  pins; ``assert_updates_match`` for gradients near AdamW's eps), and both
  ranks hold the same weights after it; the same for a k=3 accumulation
  cycle (optax ``MultiSteps`` on the JAX side);
- ``cli.auto_train`` as 2 ranks: identical validation metrics on both, one
  writer (rank 0's ``metrics.jsonl``, ``config.yml`` and checkpoints); the
  device cache and epoch dispatch equal to the host path; a SIGTERM to one
  rank inside an epoch stops both at the same step with exit 75, and
  ``--auto-resume`` ends where the uninterrupted run ends, bit for bit;
- rank r's loader batches equal JAX's ``_loader`` batches with
  ``jax.process_count``/``jax.process_index`` patched to (2, r), and its
  device cache's crops equal its host crops;
- ``cli.train``'s own launcher (one rank per card, here over the CPU) runs
  a world of two; ``local_world_size`` decides how many;
- only the writing rank adopts a ``.last.old``, and two ranks resuming at
  once do not trip over each other's adoption;
- ``maybe_init_distributed`` does nothing without a launcher.

Every process is started on a free port, its torch pinned to one thread,
and waited on with a timeout, so a hang fails one test.
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
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.data import SegmaFileDataset as JaxDataset
from segma_tpu.data import SegmentationDataLoader as JaxLoader
from segma_tpu.parallel.mesh import make_mesh as jax_make_mesh
from segma_tpu.parallel.mesh import shard_batch as jax_shard_batch
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch.checkpoint import load_meta
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import torch_to_flax
from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
from segma_tpu_torch.models.vad import CONV_SETTINGS
from segma_tpu_torch.parallel import distributed
from segma_tpu_torch.train import GradAccumulation, make_optimizer, make_train_step
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_lstm_train import _leaves
from tests.test_torch_vad import LR, assert_updates_match, build_pair, overrides

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
GLOBAL_BATCH = 8  # one row per JAX device, four per rank
K = 3
WAIT_S = 240  # a process's wall, after which the test fails
FIT = [*overrides("conv_vad"), "train.batch_size=4", "train.seed=0", "train.max_epochs=3",
       "train.dataloader.num_workers=1", "train.log_every_n_steps=0",
       "train.extra_val_metrics=[loss,f1_score,auroc]"]
CLASSES = "data.classes=[KCHI,OCH,MAL,FEM]"  # chip_smoke.TRAIN_CLASSES
PREEMPT_STEP = 11  # rank 1's SIGTERM: inside epoch 1 of 8-step epochs

WORKER = r'''
import json, os, signal, sys
import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.environ["SEGMA_REPO"])
from segma_tpu_torch.parallel import distributed

mode, out = sys.argv[1], sys.argv[2]
assert distributed.maybe_init_distributed(device="cpu"), "the world did not start"
world = distributed.current_world()
assert world.size == 2, world.size


def dump(name, arrays):
    np.savez(os.path.join(out, f"{name}_rank{world.rank}.npz"), **arrays)


if mode == "step":
    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.train import GradAccumulation, make_optimizer, make_train_step
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = load_config(os.path.join(os.environ["SEGMA_REPO"],
                                   "segma_tpu_torch/config/default.yml"), sys.argv[3:])
    batches = np.load(os.path.join(out, "batches.npz"))
    rows = slice(4 * world.rank, 4 * world.rank + 4)

    def model_at_start():
        model = Models["conv_vad"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
        model.module.load_state_dict(torch.load(os.path.join(out, "start.pt")))
        return model

    def local(i):
        return {k: torch.from_numpy(batches[f"{k}{i}"][rows]) for k in ("x", "y")}

    model = model_at_start()
    step = make_train_step(model, make_optimizer(model, 1e-3), world=world, group=world.group)
    loss, per_label = step(local(0), None)
    named = dict(model.module.named_parameters())
    dump("step", {"loss": loss.numpy()[None], "per_label": per_label.numpy(),
                  **{f"grad:{n}": p.grad.numpy() for n, p in named.items()},
                  **{f"param:{n}": p.detach().numpy() for n, p in named.items()}})
    model = model_at_start()
    opt = make_optimizer(model, 1e-3)
    accum = GradAccumulation(model, 3, world.group)
    step = make_train_step(model, opt, accum=accum, world=world, group=world.group)
    for i in range(3):
        step(local(i), None)
    dump("accum", {f"param:{n}": p.detach().numpy()
                   for n, p in model.module.named_parameters()})
elif mode == "fits":
    from segma_tpu_torch.cli.train import run_training
    from segma_tpu_torch.config import load_config

    args = json.loads(sys.argv[3])
    results = {}
    for tag, extra in args["runs"].items():
        cfg = load_config(os.path.join(os.environ["SEGMA_REPO"],
                                       "segma_tpu_torch/config/default.yml"), extra)
        r = run_training(cfg, [], run_id=tag, output=args["root"], device="cpu")
        results[tag] = {"history": [{k: v for k, v in h.items() if "time" not in k
                                     and k != "samples_per_s"} for h in r["history"]],
                        "best_score": r["best_score"]}
    print("FITS " + json.dumps({"rank": world.rank, "results": results}), flush=True)
elif mode == "preempt":
    import segma_tpu_torch.train as train_mod
    from segma_tpu_torch.cli import auto_train

    make = train_mod.make_train_step
    calls = [0]

    def make_and_signal(*a, **kw):
        step = make(*a, **kw)

        def signalling(batch, generator):
            calls[0] += 1
            out = step(batch, generator)
            if world.rank == 1 and calls[0] == int(os.environ["PREEMPT_STEP"]):
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return signalling

    train_mod.make_train_step = make_and_signal
    auto_train.main(sys.argv[3:])
else:
    from segma_tpu_torch.cli import auto_train

    auto_train.main(sys.argv[3:])
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


def _ranks(tmp_path: Path, *args: str, env: dict | None = None) -> list[tuple[int, str]]:
    """The worker as 2 ranks of a gloo world (torchrun's variables on a free
    port); returns each rank's (exit code, output)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = []
    for r in range(WORLD):
        penv = {**os.environ, "SEGMA_REPO": str(REPO), "RANK": str(r), "LOCAL_RANK": str(r),
                "WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "OMP_NUM_THREADS": "1", **(env or {})}
        procs.append(subprocess.Popen([sys.executable, str(script), *args], env=penv,
                                      cwd=tmp_path, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=WAIT_S)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(code, out) for out, code in outs]


def _ok(results: list[tuple[int, str]], want: int = 0) -> list[str]:
    for r, (code, out) in enumerate(results):
        assert code == want, f"rank {r} exited {code}:\n{out[-4000:]}"
    return [out for _, out in results]


# -- one step and one accumulation cycle ------------------------------------------


def _global_batches(n: int) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(7)
    return [{"x": (rng.standard_normal((GLOBAL_BATCH, 16_000)) * 0.1).astype(np.float32),
             "y": (rng.random((GLOBAL_BATCH, 49, 4)) > 0.6).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The 2-rank world's step and k=3 cycle, the one-process port's and
    JAX's over its 8-device mesh, from the same weights and batches."""
    tmp = tmp_path_factory.mktemp("steps")
    jmodel, model = build_pair("conv_vad")
    batches = _global_batches(K)
    torch.save(model.module.state_dict(), tmp / "start.pt")
    np.savez(tmp / "batches.npz", **{f"{k}{i}": b[k] for i, b in enumerate(batches)
                                     for k in ("x", "y")})
    ranks = _ranks(tmp, "step", str(tmp), *overrides("conv_vad"))
    _ok(ranks)
    world = {which: [dict(np.load(tmp / f"{which}_rank{r}.npz")) for r in range(WORLD)]
             for which in ("step", "accum")}

    start = {k: v.clone() for k, v in model.module.state_dict().items()}
    torch_batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    loss, per_label = make_train_step(model, make_optimizer(model, LR))(torch_batch, None)
    one = {"loss": float(loss), "per_label": per_label.numpy(),
           "grads": {n: p.grad.numpy().copy() for n, p in model.module.named_parameters()},
           "params": {n: p.detach().numpy().copy() for n, p in model.module.named_parameters()}}
    model.module.load_state_dict(start)
    opt = make_optimizer(model, LR)
    step = make_train_step(model, opt, accum=GradAccumulation(model, K))
    for b in batches:
        step({k: torch.from_numpy(v) for k, v in b.items()}, None)
    one["accum"] = {n: p.detach().numpy().copy() for n, p in model.module.named_parameters()}
    model.module.load_state_dict(start)

    mesh = jax_make_mesh(data=GLOBAL_BATCH)
    params = jax.tree.map(jnp.asarray, jmodel.params)

    def loss_fn(p, b):
        logits = jmodel.apply(p, jnp.asarray(b["x"]), train=True,
                              rngs={"dropout": jax.random.key(1)})
        return jmodel.loss(logits, jnp.asarray(b["y"]))[0]

    each = [jax.tree.map(np.asarray, jax.grad(loss_fn)(params, b)) for b in batches]
    jgrads = each[0]
    opt = jax_make_optimizer(jmodel, LR)
    new, _, jloss, jper = jax_make_train_step(jmodel, opt)(
        params, opt.init(params), jax_shard_batch(batches[0], mesh), jax.random.key(1))
    jax_out = {"loss": float(jloss), "per_label": np.asarray(jper), "grads": jgrads,
               "params": jax.tree.map(np.asarray, new),
               "mean_grads": jax.tree.map(lambda *g: sum(g) / len(g), *each)}
    opt = jax_make_optimizer(jmodel, LR, grad_accum_steps=K)
    p, state = jax.tree.map(jnp.asarray, jmodel.params), None
    state = opt.init(p)
    step = jax_make_train_step(jmodel, opt)
    for b in batches:
        p, state, _, _ = step(p, state, jax_shard_batch(b, mesh), jax.random.key(1))
    jax_out["accum"] = jax.tree.map(np.asarray, p)
    return {"world": world, "one": one, "jax": jax_out, "model": model}


def _flax(model, named: dict[str, np.ndarray]) -> dict:
    return torch_to_flax(model.module, {n: torch.from_numpy(v) for n, v in named.items()},
                         moments=True)


def _prefixed(arrays: dict, prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def test_ranks_hold_the_same_weights_after_a_step(steps):
    for which in ("step", "accum"):
        a, b = steps["world"][which]
        assert set(a) == set(b)
        for k in a:
            if k.startswith("param:"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{which} {k}")


def test_world_step_equals_the_global_batch_step(steps):
    got, one = steps["world"]["step"][0], steps["one"]
    assert abs(float(got["loss"][0]) - one["loss"]) <= 1e-5
    np.testing.assert_allclose(got["per_label"], one["per_label"], atol=1e-5)
    for name, g in _prefixed(got, "grad:").items():
        np.testing.assert_allclose(g, one["grads"][name], atol=1e-4, err_msg=name)
    model = steps["model"]
    assert_updates_match(_flax(model, _prefixed(got, "param:")), _flax(model, one["params"]),
                         _flax(model, one["grads"]))


def test_world_step_equals_jax_mesh_step(steps):
    got, ref = steps["world"]["step"][0], steps["jax"]
    assert abs(float(got["loss"][0]) - ref["loss"]) <= 1e-5
    np.testing.assert_allclose(got["per_label"], ref["per_label"], atol=1e-5)
    model = steps["model"]
    grads = dict(_leaves(_flax(model, _prefixed(got, "grad:"))))
    want = dict(_leaves(ref["grads"]))
    assert set(grads) == set(want)
    for key, g in grads.items():
        np.testing.assert_allclose(g, want[key], atol=1e-4, err_msg=key)
    assert_updates_match(_flax(model, _prefixed(got, "param:")), ref["params"], ref["grads"])


def test_world_accumulation_cycle_equals_one_process_and_jax(steps):
    """The cycle's one update, held where the mean gradient is steep."""
    model, ref = steps["model"], steps["jax"]
    params = _flax(model, _prefixed(steps["world"]["accum"][0], "param:"))
    assert_updates_match(params, _flax(model, steps["one"]["accum"]), ref["mean_grads"])
    assert_updates_match(params, ref["accum"], ref["mean_grads"])


# -- fits through the CLI --------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("mp_data") / "ds"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (4, 2, 1), 8.0)
    return root


def _fit_args(dataset: Path, *extra: str) -> list[str]:
    return [*FIT, f"data.dataset_path={dataset}", CLASSES, *extra]


@pytest.fixture(scope="module")
def fits(tmp_path_factory, dataset):
    """Three 2-rank fits in one world: the host path, the device cache, the
    device cache under epoch dispatch."""
    tmp = tmp_path_factory.mktemp("fits")
    runs = {"host": _fit_args(dataset, "train.data_cache=host"),
            "device": _fit_args(dataset, "train.data_cache=device"),
            "epoch": _fit_args(dataset, "train.data_cache=device", "train.dispatch=epoch")}
    outs = _ok(_ranks(tmp, "fits", str(tmp), json.dumps({"root": str(tmp / "runs"),
                                                        "runs": runs})))
    by_rank = {}
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("FITS "))
        rec = json.loads(line[len("FITS "):])
        by_rank[rec["rank"]] = rec["results"]
    return {"root": tmp / "runs", "ranks": by_rank, "outs": outs}


def test_ranks_see_the_same_validation_metrics(fits):
    a, b = fits["ranks"][0], fits["ranks"][1]
    for tag in ("host", "device", "epoch"):
        assert len(a[tag]["history"]) == 3
        assert a[tag] == b[tag], tag
        for h in a[tag]["history"]:
            assert {"val/loss", "val/f1_score", "val/auroc"} <= set(h)
            assert np.isfinite([h["val/loss"], h["val/auroc"], h["train/loss"]]).all()


def test_only_rank_0_writes(fits):
    for tag in ("host", "device", "epoch"):
        run = fits["root"] / tag
        records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
        epochs = [r["epoch"] for r in records if "epoch" in r]
        assert epochs == [0, 1, 2]  # one writer: each epoch once
        assert (run / "config.yml").exists()
        assert load_config(run / "config.yml").train.batch_size == 4
        ck = run / "checkpoints"
        assert (ck / "last" / "params.msgpack").exists() and (ck / "best.ckpt").is_symlink()
    # rank 1 echoes nothing of the metrics stream; rank 0 does
    assert "[log] - {" in fits["outs"][0] and "[log] - {" not in fits["outs"][1]


def test_device_cache_and_epoch_dispatch_equal_the_host_path(fits):
    runs = fits["ranks"][0]
    assert runs["device"]["history"] == runs["host"]["history"]
    assert runs["epoch"]["history"] == runs["host"]["history"]
    for tag in ("device", "epoch"):
        assert ((fits["root"] / tag / "checkpoints" / "last" / "params.msgpack").read_bytes()
                == (fits["root"] / "host" / "checkpoints" / "last" / "params.msgpack")
                .read_bytes())


def test_sigterm_stops_both_ranks_and_auto_resume_ends_where_the_run_ends(
        fits, dataset, tmp_path):
    """Rank 1 alone is sent SIGTERM inside epoch 1: both ranks stop at the
    same step and exit 75, rank 0's ``last/`` holds epoch 0, and
    ``--auto-resume`` ends with the uninterrupted host run's weights."""
    common = ["-c", str(REPO / "segma_tpu_torch/config/default.yml"), "--run-id", "host",
              "--output", str(tmp_path / "runs"), "--device", "cpu",
              *_fit_args(dataset, "train.data_cache=host")]
    outs = _ok(_ranks(tmp_path, "preempt", str(tmp_path), *common,
                      env={"PREEMPT_STEP": str(PREEMPT_STEP)}), want=75)
    last = tmp_path / "runs" / "host" / "checkpoints" / "last"
    assert load_meta(last)["epoch"] == 0
    for out in outs:
        assert "preempt" in out
    _ok(_ranks(tmp_path, "resume", str(tmp_path), *common, "--auto-resume"))
    assert (last / "params.msgpack").read_bytes() == (
        fits["root"] / "host" / "checkpoints" / "last" / "params.msgpack").read_bytes()


# -- the loader and the environment ----------------------------------------------


def test_rank_batches_equal_jax_process_batches(dataset, monkeypatch):
    extra = [*overrides("conv_vad"), f"data.dataset_path={dataset}", CLASSES,
             "train.batch_size=4", "train.seed=3", "train.dataloader.num_workers=1",
             "train.data_cache=host"]
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    from segma_tpu.models.vad import CONV_SETTINGS as JAX_CS

    jds, ds = JaxDataset.from_config(jcfg), SegmaFileDataset.from_config(cfg)
    jds.load(use_cache=False)
    ds.load(use_cache=False)
    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        jdm = JaxLoader(jds, JaxEncoder(jcfg.data.classes), jcfg, JAX_CS)
        dm = SegmentationDataLoader(ds, MultiLabelEncoder(cfg.data.classes), cfg, CONV_SETTINGS,
                                    process=(r, WORLD))
        for which in ("train_dataloader", "val_dataloader"):
            jl, pl = getattr(jdm, which)(), getattr(dm, which)()
            assert len(jl) == len(pl) > 0
            for epoch in (0, 1):
                jl.set_epoch(epoch)
                pl.set_epoch(epoch)
                for jb, pb in zip(jl, pl, strict=True):
                    assert pb["x"].shape[0] == 2  # batch_size / world
                    for k in ("x", "y"):
                        np.testing.assert_array_equal(pb[k], jb[k])


def test_rank_device_cache_crops_equal_its_host_crops(dataset):
    """Each rank caches its own files: the crops it gathers at its batches'
    offsets are its host batches' crops, which the test above holds to JAX
    process r's; every rank's buffer takes the world's dtype."""
    base = [*overrides("conv_vad"), f"data.dataset_path={dataset}", CLASSES,
            "train.batch_size=4", "train.seed=3", "train.dataloader.num_workers=1"]
    cfgs = {m: load_config(REPO / "segma_tpu_torch/config/default.yml",
                           [*base, f"train.data_cache={m}"]) for m in ("host", "device")}
    ds = SegmaFileDataset.from_config(cfgs["host"])
    ds.load(use_cache=False)
    for r in range(WORLD):
        host, dev = (SegmentationDataLoader(ds, MultiLabelEncoder(cfgs[m].data.classes), cfgs[m],
                                            CONV_SETTINGS, process=(r, WORLD)).train_dataloader()
                     for m in ("host", "device"))
        cache = dev.device_cache
        cache.place("cpu")
        assert cache.host_flat.dtype == np.int16  # every file is mono PCM16
        assert len(cache.bases) == len(ds.train.uris[r::WORLD])
        for epoch in (0, 1):
            host.set_epoch(epoch)
            dev.set_epoch(epoch)
            for hb, db in zip(host, dev, strict=True):
                crops = cache.gather(torch.from_numpy(db["offsets"])).float() / 32768.0
                np.testing.assert_array_equal(crops.numpy(), hb["x"])
                np.testing.assert_array_equal(db["y"], hb["y"])


def test_local_world_size(monkeypatch):
    """A plain run starts one rank per visible card when there are several
    and ``mesh.data`` is not 1; under a launcher, on the CPU, on one card or
    with ``mesh.data=1`` it runs alone; under TP/SP data x seq x model ranks
    (one card: meshless), under either dispatch over NCCL; epoch dispatch
    over ``--dist-backend gloo`` is refused there."""
    from segma_tpu_torch.cli import train as cli_train
    from segma_tpu_torch.parallel import mesh as tmesh

    for name in ("WORLD_SIZE", "COORDINATOR_ADDRESS", "SEGMA_TPU_MULTIHOST"):
        monkeypatch.delenv(name, raising=False)
    default = REPO / "segma_tpu_torch/config/default.yml"
    cfg = load_config(default)
    monkeypatch.setattr(tmesh, "visible_cards", lambda: [torch.device("cuda", 0)])
    assert cli_train.local_world_size(cfg, "cuda") == 1
    monkeypatch.setattr(tmesh, "visible_cards", lambda: [torch.device("cuda", i) for i in range(4)])
    assert cli_train.local_world_size(cfg, "cuda") == 4
    assert cli_train.local_world_size(load_config(default, ["mesh.data=2"]), "cuda") == 2
    assert cli_train.local_world_size(load_config(default, ["mesh.data=1"]), "cuda") == 1
    assert cli_train.local_world_size(cfg, "cpu") == 1
    assert cli_train.local_world_size(load_config(default, ["mesh.model=2"]), "cuda") == 4
    assert cli_train.local_world_size(
        load_config(default, ["mesh.data=1", "mesh.model=2"]), "cuda") == 2
    epoch_tp = load_config(default, ["mesh.model=2", "train.dispatch=epoch"])
    assert cli_train.local_world_size(epoch_tp, "cuda") == 4  # NCCL ranks, one per card
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        cli_train.local_world_size(epoch_tp, "cuda", "gloo")
    monkeypatch.setattr(tmesh, "visible_cards", lambda: [torch.device("cuda", 0)])
    assert cli_train.local_world_size(load_config(default, ["mesh.model=2"]), "cuda") == 1
    monkeypatch.setattr(tmesh, "visible_cards", lambda: [torch.device("cuda", i) for i in range(4)])
    for name, value in (("WORLD_SIZE", "4"), ("RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", "1")):
        monkeypatch.setenv(name, value)
    assert cli_train.local_world_size(cfg, "cuda") == 1  # under a launcher


def test_launch_ranks_runs_a_world_of_the_train_cli(dataset, tmp_path, monkeypatch):
    """``cli.train``'s own launcher, as a plain run on several cards starts
    it (here over the CPU): two ranks, one run directory, exit 0."""
    from segma_tpu_torch.cli.train import launch_ranks

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "runs"
    code = launch_ranks("segma_tpu_torch.cli.train", [
        "-c", str(REPO / "segma_tpu_torch/config/default.yml"), "--device", "cpu",
        *_fit_args(dataset, "train.max_epochs=1", f"model.chkp_path={out}")], WORLD)
    assert code == 0
    (run,) = out.iterdir()
    assert [r["epoch"] for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
            if "epoch" in r] == [0]


@pytest.mark.parametrize("batch_size, n_val", [(3, 2), (4, 1)])
def test_loader_refuses_what_jax_refuses(dataset, tmp_path, batch_size, n_val):
    from segma_tpu_torch.data.loaders import DataLoaderError

    root = tmp_path / "ds"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (4, n_val, 1), 4.0)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      [*overrides("conv_vad"), f"data.dataset_path={root}", CLASSES,
                       f"train.batch_size={batch_size}", "train.data_cache=host"])
    ds = SegmaFileDataset.from_config(cfg)
    ds.load(use_cache=False)
    dm = SegmentationDataLoader(ds, MultiLabelEncoder(cfg.data.classes), cfg, CONV_SETTINGS,
                                process=(0, WORLD))
    with pytest.raises(DataLoaderError, match="divide evenly" if batch_size == 3 else "needs"):
        dm.train_dataloader()
        dm.val_dataloader()


def test_only_the_writer_touches_last(tmp_path, monkeypatch):
    """A crash between ``last/``'s two renames leaves ``.last.old``: the
    writer (rank 0) adopts it, another rank's manager only names the path
    (a rename there could race the writer's), and two ranks resuming at
    once both find ``last/`` when one of them adopted it first."""
    import pathlib

    from segma_tpu_torch.checkpoint import CheckpointManager, recover_last_dir

    root = tmp_path / "checkpoints"
    (root / ".last.old").mkdir(parents=True)
    reader = CheckpointManager(root, write=False)
    assert reader.last_path == root / "last"
    assert (root / ".last.old").exists() and not (root / "last").exists()
    assert CheckpointManager(root).last_path == root / "last"
    assert (root / "last").exists() and not (root / ".last.old").exists()

    (root / "last").rename(root / ".last.old")
    real = pathlib.Path.rename

    def adopted_by_another_rank(self, target):
        real(self, target)  # the other rank's rename lands first
        raise FileNotFoundError(self)

    monkeypatch.setattr(pathlib.Path, "rename", adopted_by_another_rank)
    assert recover_last_dir(root) == root / "last" and (root / "last").exists()


def test_maybe_init_distributed_is_a_noop_without_a_launcher(monkeypatch):
    for name in ("SEGMA_TPU_MULTIHOST", "COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_init_distributed(device="cpu") is False
    assert not distributed.is_initialized() and distributed.current_world() is None
    assert (distributed.rank(), distributed.world_size(), distributed.is_main()) == (0, 1, True)
    assert distributed.process_shard([1, 2, 3]) == [1, 2, 3]
    assert distributed.process_shard([1, 2, 3, 4, 5], process_index=1, process_count=2) == [2, 4]
    monkeypatch.setenv("SEGMA_TPU_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="COORDINATOR_ADDRESS"):
        distributed.maybe_init_distributed(device="cpu")
