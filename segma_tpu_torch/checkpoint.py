"""Checkpoints in the JAX package's format (counterpart of
``segma_tpu/checkpoint.py``), read and written with ``msgpack``, ``yaml``
and numpy alone.

A checkpoint directory holds ``params.msgpack``, the TRAINABLE parameters
as a flax tree (flax's names and layouts, ``convert.torch_to_flax``), in
flax's msgpack encoding: nested maps, each array an ext of type 1 holding
the msgpack of (shape, dtype name, C-order bytes), an array above
``MAX_CHUNK_SIZE`` bytes split into a map of flat chunks. ``meta.yaml``
holds the epoch, the monitored score, the config and the fingerprint of the
frozen parameters, which are never written: inference rebuilds them from
``train.seed`` (``init_generator``) and checks them against the
fingerprint. So the JAX package's ``load_params`` restores a checkpoint
written here, and this module restores one written there.

A member of a tensor-parallel mesh holds blocks of the sharded entries
(``parallel.sharding.Blocks``): what it writes is the whole tree, its
blocks gathered over the model group first (``blocks.gather``, which every
member calls), and what it reads it cuts into its blocks (``blocks.take``),
so a checkpoint written under one mesh resumes under another, or none.

```
<run_dir>/checkpoints/
├── epoch=03-val_loss=0.123/   (one per kept epoch: params.msgpack, meta.yaml)
├── last/                      (the most recent epoch, and opt_state.msgpack
│                               and train_state.yaml for an exact resume)
└── best.ckpt -> <best dir>
```

``last/opt_state.msgpack`` holds the AdamW state as optax's tree of the JAX
package's optimizer, ``masked(inject_hyperparams(adamw))`` over the whole
parameter tree, wrapped in ``MultiSteps`` under gradient accumulation
(``opt_state_tree``), so each package resumes from the other's ``last/``. ``train_state.yaml`` holds the plateau scheduler's and
early stopping's counters. A missing or torn file of either resumes with a
fresh state and a warning, as in JAX.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path
from typing import Any, Callable

import msgpack
import numpy as np
import torch

from segma_tpu_torch.config import Config
from segma_tpu_torch.convert import flax_to_torch, load_flax_subtrees, torch_to_flax
from segma_tpu_torch.models.base import SegmentationModel
from segma_tpu_torch.parallel.sharding import WHOLE, Blocks
from segma_tpu_torch.utils.logging import log

MAX_CHUNK_SIZE = 2**30  # flax's largest array leaf before chunking, in bytes
_EXT_NDARRAY = 1  # flax's msgpack ext type code of an array
_CHUNKED = "__msgpack_chunked_array__"


def init_generator(seed: int) -> torch.Generator:
    """THE generator that draws a model's random weights for a run seeded
    with ``seed``: one derivation shared by the model that ``Trainer.fit``
    trains and ``load_model_for_inference``, so that the frozen parameters,
    which no checkpoint holds, come back bit for bit. A CPU generator: the
    builders draw on the CPU and then move the weights to the device."""
    return torch.Generator().manual_seed(seed)


def build_model(config: Config, seed: int | None = None,
                device: str | torch.device | None = "cuda") -> SegmentationModel:
    """The configured model with random weights from ``init_generator(seed)``
    (``train.seed``, or 0, when ``seed`` is None), on ``device``."""
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    if seed is None:
        seed = 0 if config.train.seed is None else int(config.train.seed)
    return Models[config.model.name](
        MultiLabelEncoder(config.data.classes), config, device=device,
        generator=init_generator(seed),
    )


# -- flax trees ------------------------------------------------------------------


def _split_state(model: SegmentationModel) -> tuple[dict, dict]:
    state = model.module.state_dict()
    frozen = {n: t for n, t in state.items() if n.split(".")[0] in model.frozen_prefixes}
    return {n: t for n, t in state.items() if n not in frozen}, frozen


def flax_split(model: SegmentationModel, blocks: Blocks = WHOLE) -> tuple[dict, dict]:
    """(trainable, frozen) flax trees of the model's weights, split at the
    top level by ``frozen_prefixes`` as ``SegmentationModel.split_params``
    splits the JAX tree. A mesh member's trainable tree is the whole one
    (``blocks.gather``, a collective of its model group), its frozen tree
    its own blocks."""
    trainable, frozen = _split_state(model)
    return (torch_to_flax(model.module, blocks.gather(trainable)),
            torch_to_flax(model.module, frozen) if frozen else {})


def frozen_tree(model: SegmentationModel) -> dict:
    """The frozen flax tree alone (``flax_split``'s second)."""
    frozen = _split_state(model)[1]
    return torch_to_flax(model.module, frozen) if frozen else {}


def _masked(tree: Any) -> Any:
    """optax's ``MaskedNode`` at every leaf of a frozen subtree: an empty map."""
    return {k: _masked(v) for k, v in tree.items()} if isinstance(tree, dict) else {}


def _bidirectional(model: SegmentationModel) -> bool:
    lstm = getattr(model.module, "lstm_shared", None)
    return lstm.cfg.bidirectional if lstm is not None else True


def load_trainable(model: SegmentationModel, trainable: dict, blocks: Blocks = WHOLE) -> None:
    """Load a whole trainable flax tree into the model's module (a mesh
    member's blocks of it): every parameter outside ``frozen_prefixes``, and
    nothing else."""
    want = {k.split(".")[0] for k in model.module.state_dict()} - set(model.frozen_prefixes)
    if set(trainable) != want:
        raise ValueError(
            f"checkpoint tree does not match the model's trainable parameters: top-level "
            f"keys {sorted(trainable)}, the model's {sorted(want)}"
        )
    load_flax_subtrees(model.module, trainable, _bidirectional(model), take=blocks.take)


def _leaves(tree: dict, prefix: str = ""):
    """(path, leaf) pairs, the path as ``jax.tree_util.keystr`` writes a
    path of dict keys: ``['encoder']['layers_0']``."""
    for key, value in tree.items():
        path = f"{prefix}[{key!r}]"
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, value


def frozen_fingerprint(frozen: dict) -> str:
    """sha256 over a flax tree's leaves sorted by path: each path, dtype and
    shape, then the bytes. The JAX package's recipe, so the same weights give
    the same digest on both sides."""
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(frozen), key=lambda kv: kv[0]):
        arr = np.asarray(leaf)
        h.update(path.encode())
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# -- flax's msgpack encoding -----------------------------------------------------


def _pack_ext(x: Any) -> msgpack.ExtType:
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _unpack_ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        shape, name, buffer = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buffer, dtype=np.dtype(name.decode())).reshape(shape)
    return msgpack.ExtType(code, data)


def _chunked(arr: np.ndarray) -> dict:
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {
        _CHUNKED: True,
        "shape": {str(i): d for i, d in enumerate(arr.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def _for_msgpack(tree: dict) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[str(key)] = _for_msgpack(value)
        else:
            arr = np.asarray(value)
            out[str(key)] = _chunked(arr) if arr.nbytes > MAX_CHUNK_SIZE else arr
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def to_msgpack(tree: dict) -> bytes:
    """A tree of numpy arrays in flax's msgpack encoding (``to_bytes``)."""
    return msgpack.packb(_for_msgpack(tree), default=_pack_ext, strict_types=True)


def msgpack_restore(blob: bytes) -> dict:
    """flax's ``msgpack_restore``: the tree, arrays read-only, without a template."""
    return _unchunk(msgpack.unpackb(blob, ext_hook=_unpack_ext, raw=False))


# -- optimizer and train state ------------------------------------------------------


def _f32(x: float | torch.Tensor) -> np.ndarray:
    """An f32 scalar; a learning rate held as a device tensor is read."""
    return np.asarray(float(x), np.float32)


def opt_state_tree(model: SegmentationModel, optimizer: torch.optim.Optimizer,
                   accum: Any = None, blocks: Blocks = WHOLE) -> dict:
    """The optimizer state as optax's tree: ``_adamw_tree``, or, with
    ``accum`` (``train.GradAccumulation``, ``train.grad_accum_steps`` > 1), the
    ``optax.MultiSteps`` state around it, as flax's ``to_state_dict`` writes
    it::

        {mini_step, gradient_step, inner_opt_state: <_adamw_tree>,
         acc_grads: <the running mean, whole flax tree>, skip_state: {}}

    ``mini_step`` and ``gradient_step`` are int32 scalars. ``acc_grads``
    spans the whole parameter tree, as optax's does; a frozen leaf has no
    effect on the masked update, so it is written as zeros in its shape (JAX
    accumulates its gradient there) and ignored when read.

    A mesh member's tree is the whole model's: its moments and accumulator
    gathered (``blocks.gather``, a collective of its model group)."""
    inner = _adamw_tree(model, optimizer, blocks.gather)
    if accum is None:
        return inner
    acc = torch_to_flax(model.module, blocks.gather(dict(zip(accum.names, accum.acc))),
                        moments=True)
    frozen = _split_state(model)[1]
    zeros = _zeros(torch_to_flax(model.module, blocks.zeros(frozen))) if frozen else {}
    return {"mini_step": np.asarray(accum.mini_step, np.int32),
            "gradient_step": np.asarray(accum.gradient_step, np.int32),
            "inner_opt_state": inner, "acc_grads": {**acc, **zeros}, "skip_state": {}}


def _zeros(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return np.zeros_like(tree)


def _adamw_tree(model: SegmentationModel, optimizer: torch.optim.Optimizer,
                whole: Callable[[dict], dict]) -> dict:
    """The AdamW state of ``optimizer`` over ``model`` as optax's state tree
    of ``masked(inject_hyperparams(adamw)(learning_rate=lr), trainable_mask)``
    initialised over the whole flax tree (flax's ``to_state_dict``)::

        {inner_state: {count, hyperparams: {learning_rate, b1, b2, eps,
                       eps_root, weight_decay}, hyperparams_states: {},
                       inner_state: {'0': {count, mu, nu}, '1': {}, '2': {}}}}

    ``mu`` and ``nu`` are ``exp_avg`` and ``exp_avg_sq`` in the parameters'
    flax layout, each frozen leaf an empty map (optax's ``MaskedNode``); both
    counts are AdamW's ``step``, which must be one for every parameter;
    counts are int32 and hyperparameters f32 scalars. Before the first step
    the moments are zeros and the counts 0, as ``optax.adamw(...).init``."""
    named = {n: p for n, p in model.module.named_parameters() if p.requires_grad}
    states = {n: optimizer.state.get(p, {}) for n, p in named.items()}
    steps = {float(st["step"]) for st in states.values() if st}
    if len(steps) > 1 or (steps and not all(states.values())):
        raise ValueError(
            f"AdamW steps differ between parameters ({sorted(steps)}, "
            f"{sum(not st for st in states.values())} without state): optax's tree "
            "has one count"
        )
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moment(key: str) -> dict:
        tensors = {n: states[n][key] if states[n] else torch.zeros_like(p)
                   for n, p in named.items()}
        return torch_to_flax(model.module, whole(tensors), moments=True)

    frozen = _split_state(model)[1]
    masked = _masked(torch_to_flax(model.module, frozen)) if frozen else {}
    mu, nu = moment("exp_avg"), moment("exp_avg_sq")
    group = optimizer.param_groups[0]
    return {"inner_state": {
        "count": count,
        "hyperparams": {
            "learning_rate": _f32(group["lr"]), "b1": _f32(group["betas"][0]),
            "b2": _f32(group["betas"][1]), "eps": _f32(group["eps"]), "eps_root": _f32(0.0),
            "weight_decay": _f32(group["weight_decay"]),
        },
        "hyperparams_states": {},
        "inner_state": {
            "0": {"count": count, "mu": {**mu, **masked}, "nu": {**nu, **masked}},
            "1": {}, "2": {},
        },
    }}


def restore_opt_state(model: SegmentationModel, optimizer: torch.optim.Optimizer,
                      tree: dict, accum: Any = None, blocks: Blocks = WHOLE) -> None:
    """Set ``optimizer``'s AdamW state from optax's tree (``opt_state_tree``'s
    inverse): each trainable parameter's ``step``, ``exp_avg`` and
    ``exp_avg_sq``, matched by name through ``flax_to_torch``, and every
    group's learning rate, which carries the plateau scale; with ``accum``,
    its counters and running mean from the ``MultiSteps`` state. The other
    hyperparameters must be the optimizer's own (at f32). A tree of another
    structure (one with or without ``MultiSteps`` where ``accum`` says the
    other) raises before anything is set. A mesh member takes its
    ``blocks`` of the whole moments and accumulator."""
    template = opt_state_tree(model, optimizer, accum, blocks)
    tree = _match(template, tree, "opt_state")
    outer, tree = (tree, tree["inner_opt_state"]) if accum is not None else (None, tree)
    inner = tree["inner_state"]
    adam, hp = inner["inner_state"]["0"], inner["hyperparams"]
    want_hp = (template["inner_opt_state"] if accum is not None else template)
    for key, want in want_hp["inner_state"]["hyperparams"].items():
        if key != "learning_rate" and hp[key] != want:
            raise ValueError(f"opt_state: {key} {float(hp[key])} is not the optimizer's "
                             f"{float(want)}")
    trainable = {k: v for k, v in adam["mu"].items() if k not in model.frozen_prefixes}
    mu = blocks.take(flax_to_torch(trainable, _bidirectional(model), moments=True))
    nu = blocks.take(flax_to_torch({k: adam["nu"][k] for k in trainable}, _bidirectional(model),
                                   moments=True))
    step = float(adam["count"])
    # a capturable AdamW (the card's) keeps its step on the parameters' device
    on_device = bool(optimizer.param_groups[0].get("capturable"))
    new = {}
    for name, p in model.module.named_parameters():
        if p.requires_grad:
            new[p] = {"step": torch.tensor(step, dtype=torch.float32,
                                           device=p.device if on_device else None),
                      "exp_avg": mu[name].to(p.device, p.dtype),
                      "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    if outer is not None:
        acc = blocks.take(flax_to_torch({k: outer["acc_grads"][k] for k in trainable},
                                        _bidirectional(model), moments=True))
        for name, buf in zip(accum.names, accum.acc):
            buf.copy_(acc[name].to(buf.device, buf.dtype))
        accum.mini_step = int(outer["mini_step"])
        accum.gradient_step = int(outer["gradient_step"])
    for p, st in new.items():
        optimizer.state[p] = st
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):  # the card's: set in place
            group["lr"].fill_(float(hp["learning_rate"]))
        else:
            group["lr"] = float(hp["learning_rate"])


def load_opt_state(path: Path | str, model: SegmentationModel,
                   optimizer: torch.optim.Optimizer, accum: Any = None,
                   blocks: Blocks = WHOLE) -> bool:
    """Restore optimizer state from a ``last/`` checkpoint; True when it was.

    The moments are an exactness extra, not a correctness requirement (top-k
    directories never carry them): a missing file resumes with fresh moments,
    and a torn or mismatched one too, with a warning, as in JAX."""
    p = Path(path) / "opt_state.msgpack"
    if not p.exists():
        return False
    try:
        restore_opt_state(model, optimizer, msgpack_restore(p.read_bytes()), accum, blocks)
        return True
    except Exception as e:  # noqa: BLE001 — degrade, never crash resume
        log(f"WARNING: {p}: optimizer state not restorable ({type(e).__name__}); "
            "resuming with fresh optimizer moments")
        return False


def load_train_state(path: Path | str) -> dict:
    """Scheduler and early-stopping counters from ``last/`` ({} when absent);
    torn or alien YAML gives {} with a warning, as in JAX."""
    import yaml

    p = Path(path) / "train_state.yaml"
    if not p.exists():
        return {}
    try:
        with p.open() as f:
            data = yaml.safe_load(f)
        if data is None:
            return {}
        if not isinstance(data, dict):
            raise ValueError(f"expected a mapping, got {type(data).__name__}")
        return data
    except (yaml.YAMLError, ValueError) as e:
        log(f"WARNING: {p}: train state not restorable ({type(e).__name__}); "
            "resuming with fresh scheduler/early-stop counters")
        return {}


# -- checkpoint directories ---------------------------------------------------------


def save_params(path: Path | str, params: dict, meta: dict | None = None) -> Path:
    """Write one checkpoint directory: msgpack params + YAML metadata."""
    import yaml

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "params.msgpack").write_bytes(to_msgpack(params))
    if meta is not None:
        with (path / "meta.yaml").open("w") as f:
            yaml.dump(meta, f, sort_keys=False)
    return path


def _match(template: Any, tree: Any, where: str) -> Any:
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(template) != set(tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where}: keys {got} do not match the template's {sorted(template)}")
        return {k: _match(template[k], tree[k], f"{where}[{k!r}]") for k in template}
    arr, want = np.asarray(tree), np.asarray(template)
    if arr.shape != want.shape:
        raise ValueError(f"{where}: shape {arr.shape} does not match the template's {want.shape}")
    return np.array(arr, dtype=want.dtype)


def load_params(path: Path | str, template: dict) -> dict:
    """Restore a params tree; ``template`` gives its structure, shapes and
    dtypes. A blob that does not parse raises a ValueError naming the file."""
    path = Path(path)
    blob = (path / "params.msgpack").read_bytes() if path.is_dir() else path.read_bytes()
    try:
        tree = msgpack_restore(blob)
    except Exception as e:  # noqa: BLE001 — any parse failure is a corrupted blob
        raise ValueError(
            f"{path}: corrupted checkpoint — params.msgpack does not parse ({type(e).__name__})"
        ) from e
    return _match(template, tree, str(path))


def load_meta(path: Path | str) -> dict:
    """meta.yaml as a dict ({} when absent); torn or alien YAML raises a
    ValueError."""
    import yaml

    meta_p = Path(path) / "meta.yaml"
    if not meta_p.exists():
        return {}
    try:
        with meta_p.open() as f:
            data = yaml.safe_load(f)
    except yaml.YAMLError as e:
        raise ValueError(
            f"{meta_p}: corrupted checkpoint metadata (does not parse as YAML)"
        ) from e
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(
            f"{meta_p}: corrupted checkpoint metadata (expected a mapping, "
            f"got {type(data).__name__})"
        )
    return data


def checkpoint_is_loadable(path: Path | str) -> bool:
    """params.msgpack exists and parses, and meta.yaml (when present) too."""
    try:
        msgpack_restore((Path(path) / "params.msgpack").read_bytes())
        load_meta(path)
        return True
    except Exception:  # noqa: BLE001 — any parse failure means "not valid"
        return False


class CheckpointManager:
    """top-k + last + best bookkeeping over checkpoint directories, with the
    JAX package's rules: ``save_top_k`` -1 keeps all, 0 is refused (best.ckpt
    must point somewhere), the best is never evicted; ``last/`` is written
    every step and replaced by two renames, so one always exists on disk.
    ``write=False`` keeps the same bookkeeping and touches nothing on disk:
    the manager of a rank other than 0, whose decisions must be rank 0's."""

    def __init__(
        self,
        dirpath: Path | str,
        monitor: str = "val/loss",
        mode: str = "min",
        save_top_k: int = 5,
        write: bool = True,
    ) -> None:
        if save_top_k == 0:
            raise ValueError(
                "save_top_k=0 (save no epoch checkpoints) is not supported: "
                "use save_top_k=1 to keep only the best, or -1 to keep all"
            )
        self.dirpath = Path(dirpath)
        self.write = write
        if write:
            self.dirpath.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.kept: list[tuple[float, Path]] = []
        self.best_path: Path | None = None
        self.best_score: float | None = None
        self._rediscover()

    def _rediscover(self) -> None:
        """Adopt the epoch checkpoints already in the directory; one with
        torn metadata is left out with a warning."""
        for p in sorted(self.dirpath.glob("epoch=*")):
            try:
                meta = load_meta(p)
                if "score" not in meta:
                    continue
                score = float(meta["score"])
            except (ValueError, TypeError):
                log(f"WARNING: skipping checkpoint with torn metadata: {p}")
                continue
            self.kept.append((score, p))
            if self.best_score is None or self._is_better(score, self.best_score):
                self.best_score = score
                self.best_path = p
        self.kept.sort(key=lambda t: t[0], reverse=(self.mode == "max"))

    def _is_better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def step(self, epoch: int, score: float, trainable_params: dict, meta: dict,
             opt_state: dict | None = None, train_state: dict | None = None) -> None:
        """Record one epoch's monitored score; write, evict and relink.
        ``opt_state`` (``opt_state_tree``) and ``train_state`` go to ``last/``
        only: they make a resume exact without growing the top-k dirs."""
        meta = {**meta, "epoch": epoch, "score": float(score)}
        name = f"epoch={epoch:02d}-{self.monitor.replace('/', '_')}={score:.3f}"
        path = self.dirpath / name
        if self.write:
            self._write_last(trainable_params, meta, opt_state, train_state)
            save_params(path, trainable_params, meta)
        self.kept.append((score, path))
        self.kept.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
        if self.save_top_k > 0:
            while len(self.kept) > self.save_top_k:
                _, evicted = self.kept.pop()  # the best ranks first: never evicted
                if self.write:
                    shutil.rmtree(evicted, ignore_errors=True)
        if self.best_score is None or self._is_better(score, self.best_score):
            self.best_score = float(score)
            self.best_path = path
            if self.write:
                best_link = self.dirpath / "best.ckpt"
                best_link.unlink(missing_ok=True)
                best_link.symlink_to(path.resolve())

    def _write_last(self, trainable_params: dict, meta: dict, opt_state: dict | None = None,
                    train_state: dict | None = None) -> None:
        """Replace ``last/``: write a tmp dir, then two renames, so that a
        resumable ``last/`` (or ``.last.old``, ``recover_last_dir``) is on disk
        at every moment. The tmp dir starts empty: a stale one from a crashed
        write must not carry an old opt_state.msgpack into a ``last/`` written
        without one."""
        import yaml

        last = self.dirpath / "last"
        tmp = self.dirpath / ".last.tmp"
        old = self.dirpath / ".last.old"
        shutil.rmtree(tmp, ignore_errors=True)
        save_params(tmp, trainable_params, meta)
        if opt_state is not None:
            (tmp / "opt_state.msgpack").write_bytes(to_msgpack(opt_state))
        if train_state is not None:
            with (tmp / "train_state.yaml").open("w") as f:
                yaml.dump(train_state, f)
        shutil.rmtree(old, ignore_errors=True)
        if last.exists():
            last.rename(old)
        tmp.rename(last)
        shutil.rmtree(old, ignore_errors=True)

    def refresh_last(self, epoch: int, trainable_params: dict, meta: dict,
                     opt_state: dict | None = None, train_state: dict | None = None) -> None:
        """Rewrite ``last/`` without top-k accounting, for an epoch that was
        not scored."""
        if self.write:
            self._write_last(trainable_params, {**meta, "epoch": epoch}, opt_state, train_state)

    @property
    def last_path(self) -> Path:
        """``last/``; the writer adopts a ``.last.old`` left by a crash
        (``recover_last_dir``), another rank only names the path: a rename
        there could race the writer's own two renames."""
        if not self.write:
            return self.dirpath / "last"
        return recover_last_dir(self.dirpath)


def resolve_checkpoint(path: Path | str) -> Path:
    """Follow best.ckpt symlinks / accept run dirs or checkpoint dirs."""
    path = Path(path)
    if path.is_symlink():
        path = path.resolve()
    if (path / "params.msgpack").exists():
        return path
    if (path / "checkpoints").exists():
        return resolve_checkpoint(path / "checkpoints" / "best.ckpt")
    raise FileNotFoundError(f"no checkpoint found at {path}")


def load_model_for_inference(
    config: Config, checkpoint: Path | str | None, seed: int | None = None,
    device: str | torch.device | None = "cuda",
) -> SegmentationModel:
    """Build the configured model from ``init_generator`` of ``train.seed``
    (or ``seed``) and overlay the trained parameters of ``checkpoint`` (a
    checkpoint dir, a ``best.ckpt`` link or a run dir). When the metadata
    carries a ``frozen_fingerprint``, the rebuilt frozen tree must match it."""
    if seed is None:
        seed = 0 if config.train.seed is None else int(config.train.seed)
    ckpt_path = None if checkpoint is None else resolve_checkpoint(checkpoint)
    model = build_model(config, seed, device=device)
    if ckpt_path is not None:
        trainable, frozen = flax_split(model)
        expected = load_meta(ckpt_path).get("frozen_fingerprint")
        if expected is not None and frozen:
            actual = frozen_fingerprint(frozen)
            if actual != expected:
                raise ValueError(
                    f"frozen params rebuilt for inference do not match the tree this "
                    f"checkpoint was trained against (fingerprint {actual[:12]} != recorded "
                    f"{expected[:12]}, checkpoint {ckpt_path}): check that train.seed "
                    f"({seed}) and the encoder match the training run"
                )
        load_trainable(model, load_params(ckpt_path, trainable))
    return model


def find_resumable(checkpoints_dir: Path | str) -> Path | None:
    """The newest checkpoint under a run's ``checkpoints/`` that parses:
    ``last/`` (through ``recover_last_dir``), else the epoch directory of the
    highest epoch that parses (its resume loses only the optimizer state),
    else None. A torn checkpoint is skipped with a warning; a torn meta.yaml
    ranks its directory last."""
    checkpoints_dir = Path(checkpoints_dir)
    last = recover_last_dir(checkpoints_dir)
    if last.exists():
        if checkpoint_is_loadable(last):
            return last
        log(f"WARNING: {last} is corrupted (params.msgpack does not parse); "
            "falling back to the newest epoch checkpoint")

    def epoch_of(p: Path) -> int:
        try:
            return int(load_meta(p).get("epoch", -1))
        except (ValueError, TypeError):
            return -1

    epochs = sorted((p for p in checkpoints_dir.glob("epoch=*") if p.is_dir()),
                    key=epoch_of, reverse=True)
    for p in epochs:
        if checkpoint_is_loadable(p):
            return p
        log(f"WARNING: skipping corrupted checkpoint {p}")
    return None


def recover_last_dir(checkpoints_dir: Path | str) -> Path:
    """``last/`` under ``checkpoints_dir``, adopting a ``.last.old`` left by a
    crash between ``_write_last``'s two renames (the previous epoch, still a
    valid resume point)."""
    checkpoints_dir = Path(checkpoints_dir)
    last = checkpoints_dir / "last"
    old = checkpoints_dir / ".last.old"
    if not last.exists() and old.exists():
        try:
            old.rename(last)
        except FileNotFoundError:  # another rank, resuming too, adopted it first
            pass
    return last
