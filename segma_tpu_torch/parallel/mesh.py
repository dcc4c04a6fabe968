"""The device mesh and data-parallel placement (counterpart of
``segma_tpu/parallel/mesh.py``).

A ``Mesh`` is a (data, seq, model) array of ``torch.device``s under JAX's
axis names. Along ``data`` the port keeps one replica of the model per
coordinate (``replicate``) and splits a batch or a window stack into
contiguous blocks of its leading axis, in order (``shard_batch``), as
``PartitionSpec("data")`` places an array. Each data coordinate holds
``seq * model`` members (``Mesh.members``): under ``model`` (tensor
parallelism) and ``seq`` (the Whisper encoder's time axis) every member is a
module copy holding its blocks (``parallel.sharding``). Serving runs a
mesh's members as threads of one process; training runs one process per
member, rank r at coordinate ``rank_coordinate(r, shape)`` of the world's
``world_shape``, under either dispatch, but for epoch dispatch over gloo
ranks on cards (``check_dispatch``).

A device list may name one card more than once: N replicas on one card run
the split, the streams and the gather where only one card exists.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:
    from segma_tpu_torch.config import Config
    from segma_tpu_torch.models.base import SegmentationModel

AXIS_NAMES = ("data", "seq", "model")
EPOCH_GLOO_CARD = (
    "train.dispatch=epoch captures the step as a CUDA graph, and under tensor or sequence "
    "parallelism (mesh.model > 1 or mesh.seq > 1) the step holds the layers' own collectives: "
    "a gloo collective on a card's tensors waits on the host, so a graph cannot hold it, and "
    "NCCL refuses two ranks on one card; train one NCCL rank per card, or with "
    "train.dispatch=step, which trains this mesh over gloo")


@dataclass(frozen=True)
class Mesh:
    """``devices``: a (data, seq, model) object array of ``torch.device``."""

    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXIS_NAMES, self.devices.shape))

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each data coordinate (seq and model at 0)."""
        return list(self.devices[:, 0, 0])

    @property
    def primary(self) -> torch.device:
        """Where inputs arrive and outputs are gathered: the first device."""
        return self.devices.flat[0]

    def members(self, i: int) -> list[tuple[torch.device, int, int]]:
        """The (device, seq rank, model rank) of each member of data
        coordinate ``i``, seq-major; the first supplies the coordinate's
        outputs."""
        return [(self.devices[i, s, m], s, m)
                for s in range(self.devices.shape[1]) for m in range(self.devices.shape[2])]


def visible_cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    config: Config | None = None,
    devices: list | None = None,
    data: int | None = None,
    model: int | None = None,
    seq: int | None = None,
) -> Mesh:
    """Build the (data, seq, model) mesh over ``devices`` (the visible cards
    by default). ``data = -1`` (the default) takes every device not claimed
    by ``seq * model``; each size comes from its argument, else from
    ``config.mesh``."""
    if devices is None:
        devices = visible_cards()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    model_sz = model if model is not None else (config.mesh.model if config is not None else 1)
    seq_sz = seq if seq is not None else (config.mesh.seq if config is not None else 1)
    data_sz = data if data is not None else (config.mesh.data if config is not None else -1)
    shape = _resolve(n, data_sz, seq_sz, model_sz)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape))


def _resolve(n: int, data: int, seq: int, model: int) -> tuple[int, int, int]:
    """(data, seq, model) over ``n`` devices; ``data = -1`` takes the rest."""
    if data == -1:
        if n % (model * seq):
            raise ValueError(f"{n} devices not divisible by seq={seq} * model={model}")
        data = n // (model * seq)
    if data * seq * model != n:
        raise ValueError(f"mesh {data}x{seq}x{model} does not match {n} devices")
    return data, seq, model


def world_shape(config: Config, size: int) -> tuple[int, int, int]:
    """The (data, seq, model) shape of a training world of ``size`` ranks,
    one per mesh device, resolved from ``config.mesh`` as ``make_mesh``
    resolves it (and with its errors). A data-only config (seq = model = 1)
    gives (size, 1, 1) whatever ``mesh.data`` says, as data-parallel
    training always took one rank per process of the world."""
    mc = config.mesh
    if mc.seq * mc.model == 1:
        return size, 1, 1
    return _resolve(size, mc.data, mc.seq, mc.model)


def rank_coordinate(rank: int, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """Rank ``rank``'s (d, s, m) in a world of ``shape``: ``make_mesh``'s
    device order, rank r standing for device r."""
    d, s, m = np.unravel_index(rank, shape)
    return int(d), int(s), int(m)


def check_dispatch(config: Config, shape: tuple[int, int, int], backend: str,
                   device: str | torch.device) -> None:
    """Raise ``ValueError`` where the trainer cannot run ``config`` over a
    world of ``shape`` whose collectives run on ``backend`` over tensors on
    ``device``: ``train.dispatch=epoch`` with seq or model above 1 over gloo
    on a card (``EPOCH_GLOO_CARD``). Over NCCL, one rank per card, the
    step's graph holds the layers' collectives; over gloo on the CPU the
    epoch runs eagerly."""
    if (config.train.dispatch == "epoch" and shape[1] * shape[2] > 1 and backend == "gloo"
            and torch.device(device).type == "cuda"):
        raise ValueError(f"mesh {dict(zip(AXIS_NAMES, shape))} of gloo ranks on cards: "
                         f"{EPOCH_GLOO_CARD}")


def visible_devices(device: torch.device) -> list[torch.device]:
    """What ``--mesh auto`` spreads over: every visible card for a card, the
    CPU alone for the CPU."""
    device = torch.device(device)
    return visible_cards() if device.type == "cuda" else [device]


def auto_mesh(config: Config, device: torch.device) -> Mesh | None:
    """``--mesh auto``: a mesh over ``visible_devices(device)`` when there
    are several and the config asks for more than one device (``mesh.data``
    not 1, or ``mesh.seq * mesh.model`` above 1); otherwise None, one device,
    on which a config with ``mesh.seq`` or ``mesh.model`` above 1 serves
    meshless, as JAX's builders then bake no mesh in. A ``mesh.data`` of
    k > 0 takes the first k * seq * model."""
    devices = visible_devices(device)
    per_coordinate = config.mesh.seq * config.mesh.model
    if (config.mesh.data == 1 and per_coordinate == 1) or len(devices) < 2:
        return None
    if config.mesh.data > 0:
        devices = devices[: config.mesh.data * per_coordinate]
    return make_mesh(config, devices)


def describe(mesh: Mesh) -> str:
    """What serves over ``mesh``, in words (the doctor's and the server's)."""
    d, s, m = mesh.devices.shape
    if s * m == 1:
        return f"{d} replica(s), one per data coordinate, each dispatch's windows split over them"
    return (f"{d} data coordinate(s) of {s * m} members: heads and MLP features over "
            f"model={m}, the Whisper encoder's time axis over seq={s}; serving runs the members "
            f"as threads, training as one process each")


def replicate(model: SegmentationModel, mesh: Mesh) -> list[SegmentationModel]:
    """One model per data coordinate, on its device, each a copy of
    ``model``'s module (weights, frozen parameters and buffers); the first
    is ``model`` itself when it already lies on the first device."""
    replicas = []
    for i, device in enumerate(mesh.data_devices):
        if i == 0 and _same_device(model.device, device):
            replicas.append(model)
            continue
        with torch.inference_mode(False):  # parameters, not inference tensors
            module = copy.deepcopy(model.module).to(device)
        replicas.append(dataclasses.replace(model, module=module, device=device))
    return replicas


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        current = torch.cuda.current_device()
        return (a.index if a.index is not None else current) == (
            b.index if b.index is not None else current)
    return True


def block_bounds(n: int, parts: int, align: int = 1) -> list[tuple[int, int]]:
    """``parts`` contiguous blocks of ``range(n)``, in order: each of
    ceil(n / parts) rows, rounded up to a multiple of ``align`` when it is
    larger than ``align``; the last blocks may be shorter or empty."""
    size = -(-n // parts)
    if size > align:
        size = -(-size // align) * align
    return [(min(n, i * size), min(n, (i + 1) * size)) for i in range(parts)]


def shard_batch(batch: Any, mesh: Mesh) -> list[Any]:
    """A batch (a tensor, or a dict of tensors) split along its leading
    axis over ``data``: block i, on data device i. The leading axis must
    divide over the data axis, as JAX's placement requires."""
    tensors = batch if isinstance(batch, dict) else {None: batch}
    n = len(next(iter(tensors.values())))
    parts = mesh.shape["data"]
    if n % parts:
        raise ValueError(f"a leading axis of {n} does not divide over data={parts}")
    blocks = []
    for (lo, hi), device in zip(block_bounds(n, parts), mesh.data_devices):
        block = {k: v[lo:hi].to(device) for k, v in tensors.items()}
        blocks.append(block if isinstance(batch, dict) else block[None])
    return blocks
