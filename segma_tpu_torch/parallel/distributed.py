"""Multi-process training (counterpart of
``segma_tpu/parallel/distributed.py``).

Every process runs the same program on its own card; ``torch.distributed``
joins them into one world. Data-parallel, each rank takes its own shard of
the files (``process_shard``). Under tensor or sequence parallelism
(``mesh.model`` or ``mesh.seq`` above 1) the world is a (data, seq, model)
mesh of ranks (``World.mesh``): the ``seq * model`` ranks of one data
coordinate take the same shard and hold the blocks of one model, joined by
their seq and model groups, and the trainer reduces over the data group. ``maybe_init_distributed()`` reads the launcher's environment:
``torchrun``'s (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or the JAX package's (``SEGMA_TPU_MULTIHOST=1``,
``COORDINATOR_ADDRESS`` as ``host:port``, ``PROCESS_COUNT``,
``PROCESS_ID``). On one process, with none of them set, it does nothing.

The world's collectives run on NCCL for cards and on gloo for the CPU;
gloo on cards only when the caller names it (several ranks on one card, a
rehearsal, which NCCL refuses). A second, gloo group carries the host's
flags and objects (the preemption vote, the run directory's name), so that
agreeing on them never waits for the card.
"""

from __future__ import annotations

import gc
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from segma_tpu_torch.parallel.collectives import SOLO, DistGroup, Solo
from segma_tpu_torch.parallel.mesh import rank_coordinate, world_shape

if TYPE_CHECKING:
    from segma_tpu_torch.config import Config

BACKENDS = ("nccl", "gloo")
# a rank that never arrives fails the others after this long
TIMEOUT = timedelta(minutes=30)


def _env_int(name: str, default: int | None = None) -> int | None:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def launcher_env() -> dict | None:
    """(init_method, world_size, rank, local_rank) from the launcher's
    environment, or None when no launcher started this process."""
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator:
        count, pid = _env_int("PROCESS_COUNT"), _env_int("PROCESS_ID")
        if count is None or pid is None:
            raise RuntimeError("COORDINATOR_ADDRESS needs PROCESS_COUNT and PROCESS_ID")
        return {"init_method": f"tcp://{coordinator}", "world_size": count, "rank": pid,
                "local_rank": _env_int("LOCAL_RANK", 0)}
    if "WORLD_SIZE" in os.environ:
        for name in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
            if name not in os.environ:
                raise RuntimeError(f"WORLD_SIZE is set but {name} is not (torchrun sets both)")
        return {"init_method": "env://", "world_size": _env_int("WORLD_SIZE"),
                "rank": _env_int("RANK"), "local_rank": _env_int("LOCAL_RANK", 0)}
    if os.environ.get("SEGMA_TPU_MULTIHOST") == "1":
        raise RuntimeError(
            "SEGMA_TPU_MULTIHOST=1 needs COORDINATOR_ADDRESS, PROCESS_COUNT and PROCESS_ID, "
            "or torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
    return None


def maybe_init_distributed(device: str | torch.device = "cuda", backend: str | None = None
                           ) -> bool:
    """Join the world that the launcher's environment names (a world of one
    too, so that its step runs the collectives). ``backend``: NCCL for a
    card, gloo for the CPU by default. Returns True when this call (or an
    earlier one) initialised the world, False on one process with no
    launcher, where nothing is done."""
    if torch.distributed.is_initialized():
        return True
    env = launcher_env()
    if env is None:
        return False
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the nccl backend needs a card: pass device='cuda'")
    kwargs = {}
    if kind == "cuda":
        card = torch.device("cuda", env["local_rank"])
        torch.cuda.set_device(card)
        if backend == "nccl":
            kwargs["device_id"] = card
    torch.distributed.init_process_group(
        backend, init_method=env["init_method"], world_size=env["world_size"],
        rank=env["rank"], timeout=TIMEOUT, **kwargs)
    return True


_host_group = None  # the gloo group of host flags, when the world's backend is not gloo
_meshes: dict[tuple[int, int, int], WorldMesh] = {}  # the groups made, by mesh shape


def is_initialized() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def rank() -> int:
    return torch.distributed.get_rank() if is_initialized() else 0


def world_size() -> int:
    return torch.distributed.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return rank() == 0


def local_device(device: str | torch.device) -> torch.device:
    """This rank's device: for a card, the current one, which
    ``maybe_init_distributed`` set to ``LOCAL_RANK``; else ``device``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device())


def data_process(config: Config) -> tuple[int, int]:
    """(this process's data coordinate, the data size) under ``config``'s
    mesh: (rank, world size) in a data-parallel world, (0, 1) without one.
    The loader shards the files by it: the members of a coordinate take the
    same batches."""
    if not is_initialized():
        return 0, 1
    shape = world_shape(config, world_size())
    return rank_coordinate(rank(), shape)[0], shape[0]


def process_shard(items: list, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """This process's share of a work list: every ``world``-th item from
    its rank on."""
    idx = rank() if process_index is None else process_index
    n = world_size() if process_count is None else process_count
    return items[idx::n]


@dataclass(frozen=True)
class WorldMesh:
    """This process's place in a world of ``shape`` = (data, seq, model)
    ranks: its (d, s, m) ``coordinate``, and the ``data``, ``seq`` and
    ``model`` groups it belongs to (``DistGroup``; ``SOLO`` where that axis
    is 1)."""

    shape: tuple[int, int, int]
    coordinate: tuple[int, int, int]
    data: DistGroup | Solo
    seq: DistGroup | Solo
    model: DistGroup | Solo


class World:
    """The initialised world as the trainer uses it: its collectives'
    ``backend``, the world as a group (``group``: tensor means, sums and
    gathers in rank order), its (data, seq, model) mesh, and host-side
    votes."""

    def __init__(self) -> None:
        if not is_initialized():
            raise RuntimeError("no torch.distributed world: call maybe_init_distributed first")
        self.rank = torch.distributed.get_rank()
        self.size = torch.distributed.get_world_size()
        self.is_main = self.rank == 0
        self.backend = torch.distributed.get_backend()
        self.group = DistGroup(range(self.size))
        global _host_group
        if _host_group is None and self.backend != "gloo":
            # made once, by every rank at the same point (a collective)
            _host_group = torch.distributed.new_group(backend="gloo")

    def mesh(self, config: Config) -> WorldMesh:
        """The world as the (data, seq, model) mesh of ``config`` (its
        ``world_shape``), one rank per mesh device. The groups are made once
        per shape, by every rank in one order (``new_group`` is a
        collective of the world): for each (d, s) the model group, for each
        (d, m) the seq group, for each (s, m) the data group, each only
        where its axis is above 1. In a data-parallel world the data group
        is the world itself."""
        shape = world_shape(config, self.size)
        if shape not in _meshes:
            grid = np.arange(self.size).reshape(shape)
            lines = {axis: {} for axis in ("model", "seq", "data")}
            for axis, ranks_of in (
                    ("model", [grid[d, s, :] for d in range(shape[0]) for s in range(shape[1])]),
                    ("seq", [grid[d, :, m] for d in range(shape[0]) for m in range(shape[2])]),
                    ("data", [grid[:, s, m] for s in range(shape[1]) for m in range(shape[2])])):
                for ranks in ranks_of:
                    ranks = [int(r) for r in ranks]
                    if len(ranks) == 1:
                        continue
                    if len(ranks) == self.size:  # the whole world
                        pg = None
                    else:
                        pg = torch.distributed.new_group(ranks)
                    if self.rank in ranks:
                        lines[axis] = DistGroup(ranks, pg)
            _meshes[shape] = WorldMesh(
                shape, rank_coordinate(self.rank, shape),
                **{axis: group or SOLO for axis, group in lines.items()})
        return _meshes[shape]

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (a host vote)."""
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=_host_group)
        return bool(t.item())

    def broadcast(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        torch.distributed.broadcast_object_list(box, src=0, group=_host_group)
        return box[0]


def current_world() -> World | None:
    """The initialised world, or None on one process."""
    return World() if is_initialized() else None


def destroy() -> None:
    """Leave the world (the end of a training process). Garbage is
    collected and the card synchronised first: NCCL does not destroy a
    communicator while a CUDA graph that captured its collectives lives
    (``train.EpochReplay``), so a trainer left in a reference cycle must go
    before its world does."""
    global _host_group
    if is_initialized():
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        torch.distributed.destroy_process_group()
    _host_group = None
    _meshes.clear()
