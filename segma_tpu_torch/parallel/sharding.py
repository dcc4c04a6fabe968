"""Parameter sharding rules: tensor parallelism for the encoder stacks
(counterpart of ``segma_tpu/parallel/sharding.py``).

``TP_RULES`` are JAX's: regexes over a parameter's flax path, each with the
``PartitionSpec`` of its kernel, as a tuple (``()`` is replicated):

- attention q/k/v: output features over ``model`` (head-parallel), their
  biases too; out_proj: input features over ``model``;
- MLP fc1 / intermediate_dense: output features over ``model``, the bias
  too; fc2 / output_dense: input features over ``model``;
- everything else (convs, norms, the biases of row-parallel layers, WavLM's
  relative-position parameters, the LSTM, the heads) replicated.

A port parameter's flax path is the one ``convert.torch_to_flax`` gives it
(``encoder.layers.0.fc1.weight`` is ``encoder/layers_0/fc1/kernel``), and a
spec on a flax kernel (in, out) lands on the transposed torch weight (out,
in). ``shard_params(module, mesh)`` makes one module copy per device of the
mesh, each holding its member's blocks and its groups
(``parallel.collectives``): per data coordinate, a ``model`` group for each
seq rank and a ``seq`` group for each model rank, ``SOLO`` where that axis
is 1 (its collectives are then the identity). A row-parallel layer keeps
its whole bias and adds it once, after the sum over ``model``
(``models.layers.row_linear``), where XLA adds JAX's replicated bias after
its psum.

Training runs one process per mesh device: ``shard_member`` makes that
process's one copy, its groups ``torch.distributed`` ones
(``collectives.DistGroup``). ``Blocks`` relates a member's state entries to
the whole model's: ``gather`` puts the whole tensors together over the
model group (a checkpoint holds JAX's full tree), ``take`` cuts a member's
blocks out of whole tensors (a resume, under any mesh or none).
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import TYPE_CHECKING

import numpy as np
import torch
from torch import nn

from segma_tpu_torch.convert import flax_path
from segma_tpu_torch.parallel.collectives import (
    SOLO, DistGroup, Solo, ThreadGroup, ThreadMember,
)
from segma_tpu_torch.parallel.mesh import Mesh

if TYPE_CHECKING:
    from segma_tpu_torch.models.base import SegmentationModel

Spec = tuple  # a PartitionSpec: one mesh axis name (or None) per dimension

# (flax path regex, spec of the leaf). First match wins.
TP_RULES: list[tuple[str, Spec]] = [
    # attention: column-parallel qkv, row-parallel out
    (r"(self_attn|attention)/(q_proj|k_proj|v_proj)/kernel$", (None, "model")),
    (r"(self_attn|attention)/out_proj/kernel$", ("model", None)),
    # column-sharded layers also shard their bias
    (r"(self_attn|attention)/(q_proj|k_proj|v_proj)/bias$", ("model",)),
    # MLP: column-parallel up, row-parallel down
    (r"(fc1|intermediate_dense)/kernel$", (None, "model")),
    (r"(fc1|intermediate_dense)/bias$", ("model",)),
    (r"(fc2|output_dense)/kernel$", ("model", None)),
]


def spec_for_path(path: str | tuple) -> Spec:
    """The spec of the leaf at flax ``path`` ("a/b/kernel" or its parts)."""
    s = path if isinstance(path, str) else "/".join(map(str, path))
    for pattern, spec in TP_RULES:
        if re.search(pattern, s):
            return spec
    return ()  # replicate


def torch_dim(spec: Spec) -> int | None:
    """The torch dimension ``spec`` shards over ``model``: a kernel's (in,
    out) is the weight's (out, in); a bias has one."""
    if "model" not in spec:
        return None
    dim = spec.index("model")
    return 1 - dim if len(spec) == 2 else dim


def param_shardings(module: nn.Module) -> dict[str, Spec]:
    """Every state entry of ``module`` -> its spec under ``TP_RULES``."""
    return {name: spec_for_path(tuple(flax_path(module, name))) for name in module.state_dict()}


def _check_divisible(name: str, t: torch.Tensor, spec: Spec, n: int) -> None:
    dim = torch_dim(spec)
    if dim is not None and t.shape[dim] % n:
        raise ValueError(
            f"{name}: sharding {spec} over model={n} implies that dimension {dim} of the "
            f"shape {tuple(t.shape)} should be divisible by {n}, but it is {t.shape[dim]}")


def attach_groups(module: nn.Module, seq: ThreadMember | DistGroup | Solo,
                  model: ThreadMember | DistGroup | Solo) -> None:
    """Give every parallel-aware submodule its member of the seq and the
    model group (a class that declares ``seq_group`` or ``model_group``)."""
    for sub in module.modules():
        if hasattr(type(sub), "model_group"):
            sub.model_group = model
        if hasattr(type(sub), "seq_group"):
            sub.seq_group = seq


def member_groups(module: nn.Module) -> set[ThreadGroup]:
    """The thread groups a member's module copy takes part in."""
    return {getattr(sub, attr).group for sub in module.modules()
            for attr in ("model_group", "seq_group")
            if isinstance(getattr(sub, attr, None), ThreadMember)}


def _members(devices: np.ndarray) -> list[ThreadMember | Solo]:
    """The interfaces of a group over ``devices``, by rank: ``SOLO`` for a
    group of one."""
    if len(devices) == 1:
        return [SOLO]
    group = ThreadGroup(devices)
    return [group.member(r) for r in range(len(devices))]


def check_divisible(module: nn.Module, n_model: int) -> dict[str, Spec]:
    """``module``'s specs; ``ValueError`` where an entry's features do not
    divide over ``model=n_model``, as JAX's placement raises."""
    specs = param_shardings(module)
    for name, t in module.state_dict().items():
        _check_divisible(name, t, specs[name], n_model)
    return specs


def shard_params(module: nn.Module, mesh: Mesh) -> np.ndarray:
    """One copy of ``module`` per device of ``mesh`` ((data, seq, model)
    object array), on that device: a parameter that ``TP_RULES`` shards
    holds the block of model rank r of its features, the others are whole,
    and the copy carries its groups. Features that do not divide over
    ``model`` raise ``ValueError``, as JAX's placement does."""
    n_seq, n_model = mesh.shape["seq"], mesh.shape["model"]
    specs = check_divisible(module, n_model)
    copies = np.empty(mesh.devices.shape, dtype=object)
    for i in range(mesh.shape["data"]):
        seq_groups = [_members(mesh.devices[i, :, m]) for m in range(n_model)]
        model_groups = [_members(mesh.devices[i, s, :]) for s in range(n_seq)]
        for device, s, m in mesh.members(i):
            member = _member_copy(module, specs, m, n_model, device)
            attach_groups(member, seq_groups[m][s], model_groups[s][m])
            copies[i, s, m] = member
    return copies


def shard_member(module: nn.Module, seq: DistGroup | Solo, model: DistGroup | Solo
                 ) -> nn.Module:
    """This process's member of a training mesh: a copy of ``module`` on its
    device whose sharded entries hold model rank ``model.rank``'s block of
    ``model.size``, carrying ``seq`` and ``model`` (``ValueError`` as in
    ``shard_params``)."""
    specs = check_divisible(module, model.size)
    device = next(module.parameters()).device
    member = _member_copy(module, specs, model.rank, model.size, device)
    attach_groups(member, seq, model)
    return member


class Blocks:
    """The blocks a member module holds of the whole model's state entries:
    model rank ``group.rank`` of ``group.size`` holds block ``rank`` of each
    entry that ``TP_RULES`` shards, along its ``torch_dim``. Tensors are
    passed by state entry name (parameters, or their optimizer moments);
    over a group of one every method gives them back."""

    def __init__(self, module: nn.Module | None = None, group: DistGroup | Solo = SOLO) -> None:
        self.group = group
        self.dims: dict[str, int] = {}
        if group.size > 1:
            for name, spec in param_shardings(module).items():
                dim = torch_dim(spec)
                if dim is not None:
                    self.dims[name] = dim

    def gather(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The whole tensors, put together over the model group (a
        collective: every member calls it with the same names): one
        all-gather per dtype of the sharded blocks flattened together."""
        names = [n for n in tensors if n in self.dims]
        if not names:
            return dict(tensors)
        out = dict(tensors)
        by_dtype: dict[torch.dtype, list[str]] = {}
        for n in names:
            by_dtype.setdefault(tensors[n].dtype, []).append(n)
        for same in by_dtype.values():
            flat = torch.cat([tensors[n].detach().reshape(-1) for n in same])
            rows = self.group.all_gather(flat, 0).view(self.group.size, -1)
            offset = 0
            for n in same:
                t = tensors[n]
                parts = [row[offset : offset + t.numel()].view_as(t) for row in rows]
                out[n] = torch.cat(parts, dim=self.dims[n])
                offset += t.numel()
        return out

    def take(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This member's blocks of the whole ``tensors``."""
        out = dict(tensors)
        for n, dim in self.dims.items():
            if n in out:
                width = out[n].shape[dim] // self.group.size
                out[n] = out[n].narrow(dim, self.group.rank * width, width).clone()
        return out

    def zeros(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Zeros in the whole shapes of this member's ``tensors``, without a
        collective."""
        out = {}
        for n, t in tensors.items():
            shape = list(t.shape)
            if n in self.dims:
                shape[self.dims[n]] *= self.group.size
            out[n] = torch.zeros(shape, dtype=t.dtype)
        return out


WHOLE = Blocks()  # a module that holds every entry whole


def _member_copy(module: nn.Module, specs: dict[str, Spec], rank: int, n: int,
                 device: torch.device) -> nn.Module:
    """A copy of ``module`` on ``device`` whose sharded entries hold model
    rank ``rank``'s block of ``n``."""
    with torch.inference_mode(False), torch.no_grad():  # parameters, not inference tensors
        member = copy.deepcopy(module)
        for name, p in [*member.named_parameters(), *member.named_buffers()]:
            dim = torch_dim(specs.get(name, ()))
            if dim is None:
                continue
            width = p.shape[dim] // n
            block = p.narrow(dim, rank * width, width).clone()
            *mods, leaf = name.split(".")
            owner = member.get_submodule(".".join(mods))
            if isinstance(p, nn.Parameter):
                setattr(owner, leaf, nn.Parameter(block, requires_grad=p.requires_grad))
            else:
                owner.register_buffer(leaf, block)
        return member.to(device)


def shard_model(model: SegmentationModel, mesh: Mesh) -> np.ndarray:
    """One ``SegmentationModel`` per device of ``mesh`` over ``shard_params``'s
    module copies ((data, seq, model) object array)."""
    modules = shard_params(model.module, mesh)
    out = np.empty(modules.shape, dtype=object)
    for idx, module in np.ndenumerate(modules):
        out[idx] = dataclasses.replace(model, module=module, device=mesh.devices[idx])
    return out
