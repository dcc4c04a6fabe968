"""Parallelism (counterpart of ``segma_tpu/parallel/``): the device mesh
with its replicas and blocks (``mesh``), the tensor-parallel rules and the
members' module copies (``sharding``), the collectives of a member's groups
(``collectives``, with their backward under autograd), and the
multi-process world of training, data-parallel or over a (data, seq, model)
mesh of ranks (``distributed``)."""

from segma_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "auto_mesh", "make_mesh", "replicate", "shard_batch"]
