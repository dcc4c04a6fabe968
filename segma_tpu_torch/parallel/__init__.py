"""Data parallelism (counterpart of ``segma_tpu/parallel/``): the device mesh
with its replicas and blocks (``mesh``) and the multi-process world of
training (``distributed``). Tensor and sequence parallelism
(``segma_tpu/parallel/sharding.py``) are not ported yet."""

from segma_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "auto_mesh", "make_mesh", "replicate", "shard_batch"]
