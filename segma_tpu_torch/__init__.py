"""segma_tpu_torch: the PyTorch and CUDA port of segma_tpu for NVIDIA Hopper.

Sliding-window speech segmentation with the reference's six models (the
five Whisper variants, ``surgical_hydra`` by default, and
``surgical_hubert_hydra``), the log-mel frontend and flash attention as
hand-written CUDA kernels (``csrc/``), training, checkpoints in the JAX
package's format, and the import of reference checkpoints. The
package imports torch and numpy, and msgpack and yaml for checkpoints. Its
entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "segma_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
