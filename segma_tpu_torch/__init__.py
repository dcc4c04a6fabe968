"""segma_tpu_torch: the PyTorch and CUDA port of segma_tpu for NVIDIA Hopper.

Sliding-window speech segmentation with the JAX package's ten models (the
reference's six: the five Whisper variants, ``surgical_hydra`` by default,
and ``surgical_hubert_hydra``; and ``surgical_wavlm_hydra``,
``sincnet_hydra``, ``conv_vad`` and ``powerset_vad``), the log-mel
frontend, flash attention and the LSTM's recurrence in inference as
hand-written CUDA kernels (``csrc/``), training, checkpoints in the JAX
package's format, and the import of reference checkpoints. The
package imports torch and numpy, and msgpack and yaml for checkpoints. Its
entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

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


_tf32_lock = threading.Lock()
_tf32_depth = 0  # open no_tf32 scopes, over every thread
_tf32_saved: tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """cuDNN and cuBLAS without TF32 while any scope is open, the caller's
    flags restored once the last one closes. Every f32 computation of the
    port runs under it, in a bf16 model too (the BiLSTM, the f32 heads):
    PyTorch's default ``torch.backends.cudnn.allow_tf32 = True`` would put
    cuDNN's f32 convolutions and LSTM in TF32, and a caller may set
    ``torch.backends.cuda.matmul.allow_tf32``. TF32 does not touch bf16.

    The flags are process-global and a server runs forwards on several
    threads at once, so the scopes are counted under a lock: the first to
    open saves the flags and turns TF32 off, a nested or overlapping scope
    changes nothing, and the last to close restores them. A scope that
    restored on its own exit would turn TF32 back on under another
    thread's open scope."""
    global _tf32_depth, _tf32_saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = False
            cudnn.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _tf32_saved
