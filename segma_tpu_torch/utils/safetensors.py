"""A reader of ``.safetensors`` files in numpy alone (the format of HF's
``model.safetensors``), for encoder snapshots.

The file is a little-endian u64 header length N, N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``, then the raw little-endian buffer the offsets index. ``BF16`` has
no numpy dtype: its tensors are widened to f32, which is exact (a bf16 is the
high half of an f32).
"""

from __future__ import annotations

import json
import struct
from math import prod
from pathlib import Path

import numpy as np

_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}


def load_file(path: Path | str) -> dict[str, np.ndarray]:
    """{name: array} of a ``.safetensors`` file; BF16 tensors come back as
    f32. A header or offset that does not fit the file raises a ValueError
    naming the file."""
    path = Path(path)
    data = bytearray(path.stat().st_size)  # writable, so torch may share it
    with path.open("rb") as f:
        f.readinto(data)
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(data)} bytes)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(data[8 : 8 + n])
    buf = memoryview(data)[8 + n :]
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = 2 if dtype == "BF16" else np.dtype(_DTYPES[dtype]).itemsize
        if not 0 <= begin <= end <= len(buf) or end - begin != prod(shape) * itemsize:
            raise ValueError(f"{path}: tensor {name!r} ({dtype}, {shape}) does not fit its "
                             f"offsets [{begin}, {end}) in a buffer of {len(buf)} bytes")
        raw = buf[begin:end]
        if dtype == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        else:
            out[name] = np.frombuffer(raw, _DTYPES[dtype]).reshape(shape)
    return out
