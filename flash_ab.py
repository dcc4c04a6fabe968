#!/usr/bin/env python3
"""The flash forward kernels of this checkout against those of another
checkout, in turns on one card.

    python3 flash_ab.py DIR

DIR holds another checkout (``git archive`` of the parent commit). Its
kernels are built by its own ``ops/_build.py`` in a child process, which
also reports the argument types its ``library()`` gives each forward entry
point: three ints are ``(batch, seq, heads)``, the one-length entry of the
checkouts before ``seq_q`` and ``seq_kv``; four are ``(batch, seq_q, seq_kv,
heads)``, and both lengths are passed the shape's one length. At
Whisper-base's serving shape (64,
1500, 8, 64), in bf16 and in f32, both libraries' entry points are called
bare through ctypes (no wrapper, no launch counter) on the same inputs: the
outputs must be bitwise equal, and both are timed in turns by
``chip_smoke.time_turns`` (10 groups of 20 calls, the order of the two
alternating from group to group). Prints the card's name and power limit,
each kernel's median and spread, and the ratio of the medians.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPE = (64, 1500, 8, 64)
GROUPS = 10
ENTRIES = ("segma_flash_attn_fwd", "segma_flash_attn_fwd_f32")
# the child, in the other checkout: build its kernels and report its
# ``library()``'s argument types of each forward entry point
ARGTYPES_CHILD = (
    "import json; from segma_tpu_torch.ops import _build; lib = _build.library(); "
    f"print(json.dumps({{e: [t.__name__ for t in getattr(lib, e).argtypes] for e in {ENTRIES!r}}}))"
)


def main(other: Path) -> int:
    import torch

    import chip_smoke
    from segma_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("flash_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    child = subprocess.run([sys.executable, "-c", ARGTYPES_CHILD], cwd=other, check=True,
                           capture_output=True, text=True)
    argtypes = json.loads(child.stdout.strip().splitlines()[-1])
    old = ctypes.CDLL(str(other / "segma_tpu_torch" / "_build" / _build.LIB_PATH.name))
    new = _build.library()
    b, s, h, _ = SHAPE
    old_sizes = {}  # entry -> the other checkout's (batch, lengths, heads) arguments
    for entry in ENTRIES:
        types = [getattr(ctypes, name) for name in argtypes[entry]]
        n_ints = types.count(ctypes.c_int)
        if n_ints not in (3, 4):
            raise SystemExit(f"flash_ab: {entry} of {other} takes {argtypes[entry]}, "
                             f"neither the one-length nor the two-length entry")
        getattr(old, entry).argtypes = types
        getattr(old, entry).restype = ctypes.c_int
        old_sizes[entry] = (b, s, h) if n_ints == 3 else (b, s, s, h)
    sm = 64**-0.5
    g = torch.Generator(device="cuda").manual_seed(5)
    for dtype, entry in zip((torch.bfloat16, torch.float32), ENTRIES):
        q, k, v = (torch.randn(SHAPE, device="cuda", generator=g).to(dtype) for _ in range(3))
        outs = {"parent": torch.empty_like(q), "change": torch.empty_like(q)}
        stream = torch.cuda.current_stream().cuda_stream
        scale = sm * math.log2(math.e)

        def parent():
            _build.check(getattr(old, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             outs["parent"].data_ptr(), None, *old_sizes[entry],
                                             scale, stream), entry)

        def change():
            _build.check(getattr(new, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             outs["change"].data_ptr(), None, b, s, s, h, scale,
                                             stream), entry)

        parent()
        change()
        torch.cuda.synchronize()
        if not torch.equal(outs["parent"], outs["change"]):
            raise AssertionError(f"{entry}: the two checkouts' outputs differ")
        times = {"parent": [], "change": []}
        for n in range(GROUPS):
            order = ("parent", "change") if n % 2 == 0 else ("change", "parent")
            one = chip_smoke.time_turns({k: {"parent": parent, "change": change}[k]
                                         for k in order}, groups=1)
            for name, t in one.items():
                times[name] += t
        ratio = chip_smoke.median(times["change"]) / chip_smoke.median(times["parent"])
        print(f"flash_ab {entry} {SHAPE} [{card}]: outputs bitwise equal; parent "
              f"{chip_smoke.spread(times['parent'])}, change {chip_smoke.spread(times['change'])};"
              f" change / parent {ratio:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(Path(sys.argv[1]).resolve()))
