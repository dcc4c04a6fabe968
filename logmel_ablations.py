#!/usr/bin/env python3
"""Timing-only ablations of the log-mel kernel on one NVIDIA GPU.

    python3 logmel_ablations.py [name ...]

Each ablation is a copy of ``segma_tpu_torch/csrc/logmel.cu`` with one piece
taken out (ABLATIONS below; all of them by default). Its output is wrong by
design: only its time says what that piece costs. Every copy is built by
its own ``nvcc`` (the flags of ``ops/_build.py``), all started together,
into ``segma_tpu_torch/_build/ablations/`` (gitignored), bound with ctypes
through the same C entry point, and timed at the serving shape (64, 480000)
in turns with the kept kernel (``chip_smoke.time_turns``).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

# piece taken out: (text of csrc/logmel.cu, its replacement), each found once
ABLATIONS = {
    # no basis loaded: the stages hold whatever was there
    "no_basis": [(
        "            mbar_arrive_expect_tx(full, STAGE_BYTES);\n"
        "            tma_load_3d(stage_smem + st * STAGE_BYTES, &map_basis, kb * KB, ch * 2 * NCB,"
        " 0,\n                        full);",
        "            mbar_arrive(full);",
    )],
    # half the basis bytes (the hi part): the L2 traffic of a 2-block multicast
    "half_basis": [
        ("mbar_arrive_expect_tx(full, STAGE_BYTES);",
         "mbar_arrive_expect_tx(full, STAGE_BYTES / 2);"),
        ("const cuuint32_t box[3] = {KB, 2 * NCB, 2};", "const cuuint32_t box[3] = {KB, 2 * NCB, 1};"),
    ],
    # no mel projection: the mel warps only release the power tile
    "no_mel": [("            if (pair < 2 * M) {", "            if (pair < 0) {")],
    # no IEEE add of the large-term blocks into the chunk's sum
    "no_add": [("  for (int i = 0; i < 40; ++i) acc[i] += blk[i];", "")],
    # no log10 at the end of a mel's run
    "no_log": [("log10f(fmaxf(mel[q], 1e-10f))", "mel[q]")],
}


def patched(src: str, name: str) -> str:
    for old, new in ABLATIONS[name]:
        if src.count(old) != 1:
            raise ValueError(f"ablation {name}: {old[:60]!r} is not found once in logmel.cu")
        src = src.replace(old, new)
    return src


def main(names: list[str]) -> int:
    import torch

    import chip_smoke
    from segma_tpu_torch.ops import _build, logmel

    if not torch.cuda.is_available():
        print("logmel_ablations: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"device: {card}", flush=True)
    chip_smoke.phase_build()
    src = (_build.SRC_DIR / "logmel.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(patched(src, name))
        so = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-shared", "-o",
               str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    b, t = 64, 480_000
    g = torch.Generator(device="cuda").manual_seed(1)
    wav = torch.randn((b, t), device="cuda", generator=g) * 0.1
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"{name}: {line.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name} did not build")
        lib = ctypes.CDLL(str(so))
        lib.segma_logmel.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.segma_logmel.restype = ctypes.c_int
        fns[name] = lambda lib=lib: logmel.launch(lib, wav)
    times = chip_smoke.time_turns({"kept": lambda: logmel.log10_mel_cuda(wav), **fns})
    for name, ms in times.items():
        print(f"time logmel {name} ({b}, {t}) [{card}]: {chip_smoke.spread(ms)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(ABLATIONS)))
