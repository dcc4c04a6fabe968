#!/usr/bin/env python3
"""Variants and timing-only ablations of the f32 flash backward on one NVIDIA GPU.

    python3 flash_bwd_f32_ablations.py [name ...]

Each entry of VARIANTS and ABLATIONS is a copy of
``segma_tpu_torch/csrc/flash_attn_bwd_f32.cu`` with exact text patches
(each found a given number of times, or the script stops naming it). A
variant computes the same sums in the same order, so its gradients must be
bitwise equal to the kept kernel's at the training shape (32, 199, 12, 64)
and at (2, 1, 3, 64) and (2, 129, 3, 64); an ablation takes a piece out,
its output is wrong by design and only its time says what that piece
costs. Every copy is built by its own ``nvcc`` (the flags of
``ops/_build.py``), all started together, into
``segma_tpu_torch/_build/ablations/`` (gitignored), bound with ctypes through
the same C entry point, and timed at the training shape in turns with the
kept kernel and SDPA's EFFICIENT backward (``chip_smoke.time_turns``).
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

def _offset_after(*anchors: str) -> list[tuple[str, str, int]]:
    """Consumer 1 waits at named barrier 1 before its first tile; consumer 0
    arrives there right after committing the product at each anchor line
    (one per pass) in its first tile."""
    return [
        ("  const int t = threadIdx.x % 128;\n",
         "  const int t = threadIdx.x % 128;\n  if (c == 1) named_sync(1, 256);\n", 2),
        *[(f"{a}\n      wgmma_commit();\n",
           f"{a}\n      wgmma_commit();\n      if (c == 0 && tile == 0) named_arrive(1, 256);\n",
           1) for a in anchors],
    ]


# (text of csrc/flash_attn_bwd_f32.cu, its replacement, times it is found)
VARIANTS = {
    # one consumer warpgroup of 64 rows per block, items of 64 rows, no
    # register reallocation
    "one_consumer": [
        ("constexpr int NC = 2;", "constexpr int NC = 1;", 1),
        ("    setmaxnreg_dec<56>();\n", "", 2),
        ("  setmaxnreg_inc<224>();\n", "", 2),
    ],
    # the producer loads an item's resident tiles before its first streamed
    # tiles, so these wait until the predecessor is done with the resident ones
    "resident_first": [
        ("      for (int j = 0; j < early; ++j) load_tile(it, j);\n", "", 1),
        ("      for (int j = early; j < n_tiles; ++j) load_tile(it, j);",
         "      for (int j = 0; j < n_tiles; ++j) load_tile(it, j);", 1),
    ],
    # consumer 1 starts once consumer 0 has committed its first tile's S, dP or
    # row products (in each pass), so that their CUDA-core steps fall at
    # different times
    "offset_after_s": _offset_after(
        "      score_product(s_lg, s_sm, ah, al, stage);  // S = Q K^T",
        "      score_product(s_lg, s_sm, ah, al, stage);  // S^T = K Q^T"),
    "offset_after_dp": _offset_after(
        "      score_product(p_lg, p_sm, ah, al, stage + NAT_BYTES);  // dP = dO V^T",
        "      score_product(p_lg, p_sm, ah, al, stage + NAT_BYTES);  // dP^T = V dO^T"),
    "offset_after_rows": _offset_after(
        "      row_product(blk, dh, dl, stage + 2 * NAT_BYTES);  // dQ += dS K",
        "      row_product(blk_k, dh, dl, stage + 2 * NAT_BYTES);  // dK += dS^T Q"),
}

ABLATIONS = {
    # the converters write no transposed tiles
    "no_transpose": [("    if (tsr < NT) {", "    if (tsr < 0) {", 1)],
    # the converters touch no stage: they only release it
    "no_convert": [("  for (int g = tid / 32; g < 8; g += 3) {",
                    "  for (int g = tid / 32; g < 0; g += 3) {", 1)],
    # the consumers do not split the resident rows: raw f32 bits as hi, 0 as lo
    "no_split": [(
        "        split(v[t][i], hi[4 * (2 * jp + t) + i], lo[4 * (2 * jp + t) + i]);",
        "        hi[4 * (2 * jp + t) + i] = __float_as_uint(v[t][i]);\n"
        "        lo[4 * (2 * jp + t) + i] = 0u;", 1)],
    # the score products as one TF32 product (the small terms' wgmmas out)
    "one_tf32_scores": [
        ("      wgmma_m64n32k8_tf32_rs_zero_d(sm, &lo[0], b_hi);\n"
         "      wgmma_m64n32k8_tf32_rs(sm, &hi[0], b_lo);\n", "", 1),
        ("      wgmma_m64n32k8_tf32_rs(sm, &lo[4 * kk], b_hi);\n"
         "      wgmma_m64n32k8_tf32_rs(sm, &hi[4 * kk], b_lo);\n", "", 1),
    ],
    # the products over the tile's rows as one TF32 product
    "one_tf32_rows": [(
        "    if (kk == 0) {\n"
        "      wgmma_m64n64k8_tf32_rs_zero_d(blk, &lo[0], b_hi);\n"
        "    } else {\n"
        "      wgmma_m64n64k8_tf32_rs(blk, &lo[4 * kk], b_hi);\n"
        "    }\n"
        "    wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_lo);\n"
        "    wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_hi);\n",
        "    if (kk == 0) {\n"
        "      wgmma_m64n64k8_tf32_rs_zero_d(blk, &hi[0], b_hi);\n"
        "    } else {\n"
        "      wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_hi);\n"
        "    }\n", 1)],
}

CHECK_SHAPES = ((32, 199, 12, 64), (2, 1, 3, 64), (2, 129, 3, 64))


def patched(src: str, name: str) -> str:
    for old, new, count in {**VARIANTS, **ABLATIONS}[name]:
        if src.count(old) != count:
            raise ValueError(f"{name}: {old[:60]!r} is not found {count} times in "
                             "flash_attn_bwd_f32.cu")
        src = src.replace(old, new)
    return src


def launcher(lib):
    """The C entry point of ``lib`` called as ops/attention.flash_attn_bwd
    calls it, uncounted."""
    import torch

    def bwd(q, k, v, out, lse, dout, sm):
        b, s, h, _ = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        pairs = torch.empty((b, h, -(-s // 128) * 128, 2), device=q.device)
        err = lib.segma_flash_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), pairs.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, sm * math.log2(math.e), sm, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return dq, dk, dv
    return bwd


def main(names: list[str]) -> int:
    import torch

    import chip_smoke
    from segma_tpu_torch.ops import _build, attention

    if not torch.cuda.is_available():
        print("flash_bwd_f32_ablations: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"device: {card}", flush=True)
    chip_smoke.phase_build()
    src = (_build.SRC_DIR / "flash_attn_bwd_f32.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"bwd_f32_{name}.cu"
        cu.write_text(patched(src, name))
        so = out_dir / f"bwd_f32_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-shared", "-o",
               str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line or "warning" in line:
                print(f"{name}: {line.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build")
        lib = ctypes.CDLL(str(so))
        lib.segma_flash_attn_bwd_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.segma_flash_attn_bwd_f32.restype = ctypes.c_int
        fns[name] = launcher(lib)

    torch.set_grad_enabled(False)
    g = torch.Generator(device="cuda").manual_seed(5)
    sm = 64**-0.5
    for shape in CHECK_SHAPES:
        q, k, v, dout = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        kept = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
        for name in names:
            if name in VARIANTS:
                got = fns[name](q, k, v, out, lse, dout, sm)
                if not all(torch.equal(a, b) for a, b in zip(got, kept)):
                    raise AssertionError(f"variant {name} differs from the kept kernel at {shape}")
                print(f"check {name} {shape}: bitwise equal to the kept kernel", flush=True)

    q, k, v, dout = (torch.randn(chip_smoke.TRAIN_ATTN_SHAPE, device="cuda", generator=g)
                     for _ in range(4))
    out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    library = {n: c for n, c in chip_smoke.sdpa_calls(qt, kt, vt, sm, dot).items()
               if "EFFICIENT" in n}
    times = chip_smoke.time_turns({
        "kept": lambda: attention.flash_attn_bwd(q, k, v, out, lse, dout, sm),
        **{n: (lambda fn=fn: fn(q, k, v, out, lse, dout, sm)) for n, fn in fns.items()},
        **library,
    })
    for name, ms in times.items():
        print(f"time flash_attn_bwd f32 {name} {chip_smoke.TRAIN_ATTN_SHAPE} [{card}]: "
              f"{chip_smoke.spread(ms)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [*VARIANTS, *ABLATIONS]))
