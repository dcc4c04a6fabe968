#!/usr/bin/env python3
"""Variants and timing-only ablations of the f32 flash kernels on one NVIDIA GPU.

    python3 flash_f32_ablations.py [fwd|bwd] [name ...]

Two tables, ``KERNELS["fwd"]`` (``segma_tpu_torch/csrc/flash_attn_f32.cu``)
and ``KERNELS["bwd"]`` (``csrc/flash_attn_bwd_f32.cu``), each of variants
and ablations. An entry is a copy of the kernel's source and of
``csrc/sm90.cuh`` (which holds the tiles and products the two kernels
share) with exact text patches, each found a given number of times in its
file, or the script stops naming it. A variant computes the same sums in the
same order, so its outputs must be bitwise equal to the kept kernel's at
the kernel's CHECK_SHAPES; an ablation takes a piece out, its output is
wrong by design and only its time says what that piece costs. Every copy
is built by its own ``nvcc`` (the flags of ``ops/_build.py``), all started
together, into ``segma_tpu_torch/_build/ablations/`` (gitignored), bound
with ctypes through the kernel's C entry point, and timed in turns with the
kept kernel and SDPA's EFFICIENT backend (``chip_smoke.time_turns``): the
forward at the serving shape (64, 1500, 8, 64) and the training shape (32,
199, 12, 64), the backward at the training shape. With no arguments, every
entry of both.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

FWD_SRC = "flash_attn_f32.cu"
BWD_SRC = "flash_attn_bwd_f32.cu"
SM90 = "sm90.cuh"


def _q_split_per_tile() -> list[tuple[str, str, str, int]]:
    """Q stays raw in shared memory; each consumer splits its rows into
    registers per tile (resident_frags) and runs the score product with A
    from registers, as the backward does."""
    patches = [(FWD_SRC, "        convert_q(q_smem, tid);\n", "", 1)]
    for ind, wait in (("    ", "wgmma_wait<0>();"),
                      ("      ", "wgmma_wait<1>();  // the scores of tile j")):
        patches += [
            (FWD_SRC,
             f"\n{ind}wgmma_fence();\n{ind}qk_product(lg, sm, q_mine, stage0 + st * STAGE_BYTES);",
             f"\n{ind}uint32_t ah[32], al[32];\n{ind}resident_frags(ah, al, q_mine, row, quad);\n"
             f"{ind}wgmma_fence();\n{ind}score_product(lg, sm, ah, al, stage0 + st * STAGE_BYTES);",
             1),
            (FWD_SRC, f"{ind}{wait}\n{ind}join(lg, sm);\n",
             f"{ind}{wait}\n{ind}join(lg, sm);\n"
             f"{ind}fence_regs<32>(ah);\n{ind}fence_regs<32>(al);\n",
             1),
        ]
    return patches


def _offset_after(*anchors: str) -> list[tuple[str, str, str, int]]:
    """Consumer 1 waits at named barrier 1 before its first tile; consumer 0
    arrives there right after committing the product at each anchor line
    (one per pass) in its first tile."""
    return [
        (BWD_SRC, "  const int t = threadIdx.x % 128;\n",
         "  const int t = threadIdx.x % 128;\n  if (c == 1) named_sync(1, 256);\n", 2),
        *[(BWD_SRC, f"{a}\n      wgmma_commit();\n",
           f"{a}\n      wgmma_commit();\n      if (c == 0 && tile == 0) named_arrive(1, 256);\n",
           1) for a in anchors],
    ]


# the products over a tile's rows (P V, dQ, dK, dV) as one TF32 product
_ONE_TF32_ROWS = [(SM90, (
    "    if (kk == 0) {\n"
    "      wgmma_m64n64k8_tf32_rs_zero_d(blk, &lo[0], b_hi);\n"
    "    } else {\n"
    "      wgmma_m64n64k8_tf32_rs(blk, &lo[4 * kk], b_hi);\n"
    "    }\n"
    "    wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_lo);\n"
    "    wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_hi);\n"), (
    "    if (kk == 0) {\n"
    "      wgmma_m64n64k8_tf32_rs_zero_d(blk, &hi[0], b_hi);\n"
    "    } else {\n"
    "      wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_hi);\n"
    "    }\n"), 1)]

_CONVERT_TOP = "    const int half = (g >> 1) & 1, jj = g & 1;\n"

KERNELS = {
    "fwd": {
        "source": FWD_SRC,
        "variants": {
            # Q split once per item into hi and lo in shared memory (kept)
            # against a split per tile into registers
            "q_split_per_tile": _q_split_per_tile(),
            # one consumer warpgroup of 64 rows per block, items of 64 rows,
            # no register reallocation
            "one_consumer": [
                (FWD_SRC, "constexpr int NC = 2;", "constexpr int NC = 1;", 1),
                (FWD_SRC, "    setmaxnreg_dec<56>();\n", "", 1),
                (FWD_SRC, "  setmaxnreg_inc<224>();\n", "", 1),
            ],
            # three K/V stages in flight instead of four
            "three_stages": [
                (FWD_SRC, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;", 1)],
            # no register reallocation: every warpgroup keeps the launch's 168
            "no_setmaxnreg": [
                (FWD_SRC, "    setmaxnreg_dec<56>();\n", "", 1),
                (FWD_SRC, "  setmaxnreg_inc<224>();\n", "", 1),
            ],
        },
        "ablations": {
            # the score products as one TF32 product (the small terms' wgmmas out)
            "one_tf32_scores": [
                (FWD_SRC, "      wgmma_m64n32k8_tf32_ss_zero_d(sm, a_lo, b_hi);\n"
                          "      wgmma_m64n32k8_tf32_ss(sm, a_hi, b_lo);\n", "", 1),
                (FWD_SRC, "      wgmma_m64n32k8_tf32_ss(sm, a_lo, b_hi);\n"
                          "      wgmma_m64n32k8_tf32_ss(sm, a_hi, b_lo);\n", "", 1),
            ],
            "one_tf32_pv": _ONE_TF32_ROWS,
            # the converters touch no stage and no Q: they only release them
            "no_convert": [
                (FWD_SRC, "  for (int g = tid / 32; g < 8; g += 3) {",
                 "  for (int g = tid / 32; g < 0; g += 3) {", 1),
                (FWD_SRC, "  for (int u = tid; u < BQ * 4; u += CONVERTERS) {",
                 "  for (int u = tid; u < 0; u += CONVERTERS) {", 1),
            ],
            # the converters split only K (no V^T), or only V
            "no_vt": [(FWD_SRC, _CONVERT_TOP, "    if (g >= 4) continue;\n" + _CONVERT_TOP, 1)],
            "no_k_split": [(FWD_SRC, _CONVERT_TOP, "    if (g < 4) continue;\n" + _CONVERT_TOP, 1)],
            # no exp2 in the softmax: P is the shifted score itself
            "no_exp2": [(FWD_SRC, "        p = ex2(fmaf(p, c, -ms_new));",
                         "        p = fmaf(p, c, -ms_new);", 1)],
        },
    },
    "bwd": {
        "source": BWD_SRC,
        "variants": {
            # one consumer warpgroup of 64 rows per block, items of 64 rows,
            # no register reallocation
            "one_consumer": [
                (BWD_SRC, "constexpr int NC = 2;", "constexpr int NC = 1;", 1),
                (BWD_SRC, "    setmaxnreg_dec<56>();\n", "", 2),
                (BWD_SRC, "  setmaxnreg_inc<224>();\n", "", 2),
            ],
            # the producer loads an item's resident tiles before its first
            # streamed tiles, so these wait until the predecessor is done with
            # the resident ones
            "resident_first": [
                (BWD_SRC, "      for (int j = 0; j < early; ++j) load_tile(it, j);\n", "", 1),
                (BWD_SRC, "      for (int j = early; j < n_tiles; ++j) load_tile(it, j);",
                 "      for (int j = 0; j < n_tiles; ++j) load_tile(it, j);", 1),
            ],
            # consumer 1 starts once consumer 0 has committed its first tile's
            # S, dP or row products (in each pass), so that their CUDA-core
            # steps fall at different times
            "offset_after_s": _offset_after(
                "      score_product(s_lg, s_sm, ah, al, stage);  // S = Q K^T",
                "      score_product(s_lg, s_sm, ah, al, stage);  // S^T = K Q^T"),
            "offset_after_dp": _offset_after(
                "      score_product(p_lg, p_sm, ah, al, stage + NAT_BYTES);  // dP = dO V^T",
                "      score_product(p_lg, p_sm, ah, al, stage + NAT_BYTES);  // dP^T = V dO^T"),
            "offset_after_rows": _offset_after(
                "      row_product(blk, dh, dl, stage + 2 * NAT_BYTES);  // dQ += dS K",
                "      row_product(blk_k, dh, dl, stage + 2 * NAT_BYTES);  // dK += dS^T Q"),
        },
        "ablations": {
            # the converters write no transposed tiles
            "no_transpose": [(BWD_SRC, "    if (tsr < NT) store16_t(", "    if (tsr < 0) store16_t(",
                              1)],
            # the converters touch no stage: they only release it
            "no_convert": [(BWD_SRC, "  for (int g = tid / 32; g < 8; g += 3) {",
                            "  for (int g = tid / 32; g < 0; g += 3) {", 1)],
            # the consumers do not split the resident rows: raw f32 bits as hi, 0 as lo
            "no_split": [(SM90,
                          "        split(v[t][i], hi[4 * (2 * jp + t) + i], lo[4 * (2 * jp + t) + i]);",
                          "        hi[4 * (2 * jp + t) + i] = __float_as_uint(v[t][i]);\n"
                          "        lo[4 * (2 * jp + t) + i] = 0u;", 1)],
            # the score products as one TF32 product (the small terms' wgmmas out)
            "one_tf32_scores": [
                (SM90, "      wgmma_m64n32k8_tf32_rs_zero_d(sm, &lo[0], b_hi);\n"
                       "      wgmma_m64n32k8_tf32_rs(sm, &hi[0], b_lo);\n", "", 1),
                (SM90, "      wgmma_m64n32k8_tf32_rs(sm, &lo[4 * kk], b_hi);\n"
                       "      wgmma_m64n32k8_tf32_rs(sm, &hi[4 * kk], b_lo);\n", "", 1),
            ],
            "one_tf32_rows": _ONE_TF32_ROWS,
        },
    },
}

FWD_CHECK_SHAPES = ((64, 1500, 8, 64), (32, 199, 12, 64), (2, 1, 3, 64), (2, 33, 3, 64),
                    (2, 129, 3, 64))
BWD_CHECK_SHAPES = ((32, 199, 12, 64), (2, 1, 3, 64), (2, 129, 3, 64))


def entries(kernel: str) -> dict:
    return {**KERNELS[kernel]["variants"], **KERNELS[kernel]["ablations"]}


def patched(sources: dict[str, str], kernel: str, name: str) -> dict[str, str]:
    """The kernel's source and sm90.cuh (``sources``, by file name) with the
    patches of entry ``name`` applied."""
    out = dict(sources)
    for file, old, new, count in entries(kernel)[name]:
        if out[file].count(old) != count:
            raise ValueError(f"{kernel} {name}: {old[:60]!r} is not found {count} times in {file}")
        out[file] = out[file].replace(old, new)
    return out


def read_sources(kernel: str) -> dict[str, str]:
    from segma_tpu_torch.ops import _build

    return {f: (_build.SRC_DIR / f).read_text() for f in (KERNELS[kernel]["source"], SM90)}


def fwd_launcher(lib):
    """The forward's C entry point of ``lib`` called as
    ops/attention.flash_attn_fwd calls it with the LSE, uncounted."""
    import torch

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.segma_flash_attn_fwd_f32.argtypes = [p] * 5 + [i] * 3 + [f, p]
    lib.segma_flash_attn_fwd_f32.restype = i

    def fwd(q, k, v, sm):
        b, s, h, _ = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), device=q.device)
        err = lib.segma_flash_attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h,
            sm * math.log2(math.e), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out, lse
    return fwd


def bwd_launcher(lib):
    """The backward's C entry point of ``lib`` called as
    ops/attention.flash_attn_bwd calls it, uncounted."""
    import torch

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.segma_flash_attn_bwd_f32.argtypes = [p] * 10 + [i] * 3 + [f, f, p]
    lib.segma_flash_attn_bwd_f32.restype = i

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


def build_all(todo: list[tuple[str, str]]) -> dict[tuple[str, str], ctypes.CDLL]:
    """One nvcc per (kernel, name), all started together; ptxas's registers,
    spills and warnings printed."""
    from segma_tpu_torch.ops import _build

    procs = {}
    for kernel, name in todo:
        d = _build.BUILD_DIR / "ablations" / f"{kernel}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for file, text in patched(read_sources(kernel), kernel, name).items():
            (d / file).write_text(text)
        so = d / "lib.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-shared", "-o", str(so),
               str(d / KERNELS[kernel]["source"])]
        procs[kernel, name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        text = proc.communicate()[0]
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                print(f"{key[0]} {key[1]}: {line.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{key[0]} {key[1]} did not build")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def run_fwd(names: list[str], libs: dict, card: str) -> None:
    import torch

    import chip_smoke
    from segma_tpu_torch.ops import attention

    fns = {n: fwd_launcher(libs["fwd", n]) for n in names}
    variants = KERNELS["fwd"]["variants"]
    g = torch.Generator(device="cuda").manual_seed(5)
    sm = 64**-0.5
    for shape in FWD_CHECK_SHAPES:
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        kept = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        for name in names:
            if name in variants:
                if not all(torch.equal(a, b) for a, b in zip(fns[name](q, k, v, sm), kept)):
                    raise AssertionError(f"fwd variant {name} differs from kept at {shape}")
                print(f"check fwd {name} {shape}: bitwise equal to the kept kernel", flush=True)
        del q, k, v, kept
    for shape, iters in (((chip_smoke.INNER_BATCH, 1500, 8, 64), 5),
                         (chip_smoke.TRAIN_ATTN_SHAPE, 20)):
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library = {n: c for n, c in chip_smoke.sdpa_calls(qt, kt, vt, sm).items()
                   if "EFFICIENT" in n}
        times = chip_smoke.time_turns({
            "kept": lambda: attention.flash_attn_fwd(q, k, v, sm, with_lse=True),
            **{n: (lambda fn=fn: fn(q, k, v, sm)) for n, fn in fns.items()},
            **library,
        }, iters=iters)
        for name, ms in times.items():
            print(f"time flash_attn_fwd f32 {name} {shape} [{card}]: {chip_smoke.spread(ms)}",
                  flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def run_bwd(names: list[str], libs: dict, card: str) -> None:
    import torch

    import chip_smoke
    from segma_tpu_torch.ops import attention

    fns = {n: bwd_launcher(libs["bwd", n]) for n in names}
    variants = KERNELS["bwd"]["variants"]
    g = torch.Generator(device="cuda").manual_seed(5)
    sm = 64**-0.5
    for shape in BWD_CHECK_SHAPES:
        q, k, v, dout = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        kept = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
        for name in names:
            if name in variants:
                got = fns[name](q, k, v, out, lse, dout, sm)
                if not all(torch.equal(a, b) for a, b in zip(got, kept)):
                    raise AssertionError(f"bwd variant {name} differs from kept at {shape}")
                print(f"check bwd {name} {shape}: bitwise equal to the kept kernel", flush=True)

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


def main(args: list[str]) -> int:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("flash_f32_ablations: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    kernels = [args[0]] if args and args[0] in KERNELS else list(KERNELS)
    names = args[1:] if args and args[0] in KERNELS else args
    todo = [(kn, n) for kn in kernels for n in (names or entries(kn)) if n in entries(kn)]
    unknown = set(names) - {n for _, n in todo}
    if unknown:
        print(f"flash_f32_ablations: no entry {sorted(unknown)} in {kernels}", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"device: {card}", flush=True)
    chip_smoke.phase_build()
    libs = build_all(todo)
    torch.set_grad_enabled(False)
    for kernel, run in (("fwd", run_fwd), ("bwd", run_bwd)):
        mine = [n for kn, n in todo if kn == kernel]
        if mine:
            run(mine, libs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
