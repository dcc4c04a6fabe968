// The tensor-core fragment helpers of the flash backward (flash_attn_bwd.cu):
// one warp-wide mma.sync m16n8k16 (bf16 in, f32 accumulate) and the bf16 pair
// loads and packs that build its fragments, with the tile layout its two
// kernels agree on. Included by that source; not compiled on its own. The
// forward (flash_attn.cu) takes its Hopper helpers from sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // head dim (Whisper, HuBERT)
constexpr int WARPS = 4;    // warps per block, 16 rows each
constexpr int LDS = 72;     // padded shared row, in bf16 elements (144 B), so
                            // the fragment reads hit 32 distinct banks

// c (16 x 8, f32) += a (16 x 16, row-major A fragments) times the 16 x 8 B
// fragment held in b0, b1
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace
