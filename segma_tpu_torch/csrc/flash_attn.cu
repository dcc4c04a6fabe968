// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: segma_tpu/ops/attention.py, _flash_bhsd, which calls JAX's bundled
// Pallas TPU flash_attention (its pallas_call lives in
// jax/experimental/pallas/ops/tpu/flash_attention.py) with pad-to-128 and
// SegmentIds masking of the padding.
//
// What it computes: out = softmax(q k^T * sm_scale) v for every (batch, head),
// on q, k, v and out laid out (B, S, H, D) as the encoders produce them, with an
// online softmax (running max and sum) and the output accumulated in f32.
//
// What bounds it on this card: 4*S*S*D FLOP per (batch, head) against 8*S*D
// bytes, so at Whisper's padded S=1500 it is bound by the bf16 tensor-core
// rate, not by device memory; the score matrix never reaches device memory.
//
// Design (simple and correct first; wgmma/TMA is later work). One block of four
// warps owns 64 query rows of one (batch, head); each warp owns 16 rows and
// keeps their Q fragments in registers. The block walks the keys in tiles of
// 64: it stages K and V^T in shared memory (rows padded to 72 elements so the
// fragment reads hit 32 distinct banks), each warp forms its 16x64 score tile
// with mma.sync m16n8k16 (bf16 in, f32 accumulate), masks keys at or past S by
// index (this replaces the TPU's pad-to-128 plus SegmentIds), updates the
// running max and sum in the exp2 domain, and adds P V into its f32
// accumulators with P taken straight from the score registers. Rows past S
// compute on zeros and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // head dim (Whisper, HuBERT)
constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int BK = 64;      // keys per tile
constexpr int WARPS = 4;
constexpr int LDS = 72;     // padded shared row, in bf16 elements (144 B)

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

__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                 int H, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK][LDS];   // K tile, [key][d]
  __shared__ __align__(16) __nv_bfloat16 vts[D][LDS];   // V tile transposed, [d][key]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;

  // this warp's query rows: r0 (fragment rows g) and r1 (rows g + 8)
  const int r0 = blockIdx.x * BQ + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qa[4][4];  // A fragments of Q for the 4 k-steps of 16 over D
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < S ? ld_pair(q + base + r0 * row_stride + c) : 0u;
    qa[kk][1] = r1 < S ? ld_pair(q + base + r1 * row_stride + c) : 0u;
    qa[kk][2] = r0 < S ? ld_pair(q + base + r0 * row_stride + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld_pair(q + base + r1 * row_stride + c + 8) : 0u;
  }

  float acc[8][4];  // O: 8 tiles of 8 columns of D; [0..1] row r0, [2..3] row r1
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // running sum, this thread's columns

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * (D / 8); i += WARPS * 32) {
      const int r = i >> 3;
      const int c = (i & 7) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        const size_t off = base + (size_t)(k0 + r) * row_stride + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[c + j][r] = ve[j];
    }
    __syncthreads();

    // scores for 16 rows x 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // mask keys past S, move to the log2 domain, row max over the quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + n * 8 + 2 * t + j < S;
        s[n][j] = valid ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = valid ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // key 0 lies in the first tile, so the max is finite from then on
    const float a0 = exp2f(m0 - mx0);
    const float a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = exp2f(s[n][j] - m0);
        s[n][2 + j] = exp2f(s[n][2 + j] - m1);
        l0 += s[n][j];
        l1 += s[n][2 + j];
      }
    }

    // O += P V: the score C fragments are the A fragments of P
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vr = &vts[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16(acc[n], pa, ld_pair(vr), ld_pair(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(o + base + r0 * row_stride + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(o + base + r1 * row_stride + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

}  // namespace

// q, k, v, o: contiguous (batch, seq, heads, 64) bf16. scale_log2 is
// sm_scale * log2(e). Returns cudaGetLastError() after the launch.
extern "C" int segma_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    int batch, int seq, int heads, float scale_log2,
                                    void* stream) {
  dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_fwd_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, heads,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}
