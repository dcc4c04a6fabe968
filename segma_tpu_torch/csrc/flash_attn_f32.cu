// Flash attention forward in f32 (sm_90a), f32 in and out.
//
// Replaces: segma_tpu/ops/attention.py:148, _flash_bhsd, on f32 inputs. The
// JAX package hands JAX's bundled Pallas TPU flash_attention (its forward
// pallas_call lives in jax/experimental/pallas/ops/tpu/flash_attention.py)
// q, k and v in the model's dtype, so with train.precision=f32 that kernel
// runs in f32, with the per-row log-sum-exp when the encoder trains.
//
// What it computes: out = softmax(q k^T * sm_scale) v for every (batch,
// head), on q, k, v and out laid out (B, S, H, 64) as the encoders produce
// them, with an online softmax (running max and sum, exp2 domain, the scale
// folded into scale_log2 = sm_scale log2(e)) and the output accumulated in
// f32. Given a non-null lse pointer it also writes each row's log-sum-exp of
// the scaled scores (natural log, f32, (B, H, S)) for the backward
// (flash_attn_bwd_f32.cu); the output is the same bits with or without it.
//
// What bounds it on this card: the products, 4 S^2 64 FLOP per (batch, head)
// against 16 S 64 bytes, in f32 outside the tensor cores: 295 GFLOP at
// (64, 1500, 8, 64), 4.40 ms at 67 TFLOP/s; 3.89 GFLOP at (32, 199, 12, 64),
// 0.058 ms, where the bytes (19.6 MB) take 0.006 ms. The S^2 exp2 (1.15e9 at
// the serving shape, 0.28 ms on the special-function units) are far below.
//
// Design: IEEE f32 FMA on the CUDA cores, the simple kernel first. Why not
// the tensor cores: one TF32 product misses f32 accuracy by two orders of
// magnitude, and 3xTF32 on wgmma would need IEEE adds of its large terms (the
// tensor cores' f32 sums truncate, csrc/logmel.cu) and transposed staging,
// since a TF32 wgmma takes B K-major only and V in O += P V is MN-major. A
// block is 256 threads on 128 query rows of one (batch, head), two blocks an
// SM (100 KB of shared memory, 128 registers each; f32_tiles.cuh):
//  - Q once, transposed into shared memory (q[d][row]); per tile of 64 keys,
//    K transposed (k[d][key]) and V as it is (v[key][d]), rows past S zero.
//  - S = Q K^T: each thread an 8 x 4 block (rows 8 ty.., keys 4 tx..) by
//    fmaf over the 64 head dims, three 16-byte shared loads per 32 FMA; keys
//    at or past S set to -inf; the row max and sum over the 16 threads of a
//    half warp by shuffles; P = exp2(s scale_log2 - m scale_log2).
//  - P written transposed to shared memory (p[key][row]), then O += P V by
//    the same 8 x 4 product over the tile's 64 keys; O and the sum rescaled
//    by exp2((m_old - m_new) scale_log2) first. 64 query rows with 4 x 4
//    blocks (the first design) took 10.1 ms at (64, 1500, 8, 64), this 7.9.
//  - Epilogue: O / l for rows < S; the LSE (m scale_log2 + log2 l) ln 2.
// No atomics and a fixed order of every sum: two calls on the same inputs
// give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tiles.cuh"

namespace {

using namespace f32t;

constexpr int BQ = 128;                // query rows per block
constexpr int QTILE = D * ld_of(BQ);  // floats of the q or the p tile
constexpr int SMEM_BYTES = (2 * QTILE + 2 * TILE) * 4;  // q, p, k, v: 102,400 bytes

__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* pt = smem + QTILE;
  float* kt = smem + 2 * QTILE;
  float* vn = kt + TILE;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rs = H * D;
  const size_t off = (size_t)b * S * rs + (size_t)h * D;

  load_t<BQ>(qt, q + off, q0, S, rs, tid);
  float m[8], l[8], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero(acc);

  const int n_tiles = (S + T - 1) / T;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();  // the last tile's k, v and p are read
    load_t(kt, k + off, k0, S, rs, tid);
    load_n(vn, v + off, k0, S, rs, tid);
    __syncthreads();
    float s[8][4];
    zero(s);
    mma<8>(s, qt, 8 * ty, kt, 4 * tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + 4 * tx + j >= S) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = -INFINITY;
      }
    }
    // key 0 lies in the first tile, so every row's max is finite from then on
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float ms = m_new * scale_log2;
      const float alpha = ex2(m[i] * scale_log2 - ms);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ex2(fmaf(s[i][j], scale_log2, -ms));
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    store_t<8>(pt, s, ty, tx);
    __syncthreads();
    mma<8>(acc, pt, 8 * ty, vn, 4 * tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float total = row_sum(l[i]);
    const int r = q0 + 8 * ty + i;
    if (r < S) {
      const float inv = 1.f / total;
      *reinterpret_cast<float4*>(o + off + (size_t)r * rs + 4 * tx) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
      if (lse != nullptr && tx == 0) {
        // ln(sum exp(score * sm_scale)) = (max * scale_log2 + log2(sum)) * ln 2
        lse[((size_t)b * H + h) * S + r] = (m[i] * scale_log2 + log2f(total)) * 0.6931471805599453f;
      }
    }
  }
}

}  // namespace

// q, k, v, o: contiguous (batch, seq, heads, 64) f32, 16-byte aligned. lse:
// null, or contiguous (batch, heads, seq) f32. scale_log2 is sm_scale *
// log2(e). One block per 128 query rows of each (batch, head). Returns
// cudaGetLastError() after the launch.
extern "C" int segma_flash_attn_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int batch, int seq, int heads,
                                        float scale_log2, void* stream) {
  cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_fwd_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), seq, heads, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
