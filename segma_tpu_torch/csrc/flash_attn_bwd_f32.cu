// Flash attention backward in f32 (sm_90a), f32 in and out.
//
// Replaces: the backward of JAX's bundled Pallas TPU flash attention on f32
// inputs, which segma_tpu/ops/attention.py:148 (_flash_bhsd) reaches through
// its custom_vjp when the encoder trains with train.precision=f32:
// _flash_attention_bwd_dkv (dK, dV; :941, its pallas_call at :1121) and
// _flash_attention_bwd_dq (dQ; :1287, its pallas_call at :1456) in
// jax/experimental/pallas/ops/tpu/flash_attention.py.
//
// What it computes, per (batch, head), with P recomputed from the forward's
// log-sum-exp (flash_attn_f32.cu writes it):
//   P  = exp(q k^T sm_scale - lse)        D  = rowsum(dO * O)
//   dV = P^T dO        dP = dO V^T        dS = P * (dP - D)
//   dQ = dS K sm_scale                    dK = dS^T Q sm_scale
// on q, k, v, out, dO, dq, dk, dv laid out (B, S, H, 64) f32 and lse laid out
// (B, H, S) f32.
//
// What bounds it on this card: five S x S x 64 products, 10 S^2 64 FLOP per
// (batch, head), in f32 outside the tensor cores: 9.73 GFLOP at (32, 199, 12,
// 64), 0.145 ms at 67 TFLOP/s, where the eight tensors' 78.6 MB and the lse
// take 0.023 ms. The split below recomputes S and dP in both passes (seven
// products, not five).
//
// Design: IEEE f32 FMA on the CUDA cores, the simple kernel first, for the
// reasons flash_attn_f32.cu gives (one TF32 product misses f32 accuracy;
// 3xTF32 would need IEEE adds of its large terms and transposed staging).
// JAX's split into two passes is kept, as the bf16 kernel keeps it; neither
// uses atomics and every sum runs in a fixed order, so two calls on the same
// inputs give the same bits. Both passes use the 4 x 4 register products of
// f32_tiles.cuh (mma<4>): a block of 256 threads, operands k-major in shared
// memory.
//  - dQ pass (first): a block per 64 query rows of one (batch, head). Q and
//    dO transposed in shared memory; D = rowsum(dO * O) and lse log2(e) per
//    row, written as (lse log2(e), D) pairs for the dK/dV pass; per tile of
//    64 keys, K and V transposed and K as it is; S = Q K^T and dP = dO V^T,
//    then P = exp2(S scale_log2 - lse log2 e) (keys past S: 0), dS = P (dP -
//    D) in registers, written transposed, and dQ += dS K.
//  - dK/dV pass (second, in stream order after the first): a block per 64
//    key rows. K and V transposed, resident; per tile of 64 query rows, Q and
//    dO both transposed and as they are, and the tile's pairs; S^T = K Q^T,
//    dP^T = V dO^T, P^T and dS^T in registers (queries past S: 0), each
//    written transposed, then dV += P^T dO and dK += dS^T Q.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tiles.cuh"

namespace {

using namespace f32t;

constexpr int PAIR_ROWS = 128;  // the pairs' rows are padded to it (ops/attention.py BWD_ROWS)
constexpr int DQ_SMEM = 6 * TILE * 4;   // q, dO, k, v (transposed), k, dS: 104,448 bytes
constexpr int DKV_SMEM = 8 * TILE * 4 + 2 * T * 4;  // + the tile's pairs: 139,776 bytes
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float2* __restrict__ pairs, float* __restrict__ dq, int S, int H,
                        float scale_log2, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = smem + TILE;
  float* kt = smem + 2 * TILE;
  float* vt = smem + 3 * TILE;
  float* kn = smem + 4 * TILE;
  float* dst = smem + 5 * TILE;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * T;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rs = H * D;
  const size_t off = (size_t)b * S * rs + (size_t)h * D;
  const size_t bh = (size_t)b * H + h;
  const int s_pad = (S + PAIR_ROWS - 1) / PAIR_ROWS * PAIR_ROWS;

  load_t(qt, q + off, q0, S, rs, tid);
  load_t(dot, dout + off, q0, S, rs, tid);
  // D and lse log2(e) of this thread's rows; rows past S get (0, 0)
  float di[4], l2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    float part = 0.f;
    if (r < S) {
      const float4 x = *reinterpret_cast<const float4*>(dout + off + (size_t)r * rs + 4 * tx);
      const float4 y = *reinterpret_cast<const float4*>(o + off + (size_t)r * rs + 4 * tx);
      part = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
    }
    di[i] = row_sum(part);
    l2[i] = r < S ? lse[bh * S + r] * LOG2E : 0.f;
    if (r < S && tx == 0) pairs[bh * s_pad + r] = make_float2(l2[i], di[i]);
  }
  float acc[4][4];
  zero(acc);

  const int n_tiles = (S + T - 1) / T;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();  // the last tile's k, v and dS are read
    load_t(kt, k + off, k0, S, rs, tid);
    load_t(vt, v + off, k0, S, rs, tid);
    load_n(kn, k + off, k0, S, rs, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma<4>(s, qt, 4 * ty, kt, 4 * tx);
    mma<4>(dp, dot, 4 * ty, vt, 4 * tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key = k0 + 4 * tx + j < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key ? ex2(fmaf(s[i][j], scale_log2, -l2[i])) : 0.f;
        s[i][j] = p * (dp[i][j] - di[i]);
      }
    }
    store_t<4>(dst, s, ty, tx);
    __syncthreads();
    mma<4>(acc, dst, 4 * ty, kn, 4 * tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r < S) {
      *reinterpret_cast<float4*>(dq + off + (size_t)r * rs + 4 * tx) = make_float4(
          acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale, acc[i][3] * scale);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float2* __restrict__ pairs, float* __restrict__ dk,
                         float* __restrict__ dv, int S, int H, float scale_log2, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = smem + TILE;
  float* qt = smem + 2 * TILE;
  float* dot = smem + 3 * TILE;
  float* qn = smem + 4 * TILE;
  float* don = smem + 5 * TILE;
  float* ps = smem + 6 * TILE;
  float* dss = smem + 7 * TILE;
  float* s_l2 = smem + 8 * TILE;
  float* s_d = s_l2 + T;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int c0 = blockIdx.x * T;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rs = H * D;
  const size_t off = (size_t)b * S * rs + (size_t)h * D;
  const size_t bh = (size_t)b * H + h;
  const int s_pad = (S + PAIR_ROWS - 1) / PAIR_ROWS * PAIR_ROWS;

  load_t(kt, k + off, c0, S, rs, tid);
  load_t(vt, v + off, c0, S, rs, tid);
  float acc_k[4][4], acc_v[4][4];  // rows: keys 4 ty + i; columns: head dims 4 tx + j
  zero(acc_k);
  zero(acc_v);

  const int n_tiles = (S + T - 1) / T;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * T;
    __syncthreads();  // the last tile's operands, P^T and dS^T are read
    load_t(qt, q + off, r0, S, rs, tid);
    load_t(dot, dout + off, r0, S, rs, tid);
    load_n(qn, q + off, r0, S, rs, tid);
    load_n(don, dout + off, r0, S, rs, tid);
    if (tid < T) {
      const float2 pr = r0 + tid < S ? pairs[bh * s_pad + r0 + tid] : make_float2(0.f, 0.f);
      s_l2[tid] = pr.x;
      s_d[tid] = pr.y;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];  // rows: keys 4 ty + i; columns: queries 4 tx + j
    zero(st);
    zero(dpt);
    mma<4>(st, kt, 4 * ty, qt, 4 * tx);
    mma<4>(dpt, vt, 4 * ty, dot, 4 * tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool query = r0 + 4 * tx + j < S;
      const float l2 = s_l2[4 * tx + j], dd = s_d[4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = query ? ex2(fmaf(st[i][j], scale_log2, -l2)) : 0.f;
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - dd);
      }
    }
    store_t<4>(ps, st, ty, tx);    // ps[query][key]
    store_t<4>(dss, dpt, ty, tx);  // dss[query][key]
    __syncthreads();
    mma<4>(acc_v, ps, 4 * ty, don, 4 * tx);
    mma<4>(acc_k, dss, 4 * ty, qn, 4 * tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * ty + i;
    if (c < S) {
      const size_t at = off + (size_t)c * rs + 4 * tx;
      *reinterpret_cast<float4*>(dk + at) = make_float4(
          acc_k[i][0] * scale, acc_k[i][1] * scale, acc_k[i][2] * scale, acc_k[i][3] * scale);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(acc_v[i][0], acc_v[i][1], acc_v[i][2], acc_v[i][3]);
    }
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous (batch, seq, heads, 64) f32,
// 16-byte aligned. lse: contiguous (batch, heads, seq) f32 from the forward.
// pairs: (batch, heads, seq padded to 128, 2) f32 scratch. scale_log2 is
// sm_scale * log2(e), scale is sm_scale. Launches the dQ pass, then the dK/dV
// pass, on the stream; returns the first error of cudaGetLastError().
extern "C" int segma_flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* pairs, void* dq, void* dk, void* dv, int batch,
                                        int seq, int heads, float scale_log2, float scale,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((seq + T - 1) / T, heads, batch);
  cudaFuncSetAttribute(flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DQ_SMEM);
  cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DKV_SMEM);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float2*>(pairs), static_cast<float*>(dq), seq,
      heads, scale_log2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, DKV_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float2*>(pairs),
      static_cast<float*>(dk), static_cast<float*>(dv), seq, heads, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
