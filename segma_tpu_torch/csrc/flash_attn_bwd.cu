// Flash attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: the backward of JAX's bundled Pallas TPU flash attention, which
// segma_tpu/ops/attention.py (_flash_bhsd, with the backward block sizes of
// _block_sizes) reaches through its custom_vjp when the encoder trains:
// _flash_attention_bwd_dkv (dK, dV) and _flash_attention_bwd_dq (dQ) in
// jax/experimental/pallas/ops/tpu/flash_attention.py.
//
// What it computes, per (batch, head), with P recomputed from the forward's
// log-sum-exp (flash_attn.cu writes it):
//   P  = exp(q k^T sm_scale - lse)        D  = rowsum(dO * O)   (f32)
//   dV = P^T dO        dP = dO V^T        dS = P * (dP - D)
//   dQ = dS K sm_scale                    dK = dS^T Q sm_scale
// on q, k, v, out, dO, dq, dk, dv laid out (B, S, H, 64) as the encoders
// produce them, with lse and D laid out (B, H, S).
//
// What bounds it on this card: 10*S*S*D FLOP per (batch, head) against about
// 16*S*D bytes, so at HuBERT's S=199 the bytes bound it (the card's bf16
// rate needs ~295 FLOP a byte); at Whisper's S=1500 the operations do. The
// score-sized matrices P, dP and dS never reach device memory.
//
// Design (simple and correct first; no cp.async, TMA or wgmma yet). The JAX
// split into two kernels is kept, and neither needs atomics, so the result
// is deterministic:
// - flash_bwd_dq: one block of four warps per 64 query rows; each warp owns
//   16 rows and keeps their Q and dO fragments in registers. It first forms
//   D for its rows (and writes it for the other kernel), then walks the key
//   tiles: K, K^T and V staged in shared memory, S = Q K^T and dP = dO V^T
//   with mma.sync m16n8k16 (bf16 in, f32 accumulate), P and dS in registers,
//   dQ += dS K accumulated in f32.
// - flash_bwd_dkv: one block per 64 keys, each warp owning 16 keys with
//   their K and V fragments in registers. It walks the query tiles (Q, Q^T,
//   dO, dO^T, lse and D staged in shared memory), forms S^T = K Q^T and
//   dP^T = V dO^T, and accumulates dV += P^T dO and dK += dS^T Q in f32.
// Shared rows are padded to LDS = 72 elements, as in the forward (both take
// the fragment helpers from mma_bf16.cuh). Keys at or past S get P = 0 by
// index; query rows past S are staged as zeros with lse = +inf, so their P
// is 0 and they add nothing; nothing past S is read or stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BT = 64;      // rows of a tile (queries or keys), 16 per warp
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 Tile[LDS];

// x . y over two packed bf16 pairs, in f32
__device__ __forceinline__ float dot_pair(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return a.x * b.x + a.y * b.y;
}

// A fragments (16 rows x 64 of D, 4 k-steps of 16) of rows r0 and r0 + 8 of
// one (batch, head); rows at or past S read as zeros.
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const __nv_bfloat16* src,
                                       size_t base, size_t row_stride, int r0, int S,
                                       int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < S ? ld_pair(src + base + (size_t)r0 * row_stride + c) : 0u;
    a[kk][1] = r1 < S ? ld_pair(src + base + (size_t)r1 * row_stride + c) : 0u;
    a[kk][2] = r0 < S ? ld_pair(src + base + (size_t)r0 * row_stride + c + 8) : 0u;
    a[kk][3] = r1 < S ? ld_pair(src + base + (size_t)r1 * row_stride + c + 8) : 0u;
  }
}

// Stage rows [r_begin, r_begin + 64) of one (batch, head) into shared memory,
// as rows ([row][d]) and, where cols is not null, transposed ([d][row]);
// rows at or past S are zeros.
__device__ __forceinline__ void stage(const __nv_bfloat16* src, size_t base,
                                      size_t row_stride, int r_begin, int S, Tile* rows,
                                      Tile* cols) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += WARPS * 32) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r_begin + r < S) {
      val = *reinterpret_cast<const uint4*>(src + base + (size_t)(r_begin + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&rows[r][c]) = val;
    if (cols != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[c + j][r] = e[j];
    }
  }
}

// c (16 x 64, 8 tiles of 8 columns) += A (16 x 64, fragments a) times B,
// where bt[n][k] holds column n of B
__device__ __forceinline__ void mma_16x64(float (*c)[4], const uint32_t (*a)[4],
                                          const Tile* bt, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* p = &bt[n * 8 + g][kk * 16 + 2 * t];
      mma_bf16(c[n], a[kk], ld_pair(p), ld_pair(p + 8));
    }
  }
}

__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// C fragments of a 16 x 64 product -> bf16 A fragments of the next product
// over those 64 columns
__device__ __forceinline__ void c_to_a(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// rows r0 and r0 + 8 of a 16 x 64 f32 result, times mul, stored as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t base,
                                           size_t row_stride, int r0, int S,
                                           const float (*c)[4], float mul, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dst + base + (size_t)r0 * row_stride + col) =
          pack_bf16(c[n][0] * mul, c[n][1] * mul);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dst + base + (size_t)r1 * row_stride + col) =
          pack_bf16(c[n][2] * mul, c[n][3] * mul);
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int S, int H,
                    float scale_log2, float scale) {
  __shared__ __align__(16) Tile ks[BT];   // K tile [key][d]: B of Q K^T
  __shared__ __align__(16) Tile kts[D];   // K^T [d][key]: B of dS K
  __shared__ __align__(16) Tile vs[BT];   // V tile [key][d]: B of dO V^T

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t row_bh = ((size_t)b * H + h) * S;  // (B, H, S) index of row 0

  const int r0 = blockIdx.x * BT + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qa[4][4], da[4][4];
  load_a(qa, q, base, row_stride, r0, S, t);
  load_a(da, dout, base, row_stride, r0, S, t);

  // D = rowsum(dO * O) for rows r0 and r1, over the quad's 64 columns
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    if (r0 < S) {
      d0 += dot_pair(da[kk][0], ld_pair(o + base + (size_t)r0 * row_stride + c)) +
            dot_pair(da[kk][2], ld_pair(o + base + (size_t)r0 * row_stride + c + 8));
    }
    if (r1 < S) {
      d1 += dot_pair(da[kk][1], ld_pair(o + base + (size_t)r1 * row_stride + c)) +
            dot_pair(da[kk][3], ld_pair(o + base + (size_t)r1 * row_stride + c + 8));
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if (t == 0) {
    if (r0 < S) dsum[row_bh + r0] = d0;
    if (r1 < S) dsum[row_bh + r1] = d1;
  }
  const float l0 = r0 < S ? lse[row_bh + r0] * LOG2E : INFINITY;
  const float l1 = r1 < S ? lse[row_bh + r1] * LOG2E : INFINITY;

  float acc[8][4];  // dQ, unscaled
  zero(acc);
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();  // the previous tile is consumed
    stage(k, base, row_stride, k0, S, ks, kts);
    stage(v, base, row_stride, k0, S, vs, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_16x64(s, qa, ks, g, t);   // S = Q K^T
    mma_16x64(dp, da, vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + n * 8 + 2 * t + j < S;
        const float p0 = valid ? exp2f(s[n][j] * scale_log2 - l0) : 0.f;
        const float p1 = valid ? exp2f(s[n][2 + j] * scale_log2 - l1) : 0.f;
        s[n][j] = p0 * (dp[n][j] - d0);  // dS
        s[n][2 + j] = p1 * (dp[n][2 + j] - d1);
      }
    }
    uint32_t dsa[4][4];
    c_to_a(dsa, s);
    mma_16x64(acc, dsa, kts, g, t);  // dQ += dS K
  }
  store_rows(dq, base, row_stride, r0, S, acc, scale, t);
}

__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, float scale_log2,
                     float scale) {
  __shared__ __align__(16) Tile qs[BT];    // Q tile [query][d]: B of K Q^T
  __shared__ __align__(16) Tile qts[D];    // Q^T [d][query]: B of dS^T Q
  __shared__ __align__(16) Tile dos[BT];   // dO tile [query][d]: B of V dO^T
  __shared__ __align__(16) Tile dots[D];   // dO^T [d][query]: B of P^T dO
  __shared__ float lse_s[BT];              // lse * log2(e); +inf past S
  __shared__ float dsum_s[BT];             // D; 0 past S

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t row_bh = ((size_t)b * H + h) * S;

  const int c0 = blockIdx.x * BT + warp * 16 + g;  // this warp's keys c0, c0 + 8
  uint32_t ka[4][4], va[4][4];
  load_a(ka, k, base, row_stride, c0, S, t);
  load_a(va, v, base, row_stride, c0, S, t);

  float dka[8][4], dva[8][4];  // dK (unscaled) and dV
  zero(dka);
  zero(dva);
  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();  // the previous tile is consumed
    stage(q, base, row_stride, q0, S, qs, qts);
    stage(dout, base, row_stride, q0, S, dos, dots);
    for (int i = threadIdx.x; i < BT; i += WARPS * 32) {
      const bool valid = q0 + i < S;
      lse_s[i] = valid ? lse[row_bh + q0 + i] * LOG2E : INFINITY;
      dsum_s[i] = valid ? dsum[row_bh + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_16x64(s, ka, qs, g, t);    // S^T = K Q^T
    mma_16x64(dp, va, dos, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * t + j;  // query within the tile
        const float l = lse_s[col];
        const float dd = dsum_s[col];
        const float p0 = exp2f(s[n][j] * scale_log2 - l);
        const float p1 = exp2f(s[n][2 + j] * scale_log2 - l);
        s[n][j] = p0;  // P^T
        s[n][2 + j] = p1;
        dp[n][j] = p0 * (dp[n][j] - dd);  // dS^T
        dp[n][2 + j] = p1 * (dp[n][2 + j] - dd);
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    c_to_a(pa, s);
    c_to_a(dsa, dp);
    mma_16x64(dva, pa, dots, g, t);   // dV += P^T dO
    mma_16x64(dka, dsa, qts, g, t);   // dK += dS^T Q
  }
  store_rows(dk, base, row_stride, c0, S, dka, scale, t);
  store_rows(dv, base, row_stride, c0, S, dva, 1.f, t);
}

}  // namespace

// All tensors contiguous. q, k, v, o, dout, dq: (batch, seq, heads, 64) bf16;
// lse (from segma_flash_attn_fwd) and dsum: (batch, heads, seq) f32. Writes
// dq and dsum = rowsum(dout * o), which segma_flash_attn_bwd_dkv reads, so
// it launches first on the same stream. scale_log2 is sm_scale * log2(e).
// Returns cudaGetLastError() after the launch.
extern "C" int segma_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* dsum, void* dq, int batch, int seq, int heads,
                                       float scale_log2, float scale, void* stream) {
  dim3 grid((seq + BT - 1) / BT, heads, batch);
  flash_bwd_dq_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<__nv_bfloat16*>(dq), seq, heads, scale_log2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv: (batch, seq, heads, 64) bf16; the other arguments as above.
extern "C" int segma_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* dsum,
                                        void* dk, void* dv, int batch, int seq, int heads,
                                        float scale_log2, float scale, void* stream) {
  dim3 grid((seq + BT - 1) / BT, heads, batch);
  flash_bwd_dkv_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq, heads,
      scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
