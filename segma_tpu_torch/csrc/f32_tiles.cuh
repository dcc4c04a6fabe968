// Shared-memory tiles and R x 4 register products in IEEE f32 on the CUDA
// cores, for the f32 flash-attention forward (flash_attn_f32.cu; the f32
// backward, flash_attn_bwd_f32.cu, runs 3xTF32 on wgmma instead).
//
// A block is 256 threads, (ty, tx) = (tid / 16, tid % 16); a (16 R) x 64
// product tile gives thread (ty, tx) rows R ty .. R ty + R - 1 and columns
// 4 tx .. 4 tx + 3, so the 16 threads that share a row are one half of a warp
// and reduce over the row with shuffles (row_max, row_sum). Every product
// here reads both operands k-major from shared memory at a padded stride:
// a[k][row] (R / 4 16-byte loads per k, the same two addresses for a half
// warp's 16 tx) and b[k][col] (one 16-byte load, the 16 tx of a half warp
// reading 256 contiguous bytes). Tensors are (B, S, H, 64) f32 rows of 64
// contiguous floats, H * 64 apart.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32t {

constexpr int D = 64;             // head dim
constexpr int T = 64;             // rows of a tile (queries or keys)
constexpr int LD = T + 4;         // padded row stride of a tile, in floats
constexpr int TILE = D * LD;      // floats of one tile, k-major or row-major
constexpr int THREADS = 256;

// padded row stride of a k-major tile of `rows` rows (16-byte aligned rows)
__host__ __device__ constexpr int ld_of(int rows) { return rows + 4; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows row0 .. row0 + ROWS - 1 of one (batch, head) into dst as dst[d][r]
// (stride ld_of(ROWS)), the k-major form of a product over the head dim;
// rows at or past S are zeros. base points at row 0 of the (batch, head),
// rows rs floats apart.
template <int ROWS = T>
__device__ __forceinline__ void load_t(float* dst, const float* base, int row0, int S, int rs,
                                       int tid) {
  constexpr int LDA = ld_of(ROWS);
#pragma unroll
  for (int it = 0; it < (ROWS * D / 4) / THREADS; ++it) {
    const int idx = tid + THREADS * it;
    const int r = idx % ROWS;  // a warp's 32 threads: 32 rows, one conflict-free store each
    const int d4 = idx / ROWS;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = *reinterpret_cast<const float4*>(base + (size_t)(row0 + r) * rs + 4 * d4);
    dst[(4 * d4 + 0) * LDA + r] = v.x;
    dst[(4 * d4 + 1) * LDA + r] = v.y;
    dst[(4 * d4 + 2) * LDA + r] = v.z;
    dst[(4 * d4 + 3) * LDA + r] = v.w;
  }
}

// The same rows into dst as dst[r][d], the k-major form of a product over
// the rows; rows at or past S are zeros.
__device__ __forceinline__ void load_n(float* dst, const float* base, int row0, int S, int rs,
                                       int tid) {
#pragma unroll
  for (int it = 0; it < (T * D / 4) / THREADS; ++it) {
    const int idx = tid + THREADS * it;
    const int r = idx / (D / 4);  // 16 threads read one row's 256 contiguous bytes
    const int d4 = idx % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = *reinterpret_cast<const float4*>(base + (size_t)(row0 + r) * rs + 4 * d4);
    *reinterpret_cast<float4*>(dst + r * LD + 4 * d4) = v;
  }
}

// acc[i][j] += sum_k a[k][ra + i] b[k][cb + j] over k < 64, for i < R (a at
// stride ld_of(16 R), b at LD), with fmaf in a fixed order (k ascending):
// the same inputs give the same bits.
template <int R>
__device__ __forceinline__ void mma(float (&acc)[R][4], const float* a, int ra, const float* b,
                                    int cb) {
  constexpr int LDA = ld_of(16 * R);
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    float xs[R];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(a + k * LDA + ra + 4 * q);
      xs[4 * q] = x.x;
      xs[4 * q + 1] = x.y;
      xs[4 * q + 2] = x.z;
      xs[4 * q + 3] = x.w;
    }
    const float4 y = *reinterpret_cast<const float4*>(b + k * LD + cb);
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
  }
}

// Thread (ty, tx)'s R x 4 values x[i][j] at (R ty + i, 4 tx + j) into dst
// transposed, dst[4 tx + j][R ty + i] (stride ld_of(16 R)): the k-major A
// operand of a product over the columns.
template <int R>
__device__ __forceinline__ void store_t(float* dst, const float (&x)[R][4], int ty, int tx) {
  constexpr int LDA = ld_of(16 * R);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      *reinterpret_cast<float4*>(dst + (4 * tx + j) * LDA + R * ty + 4 * q) =
          make_float4(x[4 * q][j], x[4 * q + 1][j], x[4 * q + 2][j], x[4 * q + 3][j]);
    }
  }
}

// max and sum over the 16 threads of a half warp that share a row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
  }
}

}  // namespace f32t
