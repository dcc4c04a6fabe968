// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: segma_tpu/ops/attention.py:148, _flash_bhsd, which calls JAX's
// bundled Pallas TPU flash_attention (its forward pallas_call lives in
// jax/experimental/pallas/ops/tpu/flash_attention.py) with pad-to-128 and
// SegmentIds masking of the padding.
//
// What it computes: out = softmax(q k^T * sm_scale) v for every (batch, head),
// on q, k, v and out laid out (B, S, H, 64) as the encoders produce them, with
// an online softmax (running max and sum, exp2 domain) and the output
// accumulated in f32. Given a non-null lse pointer it also writes each row's
// log-sum-exp of the scaled scores (natural log, f32, (B, H, S)), which the
// backward kernels (flash_attn_bwd.cu) use to recompute P; the output is the
// same bits with or without it.
//
// What bounds it on this card: two ceilings of about the same height. The
// products are 4 S^2 64 FLOP per (batch, head) against 8 S 64 bytes, so at
// Whisper's S = 1500 they are bound by the bf16 tensor-core rate, not by
// memory: 295 GFLOP at (64, 1500, 8, 64), 0.298 ms at 989 TFLOP/s. The
// softmax needs S^2 exp2 per (batch, head), and the special-function unit
// gives 16 a clock per SM: 1.15e9 exp2 at that shape, 0.276 ms over 132 SMs
// at 1.98 GHz. Run one after the other, the two add up; the design overlaps
// them.
//
// Design. A work item is 128 query rows of one (batch, head). The grid is
// one block per SM (fewer if there are fewer items); each block walks the
// items blockIdx.x, + gridDim.x, ..., so one block's next item loads while
// its last one finishes. A block is three warpgroups:
//  - Warpgroup 0 is the producer: one thread issues TMA loads through 3-D
//    tensor maps {H 64, S, B} with 128-byte swizzle, each item's Q once its
//    previous Q is read, and K and V in tiles of 128 keys into a ring of
//    STAGES shared-memory stages, each with a full mbarrier (TMA bytes) and an
//    empty one (consumer warps). The maps zero-fill rows past S within the
//    batch, so no tile reads the next batch. It keeps 24 registers.
//  - Warpgroups 1 and 2 are consumers of 64 query rows each, with 240
//    registers. Per key tile: S = Q K^T as 4 wgmma m64n128k16 with both
//    operands K-major in shared memory; keys at or past S set to -inf; the
//    online softmax in registers; P converted to bf16 in registers, where it
//    is the A operand of O += P V, 8 wgmma m64n64k16 with V read straight from
//    its TMA tile as an MN-major B operand (no transpose).
//  - The two consumers take turns on the tensor cores through two named
//    barriers: each issues Q K_j^T and P_{j-1} V_{j-1}, hands the turn to the
//    other, and computes the softmax of tile j as soon as its scores are in,
//    while its own P V and the other consumer's products run.
//  - Epilogue: O times 1 / l, cast to bf16, stored for rows < S only.
// No atomics, and an item's arithmetic does not depend on which block runs
// it: two calls on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NC = 2;            // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NC;      // query rows per work item
constexpr int BK = 128;          // keys per tile
constexpr int STAGES = 3;        // K and V tiles in flight
constexpr int TILE_BYTES = BK * 64 * 2;  // one K or V tile, 16 KB
constexpr int Q_BYTES = BQ * 64 * 2;
constexpr int THREADS = 128 * (NC + 1);
constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * TILE_BYTES + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s (64 x 128, f32) = Q K^T over the 64 head dims: 4 k-steps of 16, each 32
// bytes further into every 128-byte row of both tiles
__device__ __forceinline__ void qk_product(float (&s)[64], uint64_t q_desc, uint32_t k_tile) {
  const uint64_t k_desc = sw128_desc(k_tile);
  wgmma_m64n128k16_ss_zero_d(s, q_desc, k_desc);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {
    wgmma_m64n128k16_ss_acc(s, q_desc + ((kk * 32) >> 4), k_desc + ((kk * 32) >> 4));
  }
}

// acc (64 x 64, f32) += P V over 128 keys: 8 k-steps of 16 keys, each 2
// groups of 8 rows (2048 bytes) further into the V tile
__device__ __forceinline__ void pv_product(float (&acc)[32], const uint32_t (&p)[32],
                                           uint32_t v_tile) {
  const uint64_t v_desc = sw128_desc(v_tile);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_m64n64k16_rs_tb(acc, &p[4 * kk], v_desc + ((kk * 2048) >> 4));
  }
}

// One key tile of the online softmax, in the exp2 domain: mask keys at or
// past S (the first `valid` keys of this tile are real), update the running
// max m and sum l of rows r and r + 8, and leave the tile's probabilities in
// s and the factor the O accumulator must take in a0, a1. Layout of the
// m64n128k16 accumulator (sm90.cuh): s[4 n + 2 i + e] is (row + 8 i, key
// 8 n + 2 quad + e).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1, int valid,
                                             int quad, float scale_log2) {
  if (valid < BK) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * n + 2 * quad + e >= valid) {
          s[4 * n + e] = -INFINITY;
          s[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
  }
  // two chains per row, for the scheduler
  float mx0 = m0, mx1 = m1, mx0b = m0, mx1b = m1;
#pragma unroll
  for (int n = 0; n < 16; n += 2) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    mx0b = fmaxf(mx0b, fmaxf(s[4 * n + 4], s[4 * n + 5]));
    mx1b = fmaxf(mx1b, fmaxf(s[4 * n + 6], s[4 * n + 7]));
  }
  mx0 = fmaxf(mx0, mx0b);
  mx1 = fmaxf(mx1, mx1b);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // key 0 lies in the first tile, so the max is finite from then on
  const float ms0 = mx0 * scale_log2;
  const float ms1 = mx1 * scale_log2;
  a0 = ex2(m0 * scale_log2 - ms0);
  a1 = ex2(m1 * scale_log2 - ms1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale_log2, -ms0));
      s[4 * n + 2 + e] = ex2(fmaf(s[4 * n + 2 + e], scale_log2, -ms1));
      sum0 += s[4 * n + e];
      sum1 += s[4 * n + 2 + e];
    }
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// Rescale the O accumulator by a0, a1 and convert the probabilities to the
// bf16 A operand of the next P V: the C fragments of score column blocks
// 2 kk and 2 kk + 1 are the A fragments of k-step kk.
__device__ __forceinline__ void rescale_and_pack(float (&acc)[32], uint32_t (&p)[32],
                                                 const float (&s)[64], float a0, float a1) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[4 * n] *= a0;
    acc[4 * n + 1] *= a0;
    acc[4 * n + 2] *= a1;
    acc[4 * n + 3] *= a1;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A work item is 128 query rows of one (batch, head): item = (b H + h) n_qt
// + qt, so the items running at once are mostly the query tiles of a few
// (batch, head) pairs, which share their K and V in L2.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item decode(int item, int n_qt, int H) {
  const int bh = item / n_qt;
  return {item - bh * n_qt, bh % H, bh / H};
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int n_items, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 2];  // full[], empty[], q full, q empty

  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t k_smem = base + Q_BYTES;                        // + stage * TILE_BYTES
  const uint32_t v_smem = base + Q_BYTES + STAGES * TILE_BYTES;  // + stage * TILE_BYTES
  const uint32_t full_bar = smem_addr(&bars[0]);                 // + 8 stage
  const uint32_t empty_bar = smem_addr(&bars[STAGES]);           // + 8 stage
  const uint32_t q_full = smem_addr(&bars[2 * STAGES]);
  const uint32_t q_empty = smem_addr(&bars[2 * STAGES + 1]);

  const int n_qt = (S + BQ - 1) / BQ;
  const int n_tiles = (S + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * NC);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NC);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: Q of each item once its previous Q is read, K and V tiles
    // through the ring; `tile` counts tiles over all items of this block
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&map_q);
      prefetch_tensor_map(&map_k);
      prefetch_tensor_map(&map_v);
      int tile = 0, round = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
        const Item it = decode(item, n_qt, H);
        if (round > 0) mbar_wait(q_empty, (round - 1) & 1);
        mbar_arrive_expect_tx(q_full, Q_BYTES);
        tma_load_3d(q_smem, &map_q, it.h * 64, it.qt * BQ, it.b, q_full);
        for (int j = 0; j < n_tiles; ++j, ++tile) {
          const int st = tile % STAGES;
          if (tile >= STAGES) mbar_wait(empty_bar + 8 * st, ((tile / STAGES) + 1) & 1);
          const uint32_t full = full_bar + 8 * st;
          mbar_arrive_expect_tx(full, 2 * TILE_BYTES);
          tma_load_3d(k_smem + st * TILE_BYTES, &map_k, it.h * 64, j * BK, it.b, full);
          tma_load_3d(v_smem + st * TILE_BYTES, &map_v, it.h * 64, j * BK, it.b, full);
        }
      }
    }
  } else {
    // consumers: c = 0 or 1, 64 query rows of each item
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    // the turn barriers: consumer c waits on 1 + c and hands over to the other
    const uint32_t my_turn = 1 + c;
    const uint32_t other_turn = 2 - c;
    const uint64_t q_desc = sw128_desc(q_smem + c * (Q_BYTES / NC));
    const size_t row_stride = (size_t)H * 64;

    // Consumer 0 goes first. Each turn barrier then sees as many arrivals as
    // waits: consumer 1 skips its hand-over on its last turn.
    if (c == 1) named_arrive(other_turn, 256);
    const int last_item = n_items - 1 - (n_items - 1 - (int)blockIdx.x) % (int)gridDim.x;

    int tile = 0, round = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
      const Item it = decode(item, n_qt, H);
      const bool last_turns = item == last_item;
      float acc[32];   // O, 64 rows x 64: acc[4 n + 2 i + e] = (row + 8 i, col 8 n + 2 quad + e)
      float s[64];     // scores, 64 rows x 128 keys, the same layout over 16 column blocks
      uint32_t p[32];  // P in bf16: the A fragments of the 8 k-steps of 16 keys
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores, rows r, r + 8
      float l0 = 0.f, l1 = 0.f;              // running sums, this thread's columns
      float a0, a1;                          // the factor O takes before the next P V

      // Tile 0: Q K_0^T alone. Then, per tile j, Q K_j^T and P_{j-1} V_{j-1}
      // in one turn, as two commit groups: the softmax of tile j runs as soon
      // as its scores are in, while P_{j-1} V_{j-1} (and the other consumer's
      // products) still run. No product sits under a condition: ptxas would
      // serialise them.
      mbar_wait(q_full, round & 1);
      int st = tile % STAGES;
      mbar_wait(full_bar + 8 * st, (tile / STAGES) & 1);
      named_sync(my_turn, 256);
      wgmma_fence();
      qk_product(s, q_desc, k_smem + st * TILE_BYTES);
      wgmma_commit();
      if (c == 0 || !(last_turns && n_tiles == 1)) named_arrive(other_turn, 256);
      wgmma_wait<0>();
      fence_regs<64>(s);
      if (n_tiles == 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);  // Q is read
      }
      softmax_tile(s, m0, m1, l0, l1, a0, a1, S, quad, scale_log2);
      rescale_and_pack(acc, p, s, a0, a1);

      for (int j = 1; j < n_tiles; ++j) {
        const int prev = st;
        ++tile;
        st = tile % STAGES;
        mbar_wait(full_bar + 8 * st, (tile / STAGES) & 1);
        named_sync(my_turn, 256);
        wgmma_fence();
        qk_product(s, q_desc, k_smem + st * TILE_BYTES);
        wgmma_commit();
        pv_product(acc, p, v_smem + prev * TILE_BYTES);
        wgmma_commit();
        if (c == 0 || !(last_turns && j + 1 == n_tiles)) named_arrive(other_turn, 256);
        wgmma_wait<1>();  // the scores of tile j
        fence_regs<64>(s);
        if (j + 1 == n_tiles) {
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);  // Q is read
        }
        softmax_tile(s, m0, m1, l0, l1, a0, a1, S - j * BK, quad, scale_log2);
        wgmma_wait<0>();  // P_{j-1} V_{j-1}
        fence_regs<32>(acc);
        fence_regs<32>(p);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * prev);  // K_{j-1} and V_{j-1} are read
        rescale_and_pack(acc, p, s, a0, a1);
      }

      // the last tile's P V
      wgmma_fence();
      pv_product(acc, p, v_smem + st * TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
      ++tile;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0;
      const float inv1 = 1.f / l1;
      const int r0 = it.qt * BQ + c * 64 + (t / 32) * 16 + lane / 4;
      const int r1 = r0 + 8;
      if (lse != nullptr && quad == 0) {
        // ln(sum exp(score * sm_scale)) = (max * scale_log2 + log2(sum)) * ln 2
        const size_t row0 = ((size_t)it.b * H + it.h) * S;
        if (r0 < S) lse[row0 + r0] = (m0 * scale_log2 + log2f(l0)) * 0.6931471805599453f;
        if (r1 < S) lse[row0 + r1] = (m1 * scale_log2 + log2f(l1)) * 0.6931471805599453f;
      }
      __nv_bfloat16* ob = o + (size_t)it.b * S * row_stride + (size_t)it.h * 64 + 2 * quad;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (r0 < S) {
          *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + 8 * n) =
              pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
        }
        if (r1 < S) {
          *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + 8 * n) =
              pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
        }
      }
    }
  }
}

}  // namespace

// q, k, v, o: contiguous (batch, seq, heads, 64) bf16, 16-byte aligned. lse:
// null, or contiguous (batch, heads, seq) f32. scale_log2 is sm_scale *
// log2(e). Launches one block per SM (or fewer, one per work item), each
// looping over work items. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
extern "C" int segma_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int batch, int seq, int heads,
                                    float scale_log2, void* stream) {
  alignas(64) CUtensorMap map_q, map_k, map_v;
  if (!bshd_tensor_map(&map_q, q, batch, seq, heads, BQ) ||
      !bshd_tensor_map(&map_k, k, batch, seq, heads, BK) ||
      !bshd_tensor_map(&map_v, v, batch, seq, heads, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int n_items = (seq + BQ - 1) / BQ * heads * batch;
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  flash_fwd_kernel<<<n_items < n_sm ? n_items : n_sm, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), seq, heads,
      n_items, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
