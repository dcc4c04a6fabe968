// Flash attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: the backward of JAX's bundled Pallas TPU flash attention, which
// segma_tpu/ops/attention.py:148 (_flash_bhsd, with the backward block sizes
// of _block_sizes) reaches through its custom_vjp when the encoder trains:
// _flash_attention_bwd_dkv (dK, dV; its pallas_call at :1121) and
// _flash_attention_bwd_dq (dQ; its pallas_call at :1456) in
// jax/experimental/pallas/ops/tpu/flash_attention.py.
//
// What it computes, per (batch, head), with P recomputed from the forward's
// log-sum-exp (flash_attn.cu writes it):
//   P  = exp(q k^T sm_scale - lse)        D  = rowsum(dO * O)   (f32)
//   dV = P^T dO        dP = dO V^T        dS = P * (dP - D)
//   dQ = dS K sm_scale                    dK = dS^T Q sm_scale
// on q, k, v, out, dO, dq, dk, dv laid out (B, S, H, 64) as the encoders
// produce them, with lse laid out (B, H, S).
//
// What bounds it on this card: five S x S x 64 products, 10 S^2 64 FLOP per
// (batch, head), against eight (S, 64) bf16 tensors and the lse read or
// written once. At HuBERT's S = 199 the bytes bound it: 78.6 MB at (32, 199,
// 12, 64), 0.0234 ms at 3.35 TB/s, where the products need 0.0098 ms. At
// Whisper's S = 1500 the products do: 737 GFLOP at (64, 1500, 8, 64), 0.745
// ms at 989 TFLOP/s. The split below recomputes S and dP in both passes
// (seven products, not five), reads Q, K, V and dO in both, and pads S to
// whole tiles. The score-sized matrices P, dP and dS never reach device
// memory. At small S what holds a kernel back is latency: each tile is a
// short chain (load, two products, the elementwise step, the products that
// use it), so the design keeps loads in flight ahead of the products and
// overlaps each tile's elementwise step with products still running.
//
// Design. JAX's split into two passes is kept; neither uses atomics, and an
// item's arithmetic does not depend on which block runs it, so two calls on
// the same inputs give the same bits. Both passes run the forward's
// pipeline (flash_attn.cu, on sm90.cuh):
//  - A work item is 128 "resident" rows of one (batch, head); the grid is
//    one block per SM (fewer if there are fewer items), each walking the
//    items blockIdx.x, + gridDim.x, ... A block is three warpgroups.
//  - Warpgroup 0 is the producer: one thread issues TMA loads through 3-D
//    tensor maps {H 64, S, B} with 128-byte swizzle, which fill rows past S
//    with zeros within the batch: each item's resident tiles into one of two
//    buffers (the next item's load while this one runs), then the other
//    operands in tiles of 64 "streamed" rows through a ring of STAGES
//    stages, each with a full mbarrier (TMA bytes) and an empty one
//    (consumer warps).
//  - Warpgroups 1 and 2 are consumers of 64 resident rows each. They take
//    their resident rows into registers once per item, as the A operand of
//    the two score products of every streamed tile (wgmma m64n64k16, B the
//    streamed tile K-major, 4 k-steps over the head dims), each in a commit
//    group of its own, so the exp2 of the first runs while the second does.
//    Then the elementwise step in registers, and products whose A operand is
//    that result in bf16 registers and whose B operand is the streamed tile
//    read MN-major (trans-b). No tile is ever transposed in shared memory.
//    The score products of tile j are issued with tile j - 1's last
//    products, which run during tile j's elementwise step. The first tile is
//    peeled, so no product sits under a condition (ptxas would serialise
//    every wgmma). Both consumers work on the same item, so consumer 1
//    starts LAG tiles behind consumer 0: they then reach the item
//    boundaries, where a consumer's chain runs without overlap, at
//    different times.
//  - dQ pass (flash_bwd_dq_kernel, first): Q, dO and O resident, K and V
//    streamed. While tile 0's products run, each row's D (from the resident
//    dO and O) and lse log2(e) are formed and written, padded to whole items
//    with (+inf, 0), as (lse log2(e), D) pairs for the other pass. Per tile:
//    S = Q K^T, dP = dO V^T; dS = P (dP - D) with keys at or past S masked
//    to P = 0; dQ += dS K.
//  - dK/dV pass (flash_bwd_dkv_kernel): K and V resident, Q and dO
//    streamed, with the tile's 64 (lse log2(e), D) pairs by a bulk copy into
//    the same stage. Per tile: S^T = K Q^T, dP^T = V dO^T; P^T and dS^T =
//    P^T (dP^T - D) per query column; dV += P^T dO, dK += dS^T Q. Queries
//    past S read zeros with lse = +inf, so their P is 0. It is a
//    programmatic dependent launch: its blocks start on the SMs that the dQ
//    pass frees, and only the bulk copies of the pairs wait for the dQ pass
//    to finish. It walks its items in reverse, so it starts on the (batch,
//    head) pairs whose tensors the dQ pass left in L2.
//  - Epilogue: the f32 accumulators (dQ and dK times sm_scale) cast to bf16
//    and stored for rows before S only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NC = 2;                    // consumer warpgroups, 64 resident rows each
constexpr int BR = 64 * NC;              // resident rows per work item
constexpr int BT = 64;                   // streamed rows per tile
constexpr int STAGES = 4;                // streamed tiles in flight
constexpr int LAG = 2;                   // tiles consumer 1 starts behind consumer 0
constexpr uint32_t LAG_BAR = 1;          // the named barrier that sets the lag
constexpr int TILE_BYTES = BT * 64 * 2;  // one streamed tile, 8 KB
constexpr int HALF_BYTES = 64 * 64 * 2;  // one consumer's resident rows
constexpr int RES_BYTES = BR * 64 * 2;   // one resident tile, 16 KB
constexpr int RES_TILES = 3;             // resident tiles of an item: Q, dO, O or K, V
constexpr int PAIR_BYTES = BT * 8;       // one tile's (lse log2(e), D) pairs
constexpr int THREADS = 128 * (NC + 1);
// two items' resident tiles, the ring, + alignment slack
constexpr int SMEM_BYTES =
    2 * RES_TILES * RES_BYTES + 2 * STAGES * TILE_BYTES + STAGES * PAIR_BYTES + 1024;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared loads. volatile: they must stay after the mbarrier wait that makes
// the data visible.
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The A fragments (sm90.cuh) of rows row and row + 8 of a swizzled [row][64]
// tile at shared `tile`, over its 4 k-steps of 16 head dims
__device__ __forceinline__ void load_frags(uint32_t (&a)[16], uint32_t tile, int row, int quad) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      a[4 * kk + 2 * hi] = lds_u32(tile + sw128_offset(row, 2 * kk + hi) + 4 * quad);
      a[4 * kk + 2 * hi + 1] = lds_u32(tile + sw128_offset(row + 8, 2 * kk + hi) + 4 * quad);
    }
  }
}

// x . y over head dims 16 quad .. 16 quad + 15 of row `row` of two swizzled
// [row][64] tiles at shared x and y, in f32
__device__ __forceinline__ float dot16(uint32_t x, uint32_t y, int row, int quad) {
  float sum = 0.f;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const uint32_t off = sw128_offset(row, 2 * quad + hi);
    const uint4 a = lds_u4(x + off);
    const uint4 b = lds_u4(y + off);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      sum = fmaf(fa.x, fb.x, sum);
      sum = fmaf(fa.y, fb.y, sum);
    }
  }
  return sum;
}

// d (64 x 64, f32) = A T^T over the 64 head dims: A the resident rows in
// registers (load_frags), T the [row][d] streamed tile at t_tile, K-major;
// 4 k-steps of 16, each 32 bytes further into every 128-byte row of T
__device__ __forceinline__ void rows_product(float (&d)[32], const uint32_t (&a)[16],
                                             uint32_t t_tile) {
  const uint64_t t_desc = sw128_desc(t_tile);
  wgmma_m64n64k16_rs_zero_d(d, &a[0], t_desc);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {
    wgmma_m64n64k16_rs_acc(d, &a[4 * kk], t_desc + ((kk * 32) >> 4));
  }
}

// acc (64 x 64, f32) += A T over the 64 streamed rows, A in bf16 registers
// (pack below), T the [row][d] tile read MN-major: 4 k-steps of 16 rows,
// each 2 groups of 8 rows (2048 bytes) further into the tile
__device__ __forceinline__ void tile_product(float (&acc)[32], const uint32_t (&a)[16],
                                             uint32_t t_tile) {
  const uint64_t t_desc = sw128_desc(t_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16_rs_tb(acc, &a[4 * kk], t_desc + ((kk * 2048) >> 4));
  }
}

// The f32 accumulator of a 64 x 64 product (sm90.cuh: c[4 n + 2 i + e] is
// (row + 8 i, column 8 n + 2 quad + e)) as the bf16 A operand of a product
// over those 64 columns: column blocks 2 kk and 2 kk + 1 make k-step kk.
__device__ __forceinline__ void pack(uint32_t (&a)[16], const float (&c)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// dQ pass, in place of the scores s: P = exp2(s scale_log2 - lse log2(e))
// for this thread's query rows r (l0) and r + 8 (l1)
__device__ __forceinline__ void p_rows(float (&s)[32], float l0, float l1, float scale_log2) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale_log2, -l0));
      s[4 * n + 2 + e] = ex2(fmaf(s[4 * n + 2 + e], scale_log2, -l1));
    }
  }
}

// dQ pass, in place of P: dS = P (dP - D) for rows r (d0) and r + 8 (d1);
// keys at or past S (the first `valid` of this tile are real) get dS = 0
__device__ __forceinline__ void ds_rows(float (&p)[32], const float (&dp)[32], float d0, float d1,
                                        int valid, int quad) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[4 * n + e] *= dp[4 * n + e] - d0;
      p[4 * n + 2 + e] *= dp[4 * n + 2 + e] - d1;
    }
  }
  if (valid < BT) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * n + 2 * quad + e >= valid) {
          p[4 * n + e] = 0.f;
          p[4 * n + 2 + e] = 0.f;
        }
      }
    }
  }
}

// dK/dV pass, in place of s = S^T: P^T. This thread's columns are the tile's
// queries 8 n + 2 quad + e, whose (lse log2(e), D) pairs lie at shared
// address `pairs`.
__device__ __forceinline__ void p_cols(float (&s)[32], uint32_t pairs, int quad,
                                       float scale_log2) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float4 ld = lds_f4(pairs + (8 * n + 2 * quad) * 8);  // queries e = 0, 1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[4 * n + 2 * i] = ex2(fmaf(s[4 * n + 2 * i], scale_log2, -ld.x));
      s[4 * n + 2 * i + 1] = ex2(fmaf(s[4 * n + 2 * i + 1], scale_log2, -ld.z));
    }
  }
}

// dK/dV pass, in place of dp = dP^T: dS^T = P^T (dP^T - D)
__device__ __forceinline__ void ds_cols(const float (&p)[32], float (&dp)[32], uint32_t pairs,
                                        int quad) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float4 ld = lds_f4(pairs + (8 * n + 2 * quad) * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = 4 * n + 2 * i;
      dp[x] = p[x] * (dp[x] - ld.y);
      dp[x + 1] = p[x + 1] * (dp[x + 1] - ld.w);
    }
  }
}

// rows r0 and r0 + 8 of a 64 x 64 accumulator, times mul, stored as bf16
// where they lie before S; dst points at row 0, column 2 quad of one
// (batch, head)
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t row_stride, int r0, int S,
                                           const float (&acc)[32], float mul) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dst + r0 * row_stride + 8 * n) =
          pack_bf16(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dst + r1 * row_stride + 8 * n) =
          pack_bf16(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
    }
  }
}

// A consumer warp is done with what `bar` guards
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Consumer 1 waits at LAG_BAR before its first tile, and consumer 0 arrives
// there once it has done LAG tiles (or all) of its first item: the two then
// reach item boundaries, where a consumer's products run without overlap,
// at different times. Called by consumer 0 after tile j of round `round`.
__device__ __forceinline__ void lead(int round, int j, int n_tiles) {
  if (round == 0 && j + 1 == min(LAG, n_tiles)) named_arrive(LAG_BAR, 256);
}

// A work item is 128 resident rows of one (batch, head): item = (b H + h)
// n_rt + rt, so the items running at once are mostly the row tiles of a few
// (batch, head) pairs, which share their streamed operands in L2.
struct Item {
  int rt, h, b;
};

__device__ __forceinline__ Item decode(int item, int n_rt, int H) {
  const int bh = item / n_rt;
  return {item - bh * n_rt, bh % H, bh / H};
}

// Shared addresses: the two buffers of resident tiles (res(buf, i)), the
// ring's stages (+ stage * TILE_BYTES or PAIR_BYTES) and the mbarriers (+ 8
// stage, + 8 buf)
struct Smem {
  uint32_t res0, str1, str2, pairs, full, empty, res_full, res_empty;
  __device__ __forceinline__ uint32_t res(int buf, int i) const {
    return res0 + (buf * RES_TILES + i) * RES_BYTES;
  }
};

constexpr int N_BARS = 2 * STAGES + 4;  // full[], empty[], res full[2], res empty[2]

__device__ __forceinline__ Smem setup(uint8_t* smem_raw, uint64_t* bars) {
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  Smem sm;
  sm.res0 = base;
  sm.str1 = base + 2 * RES_TILES * RES_BYTES;
  sm.str2 = sm.str1 + STAGES * TILE_BYTES;
  sm.pairs = sm.str2 + STAGES * TILE_BYTES;
  sm.full = smem_addr(&bars[0]);
  sm.empty = smem_addr(&bars[STAGES]);
  sm.res_full = smem_addr(&bars[2 * STAGES]);
  sm.res_empty = smem_addr(&bars[2 * STAGES + 2]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, 4 * NC);  // one arrival per consumer warp
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(sm.res_full + 8 * buf, 1);
      mbar_init(sm.res_empty + 8 * buf, 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// The producer thread: per item (in reverse order if kRev), its NRES
// resident tiles into buffer round mod 2 once the item two rounds back is
// done with it, then the streamed tiles through the ring, with their (lse
// log2(e), D) pairs from `pairs` if it is not null (which the dQ pass must
// have finished writing: the first such copy waits for it). `tile` counts
// tiles over all items of this block.
template <bool kRev, int NRES>
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* const (&res)[NRES],
                                        const CUtensorMap& str1, const CUtensorMap& str2,
                                        const float2* pairs, int S, int H, int n_items) {
#pragma unroll
  for (int i = 0; i < NRES; ++i) prefetch_tensor_map(res[i]);
  prefetch_tensor_map(&str1);
  prefetch_tensor_map(&str2);
  const int n_rt = (S + BR - 1) / BR;
  const int n_tiles = (S + BT - 1) / BT;
  const uint32_t tile_tx = 2 * TILE_BYTES + (pairs != nullptr ? PAIR_BYTES : 0);
  int tile = 0, round = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
    const Item it = decode(kRev ? n_items - 1 - item : item, n_rt, H);
    const int buf = round & 1;
    if (round >= 2) mbar_wait(sm.res_empty + 8 * buf, ((round >> 1) - 1) & 1);
    const uint32_t res_full = sm.res_full + 8 * buf;
    mbar_arrive_expect_tx(res_full, NRES * RES_BYTES);
#pragma unroll
    for (int i = 0; i < NRES; ++i) {
      tma_load_3d(sm.res(buf, i), res[i], it.h * 64, it.rt * BR, it.b, res_full);
    }
    for (int j = 0; j < n_tiles; ++j, ++tile) {
      const int st = tile % STAGES;
      if (tile >= STAGES) mbar_wait(sm.empty + 8 * st, ((tile / STAGES) + 1) & 1);
      const uint32_t full = sm.full + 8 * st;
      mbar_arrive_expect_tx(full, tile_tx);
      tma_load_3d(sm.str1 + st * TILE_BYTES, &str1, it.h * 64, j * BT, it.b, full);
      tma_load_3d(sm.str2 + st * TILE_BYTES, &str2, it.h * 64, j * BT, it.b, full);
      if (pairs != nullptr) {
        if (tile == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
        bulk_load(sm.pairs + st * PAIR_BYTES,
                  pairs + ((size_t)it.b * H + it.h) * (n_rt * BR) + j * BT, PAIR_BYTES, full);
      }
    }
  }
}

// dQ pass. Resident Q, dO and O (res 0, 1, 2), streamed K (str1) and V
// (str2). Also writes the (lse log2(e), D) pairs of every row, padded with
// (+inf, 0) to whole items: (B, H, n_rt 128) float2.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_o,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                    float2* __restrict__ pairs, __nv_bfloat16* __restrict__ dq, int S, int H,
                    int n_items, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const Smem sm = setup(smem_raw, bars);
  // the dK/dV pass may start its blocks as this pass's blocks finish
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* res[3] = {&map_q, &map_do, &map_o};
      produce<false>(sm, res, map_k, map_v, nullptr, S, H, n_items);
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int row = (t / 32) * 16 + lane / 4;  // this thread's rows row, row + 8 of 64
    const int n_rt = (S + BR - 1) / BR;
    const int n_tiles = (S + BT - 1) / BT;
    const size_t row_stride = (size_t)H * 64;

    if (c == 1) named_sync(LAG_BAR, 256);
    int tile = 0, round = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
      const Item it = decode(item, n_rt, H);
      const int buf = round & 1;
      const size_t bh = (size_t)it.b * H + it.h;
      const size_t base = (size_t)it.b * S * row_stride + (size_t)it.h * 64;
      const int r0 = it.rt * BR + c * 64 + row;
      const int r1 = r0 + 8;
      const float lse0 = r0 < S ? lse[bh * S + r0] : 0.f;  // in flight while the tiles load
      const float lse1 = r1 < S ? lse[bh * S + r1] : 0.f;

      float acc[32];    // dQ, unscaled: acc[4 n + 2 i + e] = (row + 8 i, col 8 n + 2 quad + e)
      float s[32];      // scores, then P, then dS: 64 query rows x 64 keys, the same layout
      float dp[32];     // dP
      uint32_t qa[16];  // Q and dO rows: the A operands of the score products
      uint32_t doa[16];
      uint32_t ds[16];  // dS in bf16: the A fragments of the 4 k-steps of 16 keys
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;

      // Tile 0: S and dP alone, while D forms. Then, per tile j, S_j, dP_j
      // and dQ += dS_{j-1} K_{j-1} as three commit groups: P_j is formed as
      // soon as S_j is in, dS_j as soon as dP_j is, while the dQ product
      // still runs.
      mbar_wait(sm.res_full + 8 * buf, (round >> 1) & 1);
      load_frags(qa, sm.res(buf, 0) + c * HALF_BYTES, row, quad);
      load_frags(doa, sm.res(buf, 1) + c * HALF_BYTES, row, quad);
      int st = tile % STAGES;
      mbar_wait(sm.full + 8 * st, (tile / STAGES) & 1);
      wgmma_fence();
      rows_product(s, qa, sm.str1 + st * TILE_BYTES);  // S = Q K^T
      wgmma_commit();
      rows_product(dp, doa, sm.str2 + st * TILE_BYTES);  // dP = dO V^T
      wgmma_commit();

      // D = rowsum(dO * O) of rows r0 and r1 from the resident tiles (zeros
      // past S), 16 head dims per thread of the quad, and lse log2(e); rows
      // past S get (+inf, 0), so their P is 0
      const uint32_t do_half = sm.res(buf, 1) + c * HALF_BYTES;
      const uint32_t o_half = sm.res(buf, 2) + c * HALF_BYTES;
      float d0 = dot16(do_half, o_half, row, quad);
      float d1 = dot16(do_half, o_half, row + 8, quad);
      d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
      d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
      const float l0 = r0 < S ? lse0 * LOG2E : INFINITY;
      const float l1 = r1 < S ? lse1 * LOG2E : INFINITY;
      if (quad == 0) {
        pairs[bh * (n_rt * BR) + r0] = make_float2(l0, d0);
        pairs[bh * (n_rt * BR) + r1] = make_float2(l1, d1);
      }
      release(sm.res_empty + 8 * buf, lane);  // Q, dO and O are read

      wgmma_wait<1>();
      fence_regs<32>(s);
      p_rows(s, l0, l1, scale_log2);
      wgmma_wait<0>();
      fence_regs<32>(dp);
      ds_rows(s, dp, d0, d1, S, quad);
      pack(ds, s);
      if (c == 0) lead(round, 0, n_tiles);

      for (int j = 1; j < n_tiles; ++j) {
        const int prev = st;
        ++tile;
        st = tile % STAGES;
        mbar_wait(sm.full + 8 * st, (tile / STAGES) & 1);
        wgmma_fence();
        rows_product(s, qa, sm.str1 + st * TILE_BYTES);
        wgmma_commit();
        rows_product(dp, doa, sm.str2 + st * TILE_BYTES);
        wgmma_commit();
        tile_product(acc, ds, sm.str1 + prev * TILE_BYTES);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<2>();  // S_j
        fence_regs<32>(s);
        p_rows(s, l0, l1, scale_log2);
        wgmma_wait<1>();  // dP_j
        fence_regs<32>(dp);
        ds_rows(s, dp, d0, d1, S - j * BT, quad);
        wgmma_wait<0>();  // dQ += dS_{j-1} K_{j-1}
        fence_regs<32>(acc);
        fence_regs<16>(ds);
        release(sm.empty + 8 * prev, lane);  // K_{j-1} and V_{j-1} are read
        pack(ds, s);
        if (c == 0) lead(round, j, n_tiles);
      }

      // the last tile's dQ product
      wgmma_fence();
      tile_product(acc, ds, sm.str1 + st * TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(acc);
      fence_regs<16>(qa);
      fence_regs<16>(doa);
      release(sm.empty + 8 * st, lane);
      ++tile;

      store_rows(dq + base + 2 * quad, row_stride, r0, S, acc, scale);
    }
  }
}

// dK/dV pass. Resident K and V (res 0, 1), streamed Q (str1) and dO (str2)
// with the pairs the dQ pass wrote. Items in reverse order.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do, const float2* __restrict__ pairs,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                     int n_items, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const Smem sm = setup(smem_raw, bars);

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* res[2] = {&map_k, &map_v};
      produce<true>(sm, res, map_q, map_do, pairs, S, H, n_items);
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int row = (t / 32) * 16 + lane / 4;  // this thread's rows row, row + 8 of 64
    const int n_rt = (S + BR - 1) / BR;
    const int n_tiles = (S + BT - 1) / BT;
    const size_t row_stride = (size_t)H * 64;

    if (c == 1) named_sync(LAG_BAR, 256);
    int tile = 0, round = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
      const Item it = decode(n_items - 1 - item, n_rt, H);
      const int buf = round & 1;
      const size_t base = (size_t)it.b * S * row_stride + (size_t)it.h * 64;
      const int k0 = it.rt * BR + c * 64 + row;

      float dka[32];   // dK (unscaled), 64 keys x 64: the accumulator layout
      float dva[32];   // dV
      float s[32];     // S^T, then P^T: 64 keys x 64 queries
      float dp[32];    // dP^T, then dS^T
      uint32_t ka[16];  // K and V rows: the A operands of the score products
      uint32_t va[16];
      uint32_t p[16], ds[16];  // P^T and dS^T in bf16: A fragments over 4 k-steps of 16 queries
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

      // Tile 0 alone, then per tile j: S^T_j, dP^T_j, and dV, dK from tile
      // j - 1, as three commit groups (as in the dQ pass).
      mbar_wait(sm.res_full + 8 * buf, (round >> 1) & 1);
      load_frags(ka, sm.res(buf, 0) + c * HALF_BYTES, row, quad);
      load_frags(va, sm.res(buf, 1) + c * HALF_BYTES, row, quad);
      release(sm.res_empty + 8 * buf, lane);  // K and V are in registers
      int st = tile % STAGES;
      mbar_wait(sm.full + 8 * st, (tile / STAGES) & 1);
      wgmma_fence();
      rows_product(s, ka, sm.str1 + st * TILE_BYTES);  // S^T = K Q^T
      wgmma_commit();
      rows_product(dp, va, sm.str2 + st * TILE_BYTES);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<32>(s);
      p_cols(s, sm.pairs + st * PAIR_BYTES, quad, scale_log2);
      wgmma_wait<0>();
      fence_regs<32>(dp);
      ds_cols(s, dp, sm.pairs + st * PAIR_BYTES, quad);
      pack(p, s);
      pack(ds, dp);
      if (c == 0) lead(round, 0, n_tiles);

      for (int j = 1; j < n_tiles; ++j) {
        const int prev = st;
        ++tile;
        st = tile % STAGES;
        mbar_wait(sm.full + 8 * st, (tile / STAGES) & 1);
        wgmma_fence();
        rows_product(s, ka, sm.str1 + st * TILE_BYTES);
        wgmma_commit();
        rows_product(dp, va, sm.str2 + st * TILE_BYTES);
        wgmma_commit();
        tile_product(dva, p, sm.str2 + prev * TILE_BYTES);   // dV += P^T dO
        tile_product(dka, ds, sm.str1 + prev * TILE_BYTES);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<2>();  // S^T_j
        fence_regs<32>(s);
        p_cols(s, sm.pairs + st * PAIR_BYTES, quad, scale_log2);
        wgmma_wait<1>();  // dP^T_j
        fence_regs<32>(dp);
        ds_cols(s, dp, sm.pairs + st * PAIR_BYTES, quad);
        wgmma_wait<0>();  // dV and dK of tile j - 1
        fence_regs<32>(dva);
        fence_regs<32>(dka);
        fence_regs<16>(p);
        fence_regs<16>(ds);
        release(sm.empty + 8 * prev, lane);  // Q_{j-1}, dO_{j-1} and their pairs are read
        pack(p, s);
        pack(ds, dp);
        if (c == 0) lead(round, j, n_tiles);
      }

      // the last tile's dV and dK products
      wgmma_fence();
      tile_product(dva, p, sm.str2 + st * TILE_BYTES);
      tile_product(dka, ds, sm.str1 + st * TILE_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(dva);
      fence_regs<32>(dka);
      fence_regs<16>(ka);
      fence_regs<16>(va);
      release(sm.empty + 8 * st, lane);
      ++tile;

      store_rows(dk + base + 2 * quad, row_stride, k0, S, dka, scale);
      store_rows(dv + base + 2 * quad, row_stride, k0, S, dva, 1.f);
    }
  }
}

}  // namespace

// All tensors contiguous and 16-byte aligned. q, k, v, o, dout, dq, dk, dv:
// (batch, seq, heads, 64) bf16; lse (from segma_flash_attn_fwd): (batch,
// heads, seq) f32; pairs: scratch of (batch, heads, ceil(seq / 128) 128, 2)
// f32, where the dQ pass writes each row's (lse log2(e), rowsum(dout * o))
// for the dK/dV pass. scale_log2 is sm_scale * log2(e). Launches the dQ pass,
// then the dK/dV pass as its programmatic dependent, on `stream`, one block
// per SM (or fewer, one per work item) each. Returns the first nonzero
// cudaGetLastError() after a launch, or cudaErrorInvalidValue when a tensor
// map cannot be encoded.
extern "C" int segma_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* pairs, void* dq,
                                    void* dk, void* dv, int batch, int seq, int heads,
                                    float scale_log2, float scale, void* stream) {
  alignas(64) CUtensorMap q_res, do_res, o_res, k_str, v_str, k_res, v_res, q_str, do_str;
  if (!bshd_tensor_map(&q_res, q, batch, seq, heads, BR) ||
      !bshd_tensor_map(&do_res, dout, batch, seq, heads, BR) ||
      !bshd_tensor_map(&o_res, o, batch, seq, heads, BR) ||
      !bshd_tensor_map(&k_str, k, batch, seq, heads, BT) ||
      !bshd_tensor_map(&v_str, v, batch, seq, heads, BT) ||
      !bshd_tensor_map(&k_res, k, batch, seq, heads, BR) ||
      !bshd_tensor_map(&v_res, v, batch, seq, heads, BR) ||
      !bshd_tensor_map(&q_str, q, batch, seq, heads, BT) ||
      !bshd_tensor_map(&do_str, dout, batch, seq, heads, BT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int n_items = (seq + BR - 1) / BR * heads * batch;
  const int grid = n_items < n_sm ? n_items : n_sm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  flash_bwd_dq_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      q_res, do_res, o_res, k_str, v_str, static_cast<const float*>(lse),
      static_cast<float2*>(pairs), static_cast<__nv_bfloat16*>(dq), seq, heads, n_items,
      scale_log2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel, k_res, v_res, q_str, do_str,
                     static_cast<const float2*>(pairs), static_cast<__nv_bfloat16*>(dk),
                     static_cast<__nv_bfloat16*>(dv), seq, heads, n_items, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
