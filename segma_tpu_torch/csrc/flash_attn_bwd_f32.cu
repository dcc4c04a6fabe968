// Flash attention backward in f32 for Hopper (sm_90a): 3xTF32 on wgmma.
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
// (batch, head), 9.73 GFLOP at (32, 199, 12, 64): 0.145 ms at the 67 TFLOP/s
// of IEEE f32 on the CUDA cores, 0.059 ms as 3xTF32 (three TF32 products
// each) at the tensor cores' 495 TFLOP/s, against 0.0235 ms for the eight
// tensors' 78.6 MB and the lse. This design recomputes S and dP in both
// passes (seven products) and pads them to whole tiles (256 x 224 at S =
// 199): 65.9 GFLOP as 3xTF32, 0.133 ms at the TF32 peak.
//
// Why 3xTF32. One TF32 product keeps 11 bits of each operand and misses the
// f32 bar (5e-5 x max(1, max|ref|) against float64) 12 to 17 times over in
// the emulation (tests/test_torch_flash_f32_tf32.py). Each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a product is
// lo B_hi + hi B_lo + hi B_hi. The tensor cores' f32 sums truncate, so no
// truncating chain spans more than one tile: the score products take their
// large and small terms into two fresh accumulators, added in IEEE f32;
// the products over a tile's rows (dQ, dV, dK) take a fresh accumulator per
// tile, added into the running sum in IEEE f32 on the CUDA cores.
//
// Design. JAX's split into two passes is kept; neither uses atomics, and an
// item's arithmetic does not depend on which block runs it, so two calls on
// the same inputs give the same bits.
//  - A work item is 128 "resident" rows of one (batch, head); one persistent
//    block per SM (fewer if there are fewer items) walks the items
//    blockIdx.x, + gridDim.x, ... A block is three warpgroups.
//  - Warpgroup 0, thread 0: TMA through 3-D tensor maps {H 64, S, B} of f32,
//    each 64 columns as two boxes of 32 (128 bytes, 128-byte swizzle), rows
//    past S zero-filled: each item's resident tiles raw, once both consumers
//    are done with the last item's (two buffers do not fit beside two
//    stages), and the streamed operands in tiles of BT = 32 rows through a
//    ring of STAGES stages (full, ready and empty mbarriers per stage). An
//    item's first STAGES tiles are loaded before its resident tiles, into
//    the stages the last item frees, so they land and are converted while
//    the consumers finish it.
//  - Warpgroup 0, warps 1-3: the converters. A TF32 wgmma reads B only
//    K-major, so the products over a tile's rows need the streamed tile
//    transposed. Per stage, each landed tile is rewritten in place as its
//    TF32 hi part, with its lo part beside it, and, where a product reduces
//    over its rows, written transposed in hi and lo. Both writes permute the
//    k index within each k-step (below), so that a thread's registers feed
//    wgmma's A fragments without shuffles. Then fence.proxy.async and the
//    stage's ready barrier.
//  - Warpgroups 1 and 2, the consumers, 64 resident rows each, on the same
//    streamed tiles, so that one's tensor-core work overlaps the other's
//    CUDA-core steps (one consumer of 64 rows per block runs 1.28x slower,
//    bitwise equal: flash_f32_ablations.py bwd). The score products (m64n32,
//    8 k-steps over the head dims) take A from registers: each thread loads
//    its float4s of the raw resident rows and splits them (cvt.rna), per
//    tile. B's head dims are permuted so that slot q + 4 h of k-step 2 j + t
//    is head dim 16 j + 4 q + 2 t + h: thread q's float4 at 16 j + 4 q holds
//    its k = q and q + 4 of k-steps 2 j and 2 j + 1. The products over the
//    tile's 32 rows (m64n64, 4 k-steps) take A from the score accumulator:
//    thread q holds columns 2 q and 2 q + 1 of each 8, so the transposed B
//    tiles hold row 2 q + e of each 8 at slot q + 4 e.
//  - dQ pass (flash_bwd_dq_f32_kernel, first): Q, dO and O resident, K and V
//    streamed (K also transposed). Per item, each row's D (from the resident
//    dO and O) and lse log2(e), written as (lse log2(e), D) pairs for the
//    other pass, rows past S as (+inf, 0). Per tile: S = Q K^T, then dP =
//    dO V^T while P forms; dS = P (dP - D), keys past S masked; dQ += dS K.
//  - dK/dV pass (flash_bwd_dkv_f32_kernel): K and V resident, Q and dO
//    streamed (both also transposed), with the tile's 32 pairs by a bulk
//    copy into the stage. Per tile: S^T = K Q^T, then dP^T = V dO^T while
//    P^T forms; dS^T = P^T (dP^T - D); dV += P^T dO and dK += dS^T Q, the
//    dV sum added while the dK product runs. Queries past S read zeros with
//    lse = +inf, so their P is 0. A programmatic dependent launch: its
//    blocks start as the dQ pass's blocks finish, only the bulk copies of
//    the pairs wait for the dQ pass, and it walks its items in reverse.
//
// What limits it (flash_f32_ablations.py bwd, timing-only ablations): the
// tensor-core products are about half of the critical path (one TF32
// product instead of three takes 18% off for the score products, 13% for
// the row products); the consumers' split of the resident rows per tile
// 10%; the converters 8% (their transposed writes 1%).
//
// Shared memory (each pass 198,144 bytes of the 232,448 a block may have):
//   dQ pass:   resident 3 tiles (Q, dO, O) x 128 rows x 256 bytes = 96 KB
//              ring 2 stages x (K, V hi + lo 32 KB, K^T hi + lo 16 KB) = 96 KB
//   dK/dV:     resident 2 tiles (K, V) x 128 rows x 256 bytes      = 64 KB
//              ring 2 stages x (Q, dO hi + lo 32 KB, Q^T, dO^T hi + lo 32 KB)
//              = 128 KB, + 2 x 256 bytes of pairs
//   + 1 KB for the 1024-byte alignment of the swizzled tiles.
// Registers: 384 threads at one block per SM give 168 a thread at launch;
// setmaxnreg moves them to 56 for warpgroup 0 and 224 for the consumers
// (56 + 2 x 224 = 504 of the launch's 3 x 168). ptxas -v reports 168 and a
// 12-byte spill for each pass. The dK/dV consumer's peak: dK, dV (64),
// their two fresh tile sums (64), and the P^T and dS^T A fragments in hi and
// lo (64); or, in the score products, the split resident rows (64) and four
// score accumulators (64) beside dK and dV.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace tf32x3;

constexpr int NC = 2;                   // consumer warpgroups, 64 resident rows each
constexpr int BR = 64 * NC;             // resident rows per work item
constexpr int STAGES = 2;
constexpr int THREADS = 128 * (NC + 1); // producer and converters, consumers
constexpr int CONVERTERS = 96;          // warps 1-3 of warpgroup 0
constexpr int RES_BYTES = 2 * RES_HALF; // one consumer's resident tile, raw
constexpr int NAT_BYTES = 2 * PART;     // hi, then lo
constexpr int T_BYTES = 2 * T_PART;
constexpr int PAIR_BYTES = BT * 8;      // one tile's (lse log2(e), D) pairs
constexpr float LOG2E = 1.4426950408889634f;

// the pass's resident tiles (Q, dO, O or K, V) and transposed streamed tiles
// (K^T, or Q^T and dO^T)
template <bool kDQ>
struct Pass {
  static constexpr int NRES = kDQ ? 3 : 2;
  static constexpr int NT = kDQ ? 1 : 2;
  static constexpr int STAGE_BYTES = 2 * NAT_BYTES + NT * T_BYTES;
  static constexpr int STAGE_OFF = NC * NRES * RES_BYTES;
  static constexpr int PAIR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = PAIR_OFF + STAGES * PAIR_BYTES + 1024;
};
static_assert(Pass<true>::SMEM_BYTES <= 232448 && Pass<false>::SMEM_BYTES <= 232448,
              "shared memory");

// The converters' work on one stage: each of the two landed [32][64] tiles
// (two 128-byte-swizzled halves of 32 columns) becomes its TF32 hi part in
// place, with its head dims permuted within each 16 (slot q + 4 h of k-step
// 2 j + t, in chunk 2 t + h, holds dim 16 j + 4 q + 2 t + h: a 4 x 4
// transpose of the 16 dims' four chunks), and its lo part PART bytes on;
// the first NT tiles also go transposed into [64 dims][32 rows] tiles, row
// c at slot t_slot(c). Thread `tid` < 96 is row tid % 32 of groups tid / 32,
// + 3, + 6 of the 8 (tensor, 16 dims).
template <int NT>
__device__ __forceinline__ void convert_stage(uint32_t stage, int tid) {
  const int row = tid % 32;
  for (int g = tid / 32; g < 8; g += 3) {
    const int tsr = g >> 2, half = (g >> 1) & 1, jj = g & 1;
    const uint32_t nat = stage + tsr * NAT_BYTES + half * NAT_HALF;
    uint32_t hi[4][4], lo[4][4];
    split16(hi, lo, nat, row, jj);
    store16(nat, PART, row, jj, hi, lo);
    const uint32_t t = stage + 2 * NAT_BYTES + tsr * T_BYTES;
    if (tsr < NT) store16_t(t, t_slot(row), half, jj, hi, lo);
  }
  fence_proxy_async();
}

// acc += blk in IEEE f32, once the products that wrote blk are done
template <int N>
__device__ __forceinline__ void add_block(float (&acc)[N], float (&blk)[N]) {
  fence_regs<N>(blk);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += blk[i];
}

// rows r0 and r0 + 8 of a 64 x 64 accumulator, times mul, stored where they
// lie before S; dst points at row 0, column 2 quad of one (batch, head)
__device__ __forceinline__ void store_rows(float* dst, size_t row_stride, int r0, int S,
                                           const float (&acc)[32], float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < S) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(dst + r * row_stride + 8 * n) =
            make_float2(acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);
      }
    }
  }
}

// Shared addresses and mbarriers (+ 8 stage)
struct Smem {
  uint32_t res0, stage0, pairs, full, ready, empty, res_full, res_empty;
};

template <bool kDQ>
__device__ __forceinline__ Smem setup(uint8_t* smem_raw, uint64_t* bars) {
  using P = Pass<kDQ>;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzled tiles
  Smem sm;
  sm.res0 = base;
  sm.stage0 = base + P::STAGE_OFF;
  sm.pairs = base + P::PAIR_OFF;
  sm.full = smem_addr(&bars[0]);
  sm.ready = smem_addr(&bars[STAGES]);
  sm.empty = smem_addr(&bars[2 * STAGES]);
  sm.res_full = smem_addr(&bars[3 * STAGES]);
  sm.res_empty = smem_addr(&bars[3 * STAGES + 1]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.ready + 8 * s, CONVERTERS / 32);  // one arrival per converter warp
      mbar_init(sm.empty + 8 * s, 4 * NC);           // one per consumer warp
    }
    mbar_init(sm.res_full, 1);
    mbar_init(sm.res_empty, 4 * NC);
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

constexpr int N_BARS = 3 * STAGES + 2;

// Warpgroup 0. Thread 0: per item (in reverse order if kRev), its first
// STAGES streamed tiles, its NRES resident tiles (each as NC tiles of 64
// rows, one per consumer) once the last item is done with them, then its
// other streamed tiles; each streamed tile with its pairs from `pairs` if
// it is not null (the first such copy waits for the dQ pass to finish).
// Warps 1-3: convert each stage once it lands.
template <bool kDQ, bool kRev>
__device__ __forceinline__ void produce(const Smem& sm,
                                        const CUtensorMap* const (&res)[Pass<kDQ>::NRES],
                                        const CUtensorMap& str1, const CUtensorMap& str2,
                                        const float2* pairs, int S, int H, int n_items) {
  using P = Pass<kDQ>;
  const int n_rt = (S + BR - 1) / BR;
  const int n_tiles = (S + BT - 1) / BT;
  const int s_pad = n_rt * BR;  // the pairs' rows: whole items (ops/attention.py BWD_ROWS)
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < P::NRES; ++i) prefetch_tensor_map(res[i]);
    prefetch_tensor_map(&str1);
    prefetch_tensor_map(&str2);
    const uint32_t tile_tx = 2 * PART + (pairs != nullptr ? PAIR_BYTES : 0);
    int tile = 0, round = 0;
    auto load_tile = [&](const Item& it, int j) {
      const int st = tile % STAGES;
      if (tile >= STAGES) mbar_wait(sm.empty + 8 * st, ((tile / STAGES) + 1) & 1);
      const uint32_t full = sm.full + 8 * st;
      const uint32_t stage = sm.stage0 + st * P::STAGE_BYTES;
      mbar_arrive_expect_tx(full, tile_tx);
      tma_load_3d(stage, &str1, it.h * 64, j * BT, it.b, full);
      tma_load_3d(stage + NAT_HALF, &str1, it.h * 64 + 32, j * BT, it.b, full);
      tma_load_3d(stage + NAT_BYTES, &str2, it.h * 64, j * BT, it.b, full);
      tma_load_3d(stage + NAT_BYTES + NAT_HALF, &str2, it.h * 64 + 32, j * BT, it.b, full);
      if (pairs != nullptr) {
        if (tile == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
        bulk_load(sm.pairs + st * PAIR_BYTES,
                  pairs + ((size_t)it.b * H + it.h) * s_pad + j * BT, PAIR_BYTES, full);
      }
      ++tile;
    };
    const int early = n_tiles < STAGES ? n_tiles : STAGES;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
      const Item it = decode(kRev ? n_items - 1 - item : item, n_rt, H);
      // the item's first tiles into the stages its predecessor frees, then its
      // resident tiles once the predecessor is done with them
      for (int j = 0; j < early; ++j) load_tile(it, j);
      if (round >= 1) mbar_wait(sm.res_empty, (round - 1) & 1);
      mbar_arrive_expect_tx(sm.res_full, NC * P::NRES * RES_BYTES);
#pragma unroll
      for (int i = 0; i < NC * P::NRES; ++i) {
        const uint32_t dst = sm.res0 + i * RES_BYTES;
        const int r = it.rt * BR + (i % NC) * 64;
        tma_load_3d(dst, res[i / NC], it.h * 64, r, it.b, sm.res_full);
        tma_load_3d(dst + RES_HALF, res[i / NC], it.h * 64 + 32, r, it.b, sm.res_full);
      }
      for (int j = early; j < n_tiles; ++j) load_tile(it, j);
    }
  } else if (threadIdx.x >= 32) {
    const int tid = threadIdx.x - 32;
    const int n_mine = (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    for (int tile = 0; tile < n_mine * n_tiles; ++tile) {
      const int st = tile % STAGES;
      mbar_wait(sm.full + 8 * st, (tile / STAGES) & 1);
      convert_stage<P::NT>(sm.stage0 + st * P::STAGE_BYTES, tid);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(sm.ready + 8 * st);
    }
  }
}

// dQ pass. Resident Q, dO and O (res 0, 1, 2), streamed K (with K^T) and V.
// Also writes the (lse log2(e), D) pairs of every row of its items, padded
// with (+inf, 0): (B, H, s_pad) float2.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                        float2* __restrict__ pairs, float* __restrict__ dq, int S, int H,
                        int n_items, float scale_log2, float scale) {
  using P = Pass<true>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const Smem sm = setup<true>(smem_raw, bars);
  // the dK/dV pass may start its blocks as this pass's blocks finish
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (threadIdx.x < 128) {
    setmaxnreg_dec<56>();
    const CUtensorMap* res[3] = {&map_q, &map_do, &map_o};
    produce<true, false>(sm, res, map_k, map_v, nullptr, S, H, n_items);
    return;
  }
  setmaxnreg_inc<224>();
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int row = (t / 32) * 16 + lane / 4;  // this thread's rows row, row + 8 of 64
  const int n_rt = (S + BR - 1) / BR;
  const int n_tiles = (S + BT - 1) / BT;
  const int s_pad = n_rt * BR;  // the pairs' rows: whole items (ops/attention.py BWD_ROWS)
  const size_t row_stride = (size_t)H * 64;

  int tile = 0, round = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
    const Item it = decode(item, n_rt, H);
    const size_t bh = (size_t)it.b * H + it.h;
    const size_t base = (size_t)it.b * S * row_stride + (size_t)it.h * 64;
    const int r0 = it.rt * BR + c * 64 + row;
    const int r1 = r0 + 8;
    const float lse0 = r0 < S ? lse[bh * S + r0] : 0.f;  // in flight while the tiles load
    const float lse1 = r1 < S ? lse[bh * S + r1] : 0.f;
    const uint32_t q_res = sm.res0 + c * RES_BYTES;
    const uint32_t do_res = q_res + NC * RES_BYTES;
    const uint32_t o_res = q_res + 2 * NC * RES_BYTES;

    // D = rowsum(dO * O) of rows r0 and r1 (zeros past S), 16 head dims per
    // thread of the quad in a fixed order; rows past S get lse = +inf
    mbar_wait(sm.res_full, round & 1);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const uint32_t off = (jp >> 1) * RES_HALF;
      const int chunk = 4 * (jp & 1) + quad;
      const float4 a0 = lds_f4(do_res + off + sw128_offset(row, chunk));
      const float4 b0 = lds_f4(o_res + off + sw128_offset(row, chunk));
      const float4 a1 = lds_f4(do_res + off + sw128_offset(row + 8, chunk));
      const float4 b1 = lds_f4(o_res + off + sw128_offset(row + 8, chunk));
      d0 = fmaf(a0.x, b0.x, fmaf(a0.y, b0.y, fmaf(a0.z, b0.z, fmaf(a0.w, b0.w, d0))));
      d1 = fmaf(a1.x, b1.x, fmaf(a1.y, b1.y, fmaf(a1.z, b1.z, fmaf(a1.w, b1.w, d1))));
    }
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    const float l0 = r0 < S ? lse0 * LOG2E : INFINITY;
    const float l1 = r1 < S ? lse1 * LOG2E : INFINITY;
    if (quad == 0) {
      pairs[bh * s_pad + r0] = make_float2(l0, d0);
      pairs[bh * s_pad + r1] = make_float2(l1, d1);
    }

    float acc[32];  // dQ, unscaled: acc[4 n + 2 i + e] = (row + 8 i, col 8 n + 2 quad + e)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j, ++tile) {
      const int st = tile % STAGES;
      const uint32_t stage = sm.stage0 + st * P::STAGE_BYTES;
      uint32_t ah[32], al[32];
      float s_lg[16], s_sm[16], p_lg[16], p_sm[16];
      resident_frags(ah, al, q_res, row, quad);
      mbar_wait(sm.ready + 8 * st, (tile / STAGES) & 1);
      wgmma_fence();
      score_product(s_lg, s_sm, ah, al, stage);  // S = Q K^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(ah);
      fence_regs<32>(al);
      resident_frags(ah, al, do_res, row, quad);
      wgmma_fence();
      score_product(p_lg, p_sm, ah, al, stage + NAT_BYTES);  // dP = dO V^T
      wgmma_commit();
      // P while dP runs
      join(s_lg, s_sm);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s_lg[4 * n + e] = ex2(fmaf(s_lg[4 * n + e], scale_log2, -l0));
          s_lg[4 * n + 2 + e] = ex2(fmaf(s_lg[4 * n + 2 + e], scale_log2, -l1));
        }
      }
      wgmma_wait<0>();
      fence_regs<32>(ah);
      fence_regs<32>(al);
      join(p_lg, p_sm);
      // dS = P (dP - D); keys at or past S get 0
      const int valid = S - j * BT;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool key = 8 * n + 2 * quad + e < valid;
          s_lg[4 * n + e] = key ? s_lg[4 * n + e] * (p_lg[4 * n + e] - d0) : 0.f;
          s_lg[4 * n + 2 + e] = key ? s_lg[4 * n + 2 + e] * (p_lg[4 * n + 2 + e] - d1) : 0.f;
        }
      }
      uint32_t dh[16], dl[16];
      float blk[32];
      acc_frags(dh, dl, s_lg);
      wgmma_fence();
      row_product(blk, dh, dl, stage + 2 * NAT_BYTES);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(dh);
      fence_regs<16>(dl);
      release(sm.empty + 8 * st, lane);  // K, V and K^T of this stage are read
      add_block(acc, blk);
    }
    release(sm.res_empty, lane);  // Q, dO and O are read
    store_rows(dq + base + 2 * quad, row_stride, r0, S, acc, scale);
  }
}

// dK/dV pass. Resident K and V (res 0, 1), streamed Q and dO (each with its
// transpose) and the pairs the dQ pass wrote. Items in reverse order.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const float2* __restrict__ pairs, float* __restrict__ dk,
                         float* __restrict__ dv, int S, int H, int n_items, float scale_log2,
                         float scale) {
  using P = Pass<false>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const Smem sm = setup<false>(smem_raw, bars);

  if (threadIdx.x < 128) {
    setmaxnreg_dec<56>();
    const CUtensorMap* res[2] = {&map_k, &map_v};
    produce<false, true>(sm, res, map_q, map_do, pairs, S, H, n_items);
    return;
  }
  setmaxnreg_inc<224>();
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int row = (t / 32) * 16 + lane / 4;
  const int n_rt = (S + BR - 1) / BR;
  const int n_tiles = (S + BT - 1) / BT;
  const size_t row_stride = (size_t)H * 64;

  int tile = 0, round = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
    const Item it = decode(n_items - 1 - item, n_rt, H);
    const size_t base = (size_t)it.b * S * row_stride + (size_t)it.h * 64;
    const int k0 = it.rt * BR + c * 64 + row;
    const uint32_t k_res = sm.res0 + c * RES_BYTES;
    const uint32_t v_res = k_res + NC * RES_BYTES;

    float dka[32], dva[32];  // dK (unscaled) and dV, 64 keys x 64 dims
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(sm.res_full, round & 1);
    for (int j = 0; j < n_tiles; ++j, ++tile) {
      const int st = tile % STAGES;
      const uint32_t stage = sm.stage0 + st * P::STAGE_BYTES;
      const uint32_t prs = sm.pairs + st * PAIR_BYTES;
      uint32_t ah[32], al[32];
      float s_lg[16], s_sm[16], p_lg[16], p_sm[16];
      resident_frags(ah, al, k_res, row, quad);
      mbar_wait(sm.full + 8 * st, (tile / STAGES) & 1);  // the pairs' bulk copy
      mbar_wait(sm.ready + 8 * st, (tile / STAGES) & 1);
      wgmma_fence();
      score_product(s_lg, s_sm, ah, al, stage);  // S^T = K Q^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(ah);
      fence_regs<32>(al);
      resident_frags(ah, al, v_res, row, quad);
      wgmma_fence();
      score_product(p_lg, p_sm, ah, al, stage + NAT_BYTES);  // dP^T = V dO^T
      wgmma_commit();
      // P^T while dP^T runs: this thread's columns are the tile's queries
      // 8 n + 2 quad + e, whose pairs lie at prs
      join(s_lg, s_sm);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 ld = lds_f4(prs + (8 * n + 2 * quad) * 8);  // queries e = 0, 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s_lg[4 * n + 2 * i] = ex2(fmaf(s_lg[4 * n + 2 * i], scale_log2, -ld.x));
          s_lg[4 * n + 2 * i + 1] = ex2(fmaf(s_lg[4 * n + 2 * i + 1], scale_log2, -ld.z));
        }
      }
      wgmma_wait<0>();
      fence_regs<32>(ah);
      fence_regs<32>(al);
      join(p_lg, p_sm);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 ld = lds_f4(prs + (8 * n + 2 * quad) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          p_lg[4 * n + 2 * i] = s_lg[4 * n + 2 * i] * (p_lg[4 * n + 2 * i] - ld.y);
          p_lg[4 * n + 2 * i + 1] = s_lg[4 * n + 2 * i + 1] * (p_lg[4 * n + 2 * i + 1] - ld.w);
        }
      }
      uint32_t ph[16], pl[16], dh[16], dl[16];
      float blk_v[32], blk_k[32];
      acc_frags(ph, pl, s_lg);
      acc_frags(dh, dl, p_lg);
      wgmma_fence();
      row_product(blk_v, ph, pl, stage + 2 * NAT_BYTES + T_BYTES);  // dV += P^T dO
      wgmma_commit();
      row_product(blk_k, dh, dl, stage + 2 * NAT_BYTES);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<1>();
      add_block(dva, blk_v);
      wgmma_wait<0>();
      fence_regs<16>(ph);
      fence_regs<16>(pl);
      fence_regs<16>(dh);
      fence_regs<16>(dl);
      release(sm.empty + 8 * st, lane);  // Q, dO, their transposes and pairs are read
      add_block(dka, blk_k);
    }
    release(sm.res_empty, lane);  // K and V are read
    store_rows(dk + base + 2 * quad, row_stride, k0, S, dka, scale);
    store_rows(dv + base + 2 * quad, row_stride, k0, S, dva, 1.f);
  }
}

}  // namespace

// All tensors contiguous and 16-byte aligned. q, k, v, o, dout, dq, dk, dv:
// (batch, seq, heads, 64) f32; lse (from segma_flash_attn_fwd_f32): (batch,
// heads, seq) f32; pairs: scratch of (batch, heads, ceil(seq / 128) 128, 2)
// f32, where the dQ pass writes each row's (lse log2(e), rowsum(dout * o))
// for the dK/dV pass. scale_log2 is sm_scale * log2(e), scale is sm_scale.
// Launches the dQ pass, then the dK/dV pass as its programmatic dependent, on
// `stream`, one block per SM (or fewer, one per work item) each. Returns the
// first nonzero cudaGetLastError() after a launch, or cudaErrorInvalidValue
// when a tensor map cannot be encoded.
extern "C" int segma_flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* pairs, void* dq, void* dk, void* dv, int batch,
                                        int seq, int heads, float scale_log2, float scale,
                                        void* stream) {
  alignas(64) CUtensorMap q_res, do_res, o_res, k_str, v_str, k_res, v_res, q_str, do_str;
  if (!bshd_tensor_map(&q_res, q, batch, seq, heads, 64, true) ||
      !bshd_tensor_map(&do_res, dout, batch, seq, heads, 64, true) ||
      !bshd_tensor_map(&o_res, o, batch, seq, heads, 64, true) ||
      !bshd_tensor_map(&k_str, k, batch, seq, heads, BT, true) ||
      !bshd_tensor_map(&v_str, v, batch, seq, heads, BT, true) ||
      !bshd_tensor_map(&k_res, k, batch, seq, heads, 64, true) ||
      !bshd_tensor_map(&v_res, v, batch, seq, heads, 64, true) ||
      !bshd_tensor_map(&q_str, q, batch, seq, heads, BT, true) ||
      !bshd_tensor_map(&do_str, dout, batch, seq, heads, BT, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int n_items = (seq + BR - 1) / BR * heads * batch;
  const int grid = n_items < n_sm ? n_items : n_sm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Pass<true>::SMEM_BYTES);
  cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Pass<false>::SMEM_BYTES);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, Pass<true>::SMEM_BYTES, st>>>(
      q_res, do_res, o_res, k_str, v_str, static_cast<const float*>(lse),
      static_cast<float2*>(pairs), static_cast<float*>(dq), seq, heads, n_items, scale_log2,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Pass<false>::SMEM_BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, flash_bwd_dkv_f32_kernel, k_res, v_res, q_str, do_str,
                     static_cast<const float2*>(pairs), static_cast<float*>(dk),
                     static_cast<float*>(dv), seq, heads, n_items, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
