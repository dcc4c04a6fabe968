// Flash attention forward in f32 for Hopper (sm_90a): 3xTF32 on wgmma.
//
// Replaces: segma_tpu/ops/attention.py:148, _flash_bhsd, on f32 inputs. The
// JAX package hands JAX's bundled Pallas TPU flash_attention (its forward
// pallas_call lives in jax/experimental/pallas/ops/tpu/flash_attention.py)
// q, k and v in the model's dtype, so with train.precision=f32 that kernel
// runs in f32, with the per-row log-sum-exp when the encoder trains.
//
// What it computes: out = softmax(q k^T * sm_scale) v for every (batch,
// head), on q, k, v and out laid out (B, S, H, 64) as the encoders produce
// them. Given a non-null lse pointer it also writes each row's log-sum-exp of
// the scaled scores (natural log, f32, (B, H, S)) for the backward
// (flash_attn_bwd_f32.cu); the output is the same bits with or without it.
//
// What bounds it on this card: two S x S x 64 products, 4 S^2 64 FLOP per
// (batch, head), against 16 S 64 bytes and the lse: 295 GFLOP at (64, 1500,
// 8, 64), 4.40 ms at the 67 TFLOP/s of IEEE f32 on the CUDA cores, 1.79 ms as
// 3xTF32 (three TF32 products each) at the tensor cores' 495 TFLOP/s; 0.058
// and 0.024 ms at (32, 199, 12, 64), where the bytes (19.6 MB) take 0.006
// ms. This design pads the queries to items of 128 and the keys to tiles of
// 32: 1536 x 1504 at S = 1500 (+2.7%), 256 x 224 at S = 199 (+45%). The S^2
// exp2 (1.15e9 at the serving shape, 0.28 ms on the special-function units)
// run beside the products.
//
// Why 3xTF32. One TF32 product keeps 11 bits of each operand and misses the
// f32 bar (atol 2e-5 against float64) 18 times over at S = 199 in the
// emulation (tests/test_torch_flash_f32_tf32.py, emulate_fwd). Each operand
// x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a
// product is lo B_hi + hi B_lo + hi B_hi. The tensor cores' f32 sums
// truncate, so no truncating chain spans more than one tile: S = Q K^T takes
// its large and small terms into two fresh accumulators, added in IEEE f32;
// P V goes into a fresh accumulator per tile, added as O = O alpha + O_tile
// by fmaf on the CUDA cores (one running tensor-core sum for O lands 3 to 12
// times further from float64 in the emulation).
//
// Design (the tiles and products it shares with the backward are sm90.cuh's
// namespace tf32x3). No atomics, and an item's arithmetic does not depend on
// which block runs it: two calls on the same inputs give the same bits.
//  - A work item is 128 query rows of one (batch, head): item = (b H + h)
//    n_qt + qt, so the items in flight are the query tiles of a few (batch,
//    head)s, which read their K and V from L2. One persistent block per SM
//    (fewer if there are fewer items) walks the items blockIdx.x, +
//    gridDim.x, ... A block is three warpgroups.
//  - Warpgroup 0, thread 0: TMA through 3-D tensor maps {H 64, S, B} of f32,
//    each 64 columns as two boxes of 32 (128 bytes, 128-byte swizzle), rows
//    past S zero-filled: K and V in tiles of BT = 32 keys through a ring of
//    STAGES stages (full, ready and empty mbarriers per stage), and each
//    item's Q raw, once both consumers are done with the last item's. An
//    item's first STAGES tiles are loaded before its Q, into the stages the
//    last item frees.
//  - Warpgroup 0, warps 1-3: the converters. Per stage, K is rewritten in
//    place as its TF32 hi part with its lo part beside it, head dims
//    permuted within each 16; V is written transposed ([64 dims][32 keys]) in
//    hi and lo, its keys permuted within each 8 so that the score
//    accumulator's registers are P's A fragments (a TF32 wgmma reads B only
//    K-major, and V is MN-major for P V). Per item, Q in place as hi and lo
//    with K's permutation (the A operand of the score product, from shared
//    memory). Then fence.proxy.async and the ready barrier.
//  - Warpgroups 1 and 2, the consumers, 64 query rows each, on the same K
//    and V tiles. They take turns on the tensor cores through two named
//    barriers: in its turn a consumer issues S_j = Q K_j^T (24 wgmma
//    m64n32k8, both operands in shared memory) and O_tile = P_{j-1} V_{j-1}
//    (12 wgmma m64n64k8, P from registers), hands the turn over, and runs
//    the softmax of tile j on the CUDA cores as soon as S_j is in, while its
//    P V and the other consumer's products run. The first tile is peeled, so
//    no wgmma sits under a condition (ptxas would serialise them all).
//  - Softmax, per row, in the exp2 domain with c = sm_scale log2(e): keys
//    at or past S get -inf (by index: TMA's zero rows would score 0); the
//    running max m of the raw scores and ms = m c (rounded, __fmul_rn);
//    alpha = exp2(ms_old - ms); P = exp2(fmaf(s, c, -ms)); l = fmaf(l,
//    alpha, the thread's sum over its 8 columns); O = fmaf(O, alpha, O_tile).
//    Key 0 lies in the first tile, so every max is finite from then on.
//  - Epilogue: the four threads' row sums, O / l for rows < S; the LSE (ms
//    + log2 l) ln 2, from the ms that P was taken against.
//
// What limits it (flash_f32_ablations.py fwd on an H100 80GB HBM3 at 700 W,
// timing-only ablations): the converters, taking their work out saves 21%
// (training shape) to 31% (serving shape), and taking out K's split or V's
// transpose alone saves 8% to 19%, so their latency (three warps working
// unit by unit while the consumers' wgmma reads fill shared memory) is in
// the way more than their work; then the tensor-core products (one TF32
// product instead of three saves 12% to 17% in the scores, 11% to 15% in
// P V); the exp2 nothing measurable. Kept against its variants (same bits):
// Q split once per item into shared memory, not per tile into registers
// (+5% to +8%); two consumers, not one (+40%); four stages, not three (+4.6%
// at the training shape); setmaxnreg (+4% to +8% without it).
//
// Shared memory (230,400 bytes of the 232,448 a block may have):
//   Q, 2 consumers x 64 rows x 256 bytes x (hi, lo)                  =  64 KB
//   ring 4 stages x (K hi + lo 16 KB, V raw 8 KB, V^T hi + lo 16 KB)  = 160 KB
//   + 1 KB for the 1024-byte alignment of the swizzled tiles.
// Registers: 384 threads at one block per SM give 168 a thread at launch;
// setmaxnreg moves them to 56 for warpgroup 0 and 224 for the consumers, but
// ptxas holds every thread to the launch's 168 (8 bytes spilled). A
// consumer's peak: O (32), O_tile (32), the two score accumulators (32) and
// P's A fragments in hi and lo (32).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace tf32x3;

constexpr int NC = 2;                    // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NC;              // query rows per work item
constexpr int STAGES = 4;                // K and V tiles in flight
constexpr int THREADS = 128 * (NC + 1);  // producer and converters, consumers
constexpr int CONVERTERS = 96;           // warps 1-3 of warpgroup 0
constexpr int Q_PART = 2 * RES_HALF;     // a consumer's 64 query rows, hi (or lo): 16 KB
constexpr int Q_BYTES = 2 * Q_PART;      // hi, then lo
constexpr int V_OFF = 2 * PART;          // a stage: K hi and lo, V raw, V^T hi and lo
constexpr int VT_OFF = V_OFF + PART;
constexpr int STAGE_BYTES = VT_OFF + 2 * T_PART;  // 40 KB
constexpr int STAGE_OFF = NC * Q_BYTES;
constexpr int SMEM_BYTES = STAGE_OFF + STAGES * STAGE_BYTES + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "shared memory");
constexpr float LN2 = 0.6931471805599453f;

// The converters' work on one stage: K ([32 keys][64], two halves) in place
// as hi, lo PART bytes on; V into V^T ([64 dims][32 keys], hi, then lo
// T_PART bytes on), key c at slot t_slot(c).
// Thread `tid` < 96 is key tid % 32 of groups tid / 32, + 3, + 6 of the 8
// (tensor, 16 dims).
__device__ __forceinline__ void convert_stage(uint32_t stage, int tid) {
  const int row = tid % 32;
  for (int g = tid / 32; g < 8; g += 3) {
    const int half = (g >> 1) & 1, jj = g & 1;
    uint32_t hi[4][4], lo[4][4];
    if (g < 4) {
      const uint32_t k = stage + half * NAT_HALF;
      split16(hi, lo, k, row, jj);
      store16(k, PART, row, jj, hi, lo);
    } else {
      split16(hi, lo, stage + V_OFF + half * NAT_HALF, row, jj);
      store16_t(stage + VT_OFF, t_slot(row), half, jj, hi, lo);
    }
  }
  fence_proxy_async();
}

// The converters' work on an item's Q (NC tiles of 64 rows, two halves each,
// raw at q): in place as hi with K's permutation, lo Q_PART bytes on. A
// warp's 32 units are 32 rows of one 16 dims.
__device__ __forceinline__ void convert_q(uint32_t q, int tid) {
  for (int u = tid; u < BQ * 4; u += CONVERTERS) {
    const int row = u % BQ, g = u / BQ;
    const uint32_t half = q + (row / 64) * Q_BYTES + (g >> 1) * RES_HALF;
    uint32_t hi[4][4], lo[4][4];
    split16(hi, lo, half, row % 64, g & 1);
    store16(half, Q_PART, row % 64, g & 1, hi, lo);
  }
  fence_proxy_async();
}

// s = Q K^T over the 64 head dims, Q a consumer's converted rows at q, K the
// stage's: the small terms into sm, the large into lg, both fresh
__device__ __forceinline__ void qk_product(float (&lg)[16], float (&sm)[16], uint32_t q,
                                           uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t qa = q + (kk >> 2) * RES_HALF + (kk & 3) * 32;
    const uint32_t kb = k + (kk >> 2) * NAT_HALF + (kk & 3) * 32;
    const uint64_t a_hi = sw128_desc(qa), a_lo = sw128_desc(qa + Q_PART);
    const uint64_t b_hi = sw128_desc(kb), b_lo = sw128_desc(kb + PART);
    if (kk == 0) {
      wgmma_m64n32k8_tf32_ss_zero_d(sm, a_lo, b_hi);
      wgmma_m64n32k8_tf32_ss(sm, a_hi, b_lo);
      wgmma_m64n32k8_tf32_ss_zero_d(lg, a_hi, b_hi);
    } else {
      wgmma_m64n32k8_tf32_ss(sm, a_lo, b_hi);
      wgmma_m64n32k8_tf32_ss(sm, a_hi, b_lo);
      wgmma_m64n32k8_tf32_ss(lg, a_hi, b_hi);
    }
  }
}

// One key tile of the online softmax (see the note above) on the joined
// scores s of rows row (i = 0) and row + 8 (i = 1): keys past the first
// `valid` of the tile get -inf; m, ms and l move on; alpha gets the factor O
// and l take; s gets P. s[4 n + 2 i + e] is (row + 8 i, key 8 n + 2 quad + e).
__device__ __forceinline__ void softmax_tile(float (&s)[16], float (&m)[2], float (&ms)[2],
                                             float (&l)[2], float (&alpha)[2], int valid,
                                             int quad, float c) {
  if (valid < BT) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * n + 2 * quad + e >= valid) {
          s[4 * n + e] = -INFINITY;
          s[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int n = 0; n < 4; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    m[i] = mx;
    const float ms_new = __fmul_rn(mx, c);  // never fused into the fmaf below
    alpha[i] = ex2(ms[i] - ms_new);
    ms[i] = ms_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& p = s[4 * n + 2 * i + e];
        p = ex2(fmaf(p, c, -ms_new));
        sum += p;
      }
    }
    l[i] = fmaf(l[i], alpha[i], sum);
  }
}

// O = fmaf(O, alpha, blk) in IEEE f32, once the product that wrote blk is
// done; rows row and row + 8 take alpha[0] and alpha[1]
__device__ __forceinline__ void rescale_add(float (&o)[32], float (&blk)[32],
                                            const float (&alpha)[2]) {
  fence_regs<32>(blk);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[4 * n + 2 * i + e] = fmaf(o[4 * n + 2 * i + e], alpha[i], blk[4 * n + 2 * i + e]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int n_items, float c) {
  extern __shared__ uint8_t smem_raw[];
  // full, ready and empty per stage; Q full, Q ready, Q empty
  __shared__ __align__(8) uint64_t bars[3 * STAGES + 3];
  const uint32_t q_smem = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzled tiles
  const uint32_t stage0 = q_smem + STAGE_OFF;
  const uint32_t full = smem_addr(&bars[0]);  // + 8 stage
  const uint32_t ready = smem_addr(&bars[STAGES]);
  const uint32_t empty = smem_addr(&bars[2 * STAGES]);
  const uint32_t q_full = smem_addr(&bars[3 * STAGES]);
  const uint32_t q_ready = q_full + 8;
  const uint32_t q_empty = q_full + 16;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_tiles = (S + BT - 1) / BT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, CONVERTERS / 32);  // one arrival per converter warp
      mbar_init(empty + 8 * s, 4 * NC);           // one per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_ready, CONVERTERS / 32);
    mbar_init(q_empty, 4 * NC);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<56>();
    const int early = n_tiles < STAGES ? n_tiles : STAGES;
    if (threadIdx.x == 0) {
      // per item: its first tiles into the stages the last item frees, its Q
      // once both consumers are done with the last one, then its other tiles
      prefetch_tensor_map(&map_q);
      prefetch_tensor_map(&map_k);
      prefetch_tensor_map(&map_v);
      int tile = 0, round = 0;
      auto load_tile = [&](const Item& it, int j) {
        const int st = tile % STAGES;
        if (tile >= STAGES) mbar_wait(empty + 8 * st, ((tile / STAGES) + 1) & 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t stage = stage0 + st * STAGE_BYTES;
        mbar_arrive_expect_tx(bar, 2 * PART);
        tma_load_3d(stage, &map_k, it.h * 64, j * BT, it.b, bar);
        tma_load_3d(stage + NAT_HALF, &map_k, it.h * 64 + 32, j * BT, it.b, bar);
        tma_load_3d(stage + V_OFF, &map_v, it.h * 64, j * BT, it.b, bar);
        tma_load_3d(stage + V_OFF + NAT_HALF, &map_v, it.h * 64 + 32, j * BT, it.b, bar);
        ++tile;
      };
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
        const Item it = decode(item, n_qt, H);
        for (int j = 0; j < early; ++j) load_tile(it, j);
        if (round >= 1) mbar_wait(q_empty, (round - 1) & 1);
        mbar_arrive_expect_tx(q_full, NC * Q_PART);
#pragma unroll
        for (int i = 0; i < 2 * NC; ++i) {
          tma_load_3d(q_smem + (i >> 1) * Q_BYTES + (i & 1) * RES_HALF, &map_q,
                      it.h * 64 + 32 * (i & 1), it.rt * BQ + (i >> 1) * 64, it.b, q_full);
        }
        for (int j = early; j < n_tiles; ++j) load_tile(it, j);
      }
    } else if (threadIdx.x >= 32) {
      // in the producer's order: an item's first tiles, its Q, its other tiles
      const int tid = threadIdx.x - 32;
      int tile = 0, round = 0;
      auto convert_tile = [&]() {
        const int st = tile % STAGES;
        mbar_wait(full + 8 * st, (tile / STAGES) & 1);
        convert_stage(stage0 + st * STAGE_BYTES, tid);
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(ready + 8 * st);
        ++tile;
      };
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
        for (int j = 0; j < early; ++j) convert_tile();
        mbar_wait(q_full, round & 1);
        convert_q(q_smem, tid);
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(q_ready);
        for (int j = early; j < n_tiles; ++j) convert_tile();
      }
    }
    return;
  }

  setmaxnreg_inc<224>();
  const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int row = (t / 32) * 16 + lane / 4;  // this thread's rows row, row + 8 of 64
  // the turn barriers: consumer cw waits on 1 + cw and hands over to the other
  const uint32_t my_turn = 1 + cw;
  const uint32_t other_turn = 2 - cw;
  const uint32_t q_mine = q_smem + cw * Q_BYTES;
  const size_t row_stride = (size_t)H * 64;

  // Consumer 0 goes first. Each turn barrier then sees as many arrivals as
  // waits: consumer 1 skips its hand-over on its last turn.
  if (cw == 1) named_arrive(other_turn, 128 * NC);
  const int last_item = n_items - 1 - (n_items - 1 - (int)blockIdx.x) % (int)gridDim.x;

  int tile = 0, round = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
    const Item it = decode(item, n_qt, H);
    const bool last_turns = item == last_item;
    float acc[32];  // O: acc[4 n + 2 i + e] = (row + 8 i, col 8 n + 2 quad + e)
    float lg[16], sm[16], blk[32];
    uint32_t ph[16], pl[16];  // P in TF32 hi and lo: the A fragments of P V
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, ms[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f}, alpha[2], next[2];

    // Tile 0: Q K_0^T alone. Then, per tile j, Q K_j^T and P_{j-1} V_{j-1}
    // in one turn, as two commit groups.
    mbar_wait(q_ready, round & 1);
    int st = tile % STAGES;
    mbar_wait(ready + 8 * st, (tile / STAGES) & 1);
    named_sync(my_turn, 128 * NC);
    wgmma_fence();
    qk_product(lg, sm, q_mine, stage0 + st * STAGE_BYTES);
    wgmma_commit();
    if (cw == 0 || !(last_turns && n_tiles == 1)) named_arrive(other_turn, 128 * NC);
    wgmma_wait<0>();
    join(lg, sm);
    if (n_tiles == 1) release(q_empty, lane);  // Q is read
    softmax_tile(lg, m, ms, l, alpha, S, quad, c);
    acc_frags(ph, pl, lg);

    for (int j = 1; j < n_tiles; ++j) {
      const int prev = st;
      ++tile;
      st = tile % STAGES;
      mbar_wait(ready + 8 * st, (tile / STAGES) & 1);
      named_sync(my_turn, 128 * NC);
      wgmma_fence();
      qk_product(lg, sm, q_mine, stage0 + st * STAGE_BYTES);
      wgmma_commit();
      row_product(blk, ph, pl, stage0 + prev * STAGE_BYTES + VT_OFF);
      wgmma_commit();
      if (cw == 0 || !(last_turns && j + 1 == n_tiles)) named_arrive(other_turn, 128 * NC);
      wgmma_wait<1>();  // the scores of tile j
      join(lg, sm);
      if (j + 1 == n_tiles) release(q_empty, lane);  // Q is read
      softmax_tile(lg, m, ms, l, next, S - j * BT, quad, c);
      wgmma_wait<0>();  // P_{j-1} V_{j-1}
      fence_regs<16>(ph);
      fence_regs<16>(pl);
      release(empty + 8 * prev, lane);  // K_{j-1}, V_{j-1} are read
      rescale_add(acc, blk, alpha);
      alpha[0] = next[0];
      alpha[1] = next[1];
      acc_frags(ph, pl, lg);
    }

    // the last tile's P V
    wgmma_fence();
    row_product(blk, ph, pl, stage0 + st * STAGE_BYTES + VT_OFF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(ph);
    fence_regs<16>(pl);
    release(empty + 8 * st, lane);
    rescale_add(acc, blk, alpha);
    ++tile;

    const int r0 = it.rt * BQ + cw * 64 + row;
    float* ob = o + (size_t)it.b * S * row_stride + (size_t)it.h * 64 + 2 * quad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = r0 + 8 * i;
      if (r < S) {
        const float inv = 1.f / l[i];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<float2*>(ob + r * row_stride + 8 * n) =
              make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
        }
        // ln(sum exp(score * sm_scale)) = (ms + log2(l)) ln 2
        if (lse != nullptr && quad == 0) {
          lse[((size_t)it.b * H + it.h) * S + r] = (ms[i] + log2f(l[i])) * LN2;
        }
      }
    }
  }
}

}  // namespace

// q, k, v, o: contiguous (batch, seq, heads, 64) f32, 16-byte aligned. lse:
// null, or contiguous (batch, heads, seq) f32. scale_log2 is sm_scale *
// log2(e). Launches one block per SM (or fewer, one per work item), each
// looping over work items. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
extern "C" int segma_flash_attn_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int batch, int seq, int heads,
                                        float scale_log2, void* stream) {
  alignas(64) CUtensorMap map_q, map_k, map_v;
  if (!bshd_tensor_map(&map_q, q, batch, seq, heads, 64, true) ||
      !bshd_tensor_map(&map_k, k, batch, seq, heads, BT, true) ||
      !bshd_tensor_map(&map_v, v, batch, seq, heads, BT, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int n_items = (seq + BQ - 1) / BQ * heads * batch;
  cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  flash_fwd_f32_kernel<<<n_items < n_sm ? n_items : n_sm, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<float*>(o), static_cast<float*>(lse), seq, heads, n_items,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}
