// Fused Whisper log-mel frontend for Hopper (sm_90a): the DFT as 3xTF32 wgmma.
//
// Replaces: segma_tpu/ops/pallas_melspec.py, log_mel_spectrogram_pallas and its
// kernel body _logmel_kernel (the Pallas TPU kernel), which runs the DFT on the
// matrix unit at Precision.HIGHEST (f32 emulated by several bf16 passes).
//
// What it computes, for every frame f of a (B, T) waveform x, centred with
// reflect padding of 200 (frame f covers x[160 f - 200, 160 f + 200), index -i
// reading x[i] and T - 1 + i reading x[T - 1 - i]), n < 400, m < 80:
//   re[k]  = sum_n xf[n] cos_w[n][k],  im[k] = sum_n xf[n] sin_w[n][k]
//   mel[m] = sum_k (re[k]^2 + im[k]^2) fb[k][m]
//   out    = log10(max(mel, 1e-10)), (B, T / 160, 80)
// cos_w, sin_w are the Hann-windowed DFT basis. Bins 0 and 200 have no weight
// in the slaney filterbank, so bins 0..199 are computed: 5 chunks of 40. The
// per-example max - 8 clamp and (x + 4) / 4 stay in torch (ops/logmel.py).
//
// What bounds it on this card: the bytes, 640 in and 320 out per frame, 0.055
// ms at (64, 480000) at 3.35 TB/s. The function needs fewer operations than
// that takes: a 400-point real FFT, the power and the 391 weights of the
// sparse mel are about 10.4 kFLOP per frame, 0.030 ms at the f32 peak. This
// kernel does the DFT densely instead, as the TPU kernel does on its matrix
// unit: 2 x 2 x 400 x 201 FLOP per frame, a floor of 1.01 ms in exact f32 on
// the CUDA cores (67 TFLOP/s). One TF32 product misses the frontend's
// tolerance by two orders of magnitude; 3xTF32 does not: each f32 operand is
// split into a TF32 part hi and a TF32 remainder lo, and lo B_hi + hi B_lo +
// hi B_hi keeps about 21 bits of every product at three TF32 products, a
// floor of 0.37 ms at the tensor cores' 495 TFLOP/s.
//
// Accumulation. The tensor cores' f32 sums truncate: each sum a product
// group ends in loses up to one ulp of the terms it adds, twice the reach of
// a round to nearest. Where a bin's terms cancel, that error is large next to
// the bin. So the large terms hi B_hi of each 16 samples go to a fresh
// accumulator (zero_d), added into the chunk's sum in IEEE f32 on the CUDA
// cores; the small terms lo B_hi + hi B_lo (2^-11 of the others) stay in one
// accumulator across the chunk (restarting it per block makes no output more
// exact); the two are added at the chunk's end.
//
// Each frame's mean out first. A signal with low-frequency content rides on
// an offset that is large next to its quiet bins (brown noise, hum, a
// microphone's DC): every product, so every truncation, scales with it. The
// consumers take each frame's mean m (its 400 samples summed in f32 in a
// fixed order) out of its samples before the split, carrying the rounding of
// x - m exactly into the low part (TwoSum), and add m times the basis' column
// sums (ops/logmel.py, kernel_colsums: 200 and -100 at bins 0 and 1, about 0
// elsewhere) to each bin at the chunk's end: the DFT is linear. On brown
// noise this takes the outputs more than 1e-5 from float64 from 2.4x the
// plain version's count to none (PERF.md). A fresh large-term accumulator
// per 8 samples, without the mean taken out, took out only 12% of them.
//
// Design. A work item is 128 consecutive frames of one example; one
// persistent block per SM walks the items. Three warpgroups:
//  - Warpgroup 0, warp 0: one thread streams the basis by TMA through a ring
//    of STAGES shared-memory stages, from one 3-D map over the (2, 400, 400)
//    table: the hi and the lo part, each 5 chunks of 40 cos rows and 40 sin
//    rows, bins-major because a TF32 wgmma takes B K-major only. A stage is
//    16 samples of one chunk's 80 rows of both parts, 64-byte swizzled. The
//    basis (1.3 MB) stays in L2 and is read once per item.
//  - Warpgroup 0, warps 1-3: stage each item's samples in rows of 160 at a
//    padded stride of 164 floats (conflict-free fragment reads) by 4-byte
//    cp.async, with the reflection folded into the source index: no padded
//    copy of the waveform exists. Two span buffers let the next item's
//    samples land while this one runs.
//  - Warpgroups 1 and 2: 64 frames each. Per item, the means of the frames
//    from the span first. Sample n of frame r is span row
//    r + n / 160, column n % 160 (frames overlap by 240 samples), which a
//    register A operand reads at any offset: each thread loads its m16n8k8
//    fragments and splits them with cvt.rna.tf32. Per k-step of 8 samples,
//    three wgmma m64n80k8 (B's 80 columns are the chunk's cos and sin rows),
//    so one thread holds re and im of the same (frame, bin).
//  - After each chunk of 40 bins, in f32 on the CUDA cores: the consumers
//    write power re^2 + im^2 into a shared tile of the item's 128 rows, and
//    warps 1-3 of warpgroup 0 project it while the consumers run the next
//    chunk, with the sparse slaney filterbank (391 weights; each filter is a
//    run of at most 14 bins, each bin feeds mels m and m + 1): thread (row,
//    parity) walks the chunk's 40 bins in one unrolled pass, summing the one
//    run of its parity that holds each bin (a run crossing into the next
//    chunk stays in its register), and writes log10(max(mel, 1e-10)) at a
//    run's last bin.
// No atomics, and an item's arithmetic does not depend on the block that runs
// it: two calls on the same inputs give the same bits.
//
// What limits it (logmel_ablations.py times each piece taken out): the chain
// on the CUDA cores between two waits for the tensor cores (the IEEE adds,
// and the mel warps' issue slots), not the basis stream. Each item
// rereads the 1.3 MB basis from L2 (about 2 GB per launch at (64, 480000)),
// yet loading half of it, or none, is no faster. So 128 frames per basis
// pass are kept: a cluster of 2 blocks multicasting each stage (256 frames
// per pass) ran slower, each stage then waiting for the slower block with
// only 3 stages of slack (shared memory holds no more beside two spans),
// and two m64 products per warpgroup would need 240 accumulator registers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int HOP = 160;
constexpr int NFFT = 400;
constexpr int NMELS = 80;
constexpr int NBINS = 200;
constexpr int NCB = 40;              // bins per chunk; the wgmma N is re and im: 80
constexpr int NCHUNK = NBINS / NCB;  // 5
constexpr int KB = 16;               // samples per basis stage: 64 bytes of f32
constexpr int NKB = NFFT / KB;       // 25
constexpr int NC = 2;                // consumer warpgroups, 64 frames each
constexpr int M = 64 * NC;           // frames per item
constexpr int SPAN_ROWS = M + 2;     // frame r reads rows r, r + 1 and r + 2
constexpr int SPAN_LD = HOP + 4;     // padded row stride, in floats
constexpr int SPAN_BYTES = SPAN_ROWS * SPAN_LD * 4;
constexpr int SPAN_BUFS = 2;
constexpr int STAGES = 3;
constexpr int PART_TILE = 2 * NCB * KB * 4;  // the hi or the lo part: 80 rows x 16, 5120 bytes
constexpr int STAGE_BYTES = 2 * PART_TILE;
constexpr int PS = NCB + 1;  // power tile row stride, in floats
constexpr int POWER_BYTES = M * PS * 4;
constexpr int STAGERS = 96;  // warps 1-3 of warpgroup 0: samples and mels
constexpr int THREADS = 128 * (NC + 1);
constexpr int SPAN_OFF = STAGES * STAGE_BYTES;
constexpr int POWER_OFF = SPAN_OFF + SPAN_BUFS * SPAN_BYTES;
constexpr int SMEM_BYTES = POWER_OFF + POWER_BYTES + 1024;  // + alignment slack
// the mel tables (ops/logmel.py, mel_bin_tables): per chunk, mel parity and
// bin, a weight and {mel | MEL_FIRST | MEL_LAST}
constexpr int MEL_TABLE = NCHUNK * 2 * NCB;
constexpr int MEL_FIRST = 1 << 8;  // the first bin of the mel's run: start from zero
constexpr int MEL_LAST = 1 << 9;   // its last bin: write the output

// raw samples of this thread's A fragments for K-block kb (two k-steps of 8):
// x[s] = (row, k), (row + 8, k), (row, k + 4), (row + 8, k + 4)
__device__ __forceinline__ void load_fragments(float (&x)[2][4], const float* arow, int kb) {
  const int n0 = kb * KB;
  const int j = n0 / HOP;  // a K-block never crosses a row: 160 = 10 x 16
  const float* p = arow + j * SPAN_LD + (n0 - j * HOP);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    x[s][0] = p[8 * s];
    x[s][1] = p[8 * SPAN_LD + 8 * s];
    x[s][2] = p[8 * s + 4];
    x[s][3] = p[8 * SPAN_LD + 8 * s + 4];
  }
}

// Issue the cp.async copies of item `item`'s samples into the span at shared
// address dst: row i holds padded samples 160 (f0 + i) + u, u < 160, that is
// x[160 (f0 + i) + u - 200] reflected at both ends; rows past the last
// frame's reach read zeros.
__device__ __forceinline__ void stage_span(const float* wav, uint32_t dst, int item, int n_ft,
                                           int T, int tid) {
  const int b = item / n_ft;
  const int f0 = (item - b * n_ft) * M;
  const float* xb = wav + (size_t)b * T;
  for (int e = tid; e < SPAN_ROWS * HOP; e += STAGERS) {
    const int i = e / HOP;
    const int u = e - i * HOP;
    int xi = (f0 + i) * HOP + u - NFFT / 2;
    if (xi < 0) xi = -xi;
    if (xi >= T) xi = 2 * (T - 1) - xi;
    const bool valid = xi >= 0 && xi < T;
    cp_async_4(dst + (i * SPAN_LD + u) * 4, valid ? xb + xi : xb, valid);
  }
}

// acc += blk in IEEE f32 on the CUDA cores, once the products that wrote blk
// are done (see the accumulation note above)
__device__ __forceinline__ void add_block(float (&acc)[40], float (&blk)[40]) {
  fence_regs<40>(blk);
#pragma unroll
  for (int i = 0; i < 40; ++i) acc[i] += blk[i];
}

__global__ void __launch_bounds__(THREADS, 1)
logmel_kernel(const __grid_constant__ CUtensorMap map_basis, const float* __restrict__ wav,
              const int* __restrict__ mel_meta, const float* __restrict__ mel_weights,
              const float* __restrict__ colsum,
              float* __restrict__ out, int T, int n_frames, int n_ft, int n_items) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 2 * SPAN_BUFS + 2];
  __shared__ int s_meta[MEL_TABLE];
  __shared__ float s_weight[MEL_TABLE];
  __shared__ float s_colsum[NCHUNK * 2 * NCB];

  // 64-byte swizzled tiles need 512-byte aligned bases
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t stage_smem = raw + pad;                 // + stage * STAGE_BYTES
  const uint32_t full_bar = smem_addr(&bars[0]);         // + 8 stage
  const uint32_t empty_bar = smem_addr(&bars[STAGES]);   // + 8 stage
  const uint32_t span_full = smem_addr(&bars[2 * STAGES]);               // + 8 buf
  const uint32_t span_empty = smem_addr(&bars[2 * STAGES + SPAN_BUFS]);  // + 8 buf
  const uint32_t power_full = smem_addr(&bars[2 * STAGES + 2 * SPAN_BUFS]);
  const uint32_t power_empty = power_full + 8;
  const int wg = threadIdx.x / 128;

  for (int i = threadIdx.x; i < MEL_TABLE; i += THREADS) {
    s_meta[i] = mel_meta[i];
    s_weight[i] = mel_weights[i];
  }
  for (int i = threadIdx.x; i < NCHUNK * 2 * NCB; i += THREADS) s_colsum[i] = colsum[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * NC);  // one arrival per consumer warp
    }
    for (int b = 0; b < SPAN_BUFS; ++b) {
      mbar_init(span_full + 8 * b, STAGERS);  // one per staging thread's copies
      mbar_init(span_empty + 8 * b, 4 * NC);
    }
    mbar_init(power_full, 4 * NC);        // one arrival per consumer warp
    mbar_init(power_empty, STAGERS / 32);  // one per mel warp
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<80>();
    if (threadIdx.x == 0) {
      // the basis: every item walks chunks x K-blocks in the consumers' order
      prefetch_tensor_map(&map_basis);
      int stage = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        for (int ch = 0; ch < NCHUNK; ++ch) {
          for (int kb = 0; kb < NKB; ++kb, ++stage) {
            const int st = stage % STAGES;
            if (stage >= STAGES) mbar_wait(empty_bar + 8 * st, ((stage / STAGES) + 1) & 1);
            const uint32_t full = full_bar + 8 * st;
            mbar_arrive_expect_tx(full, STAGE_BYTES);
            tma_load_3d(stage_smem + st * STAGE_BYTES, &map_basis, kb * KB, ch * 2 * NCB, 0,
                        full);
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      // warps 1-3: stage each item's samples one item ahead, and project each
      // chunk's power tile onto the mels while the consumers run the next chunk
      const int tid = threadIdx.x - 32;
      const int lane = tid % 32;
      if (blockIdx.x < n_items) stage_span(wav, stage_smem + SPAN_OFF, blockIdx.x, n_ft, T, tid);
      cp_async_mbar_arrive(span_full);
      const float* power = reinterpret_cast<const float*>(base + POWER_OFF);
      int round = 0, pchunk = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
        const int next = item + gridDim.x;
        if (next < n_items) {
          const int buf = (round + 1) % SPAN_BUFS;
          if (round + 1 >= SPAN_BUFS) {
            mbar_wait(span_empty + 8 * buf, (((round + 1) / SPAN_BUFS) - 1) & 1);
          }
          stage_span(wav, stage_smem + SPAN_OFF + buf * SPAN_BYTES, next, n_ft, T, tid);
          cp_async_mbar_arrive(span_full + 8 * buf);
        }
        const int b = item / n_ft;
        const int f0 = (item - b * n_ft) * M;
        // (row, parity) pairs tid, tid + 96 and tid + 192 of the item's 2 x 128,
        // each warp's 32 of one parity
        float mel[3] = {0.f, 0.f, 0.f};  // each pair's current run, carried across chunk edges
        for (int ch = 0; ch < NCHUNK; ++ch, ++pchunk) {
          mbar_wait(power_full, pchunk & 1);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int pair = tid + STAGERS * q;
            if (pair < 2 * M) {
              const int row = pair % M;
              const int* meta = s_meta + (ch * 2 + pair / M) * NCB;
              const float* weight = s_weight + (ch * 2 + pair / M) * NCB;
              const float* pw = power + row * PS;
              const int frame = f0 + row;
              float* orow = out + ((size_t)b * n_frames + frame) * NMELS;
#pragma unroll
              for (int k = 0; k < NCB; ++k) {
                const int m = meta[k];
                mel[q] = fmaf(pw[k], weight[k], (m & MEL_FIRST) ? 0.f : mel[q]);
                if ((m & MEL_LAST) && frame < n_frames) {
                  orow[m & 0xFF] = log10f(fmaxf(mel[q], 1e-10f));
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(power_empty);
        }
      }
    }
  } else {
    setmaxnreg_inc<208>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int quad = lane % 4;
    // this thread's rows of the power tile: 64 c + 16 warp + lane / 4, and + 8
    float* power = reinterpret_cast<float*>(base + POWER_OFF) + (64 * c + 16 * warp + lane / 4) * PS;
    int stage = 0, round = 0, pchunk = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++round) {
      const int buf = round % SPAN_BUFS;
      const float* span = reinterpret_cast<const float*>(base + SPAN_OFF + buf * SPAN_BYTES);
      // this thread's fragment rows: 64 c + 16 warp + lane / 4, and + 8
      const float* arow = span + (64 * c + 16 * warp + lane / 4) * SPAN_LD + quad;
      mbar_wait(span_full + 8 * buf, (round / SPAN_BUFS) & 1);
      // the means of this thread's frames, rows r and r + 8: the 4 threads of a
      // quad read all 400 samples of both between them, in a fixed order
      float mean0 = 0.f, mean1 = 0.f;
      for (int kb = 0; kb < NKB; ++kb) {
        float x[2][4];
        load_fragments(x, arow, kb);
        mean0 += (x[0][0] + x[0][2]) + (x[1][0] + x[1][2]);
        mean1 += (x[0][1] + x[0][3]) + (x[1][1] + x[1][3]);
      }
      mean0 += __shfl_xor_sync(0xffffffffu, mean0, 1);
      mean0 += __shfl_xor_sync(0xffffffffu, mean0, 2);
      mean1 += __shfl_xor_sync(0xffffffffu, mean1, 1);
      mean1 += __shfl_xor_sync(0xffffffffu, mean1, 2);
      mean0 *= 1.f / NFFT;
      mean1 *= 1.f / NFFT;

      for (int ch = 0; ch < NCHUNK; ++ch, ++pchunk) {
        // acc[4 j + 2 i + e] is (row + 8 i, column 8 j + 2 quad + e): re of bin
        // 8 j + 2 quad + e for j < 5, im of bin 8 (j - 5) + 2 quad + e after
        float acc[40], sml[40], blk[40];
#pragma unroll
        for (int i = 0; i < 40; ++i) acc[i] = sml[i] = 0.f;
        float x[2][4];
        uint32_t hi[2][4], lo[2][4];
        load_fragments(x, arow, 0);
        for (int kb = 0; kb < NKB; ++kb, ++stage) {
          const int st = stage % STAGES;
          mbar_wait(full_bar + 8 * st, (stage / STAGES) & 1);
          if (kb > 0) {
            // the last K-block's products are done: its A registers and stage are free
            wgmma_wait<0>();
            fence_regs<8>(&hi[0][0]);
            fence_regs<8>(&lo[0][0]);
            fence_regs<40>(sml);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_bar + 8 * ((stage - 1) % STAGES));
            add_block(acc, blk);
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              // x - mean as xc + err exactly (TwoSum), split into TF32 hi and
              // lo; x[s][0], x[s][2] are of row r, x[s][1], x[s][3] of row r + 8
              const float m = (r & 1) ? mean1 : mean0;
              const float xc = x[s][r] - m;
              const float bb = xc - x[s][r];
              const float err = (x[s][r] - (xc - bb)) + (-m - bb);
              hi[s][r] = to_tf32(xc);
              lo[s][r] = to_tf32((xc - __uint_as_float(hi[s][r])) + err);
            }
          }
          // the stage: B_hi then B_lo, 80 rows each (40 cos, 40 sin bins); k-step
          // s starts 32 bytes into every row
          const uint64_t b_hi = sw64_desc(stage_smem + st * STAGE_BYTES);
          const uint64_t b_lo = b_hi + (PART_TILE >> 4);
          wgmma_fence();
          wgmma_m64n80k8_tf32_rs(sml, lo[0], b_hi);
          wgmma_m64n80k8_tf32_rs(sml, hi[0], b_lo);
          wgmma_m64n80k8_tf32_rs_zero_d(blk, hi[0], b_hi);
          wgmma_m64n80k8_tf32_rs(sml, lo[1], b_hi + 2);
          wgmma_m64n80k8_tf32_rs(sml, hi[1], b_lo + 2);
          wgmma_m64n80k8_tf32_rs(blk, hi[1], b_hi + 2);
          wgmma_commit();
          if (kb + 1 < NKB) load_fragments(x, arow, kb + 1);
        }
        wgmma_wait<0>();
        fence_regs<8>(&hi[0][0]);
        fence_regs<8>(&lo[0][0]);
        fence_regs<40>(sml);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * ((stage - 1) % STAGES));
        add_block(acc, blk);
#pragma unroll
        for (int i = 0; i < 40; ++i) acc[i] += sml[i];
        // the means' share: mean times the column sum of the basis, per bin
#pragma unroll
        for (int j = 0; j < 10; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float cs = s_colsum[ch * 2 * NCB + 8 * j + 2 * quad + e];
            acc[4 * j + e] = fmaf(mean0, cs, acc[4 * j + e]);
            acc[4 * j + 2 + e] = fmaf(mean1, cs, acc[4 * j + 2 + e]);
          }
        }

        // power into the shared tile, once the mel warps have read the last one
        if (pchunk > 0) mbar_wait(power_empty, (pchunk - 1) & 1);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float re = acc[4 * j + 2 * i + e], im = acc[4 * (j + 5) + 2 * i + e];
              power[8 * i * PS + 8 * j + 2 * quad + e] = re * re + im * im;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(power_full);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(span_empty + 8 * buf);  // this item's samples are read
    }
  }
}

}  // namespace

// wav: contiguous (batch, T) f32, T > 200, unpadded. basis: contiguous (2, 400,
// 400) f32, 16-byte aligned: the hi and the lo part, each 5 chunks of 40 cos
// rows then 40 sin rows, one row of 400 samples per bin.
// mel_meta (int) and mel_weights (f32), (5, 2, 40) each: the sparse
// filterbank bin by bin, from ops/logmel.py. colsum: (5, 80) f32, per chunk
// the column sums of its 40 cos then 40 sin rows of the f32 basis (ops/logmel.py,
// kernel_colsums). out: (batch, n_frames, 80) f32
// with n_frames = T / 160. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when the tensor map cannot be encoded.
extern "C" int segma_logmel(const float* wav, const float* basis, const int* mel_meta,
                            const float* mel_weights, const float* colsum, float* out, int batch, int T, int n_frames,
                            void* stream) {
  const EncodeTiledFn encode = encode_tiled();
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[3] = {NFFT, 2 * NBINS, 2};
  const cuuint64_t strides[2] = {NFFT * 4, (cuuint64_t)2 * NBINS * NFFT * 4};
  const cuuint32_t box[3] = {KB, 2 * NCB, 2};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  if (encode == nullptr ||
      encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(basis), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int n_ft = (n_frames + M - 1) / M;
  const int n_items = batch * n_ft;
  cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  logmel_kernel<<<n_items < n_sm ? n_items : n_sm, THREADS, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(
      map, wav, mel_meta, mel_weights, colsum, out, T, n_frames, n_ft, n_items);
  return static_cast<int>(cudaGetLastError());
}
