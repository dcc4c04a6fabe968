// Fused Whisper log-mel frontend for Hopper (sm_90a).
//
// Replaces: segma_tpu/ops/pallas_melspec.py, log_mel_spectrogram_pallas and its
// kernel body _logmel_kernel (the Pallas TPU kernel).
//
// What it computes, for every frame f of a reflect-padded waveform x:
//   re[k]  = sum_n x[f*160 + n] * cos_w[n][k]      n in [0, 400), k in [0, 201)
//   im[k]  = sum_n x[f*160 + n] * sin_w[n][k]
//   mel[m] = sum_k (re[k]^2 + im[k]^2) * fb[k][m]  m in [0, 80)
//   out    = log10(max(mel, 1e-10))
// cos_w/sin_w are the Hann-windowed DFT basis. The per-example max-8 clamp and
// the (x+4)/4 scaling stay in the torch wrapper, as in the JAX package.
//
// What bounds it on this card: about 354 kFLOP per frame (DFT 2*400*201*2, mel
// 2*201*80) against 640 B of input and 320 B of output per frame, so a launch is
// bound by the f32 FMA rate of the CUDA cores (no tensor cores: the frontend
// must hold atol 1e-5, which TF32 does not), not by device memory.
//
// Design. The TPU kernel keeps the whole windowed basis (772 KB) in VMEM; a
// Hopper block has 227 KB of shared memory. Here a block owns FRAMES
// consecutive frames of one example and stages their samples in shared memory
// once (neighbouring frames share 240 of their 400 samples). Each warp owns
// FRAMES_PER_WARP frames; each lane owns one frequency bin of a 32-bin chunk,
// streams that bin's basis column from L1/L2 (every block reads the same
// 400x224 tables) and accumulates re/im in registers with IEEE f32 FMA. After
// each chunk the lanes square their re/im into power and broadcast it across
// the warp with shuffles into the 80 mel accumulators, so the (frames, 201)
// power spectrum never leaves registers. The basis is zero-padded from 201 to
// 224 bins so every chunk is full; padded bins add zero power. Frame sample n
// reads basis row n: no zero-padded third block as on the TPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HOP = 160;
constexpr int NFFT = 400;
constexpr int NBINS_PAD = 224;  // 201 bins padded to 7 chunks of 32
constexpr int NMELS = 80;
constexpr int WARPS = 8;
constexpr int FRAMES_PER_WARP = 8;
constexpr int FRAMES = WARPS * FRAMES_PER_WARP;  // 64 frames per block
constexpr int SPAN = (FRAMES - 1) * HOP + NFFT;  // samples staged per block
constexpr int MELS_PER_LANE = (NMELS + 31) / 32;  // 3: mels lane, lane+32, lane+64

__global__ void __launch_bounds__(WARPS * 32)
logmel_kernel(const float* __restrict__ wav,    // (B, padded_len), reflect-padded
              const float* __restrict__ cos_w,  // (400, 224)
              const float* __restrict__ sin_w,  // (400, 224)
              const float* __restrict__ fb,     // (224, 80), rows >= 201 are zero
              float* __restrict__ out,          // (B, n_frames, 80)
              int padded_len, int n_frames) {
  __shared__ __align__(16) float xs[SPAN];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const float* src = wav + (size_t)b * padded_len + (size_t)f0 * HOP;
  const int avail = padded_len - f0 * HOP;
  for (int i = threadIdx.x; i < SPAN; i += blockDim.x) {
    xs[i] = i < avail ? src[i] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* xw = xs + warp * FRAMES_PER_WARP * HOP;

  float mel[FRAMES_PER_WARP][MELS_PER_LANE];
#pragma unroll
  for (int i = 0; i < FRAMES_PER_WARP; ++i) {
#pragma unroll
    for (int j = 0; j < MELS_PER_LANE; ++j) mel[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < NBINS_PAD; c0 += 32) {
    const int k = c0 + lane;
    float re[FRAMES_PER_WARP], im[FRAMES_PER_WARP];
#pragma unroll
    for (int i = 0; i < FRAMES_PER_WARP; ++i) {
      re[i] = 0.f;
      im[i] = 0.f;
    }

#pragma unroll 2
    for (int n = 0; n < NFFT; n += 4) {
      float cb[4], sb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cb[j] = __ldg(cos_w + (n + j) * NBINS_PAD + k);
        sb[j] = __ldg(sin_w + (n + j) * NBINS_PAD + k);
      }
#pragma unroll
      for (int i = 0; i < FRAMES_PER_WARP; ++i) {
        // every lane reads the same address: a shared-memory broadcast
        const float4 x = *reinterpret_cast<const float4*>(xw + i * HOP + n);
        re[i] = fmaf(x.x, cb[0], re[i]);
        im[i] = fmaf(x.x, sb[0], im[i]);
        re[i] = fmaf(x.y, cb[1], re[i]);
        im[i] = fmaf(x.y, sb[1], im[i]);
        re[i] = fmaf(x.z, cb[2], re[i]);
        im[i] = fmaf(x.z, sb[2], im[i]);
        re[i] = fmaf(x.w, cb[3], re[i]);
        im[i] = fmaf(x.w, sb[3], im[i]);
      }
    }

    // power of bin k for each of the warp's frames, then mel projection
#pragma unroll
    for (int i = 0; i < FRAMES_PER_WARP; ++i) re[i] = re[i] * re[i] + im[i] * im[i];

    for (int j = 0; j < 32; ++j) {
      float w[MELS_PER_LANE];
#pragma unroll
      for (int mm = 0; mm < MELS_PER_LANE; ++mm) {
        const int m = lane + 32 * mm;
        w[mm] = m < NMELS ? __ldg(fb + (c0 + j) * NMELS + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FRAMES_PER_WARP; ++i) {
        const float p = __shfl_sync(0xffffffffu, re[i], j);
#pragma unroll
        for (int mm = 0; mm < MELS_PER_LANE; ++mm) mel[i][mm] = fmaf(p, w[mm], mel[i][mm]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FRAMES_PER_WARP; ++i) {
    const int f = f0 + warp * FRAMES_PER_WARP + i;
    if (f >= n_frames) continue;
    float* dst = out + ((size_t)b * n_frames + f) * NMELS;
#pragma unroll
    for (int mm = 0; mm < MELS_PER_LANE; ++mm) {
      const int m = lane + 32 * mm;
      if (m < NMELS) dst[m] = log10f(fmaxf(mel[i][mm], 1e-10f));
    }
  }
}

}  // namespace

// wav: (batch, padded_len) f32, reflect-padded by 200 on each side, so
// padded_len = 160 * n_frames + 400. Returns cudaGetLastError() after the launch.
extern "C" int segma_logmel(const float* wav, const float* cos_w, const float* sin_w,
                            const float* fb, float* out, int batch, int padded_len,
                            int n_frames, void* stream) {
  dim3 grid((n_frames + FRAMES - 1) / FRAMES, batch);
  logmel_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      wav, cos_w, sin_w, fb, out, padded_len, n_frames);
  return static_cast<int>(cudaGetLastError());
}
