// The LSTM's recurrence for Hopper (sm_90a): one cluster of two CTAs per
// direction and pair of batch rows, h exchanged through distributed shared
// memory, the steps paced by mbarriers in each CTA's own shared memory.
//
// Replaces no TPU kernel: the JAX package's BiLSTM is a lax.scan of flax's
// OptimizedLSTMCell (segma_tpu/models/layers.py, BiLSTM), which XLA compiles.
// In the port it takes the place of cuDNN's persistent LSTM in inference
// (models/layers.py, BiLSTM; ops/rnn.py, lstm_cuda); training keeps cuDNN,
// as this kernel has no backward.
//
// What it computes, for one layer, direction d, batch row b and step n (time
// t = n forward, T - 1 - n in reverse), from h = c = 0, in IEEE f32:
//   z    = G[b, t, d, :] + W_hh[d] h           (4H: gates i, f, g, o)
//   c    = sigmoid(z_f) c + sigmoid(z_i) tanh(z_g)
//   h    = sigmoid(z_o) tanh(c),  out[b, t, d H : (d + 1) H] = h
// G = x W_ih^T + b_ih + b_hh, every step's input projection, is one f32 GEMM
// outside the kernel (ops/rnn.py, input_gates), as cuDNN computes it too.
// The activations are expf and tanhf with a correctly rounded reciprocal: no
// fast math, no TF32, no reduced precision anywhere.
//
// What bounds it on this card. The operations: 2 H 4H FLOP a row, step and
// direction; at (64, 1500, H 128, both directions) 25.2 GFLOP a layer, 0.376
// ms at the 67 TFLOP/s of the CUDA cores. The bytes: G read once (393 MB) and
// the output written once (98 MB), 0.147 ms at 3.35 TB/s. Neither is what
// limits it: each step needs the whole h of the step before, so the steps
// run one after another and each one's latency adds up, 1500 of them per
// layer. cuDNN's persistent kernel takes about 4 us a step there, a grid-wide
// synchronisation and h reloaded from global memory each step.
//
// Design. A cluster of two CTAs holds one direction and two batch rows for
// the whole sequence; clusters never wait for each other, so any batch runs
// as more clusters (at B = 64 and two directions: 64 clusters, 128 CTAs, one
// a SM). CTA r owns hidden units [r U, (r + 1) U), U = H / 2, and the four
// gates' rows of W_hh for them, 4U x H f32 (128 KB at H = 128) held in
// registers for all the steps (above H = 128 they do not fit, and are read
// through the L1 cache each step). Threads: 2H, warps of four column groups
// of 8 columns, the four gates of two units. Lane (s, q) = (lane / 4, lane %
// 4) holds column group q of its warp over the k-slice s of H: the H / 8
// values k = (8 i + s) V + e, e < V, with V = 4 (or 2 where H / 8 is not a
// multiple of 4), so that the eight slices of one shared load are 32 (or 16)
// consecutive floats and the four lanes of a slice read the same address.
// Each step, each CTA:
//   1. waits on its mbarrier of the step's parity: the whole h of the step
//      has landed in its own shared memory (each CTA holds a copy);
//   2. forms its partial sums with f32 FMAs, 2 rows x 8 columns per lane, 16
//      h values loaded for 256 FMAs (at H = 128): a lane reuses each h value
//      over 8 columns, as the shared-memory bandwidth, 128 bytes a clock, is
//      half what the FMAs would take at one column;
//   3. sums the 8 k-slices by a reduce-scatter over lanes (xor 16, 8, 4):
//      lane s ends with gate rows 2 (s & 1) and 2 (s & 1) + 1 of unit s / 2
//      & 1 of its group, batch row s / 4;
//   4. adds G's two values, which cp.async brought kAhead steps earlier into
//      a ring in shared memory, applies sigmoid or tanh, swaps with the lane
//      of the unit's other gate pair, updates c (in a register) and h;
//   5. writes its units' new h into the other parity's buffer of both CTAs,
//      itself included, with st.async, which counts its bytes on that CTA's
//      mbarrier, and into the output.
// No cluster-wide barrier: a CTA waits only for the bytes of the next h, in
// its own shared memory. Writing into the other parity is safe without one:
// a CTA reaches step n + 1 only with every CTA's slice of h_{n+1}, which
// each CTA wrote after it had read h_{n - 1} from that parity. The floor is
// the chain of each step: the shared loads and FMAs, three rounds of
// shuffles, the activations, and one st.async from SM to SM, 1500 times.
//
// The sums run in another order than cuDNN's and the CPU's, so the outputs
// agree to f32 rounding carried through the steps, not bit for bit. They do
// not depend on the launch: no atomics, and each output has one fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kCluster = 2;   // CTAs a cluster: H / 2 hidden units each
constexpr int kRows = 2;      // batch rows a cluster
constexpr int kAhead = 8;     // steps of G in flight ahead of the one computed
constexpr int kRegMax = 128;  // the largest H whose W_hh slice fits in registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

// The shared::cluster address of this CTA's shared address `addr` in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 8 bytes to shared::cluster address `addr`, counted as complete_tx bytes on
// the mbarrier at shared::cluster address `bar` (of the same CTA)
__device__ __forceinline__ void st_async_f2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::
          "r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// sm90.cuh's mbar_wait, acquiring at cluster scope: the bytes come from the
// other CTA too. Traps after 10 s rather than hang the card.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// (cp_async_4, the 4-byte copy with zero fill, is sm90.cuh's)
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + expf(-x)); }

template <int H>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(2 * H, 1)
    lstm_fwd_kernel(const float* __restrict__ gates, const float* __restrict__ w_hh,
                    float* __restrict__ out, int batch, int steps, int dirs, int slices) {
  constexpr int U = H / kCluster;         // units a CTA
  constexpr int NT = 2 * H;               // threads: U / 8 warps of 4 column groups
  constexpr int KT = H / 8;               // k values a lane
  constexpr int V = KT % 4 == 0 ? 4 : 2;  // floats a shared load of h
  constexpr int NC = KT / V;              // loads a row
  constexpr bool kRegW = H <= kRegMax;
  constexpr uint32_t kParityBytes = kRows * H * 4;  // one h buffer: a phase's bytes
  __shared__ __align__(16) float hbuf[2][kRows][H];  // h by step parity, all H units
  __shared__ float gring[kAhead][2][NT];             // each thread's own G values
  __shared__ __align__(8) uint64_t mbar[2];          // the h of each parity has landed

  const int rank = cluster_rank();
  const int cluster = cluster_index();
  const int dir = cluster / slices;
  const int slice = cluster % slices;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = lane >> 2;  // k-slice
  const int group = warp * 4 + (lane & 3);
  // after the reduce-scatter: batch row s / 4, unit s / 2 & 1 of the group,
  // gate rows gate and gate + 1: (i, f), or (g, o) where s is odd
  const int r_out = s >> 2;
  const int j_out = (s >> 1) & 1;
  const int gate = 2 * (s & 1);
  const int unit = rank * U + 2 * group + j_out;
  const int row = slice * kRows + r_out;
  const bool live = row < batch;

  // column col: W_hh[dir] row (col & 3) H + rank U + 2 group + (col >> 2)
  const float* w_dir = w_hh + static_cast<size_t>(dir) * 4 * H * H;
  auto w_row = [&](int col) {
    return w_dir + static_cast<size_t>((col & 3) * H + rank * U + 2 * group + (col >> 2)) * H;
  };
  float w[8][kRegW ? KT : 1];
  if constexpr (kRegW) {
#pragma unroll
    for (int col = 0; col < 8; ++col) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
#pragma unroll
        for (int e = 0; e < V; ++e) w[col][i * V + e] = w_row(col)[(i * 8 + s) * V + e];
      }
    }
  }

  const size_t t_stride = static_cast<size_t>(dirs) * 4 * H;  // G's, a step
  const float* g_row = gates + static_cast<size_t>(live ? row : 0) * steps * t_stride +
                       static_cast<size_t>(dir) * 4 * H + gate * H + unit;
  float* o_row = out + static_cast<size_t>(live ? row : 0) * steps * dirs * H +
                 static_cast<size_t>(dir) * H + rank * U + 2 * group;
  const uint32_t g_slot = smem_addr(&gring[0][0][threadIdx.x]);
  auto time_of = [&](int n) { return dir ? steps - 1 - n : n; };
  auto prefetch = [&](int n) {  // step n's two G values into ring slot n % kAhead
    const bool ok = live && n < steps;
    const float* src = g_row + static_cast<size_t>(ok ? time_of(n) : 0) * t_stride;
    const uint32_t dst = g_slot + static_cast<uint32_t>((n % kAhead) * 2 * NT) * 4;
    cp_async_4(dst, src, ok);
    cp_async_4(dst + NT * 4, src + H, ok);
    cp_async_commit();
  };

  const uint32_t bar0 = smem_addr(&mbar[0]);
  // a lane with (s & 2) == 0 writes row r_out's two units of its group into
  // CTA s & 1: its h buffer and mbarrier there, parity 0
  const int dst_rank = s & 1;
  const uint32_t dst_h = map_to_rank(smem_addr(&hbuf[0][r_out][rank * U + 2 * group]), dst_rank);
  const uint32_t dst_bar = map_to_rank(bar0, dst_rank);

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < kRows * H; i += NT) (&hbuf[0][0][0])[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive(bar0);                              // h_0 = 0: phase 0 of mbarrier 0
    mbar_arrive_expect_tx(bar0 + 8, kParityBytes);  // h_1: phase 0 of mbarrier 1
  }
  float c = 0.0f;
#pragma unroll
  for (int n = 0; n < kAhead; ++n) prefetch(n);
  __syncwarp();
  cluster_sync();  // both CTAs running, their mbarriers set before any st.async

  for (int n = 0; n < steps; ++n) {
    const int p = n & 1;
    mbar_wait_cluster(bar0 + 8 * p, (n >> 1) & 1);  // h_n, all of it
    if (threadIdx.x == 0) mbar_arrive_expect_tx(bar0 + 8 * p, kParityBytes);  // h_{n+2}
    const float* hp = &hbuf[p][0][0];
    float a[kRows][8];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int col = 0; col < 8; ++col) a[r][col] = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float* src = hp + r * H + (i * 8 + s) * V;
        float hv[V];
        if constexpr (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          hv[0] = v.x, hv[1] = v.y, hv[2] = v.z, hv[3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(src);
          hv[0] = v.x, hv[1] = v.y;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
#pragma unroll
          for (int col = 0; col < 8; ++col) {
            float wv;
            if constexpr (kRegW) {
              wv = w[col][i * V + e];
            } else {
              wv = __ldg(w_row(col) + (i * 8 + s) * V + e);
            }
            a[r][col] = fmaf(hv[e], wv, a[r][col]);
          }
        }
      }
    }

    // reduce-scatter over the 8 k-slices: each round keeps half the values
    // (by the lane's bit of s) and adds the partner's other half
    const bool b2 = s & 4, b1 = s & 2, b0 = s & 1;
    float x[8];  // row r_out, the 8 columns
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      const float send = b2 ? a[0][col] : a[1][col], keep = b2 ? a[1][col] : a[0][col];
      x[col] = keep + __shfl_xor_sync(kFull, send, 16);
    }
#pragma unroll
    for (int col = 0; col < 4; ++col) {  // then columns 4 j_out + col: unit j_out
      const float send = b1 ? x[col] : x[col + 4], keep = b1 ? x[col + 4] : x[col];
      x[col] = keep + __shfl_xor_sync(kFull, send, 8);
    }
    float z[2];  // gate rows gate and gate + 1
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      const float send = b0 ? x[col] : x[col + 2], keep = b0 ? x[col + 2] : x[col];
      z[col] = keep + __shfl_xor_sync(kFull, send, 4);
    }

    cp_async_wait<kAhead - 1>();  // this thread's step-n group has landed
    const float* gs = &gring[n % kAhead][0][threadIdx.x];
    const float v0 = b0 ? tanhf(z[0] + gs[0]) : sigmoid(z[0] + gs[0]);
    const float v1 = sigmoid(z[1] + gs[NT]);
    const float u0 = __shfl_xor_sync(kFull, v0, 4);  // the unit's other gate pair
    const float u1 = __shfl_xor_sync(kFull, v1, 4);
    const float ig = b0 ? u0 : v0, fg = b0 ? u1 : v1;
    const float gg = b0 ? v0 : u0, og = b0 ? v1 : u1;
    c = fmaf(fg, c, ig * gg);
    const float h = og * tanhf(c);
    const float h_other = __shfl_xor_sync(kFull, h, 8);  // the group's other unit
    const float h_lo = b1 ? h_other : h, h_hi = b1 ? h : h_other;

    const uint32_t next = static_cast<uint32_t>(p ^ 1);
    if (!b1) {
      st_async_f2(dst_h + next * kParityBytes, h_lo, h_hi, dst_bar + next * 8);
    } else if (!b0 && live) {
      *reinterpret_cast<float2*>(o_row + static_cast<size_t>(time_of(n)) * dirs * H) =
          make_float2(h_lo, h_hi);
    }
    prefetch(n + kAhead);  // into the slot read above
  }
  // h_steps, the last writes into this CTA, has landed; then neither CTA
  // leaves while the other may still write into it
  mbar_wait_cluster(bar0 + 8 * (steps & 1), (steps >> 1) & 1);
  cp_async_wait<0>();
  __syncwarp();
  cluster_sync();
}

template <int H>
int launch(const float* gates, const float* w_hh, float* out, int batch, int steps, int dirs,
           cudaStream_t stream) {
  const int slices = (batch + kRows - 1) / kRows;
  lstm_fwd_kernel<H><<<kCluster * slices * dirs, 2 * H, 0, stream>>>(gates, w_hh, out, batch,
                                                                     steps, dirs, slices);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int max_clusters(int* n) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(2 * H);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, lstm_fwd_kernel<H>, &config));
}

}  // namespace

#define SEGMA_LSTM_HIDDEN(X)                                                                 \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192) X(208) X(224) \
      X(240) X(256)

// One layer's recurrence. gates: (batch, steps, dirs, 4 hidden) f32, the
// input projection with both biases; w_hh: (dirs, 4 hidden, hidden) f32;
// out: (batch, steps, dirs, hidden) f32. hidden: a multiple of 16 up to 256
// (ops/rnn.py, supports); dirs: 1, or 2 with the second direction reversed.
extern "C" int segma_lstm_fwd(const float* gates, const float* w_hh, float* out, int batch,
                              int steps, int hidden, int dirs, void* stream) {
  if (batch < 1 || steps < 1 || dirs < 1 || dirs > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
#define SEGMA_LSTM_CASE(H) \
  case H:                  \
    return launch<H>(gates, w_hh, out, batch, steps, dirs, st);
    SEGMA_LSTM_HIDDEN(SEGMA_LSTM_CASE)
#undef SEGMA_LSTM_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of the kernel for `hidden` the card runs at once (one
// wave holds batch / 2 x directions of them)
extern "C" int segma_lstm_fwd_clusters(int hidden, int* n_clusters) {
  *n_clusters = 0;
  switch (hidden) {
#define SEGMA_LSTM_CASE(H) \
  case H:                  \
    return max_clusters<H>(n_clusters);
    SEGMA_LSTM_HIDDEN(SEGMA_LSTM_CASE)
#undef SEGMA_LSTM_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
