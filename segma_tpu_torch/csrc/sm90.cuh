// Hopper (sm_90a) building blocks for the flash kernels, forward
// (flash_attn.cu, and in f32 flash_attn_f32.cu) and backward
// (flash_attn_bwd.cu, and in f32 flash_attn_bwd_f32.cu), the log-mel kernel
// (logmel.cu) and the LSTM's recurrence (lstm_fwd.cu, which takes the
// mbarriers and cp.async): TMA tensor maps and loads, mbarriers, named barriers,
// register reallocation, wgmma (bf16, and TF32 for the 3xTF32 products of
// log-mel and the f32 flash kernels) with its shared-memory descriptors,
// cp.async; and, in namespace tf32x3, the tiles and products the two f32
// flash kernels share. Included by the sources; not compiled on its own.
//
// The flash tiles are loaded by TMA with 128-byte swizzle: a row of 64 bf16
// is exactly 128 bytes, rows are stored back to back, and the 16-byte chunks
// of row r are permuted by XOR with (r mod 8) within each 1024-byte group of
// 8 rows. wgmma reads that layout directly (descriptor layout type 1,
// SWIZZLE_128B), so a tile's base must be 1024-byte aligned. Log-mel's basis
// tiles are rows of 16 f32 (64 bytes) with 64-byte swizzle (layout type 2,
// 512-byte groups of 8 rows).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library does not link
// (it links only the CUDA runtime), so it is looked up through the runtime
// once.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A tensor map over a contiguous (batch, seq, heads, 64) bf16 tensor (f32
// if `f32`), seen as 3-D {heads * 64, seq, batch}: a box of {64, rows, 1}
// at {h * 64, s0, b} is rows x 64 of one (batch, head), 128-byte swizzled;
// in f32 a row of 64 is 256 bytes, so a box is {32, rows, 1}, half of each
// row, at {h * 64 + 32 half, s0, b}. Rows at or past seq are filled with
// zeros and never come from the next batch. Returns false if the map cannot
// be encoded (a misaligned pointer among others).
inline bool bshd_tensor_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
                            int rows, bool f32 = false) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * 64, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * 64 * elem,
                                 (cuuint64_t)seq * heads * 64 * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// 10 s means a broken pipeline; it traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
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

// TMA: the box of `map` at {c0, c1, c2} into shared memory at dst, counted
// against the transaction bytes of mbarrier bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// TMA without a map: `bytes` (a multiple of 16) contiguous bytes from global
// src to shared dst, both 16-byte aligned, counted against mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A shared load. volatile: it must stay after the mbarrier wait that makes
// the data visible.
__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a
// 128-byte-swizzled tile of 128-byte rows: chunk c of a row lies at chunk
// c ^ (row mod 8)
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// named barriers among `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`
// (1024-byte aligned, or advanced from such a base within a row): rows of 128
// bytes, groups of 8 rows 1024 bytes apart (stride byte offset). The leading
// byte offset is not read for these tiles (a K-major operand's 16 columns,
// and an MN-major operand's 64, lie within one 128-byte row); it is set to
// the same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16) B (16 x 128) (zero_d) or d + A B (acc),
// bf16 in; A and B in shared memory through descriptors, both K-major.
// Accumulator layout: thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 and that + 8; d[4 j + 2 i + e] is (row + 8 i, column 8 j +
// 2 (t % 4) + e). The zero_d form writes d without reading it, so d holds
// no live registers before the product.
__device__ __forceinline__ void wgmma_m64n128k16_ss_zero_d(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),
        "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
        "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_m64n128k16_ss_acc(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) = A (64 x 16) B (16 x 64) (zero_d) or d + A B (acc), bf16
// in. A is in registers as the A fragments described below; B is in shared
// memory through a descriptor, K-major: each of its 64 columns is a row of
// the tile. The accumulator layout of the n128 form over 8 column blocks.
__device__ __forceinline__ void wgmma_m64n64k16_rs_zero_d(float* d, const uint32_t* a,
                                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_acc(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), bf16 in. A is in registers as
// the m16n8k16 A fragments of each warp's 16 rows: a[0] (row, k..k+1), a[1]
// (row + 8, k..k+1), a[2] (row, k+8..k+9), a[3] (row + 8, k+8..k+9), with
// row = 16 warp + lane / 4 and k = 2 (lane % 4). B is in shared memory
// through a descriptor, MN-major: its 64 columns are contiguous (trans-b).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------ f32 through TF32 (logmel.cu)

// wgmma descriptor of a 64-byte-swizzled tile at shared address `addr`
// (512-byte aligned, or advanced from such a base within a row): rows of 64
// bytes (16 f32), groups of 8 rows 512 bytes apart. As for sw128_desc, the
// leading byte offset is not read (a TF32 k-step's 8 columns are 32 bytes,
// within one row) and is set to the same 512 bytes.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(512 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// f32 rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// returned as the f32 bit pattern with its low 13 bits zero: exactly what a
// TF32 product reads
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (64 x 80, f32) += A (64 x 8) B (8 x 80), TF32 in. A is in registers as
// the m16n8k8 TF32 A fragments of each warp's 16 rows: a[0] (row, k), a[1]
// (row + 8, k), a[2] (row, k + 4), a[3] (row + 8, k + 4), with row = 16 warp
// + lane / 4 and k = lane % 4. B is in shared memory through a descriptor,
// K-major (TF32 has no transposed form): each of its 80 columns is a row of
// the tile. The accumulator layout of the bf16 forms over 10 column blocks:
// d[4 j + 2 i + e] is (row + 8 i, column 8 j + 2 (lane % 4) + e).
__device__ __forceinline__ void wgmma_m64n80k8_tf32_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d = A B, the same product writing d without reading it
__device__ __forceinline__ void wgmma_m64n80k8_tf32_rs_zero_d(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d (64 x N, f32) += A (64 x 8) B (8 x N), or d = A B (zero_d), TF32 in, for
// the f32 flash kernels' 3xTF32 products: N = 32 for the score products, 64
// for the products over a tile's rows. Operands
// and accumulator layout as for wgmma_m64n80k8_tf32_rs, over N / 8 column
// blocks; B K-major through a descriptor.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs_zero_d(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs_zero_d(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d (64 x 32, f32) += A (64 x 8) B (8 x 32), or d = A B (zero_d), TF32 in,
// both operands in shared memory through descriptors, both K-major: the f32
// flash forward's score products (flash_attn_f32.cu), A its pre-split Q.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss_zero_d(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b), "r"(0));
}

// 4 bytes from global src to shared dst, or 4 zero bytes when !valid (src is
// then not read), asynchronously; cp_async_mbar_arrive makes mbarrier bar
// see one arrival once all of this thread's earlier copies have landed
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ------------------------- f32 flash attention in 3xTF32 (flash_attn_f32.cu,
// flash_attn_bwd_f32.cu)
//
// Tiles of f32 rows of 64 come by TMA as two 128-byte-swizzled halves of 32
// columns (bshd_tensor_map(..., f32 = true)). A streamed tile is BT = 32
// rows, a consumer's resident tile 64. The converter warps rewrite a
// streamed tile in place as its TF32 hi part, its lo part PART bytes on, with
// the head dims permuted within each 16 (slot q + 4 h of k-step 2 j + t holds
// dim 16 j + 4 q + 2 t + h), and write a transposed tile ([64 dims][32 rows],
// hi, then lo T_PART bytes on) with row c at slot (c & ~7) | (c & 7) / 2 |
// 4 (c & 1), so that a score accumulator's registers are the A fragments of
// the product over its columns.
namespace tf32x3 {

constexpr int BT = 32;                // streamed rows per tile
constexpr int NAT_HALF = BT * 128;    // 32 rows x 32 f32: 4 KB
constexpr int PART = 2 * NAT_HALF;    // a streamed tile's hi (or lo) part, 8 KB
constexpr int RES_HALF = 64 * 128;    // 64 rows x 32 f32: 8 KB
constexpr int T_PART = 64 * 128;      // a transposed tile's hi (or lo) part: 64 dims x 32 rows

// Shared stores. volatile: they must stay between the mbarrier wait and
// the arrival that order them.
__device__ __forceinline__ void sts_u4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x as TF32 hi and lo: x = hi + lo + O(2^-22 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The converters' pieces. Head dims 16 jj .. 16 jj + 15 (chunks 4 jj .. 4 jj
// + 3) of row `row` of a landed half tile, split: hi[i][n], lo[i][n] of dim
// 16 jj + 4 i + n
__device__ __forceinline__ void split16(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], uint32_t half,
                                        int row, int jj) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = lds_f4(half + sw128_offset(row, 4 * jj + i));
    split(x.x, hi[i][0], lo[i][0]);
    split(x.y, hi[i][1], lo[i][1]);
    split(x.z, hi[i][2], lo[i][2]);
    split(x.w, hi[i][3], lo[i][3]);
  }
}

// those 16 dims back in place as hi, permuted (chunk 4 jj + n holds dims 16
// jj + n, + 4, + 8, + 12: a 4 x 4 transpose of the four chunks), and as lo
// `lo_off` bytes on
__device__ __forceinline__ void store16(uint32_t half, uint32_t lo_off, int row, int jj,
                                        const uint32_t (&hi)[4][4], const uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const uint32_t at = half + sw128_offset(row, 4 * jj + n);
    sts_u4(at, hi[0][n], hi[1][n], hi[2][n], hi[3][n]);
    sts_u4(at + lo_off, lo[0][n], lo[1][n], lo[2][n], lo[3][n]);
  }
}

// the slot of row c of a streamed tile in its transposed tile
__device__ __forceinline__ int t_slot(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

// those 16 dims of half `half` into the transposed tile t, hi, then lo
// T_PART bytes on, at the row's slot `pos`
__device__ __forceinline__ void store16_t(uint32_t t, int pos, int half, int jj,
                                          const uint32_t (&hi)[4][4], const uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int d = 32 * half + 16 * jj + 4 * i + n;
      const uint32_t at = t + sw128_offset(d, pos >> 2) + 4 * (pos & 3);
      sts_u32(at, hi[i][n]);
      sts_u32(at + T_PART, lo[i][n]);
    }
  }
}

// The A fragments of a score product: rows row and row + 8 of a raw resident
// tile (two 8 KB halves of 32 dims), over the 8 permuted k-steps, in TF32 hi
// and lo. a[4 kk + i]: k-step kk's a[0..3] (wgmma_m64n80k8_tf32_rs).
__device__ __forceinline__ void resident_frags(uint32_t (&hi)[32], uint32_t (&lo)[32],
                                               uint32_t tile, int row, int quad) {
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    const uint32_t half = tile + (jp >> 1) * RES_HALF;
    const int chunk = 4 * (jp & 1) + quad;
    const float4 x = lds_f4(half + sw128_offset(row, chunk));
    const float4 y = lds_f4(half + sw128_offset(row + 8, chunk));
    const float v[2][4] = {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(v[t][i], hi[4 * (2 * jp + t) + i], lo[4 * (2 * jp + t) + i]);
      }
    }
  }
}

// d = A B^T over the 64 head dims, A the resident rows (resident_frags), B
// the stage's natural tile `nat` ([32 rows][64], hi then lo): the small terms
// into sm, the large into lg, both fresh
__device__ __forceinline__ void score_product(float (&lg)[16], float (&sm)[16],
                                              const uint32_t (&hi)[32], const uint32_t (&lo)[32],
                                              uint32_t nat) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t at = nat + (kk >> 2) * NAT_HALF + (kk & 3) * 32;
    const uint64_t b_hi = sw128_desc(at), b_lo = sw128_desc(at + PART);
    if (kk == 0) {
      wgmma_m64n32k8_tf32_rs_zero_d(sm, &lo[0], b_hi);
      wgmma_m64n32k8_tf32_rs(sm, &hi[0], b_lo);
      wgmma_m64n32k8_tf32_rs_zero_d(lg, &hi[0], b_hi);
    } else {
      wgmma_m64n32k8_tf32_rs(sm, &lo[4 * kk], b_hi);
      wgmma_m64n32k8_tf32_rs(sm, &hi[4 * kk], b_lo);
      wgmma_m64n32k8_tf32_rs(lg, &hi[4 * kk], b_hi);
    }
  }
}

// The score accumulator c (c[4 j + 2 i + e] is (row + 8 i, column 8 j + 2
// quad + e)) as the A fragments of a product over its 32 columns, in TF32 hi
// and lo: column 8 j + 2 quad + e is k-step j's slot quad + 4 e.
__device__ __forceinline__ void acc_frags(uint32_t (&hi)[16], uint32_t (&lo)[16],
                                          const float (&c)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v[4] = {c[4 * j], c[4 * j + 2], c[4 * j + 1], c[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], hi[4 * j + i], lo[4 * j + i]);
  }
}

// blk = A T over the tile's 32 rows, fresh: A from acc_frags, T the stage's
// transposed tile ([64 dims][32 rows], hi then lo); per k-step the small
// terms, then the large
__device__ __forceinline__ void row_product(float (&blk)[32], const uint32_t (&hi)[16],
                                            const uint32_t (&lo)[16], uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b_hi = sw128_desc(t + kk * 32), b_lo = sw128_desc(t + T_PART + kk * 32);
    if (kk == 0) {
      wgmma_m64n64k8_tf32_rs_zero_d(blk, &lo[0], b_hi);
    } else {
      wgmma_m64n64k8_tf32_rs(blk, &lo[4 * kk], b_hi);
    }
    wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_lo);
    wgmma_m64n64k8_tf32_rs(blk, &hi[4 * kk], b_hi);
  }
}

// s = lg + sm in IEEE f32, once both are done
__device__ __forceinline__ void join(float (&lg)[16], float (&sm)[16]) {
  fence_regs<16>(lg);
  fence_regs<16>(sm);
#pragma unroll
  for (int i = 0; i < 16; ++i) lg[i] += sm[i];
}

// A consumer warp is done with what `bar` guards
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A work item is 128 rows of one (batch, head), resident for the item:
// item = (b H + h) n_rt + rt
struct Item {
  int rt, h, b;
};

__device__ __forceinline__ Item decode(int item, int n_rt, int H) {
  const int bh = item / n_rt;
  return {item - bh * n_rt, bh % H, bh / H};
}

}  // namespace tf32x3

}  // namespace
