// Hopper building blocks shared by the sm_90a attention kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu): mbarriers, TMA tile loads,
// warpgroup matrix multiplies (wgmma) and their shared-memory descriptors,
// and the host-side tensor maps the TMA loads read.
//
// Layout convention. Every bf16 tile in shared memory is a column slab of
// 64 values (128 bytes) by `rows` rows, written by a TMA load with the
// 128-byte swizzle and placed on a 1024-byte boundary. A head dim above 64
// takes one slab per 64 columns. A slab serves wgmma as
//   K-major (the reduction runs along its 64 columns): 8-row groups 1024
//     bytes apart (SBO), the start address moving 32 bytes per k16 step;
//   MN-major (the reduction runs down its rows): the same bytes, 16 rows
//     (2048 bytes) per k16 step; the 8-row group stride goes in both
//     offset fields, since one slab is one swizzle atom wide.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// requested with 1024 bytes to spare).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed. A
// wait past about 2^35 cycles (over 10 s) traps: a barrier that never
// completes fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 35))
      __trap();
  }
}

// TMA: the box of `map` at coordinates (c0 innermost, c1, c2) into shared
// memory at dst, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor for a 128-byte-swizzled slab.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32) |
         (1ull << 62);
}
// A slab read K-major, k16 step kk (of 4) within it.
__device__ __forceinline__ uint64_t desc_k(uint32_t slab, int kk) {
  return desc_sw128(slab + 32u * kk, 16u, 1024u);
}
// A slab read MN-major, k16 step kk (16 rows) down it.
__device__ __forceinline__ uint64_t desc_mn(uint32_t slab, int kk) {
  return desc_sw128(slab + 2048u * kk, 1024u, 1024u);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulator registers across the
// asynchronous product: reads after wgmma_wait() see its results.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of an m64nN f32 result, thread (warp w, lane l) of the
// warpgroup: d[4j + i] is row 16w + l/4 + 8(i/2), column 8j + 2(l%4) +
// (i%2). The A operand from registers takes the same rows and, for the
// k16 step kk, the columns of d[8kk .. 8kk+7]: pack_a rounds them to bf16
// pairs.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <int N>
__device__ __forceinline__ void pack_a(const float (&d)[N], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// D (64 x 64, f32) = A (64 x 16) * B (16 x 64) [+ D if accumulate], bf16
// A and B from shared memory; A K-major, B K-major (TB = 0) or MN-major
// (TB = 1).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// D (64 x 32, f32) = A (64 x 16) * B (16 x 32) [+ D if accumulate], bf16
// A and B from shared memory; A K-major, B K-major (TB = 0) or MN-major
// (TB = 1).
template <int TB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16) * B (16 x 64), bf16. A in registers: four
// pairs a thread in the accumulator's layout (see pack_a); B from shared
// memory, K-major (TB = 0) or MN-major (TB = 1).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

}  // namespace sm90

// ------------------------------------------------------------------ host

namespace sm90_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime (so the
// library needs no link against libcuda); null if the driver lacks it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tiles of 64 columns by `rows` rows of one head of a contiguous bf16
// (BH, T, D) tensor, 128-byte swizzled; reads past T or D fill zeros, so a
// tile never reaches into the next head's rows. D % 8 == 0 (16-byte rows).
inline bool map_heads(CUtensorMap* map, const void* base, int BH, int T,
                      int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90_host
