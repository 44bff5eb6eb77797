// Dequant-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mxtpu/ops/quant_attention.py:_dequant_decode_kernel (launched by
// _decode_pallas). One query row per (slot, head) attends over that slot's
// int8 or fp8 (e4m3) paged KV cache, positions 0..pc[slot]: each K/V row
// is dequantized in registers with its f32 row scale inside an online
// softmax. No dequantized (S, H, TOT, D) tensor ever exists in device
// memory, which is the reason the kernel exists.
//
// What bounds it on the card: bytes. Each position read costs 2*(D + 4)
// bytes (a K and a V row plus their scales) for ~4*D flops, far below the
// H100's flops-per-byte balance, so the floor is the cache bytes up to pc
// over the HBM rate. The design reads only rows t <= pc (a decode step never
// touches the unwritten tail of the bucket), with one block per (slot,
// head) and sixteen warps that each run their own online softmax over
// interleaved 32-position chunks (one position per lane for the scores,
// then one output column per lane for the V read), merged once at the end.
// With S*H blocks (96 at the serving shape) the card is under-filled; a
// split over positions across blocks is the next step.
//
// Left behind from the TPU kernel: the 128-lane head-dim padding, the
// 8-sublane broadcast of the query, the scales and `lim`, and the bucket
// legality rule — every bucket length is taken.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 16;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int DMAX = 256;
constexpr int CPL = DMAX / 32;     // output columns per lane
constexpr float kMasked = -1e30f;  // the reference's mask fill value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// KV storage: 0 = int8, 1 = float8 e4m3 (finite-only, as torch's
// float8_e4m3fn)
template <int KV> __device__ __forceinline__ float deq(uint8_t b);
template <> __device__ __forceinline__ float deq<0>(uint8_t b) {
  return (float)(int8_t)b;
}
template <> __device__ __forceinline__ float deq<1>(uint8_t b) {
  const __half_raw h =
      __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dot(sq, dequant(row)) over D elements; VEC reads the row 16 bytes at a
// time (D % 16 == 0 and 16-byte aligned rows)
template <int KV, bool VEC>
__device__ __forceinline__ float row_dot(const float* sq,
                                         const uint8_t* __restrict__ row,
                                         int D) {
  float acc = 0.f;
  if (VEC) {
    for (int d = 0; d < D; d += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + d);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc = fmaf(sq[d + j],
                   deq<KV>((uint8_t)(words[j / 4] >> (8 * (j % 4)))), acc);
    }
  } else {
    for (int d = 0; d < D; ++d) acc = fmaf(sq[d], deq<KV>(row[d]), acc);
  }
  return acc;
}

template <typename TQ, int KV, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
dequant_decode_kernel(const TQ* __restrict__ q,
                      const uint8_t* __restrict__ kd,
                      const float* __restrict__ ks,
                      const uint8_t* __restrict__ vd,
                      const float* __restrict__ vs,
                      const int* __restrict__ pc, TQ* __restrict__ out,
                      int H, int TOT, int D, float scale) {
  __shared__ float sq[DMAX];
  __shared__ float wm[NWARPS], wl[NWARPS];
  __shared__ float wo[NWARPS][DMAX];

  const int bh = blockIdx.x;  // slot * H + head
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // clipped into the bucket as the serving step clips it: never read past
  const int lim = min(max(pc[bh / H], 0), TOT - 1);
  for (int d = tid; d < D; d += NTHREADS)
    sq[d] = to_f32(q[(size_t)bh * D + d]) * scale;
  __syncthreads();

  const uint8_t* kb = kd + (size_t)bh * TOT * D;
  const uint8_t* vb = vd + (size_t)bh * TOT * D;
  const float* ksb = ks + (size_t)bh * TOT;
  const float* vsb = vs + (size_t)bh * TOT;

  float m = kMasked, l = 0.f;
  float o[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) o[i] = 0.f;

  for (int base = warp * 32; base <= lim; base += NWARPS * 32) {
    const int t = base + lane;
    const bool live = t <= lim;
    const float s =
        live ? row_dot<KV, VEC>(sq, kb + (size_t)t * D, D) * ksb[t]
             : kMasked;
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < CPL; ++i) o[i] *= corr;
    const int n = min(32, lim - base + 1);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int tj = base + j;
      const float w = __shfl_sync(0xffffffffu, p, j) * vsb[tj];
      const uint8_t* vr = vb + (size_t)tj * D;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < D) o[i] = fmaf(w, deq<KV>(vr[c]), o[i]);
      }
    }
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) wo[warp][c] = o[i];
  }
  __syncthreads();
  float M = wm[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) M = fmaxf(M, wm[w]);
  float L = 0.f, f[NWARPS];
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    f[w] = expf(wm[w] - M);
    L += wl[w] * f[w];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int c = tid; c < D; c += NTHREADS) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) acc = fmaf(wo[w][c], f[w], acc);
    out[(size_t)bh * D + c] = from_f32<TQ>(acc * inv);
  }
}

template <typename TQ, int KV>
cudaError_t launch(const void* q, const void* kd, const void* ks,
                   const void* vd, const void* vs, const void* pc, void* out,
                   int S, int H, int TOT, int D, float scale, int vec,
                   cudaStream_t stream) {
  auto kern = vec ? dequant_decode_kernel<TQ, KV, true>
                  : dequant_decode_kernel<TQ, KV, false>;
  kern<<<S * H, NTHREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const uint8_t*>(kd),
      static_cast<const float*>(ks), static_cast<const uint8_t*>(vd),
      static_cast<const float*>(vs), static_cast<const int*>(pc),
      static_cast<TQ*>(out), H, TOT, D, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* kd,
                        const void* ks, const void* vd, const void* vs,
                        const void* pc, void* out, int S, int H, int TOT,
                        int D, float scale, int vec, cudaStream_t stream) {
  if (kv_dtype == 0)
    return launch<TQ, 0>(q, kd, ks, vd, vs, pc, out, S, H, TOT, D, scale,
                         vec, stream);
  if (kv_dtype == 1)
    return launch<TQ, 1>(q, kd, ks, vd, vs, pc, out, S, H, TOT, D, scale,
                         vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (S, H, D) in q_dtype (0 = f32, 1 = bf16); kd, vd: (S, H, TOT, D)
// in kv_dtype (0 = int8, 1 = fp8 e4m3); ks, vs: (S, H, TOT) f32; pc: (S,)
// int32. `vec` = rows are 16-byte aligned and D % 16 == 0. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int mxt_dequant_decode(const void* q, const void* kd,
                                  const void* ks, const void* vd,
                                  const void* vs, const void* pc, void* out,
                                  int S, int H, int TOT, int D, float scale,
                                  int q_dtype, int kv_dtype, int vec,
                                  void* stream) {
  if (S <= 0 || H <= 0 || TOT <= 0 || D <= 0 || D > DMAX ||
      (long long)S * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return (int)dispatch_kv<float>(kv_dtype, q, kd, ks, vd, vs, pc, out, S,
                                   H, TOT, D, scale, vec, s);
  if (q_dtype == 1)
    return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, q, kd, ks, vd, vs, pc,
                                           out, S, H, TOT, D, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}
