// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxtpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_pallas). Computes, per (batch*head) and
// query row i, the online softmax over the key axis and writes the
// normalised output O and the row's f32 log-sum-exp. Causal masking is
// top-left (key j is visible to row i iff j <= i) and key tiles past a
// query tile's last row are never loaded.
//
// What bounds it on the card: each K/V row it reads serves every query row
// of the tile loop, ~4*T*D flops (causal: half) per 2*D elements, so at the
// forward's shapes (T = 1024, D = 64) it sits far above the H100's
// flops-per-byte balance and is bound by arithmetic. This first version
// runs the two products on the CUDA cores in f32 (no wgmma, no TMA): its
// ceiling is the f32 FMA rate, and within that the shared-memory load rate
// (about one shared load per FMA). The design keeps the T x T score matrix
// out of device memory: one block owns 64 query rows, streams 32-key K/V
// tiles through shared memory, and holds the running max, sum and output
// row in registers (4 threads per row, D/4 output columns each).
//
// Left behind from the TPU kernel: the 128-lane head-dim padding, the
// 8-sublane broadcast of the lse rows, and the block legality rule with its
// T % 128 gate. Any T, any Tk and any D <= 256 are taken; ragged edges are
// masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int LANES = 4;               // threads per query row
constexpr int NTHREADS = BQ * LANES;   // 256
constexpr float kMasked = -1e30f;      // the reference's causal fill value

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

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int D, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // odd row stride: column walks hit distinct banks
  float* sq = smem;               // [BQ][ld]  scaled query tile
  float* sk = sq + BQ * ld;       // [BK][ld]
  float* sv = sk + BK * ld;       // [BK][ld]
  float* sp = sv + BK * ld;       // [BQ][BK + 1]  probabilities of the tile

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int grow = q0 + row;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e - r * D;
    sq[r * ld + c] =
        q0 + r < Tq ? to_f32(qb[(size_t)(q0 + r) * D + c]) * scale : 0.f;
  }

  float m = kMasked, l = 0.f;
  float o[DMAX / LANES];
#pragma unroll
  for (int i = 0; i < DMAX / LANES; ++i) o[i] = 0.f;

  // causal: keys past the tile's last row are masked for every row in it
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; sq is staged
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D;
      const bool ok = k0 + r < Tk;
      const size_t g = (size_t)(k0 + r) * D + c;
      sk[r * ld + c] = ok ? to_f32(kb[g]) : 0.f;
      sv[r * ld + c] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[BK / LANES];
#pragma unroll
    for (int t = 0; t < BK / LANES; ++t) s[t] = 0.f;
    const float* qr = sq + row * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int t = 0; t < BK / LANES; ++t)
        s[t] = fmaf(qd, sk[(lane + LANES * t) * ld + d], s[t]);
    }
    float mt = kMasked;
#pragma unroll
    for (int t = 0; t < BK / LANES; ++t) {
      const int col = k0 + lane + LANES * t;
      if (col >= Tk)
        s[t] = -INFINITY;  // past the key axis: no weight at all
      else if (causal && col > grow)
        s[t] = kMasked;    // as the reference masks: exp underflows to 0
      mt = fmaxf(mt, s[t]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int t = 0; t < BK / LANES; ++t) {
      const float p = expf(s[t] - m_new);
      ps += p;
      sp[row * (BK + 1) + lane + LANES * t] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = corr * l + ps;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own quad

    const float* pr = sp + row * (BK + 1);
#pragma unroll
    for (int i = 0; i < DMAX / LANES; ++i) o[i] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = pr[kk];
      const float* vr = sv + kk * ld;
#pragma unroll
      for (int i = 0; i < DMAX / LANES; ++i) {
        const int c = lane + LANES * i;
        if (c < D) o[i] = fmaf(p, vr[c], o[i]);
      }
    }
  }

  if (grow < Tq) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* orow = out + ((size_t)bh * Tq + grow) * D;
#pragma unroll
    for (int i = 0; i < DMAX / LANES; ++i) {
      const int c = lane + LANES * i;
      if (c < D) orow[c] = from_f32<T>(o[i] * inv);
    }
    if (lane == 0) lse[(size_t)bh * Tq + grow] = m + logf(lc);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int Tq, int Tk, int D, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1)) *
      sizeof(float);
  auto kern = flash_fwd_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, void* lse, int BH, int Tq, int Tk, int D,
                       float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                         stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                          stream);
  return launch<T, 256>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                        stream);
}

}  // namespace

// q, k, v, out: (BH, T, D) contiguous in one dtype (0 = f32, 1 = bf16);
// lse: (BH, Tq) f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int BH, int Tq, int Tk,
                             int D, float scale, int causal, int dtype,
                             void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, out, lse, BH, Tq, Tk, D, scale,
                                  causal, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, lse, BH, Tq, Tk, D,
                                          scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
