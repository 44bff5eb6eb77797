// Dequant-attention decode for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel
// mxtpu/ops/quant_attention.py:_dequant_decode_kernel (launched by
// _decode_pallas). One query row per (slot, head) attends over that slot's
// int8 or fp8 (e4m3) paged KV cache, positions 0..pc[slot] (clipped into
// [0, TOT - 1]): each K and V row is dequantized with its f32 row scale
// inside the softmax. No dequantized (S, H, TOT, D) tensor ever exists in
// device memory, which is the reason the kernel exists.
//
// What bounds it on the card: bytes. Each position up to pc costs
// 2 * (D + 4) bytes (a K and a V row of one-byte values and their f32
// scales) for ~4 * D flops. One query row makes every product an m = 1
// product, so wgmma and the tensor cores (64-row tiles) have nothing to
// offer: the floor is the cache bytes over the HBM rate, and the design's
// job is to keep enough of those bytes in flight to reach it.
// - Split over positions (flash-decoding). The grid is (S * H, NSPLIT):
//   block (bh, c) takes positions [c * C, c * C + C) of one (slot, head)
//   and returns at once when its chunk starts past the slot's cursor. The
//   wrapper picks C, a multiple of 32, from the shape alone, so that the
//   grid reaches about four blocks per SM where TOT allows: a one-position
//   prefill step (S = 1, 12 heads) runs 12 * NSPLIT blocks, not 12.
// - Staging by cp.async. A chunk's K rows of one (slot, head) are one
//   contiguous run of bytes. 128 threads copy its live rows into shared
//   memory as 16-byte words, with their K scales, in one commit group, and
//   the V rows with their scales in a second, so that V lands while the
//   scores are computed. Where D % 16 != 0 or the cache is not 16-byte
//   aligned, the widest aligned copy goes instead: 8 or 4 bytes by
//   cp.async, else single bytes by plain loads. Rows sit DP = D rounded up
//   to 16 bytes apart in shared memory, zero past D; rows past the cursor
//   are neither copied nor read.
// - Scores. A group of G lanes (D / 16 rounded up to a power of two) owns
//   one row, one 16-byte word (16 values) per lane: dequantized in
//   registers (int8 by byte permutes into the mantissa of 2^23, fp8 two at
//   a time by the e4m3x2 convert), dotted with the scaled query held in
//   registers, reduced across the group by shuffles, times the row's K
//   scale: D / 16 parallel chains of 16 FMAs, not one chain of D, and two
//   rows a group at a time.
// - P V. The chunk's softmax weights p * vs[t] (the V scale folded into
//   the weight) sit in shared memory; each thread owns one 16-byte word of
//   columns and a stripe of rows, the stripes are summed by shuffles
//   within a warp and the warps' sums through shared memory, in a fixed
//   order.
// - Merge. Each live chunk writes its partial (m, l, o[D]) in f32 to a
//   workspace; a second, small kernel, launched by the same entry point on
//   the same stream when TOT > C, merges the live chunks in chunk order,
//   so the result does not depend on which block finished first. It goes
//   as a programmatic dependent launch: its blocks are placed while the
//   chunk kernel runs, and every one of them waits for it at
//   griddepcontrol.wait before it ends, so the next kernel on the stream
//   starts after both. When only chunk 0 is live, its block writes the
//   normalized output itself.
//
// Left behind from the TPU kernel: the 128-lane head-dim padding, the
// 8-sublane broadcast of the query, the scales and the cursor, and the
// bucket legality rule (_legal_bucket): every TOT is taken, and every D up
// to 512, the Pallas path's own limit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The block's shape and shared memory are decided here alone: the wrapper
// asks mxt_dequant_decode_max_chunk for the largest C a block holds.
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DMAX = 512;              // the Pallas path's limit on D
constexpr int SMEM_MAX = 48 * 1024;    // no opt-in attribute needed
constexpr int RED_BYTES = DMAX * NWARPS * 4;  // DMAX floats a warp
constexpr float kMasked = -1e30f;      // the reference's mask fill value

struct Args {
  const void* q;
  const uint8_t* kd;
  const float* ks;
  const uint8_t* vd;
  const float* vs;
  const int* pc;
  void* out;
  float* ws;   // partials of every (bh, chunk), when nsplit > 1: o rows of
               // DO floats, then every m, then every l
  int BH, H, TOT, D, DP, DO, C, nsplit;  // DP: D up to 16 bytes; DO: to 4
  float scale;
};

// shared memory of one block: K and V chunks (C rows of DP bytes), their
// scales and the weights (C floats each), each warp's sum of its stripes
// (16 * G <= DMAX floats), and 2 floats a warp
inline int smem_bytes(int C, int DP) {
  return C * (2 * DP + 12) + RED_BYTES + 2 * NWARPS * 4;
}

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

__device__ __forceinline__ int clipped_cursor(const int* pc, int slot,
                                              int TOT) {
  return min(max(pc[slot], 0), TOT - 1);
}

// ------------------------------------------------------------- staging

// One W-byte word from global to shared memory; zero where !fill (nothing
// is read then). W = 16, 8, 4 by cp.async (complete after cp_async_wait
// and a block barrier), W = 1 by a plain load.
template <int W>
__device__ __forceinline__ void copy_word(uint8_t* dst, const uint8_t* src,
                                          bool fill) {
  if constexpr (W == 1) {
    *dst = fill ? *src : 0;
  } else {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (W == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(fill ? 16 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                   "l"(src), "n"(W), "r"(fill ? W : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A chunk's n live rows (row t at src + t * D) into dst at DP bytes a row,
// zero past column D. Where DP == D the rows are one contiguous run, copied
// word by word; rows past the cursor are neither copied nor read.
template <int W>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                           int n, int D, int DP) {
  if (DP == D) {
    for (int e = threadIdx.x * W; e < n * D; e += NTHREADS * W)
      copy_word<W>(dst + e, src + e, true);
    return;
  }
  const int wpr = DP / W;  // words a row
  for (int e = threadIdx.x; e < n * wpr; e += NTHREADS) {
    const int t = e / wpr, c = (e - t * wpr) * W;
    const bool fill = c < D;
    copy_word<W>(dst + t * DP + c, fill ? src + (size_t)t * D + c : src,
                 fill);
  }
}

__device__ __forceinline__ void stage_scales(float* dst, const float* src,
                                             int n) {
  for (int t = threadIdx.x; t < n; t += NTHREADS)
    copy_word<4>(reinterpret_cast<uint8_t*>(dst + t),
                 reinterpret_cast<const uint8_t*>(src + t), true);
}

// K rows and scales in one commit group, V rows and scales in a second
template <int W>
__device__ __forceinline__ void stage_chunk(uint8_t* sk, uint8_t* sv,
                                            float* sks, float* svs,
                                            const Args& a, size_t row0,
                                            int n) {
  stage_rows<W>(sk, a.kd + row0 * a.D, n, a.D, a.DP);
  stage_scales(sks, a.ks + row0, n);
  cp_async_commit();
  stage_rows<W>(sv, a.vd + row0 * a.D, n, a.D, a.DP);
  stage_scales(svs, a.vs + row0, n);
  cp_async_commit();
}

// ------------------------------------------------------------- dequant

// 16 one-byte values to f32. KV 0 = int8: each byte, biased by 128, is put
// in the low mantissa byte of 2^23 (0x4B0000xx = 2^23 + xx, exact) by a
// byte permute and the bias taken off. KV 1 = fp8 e4m3 (finite-only, as
// torch's float8_e4m3fn): two values a convert, through f16, exact.
template <int KV>
__device__ __forceinline__ void deq16(const uint4 w, float (&x)[16]);
template <>
__device__ __forceinline__ void deq16<0>(const uint4 w, float (&x)[16]) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[4 * i + k] =
          __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7540 + k)) -
          8388736.f;
}
template <>
__device__ __forceinline__ void deq16<1>(const uint4 w, float (&x)[16]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(u[i] >> (16 * h)), __NV_E4M3);
      const float2 f = __half22float2(__half2(r));
      x[4 * i + 2 * h] = f.x;
      x[4 * i + 2 * h + 1] = f.y;
    }
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

// ------------------------------------------------------------- kernels

// Block (bh, chunk): the chunk's partial softmax and P V. G lanes a row;
// thread (r, j) = (threadIdx.x / G, threadIdx.x % G) owns 16-byte word j of
// rows r, r + R, r + 2R, ... (R = 128 / G).
template <typename TQ, int KV, int G>
__global__ void __launch_bounds__(NTHREADS)
dequant_decode_kernel(const Args a, int width) {
  constexpr int R = NTHREADS / G;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sk = smem;
  uint8_t* sv = sk + a.C * a.DP;
  float* sks = reinterpret_cast<float*>(sv + a.C * a.DP);
  float* svs = sks + a.C;
  float* sw = svs + a.C;       // scores, then weights p * vs
  float* red = sw + a.C;       // each warp's stripes summed: 16 * G floats
  float* swarp = red + NWARPS * DMAX;

  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = tid % G, r = tid / G;
  const bool word = 16 * j < a.DP;  // lanes past the row's last word idle
  // the query's loads go out with the cursor's, before the cursor is known
  float qr[16];
  const TQ* q = static_cast<const TQ*>(a.q) + (size_t)bh * a.D;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = 16 * j + i;
    qr[i] = d < a.D ? to_f32(q[d]) * a.scale : 0.f;
  }
  const int lim = clipped_cursor(a.pc, bh / a.H, a.TOT);
  const int t0 = chunk * a.C;
  if (t0 > lim) return;
  const int n = min(a.C, lim - t0 + 1);  // live rows of this chunk
  const size_t row0 = (size_t)bh * a.TOT + t0;
  if (width == 16)
    stage_chunk<16>(sk, sv, sks, svs, a, row0, n);
  else if (width == 8)
    stage_chunk<8>(sk, sv, sks, svs, a, row0, n);
  else if (width == 4)
    stage_chunk<4>(sk, sv, sks, svs, a, row0, n);
  else
    stage_chunk<1>(sk, sv, sks, svs, a, row0, n);


  cp_async_wait<1>();  // K rows and scales
  __syncthreads();
  // two rows a group per step (four independent FMA chains a thread); the
  // loop bound is the same for every thread, so the group shuffles are
  // taken by whole warps
  for (int tb = 0; tb < n; tb += 2 * R) {
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tb + u * R + r;
      if (t < n && word) {
        float x[16];
        deq16<KV>(*reinterpret_cast<const uint4*>(sk + t * a.DP + 16 * j),
                  x);
        float e = 0.f;
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          acc[u] = fmaf(qr[i], x[i], acc[u]);
          e = fmaf(qr[i + 1], x[i + 1], e);
        }
        acc[u] += e;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tb + u * R + r;
      if (t < n && j == 0) sw[t] = acc[u] * sks[t];
    }
  }
  __syncthreads();
  float m = kMasked;
  for (int t = tid; t < n; t += NTHREADS) m = fmaxf(m, sw[t]);
  m = warp_max(m);
  if (lane == 0) swarp[warp] = m;
  cp_async_wait<0>();  // V rows and scales
  __syncthreads();
  m = swarp[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, swarp[w]);
  float l = 0.f;
  for (int t = tid; t < n; t += NTHREADS) {
    const float p = expf(sw[t] - m);
    l += p;
    sw[t] = p * svs[t];
  }
  l = warp_sum(l);
  if (lane == 0) swarp[NWARPS + warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) l += swarp[NWARPS + w];

  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  if (word) {
#pragma unroll 2
    for (int t = r; t < n; t += R) {
      const float wt = sw[t];
      float x[16];
      deq16<KV>(*reinterpret_cast<const uint4*>(sv + t * a.DP + 16 * j), x);
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] = fmaf(wt, x[i], o[i]);
    }
  }
  // the warp's stripes of one word by shuffles, then the warps' sums
  // through shared memory
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
  if (lane < G && word) {
    float4* dst = reinterpret_cast<float4*>(red + warp * 16 * G + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2],
                           o[4 * i + 3]);
  }
  __syncthreads();
  const bool direct = lim < a.C;  // chunk 0 is the only live chunk
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const size_t part = (size_t)bh * a.nsplit + chunk;
  for (int c = tid; c < a.D; c += NTHREADS) {
    float s = red[c];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) s += red[w * 16 * G + c];
    if (direct)
      static_cast<TQ*>(a.out)[(size_t)bh * a.D + c] = from_f32<TQ>(s * inv);
    else
      a.ws[part * a.DO + c] = s;
  }
  if (!direct && tid == 0) {
    const size_t parts = (size_t)a.BH * a.nsplit;
    a.ws[parts * a.DO + part] = m;
    a.ws[parts * (a.DO + 1) + part] = l;
  }
}

// One block a (slot, head): merges its live chunks' partials in chunk
// order, when more than chunk 0 is live. Thread (cl, qd) holds float4 qd
// of the partial rows of chunks cl, cl + lanes, ...: the loads of up to
// lanes * KREG chunks are all issued before the first is used. Launched as
// a programmatic dependent of the chunk kernel: its blocks may start
// early, and every block waits for that kernel's whole grid (and its
// memory) before it ends, also a block with nothing to merge. A kernel
// launched after this one waits only for this grid, so it sees the whole
// output only if this grid cannot end before the chunk kernel: the output
// of a lone chunk 0 is written by the chunk kernel itself.
constexpr int KREG = 4;
template <typename TQ>
__global__ void __launch_bounds__(NTHREADS)
dequant_combine_kernel(const Args a) {
  __shared__ __align__(16) float red[NTHREADS * 4];
  __shared__ float swarp[NWARPS];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int live = clipped_cursor(a.pc, bh / a.H, a.TOT) / a.C + 1;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (live == 1) return;
  const size_t parts = (size_t)a.BH * a.nsplit;
  const float* o = a.ws + (size_t)bh * a.nsplit * a.DO;
  const float* m = a.ws + parts * a.DO + (size_t)bh * a.nsplit;
  const float* l = m + parts;
  const int nq = a.DO / 4;                    // float4s a row, <= 128
  const int lanes = NTHREADS / nq;            // chunk lanes
  const int qd = tid % nq, cl = tid / nq;
  const bool mine = cl < lanes;
  float4 ov[KREG];
  float mv[KREG];
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    const int c = cl + k * lanes;
    const bool use = mine && c < live;
    ov[k] = use ? reinterpret_cast<const float4*>(o + (size_t)c * a.DO)[qd]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    mv[k] = use ? m[c] : kMasked;
  }
  // the first NTHREADS chunks' m and l go out with the partial rows
  const float m0 = tid < live ? m[tid] : kMasked;
  const float l0 = tid < live ? l[tid] : 0.f;
  float M = m0;
  for (int c = tid + NTHREADS; c < live; c += NTHREADS) M = fmaxf(M, m[c]);
  M = warp_max(M);
  if (tid % 32 == 0) swarp[tid / 32] = M;
  __syncthreads();
  M = swarp[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) M = fmaxf(M, swarp[w]);
  float L = l0 * expf(m0 - M);
  for (int c = tid + NTHREADS; c < live; c += NTHREADS)
    L += l[c] * expf(m[c] - M);
  L = warp_sum(L);
  __syncthreads();
  if (tid % 32 == 0) swarp[tid / 32] = L;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    const float f = expf(mv[k] - M);  // 0 for a chunk not taken
    acc.x = fmaf(ov[k].x, f, acc.x);
    acc.y = fmaf(ov[k].y, f, acc.y);
    acc.z = fmaf(ov[k].z, f, acc.z);
    acc.w = fmaf(ov[k].w, f, acc.w);
  }
  for (int c = cl + KREG * lanes; mine && c < live; c += lanes) {
    const float4 v = reinterpret_cast<const float4*>(o + (size_t)c * a.DO)[qd];
    const float f = expf(m[c] - M);
    acc.x = fmaf(v.x, f, acc.x);
    acc.y = fmaf(v.y, f, acc.y);
    acc.z = fmaf(v.z, f, acc.z);
    acc.w = fmaf(v.w, f, acc.w);
  }
  if (mine) reinterpret_cast<float4*>(red)[cl * nq + qd] = acc;
  __syncthreads();
  L = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) L += swarp[w];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = tid; d < a.D; d += NTHREADS) {
    float s = red[d];
    for (int k = 1; k < lanes; ++k) s += red[k * 4 * nq + d];
    static_cast<TQ*>(a.out)[(size_t)bh * a.D + d] = from_f32<TQ>(s * inv);
  }
}

template <typename TQ, int KV, int G>
cudaError_t launch(const Args& a, int width, cudaStream_t stream) {
  const dim3 grid(a.BH, a.nsplit);
  dequant_decode_kernel<TQ, KV, G>
      <<<grid, NTHREADS, smem_bytes(a.C, a.DP), stream>>>(a, width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  // the merge as a programmatic dependent launch: its blocks are placed
  // while the chunk kernel runs, so no launch gap stands between the two
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.BH);
  cfg.blockDim = dim3(NTHREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dequant_combine_kernel<TQ>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// lanes a row: the row's 16-byte words, rounded up to a power of two
template <typename TQ, int KV>
cudaError_t dispatch_g(const Args& a, int width, cudaStream_t s) {
  const int words = a.DP / 16;
  if (words <= 1) return launch<TQ, KV, 1>(a, width, s);
  if (words <= 2) return launch<TQ, KV, 2>(a, width, s);
  if (words <= 4) return launch<TQ, KV, 4>(a, width, s);
  if (words <= 8) return launch<TQ, KV, 8>(a, width, s);
  if (words <= 16) return launch<TQ, KV, 16>(a, width, s);
  return launch<TQ, KV, 32>(a, width, s);
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const Args& a, int width,
                        cudaStream_t s) {
  if (kv_dtype == 0) return dispatch_g<TQ, 0>(a, width, s);
  if (kv_dtype == 1) return dispatch_g<TQ, 1>(a, width, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (S, H, D) in q_dtype (0 = f32, 1 = bf16); kd, vd: (S, H, TOT, D)
// in kv_dtype (0 = int8, 1 = fp8 e4m3); ks, vs: (S, H, TOT) f32; pc: (S,)
// int32. C: positions a block, a multiple of 32; ws: S * H * ceil(TOT / C)
// * (D rounded up to 4, + 2) floats of scratch, 16-byte aligned, needed
// when TOT > C. width: bytes a copy
// (16, 8 or 4, which must divide D and the cache's base addresses; 1
// always works). Launches on `stream`; returns cudaGetLastError().
extern "C" int mxt_dequant_decode(const void* q, const void* kd,
                                  const void* ks, const void* vd,
                                  const void* vs, const void* pc, void* out,
                                  void* ws, int S, int H, int TOT, int D,
                                  int C, float scale, int q_dtype,
                                  int kv_dtype, int width, void* stream) {
  if (S <= 0 || H <= 0 || TOT <= 0 || D <= 0 || D > DMAX || C <= 0 ||
      C % 32 != 0 || (long long)S * H > 2147483647LL ||
      (width != 16 && width != 8 && width != 4 && width != 1) ||
      D % width != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.kd = static_cast<const uint8_t*>(kd);
  a.ks = static_cast<const float*>(ks);
  a.vd = static_cast<const uint8_t*>(vd);
  a.vs = static_cast<const float*>(vs);
  a.pc = static_cast<const int*>(pc);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.BH = S * H;
  a.H = H;
  a.TOT = TOT;
  a.D = D;
  a.DP = (D + 15) / 16 * 16;
  a.DO = (D + 3) / 4 * 4;
  a.C = C;
  a.nsplit = (TOT + C - 1) / C;
  a.scale = scale;
  if (smem_bytes(C, a.DP) > SMEM_MAX || a.nsplit > 65535 ||
      (a.nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, a, width, s);
  if (q_dtype == 1)
    return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, a, width, s);
  return (int)cudaErrorInvalidValue;
}

// The largest C (a multiple of 32) whose block fits its shared memory at
// head dim D, for the wrapper's chunk-size rule; 0 for a D not taken.
extern "C" int mxt_dequant_decode_max_chunk(int D) {
  if (D <= 0 || D > DMAX) return 0;
  const int DP = (D + 15) / 16 * 16;
  return (SMEM_MAX - smem_bytes(0, DP)) / (2 * DP + 12) / 32 * 32;
}
