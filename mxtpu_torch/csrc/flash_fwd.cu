// Flash-attention forward for Hopper (sm_90a), the simt route: f32 sums on
// the CUDA cores, for f32 and for the head dims the tensor-core route
// (flash_fwd_sm90.cu: bf16 with D % 8 == 0 and D <= 128) does not take.
//
// Replaces the Pallas TPU kernel mxtpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_pallas). Computes, per (batch*head) and
// query row i, the online softmax over the key axis and writes the
// normalised output O and the row's f32 log-sum-exp. Causal masking is
// top-left (key j is visible to row i iff j <= i); key tiles past a query
// tile's last row are never loaded, and only tiles that cross the diagonal
// or an edge are masked.
//
// What bounds it on the card: each K/V row it reads serves every query row
// of the tile loop, ~4*T*D flops (causal: half) per 2*D elements, so at the
// forward's shapes (T = 1024, D = 64) it sits far above the H100's
// flops-per-byte balance and is bound by arithmetic: in f32 at the scoring
// shape (B 4, H 12, causal) 0.0962 ms at the 67 TFLOP/s f32 peak. The
// design keeps the T x T score matrix out of device memory and runs both
// products on register micro-tiles (simt.cuh): one block owns 64 query rows
// (q scaled once, resident in shared memory), streams K/V tiles of BK keys
// through a double buffer filled by cp.async while the previous tile's
// products run, and holds each row's running max, partial sum and output
// in the registers of its half-warp (4 rows x 4 keys of S, 4 rows x D/16
// columns of O a thread).
//
// Left behind from the TPU kernel: the 128-lane head-dim padding, the
// 8-sublane broadcast of the lse rows, and the block legality rule with its
// T % 128 gate. Any T, any Tk and any D <= 256 are taken; ragged edges are
// masked here.

#include "simt.cuh"

namespace {

using namespace simt;

template <int DMAX>
struct Tiles {
  static constexpr int BQ = 64;                  // query rows a block
  static constexpr int BK = DMAX <= 128 ? 64 : 32;  // keys a tile
  static constexpr int LD = DMAX + kPad;
  static constexpr int LDP = BK + kPadP;
  static constexpr int TM = BQ / 16, TN = BK / 16, TJ = DMAX / 64;
  // resident q, two stages of (k, v), the tile's probabilities
  static constexpr size_t kFloats =
      (size_t)BQ * LD + (size_t)4 * BK * LD + (size_t)BQ * LDP;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, min_blocks(Tiles<DMAX>::kFloats))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int D,
                     float scale, int causal, int async) {
  using C = Tiles<DMAX>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int TM = C::TM, TN = C::TN, TJ = C::TJ;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BQ][LD]  scale * q
  float* skv = sq + BQ * LD;       // [2 stages][k, v][BK][LD]
  float* sp = skv + 4 * BK * LD;   // [BQ][LDP]  probabilities of the tile

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  // causal: keys past the tile's last row are masked for every row in it
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  auto issue = [&](int t) {
    float* st = skv + (t & 1) * 2 * BK * LD;
    stage<BK, DMAX>(st, LD, kb, t * BK, Tk, D, async);
    stage<BK, DMAX>(st + BK * LD, LD, vb, t * BK, Tk, D, async);
    cp_async_commit();
  };
  issue(0);
  stage_sync<BQ, DMAX>(sq, LD, q + (size_t)bh * Tq * D, q0, Tq, D, scale);

  float o[TM][4 * TJ] = {}, m[TM], l[TM] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) m[i] = kMasked;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) are in shared memory
    const float* sk = skv + (t & 1) * 2 * BK * LD;
    const float* sv = sk + BK * LD;
    const int k0 = t * BK;

    float s[TM][TN] = {};
    nt<TM, TN, DMAX>(s, sq + rg * LD, 16 * LD, sk + cg * LD, 16 * LD);
    if (edge_tile(q0, BQ, k0, BK, Tq, Tk, causal)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int row = q0 + rg + 16 * i, col = k0 + cg + 16 * j;
          if (col >= Tk)
            s[i][j] = -INFINITY;  // past the key axis: no weight at all
          else if (causal && col > row)
            s[i][j] = kMasked;    // as the reference masks: exp underflows
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mt = fmaxf(mt, s[i][j]);
      const float m_new = fmaxf(m[i], group_max(mt));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sp[(rg + 16 * i) * LDP + cg + 16 * j] = p;
      }
      l[i] = fmaf(corr, l[i], ps);  // this thread's keys; summed at the end
#pragma unroll
      for (int c = 0; c < 4 * TJ; ++c) o[i][c] *= corr;
    }
    __syncwarp();  // a row's probabilities come from its own half-warp
    nn<TM, TJ, BK>(o, sp + rg * LDP, 16 * LDP, sv + cg * 4, LD);
    __syncthreads();  // tile t and the probabilities are consumed
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float lc = fmaxf(group_sum(l[i]), 1e-30f);
    const int row = q0 + rg + 16 * i;
    if (row >= Tq) continue;
    const float inv = 1.f / lc;
    T* orow = out + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int u = 0; u < TJ; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * u + 4 * cg + e;
        if (c < D) orow[c] = from_f32<T>(o[i][4 * u + e] * inv);
      }
    if (cg == 0) lse[(size_t)bh * Tq + row] = m[i] + logf(lc);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int Tq, int Tk, int D, float scale,
                   int causal, int async, cudaStream_t stream) {
  using C = Tiles<DMAX>;
  const size_t smem = C::kFloats * sizeof(float);
  auto kern = flash_fwd_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + C::BQ - 1) / C::BQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Tq, Tk, D, scale, causal, async);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, void* lse, int BH, int Tq, int Tk, int D,
                       float scale, int causal, int async,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                         async, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                          async, stream);
  return launch<T, 256>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                        async, stream);
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
  // K/V rows stream by cp.async where they are 16-byte aligned f32 rows
  const int async = dtype == 0 && D % 4 == 0 && aligned16(k) && aligned16(v);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, out, lse, BH, Tq, Tk, D, scale,
                                  causal, async, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, lse, BH, Tq, Tk, D,
                                          scale, causal, 0, s);
  return (int)cudaErrorInvalidValue;
}
