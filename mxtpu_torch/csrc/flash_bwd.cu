// Flash-attention backward for Hopper (sm_90a), the simt route: K2 (dq),
// K3 (dk, dv) and the fused K4 (dq, dk and dv in one launch) in f32 sums
// on the CUDA cores, for f32 and for the head dims the tensor-core route
// (flash_bwd_sm90.cu: bf16 with D % 8 == 0 and D <= 128) does not take.
//
// Replaces the Pallas TPU kernels of mxtpu/ops/attention.py, launched by
// _flash_backward_pallas:
//   K2  _flash_bwd_dq_kernel     dq for one query tile
//   K3  _flash_bwd_dkv_kernel    dk, dv for one key tile
//   K4  _flash_bwd_fused_kernel  tile i in both roles (MXTPU_FLASH_BWD=fused)
// Every kernel recomputes the probabilities from the forward's saved
// log-sum-exp, P = exp(s - lse) with s = scale q . k, and takes the row
// term Delta = rowsum(dO * O) - dlse from the launcher (computed outside
// any kernel, as the reference does):
//   dP = dO . V^T,  dS = P * (dP - Delta),
//   dq = scale * dS . K,  dk = scale * dS^T . q,  dv = P^T . dO.
// Causal masking is top-left (key j is visible to row i iff j <= i);
// masked and out-of-range entries get P = 0, which is what exp(-1e30 -
// lse) gives the reference. lse and Delta arrive as f32 rows, or as bf16
// rows under MXTPU_FLASH_LSE=bf16, and are widened to f32 here. All sums
// are f32.
//
// What bounds them on the card: K2 does three T x Tk x D products per
// (batch, head), K3 four and K4 seven (half of each when causal), over
// inputs of 4 x T x D elements, so at the training shapes (T = 1024,
// D = 64) they sit far above the H100's flops-per-byte balance and are
// bound by arithmetic: in f32 at the training shape (B 8, H 16, causal)
// 0.385 ms for K2, 0.513 for K3 and 0.642 for K4 at the 67 TFLOP/s f32
// peak (NVIDIA H100 80GB HBM3, 700 W). The bodies run every product on
// register micro-tiles (simt.cuh), keep the T x Tk probabilities out of
// device memory and give every output element exactly one writer, so
// there are no atomics and the result does not depend on the order the
// blocks run in:
//   K2  one block owns BQ query rows (scale q and dO resident in shared
//       memory; 128 at D <= 64) and streams K/V tiles of BK keys (64),
//       double-buffered by cp.async, up to the causal diagonal; per tile
//       S and dP (8 rows x 4 keys a thread at D <= 64), dS into shared
//       memory, dq += dS K (8 rows x 4 columns a thread, in registers);
//   K3  one block owns BKV key rows (scale k and v resident; 128 at
//       D <= 64) and streams q/dO tiles of BQ2 rows (64), double-buffered
//       by cp.async, from the tile holding its first key (the causal
//       start) to the end; per tile S and dP (4 rows x 8 keys a thread),
//       P and dS into shared memory, dv += P^T dO and dk += dS^T q (4 keys
//       x 8 columns of each a thread);
//   K4  block i runs K2's body for query tile i, then K3's for key tile i:
//       key tiles j <= i for dq and query tiles j >= i for dk/dv, so under
//       causal masking every block does about the same work. Its sums are
//       this file's K2 and K3's, in the same order: its dq, dk and dv equal
//       theirs bit for bit.
//
// Left behind from the TPU kernels: the 128-lane head-dim padding, the
// 8-sublane broadcast of the lse and Delta rows, and the block legality
// rule with its T % 128 gate. Any T, any Tk and any D <= 256 are taken;
// ragged edges are masked here. K4 needs T == Tk, as the reference's.

#include "simt.cuh"

namespace {

using namespace simt;

__device__ __forceinline__ float load_row(const void* p, size_t i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

struct Args {
  const void* q;      // (BH, Tq, D)
  const void* k;      // (BH, Tk, D)
  const void* v;      // (BH, Tk, D)
  const void* dout;   // (BH, Tq, D)
  const void* lse;    // (BH, Tq) f32 or bf16
  const void* delta;  // (BH, Tq) f32 or bf16
  void* dq;           // (BH, Tq, D)
  void* dk;           // (BH, Tk, D)
  void* dv;           // (BH, Tk, D)
  int Tq, Tk, D;
  float scale;
  int causal;
  int rows_bf16;
  int async;          // stream tiles by cp.async (f32, D % 4 == 0, aligned)
};

// K2's tiles: BQ resident query rows, BK keys a streamed tile.
template <int DMAX>
struct DqTiles {
  static constexpr int BQ = DMAX <= 64 ? 128 : DMAX <= 128 ? 64 : 32;
  static constexpr int BK = DMAX <= 64 ? 64 : 32;
  static constexpr int LD = DMAX + kPad, LDS = BK + kPadP;
  static constexpr int TM = BQ / 16, TN = BK / 16, TJ = DMAX / 64;
  // resident q, dO; two stages of (k, v); the tile's dS
  static constexpr size_t kFloats =
      (size_t)2 * BQ * LD + (size_t)4 * BK * LD + (size_t)BQ * LDS;
};

// K3's tiles: BKV resident keys, BQ2 query rows a streamed tile. The
// dk/dv outputs (BKV x DMAX each) go to KG = BKV / 4 key groups of 4
// keys by CG column groups, TJ chunks of 4 columns, CS columns apart.
template <int DMAX>
struct DkvTiles {
  static constexpr int BKV = DMAX <= 64 ? 128 : 32;
  static constexpr int BQ2 = DMAX <= 128 ? 64 : 32;
  static constexpr int LD = DMAX + kPad, LDS = BKV + kPadP;
  static constexpr int TM = BQ2 / 16, TN = BKV / 16;
  static constexpr int CG = kThreads / (BKV / 4), CS = 4 * CG,
                       TJ = DMAX / CS;
  // resident k, v; two stages of (q, dO); the tile's P and dS
  static constexpr size_t kFloats =
      (size_t)2 * BKV * LD + (size_t)4 * BQ2 * LD + (size_t)2 * BQ2 * LDS;
};

// K4 runs both bodies in one block, in the larger body's shared memory.
template <int DMAX> constexpr size_t FusedFloats() {
  return DqTiles<DMAX>::kFloats > DkvTiles<DMAX>::kFloats
             ? DqTiles<DMAX>::kFloats : DkvTiles<DMAX>::kFloats;
}

// dq for query rows [q0, q0 + BQ) of head bh (K2's body).
template <typename T, int DMAX>
__device__ __forceinline__ void dq_tile(const Args& a, int bh, int q0,
                                        float* smem) {
  using C = DqTiles<DMAX>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDS = C::LDS;
  constexpr int TM = C::TM, TN = C::TN, TJ = C::TJ;
  float* sq = smem;                // [BQ][LD]  scale * q
  float* sdo = sq + BQ * LD;       // [BQ][LD]  dO
  float* skv = sdo + BQ * LD;      // [2 stages][k, v][BK][LD]
  float* sds = skv + 4 * BK * LD;  // [BQ][LDS]  dS of the tile

  const int D = a.D;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.Tk * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.Tk * D;

  // causal: keys past the tile's last row are masked for every row in it
  const int kend = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int ntiles = (kend + BK - 1) / BK;
  auto issue = [&](int t) {
    float* st = skv + (t & 1) * 2 * BK * LD;
    stage<BK, DMAX>(st, LD, kb, t * BK, a.Tk, D, a.async);
    stage<BK, DMAX>(st + BK * LD, LD, vb, t * BK, a.Tk, D, a.async);
    cp_async_commit();
  };
  issue(0);
  const size_t qo = (size_t)bh * a.Tq * D;
  stage_sync<BQ, DMAX>(sq, LD, static_cast<const T*>(a.q) + qo, q0, a.Tq, D,
                       a.scale);
  stage_sync<BQ, DMAX>(sdo, LD, static_cast<const T*>(a.dout) + qo, q0, a.Tq,
                       D, 1.f);
  float lse[TM], delta[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg + 16 * i;
    const size_t ri = (size_t)bh * a.Tq + row;
    lse[i] = row < a.Tq ? load_row(a.lse, ri, a.rows_bf16) : 0.f;
    delta[i] = row < a.Tq ? load_row(a.delta, ri, a.rows_bf16) : 0.f;
  }

  float acc[TM][4 * TJ] = {};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q, dO) are in shared memory
    const float* sk = skv + (t & 1) * 2 * BK * LD;
    const float* sv = sk + BK * LD;
    const int k0 = t * BK;

    float s[TM][TN] = {}, dp[TM][TN] = {};
    nt<TM, TN, DMAX>(s, sq + rg * LD, 16 * LD, sk + cg * LD, 16 * LD);
    nt<TM, TN, DMAX>(dp, sdo + rg * LD, 16 * LD, sv + cg * LD, 16 * LD);
    const bool edge = edge_tile(q0, BQ, k0, BK, a.Tq, a.Tk, a.causal);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = q0 + rg + 16 * i, col = k0 + cg + 16 * j;
        const bool vis = !edge || visible(row, col, a.Tq, a.Tk, a.causal);
        const float p = vis ? expf(s[i][j] - lse[i]) : 0.f;
        sds[(rg + 16 * i) * LDS + cg + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncwarp();  // a row's dS comes from its own half-warp
    nn<TM, TJ, BK>(acc, sds + rg * LDS, 16 * LDS, sk + cg * 4, LD);
    __syncthreads();  // tile t and dS are consumed
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= a.Tq) continue;
    T* out = static_cast<T*>(a.dq) + ((size_t)bh * a.Tq + row) * D;
#pragma unroll
    for (int u = 0; u < TJ; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * u + 4 * cg + e;
        if (c < D) out[c] = from_f32<T>(acc[i][4 * u + e] * a.scale);
      }
  }
}

// dk, dv for key rows [k0, k0 + BKV) of head bh (K3's body).
template <typename T, int DMAX>
__device__ __forceinline__ void dkv_tile(const Args& a, int bh, int k0,
                                         float* smem) {
  using C = DkvTiles<DMAX>;
  constexpr int BKV = C::BKV, BQ2 = C::BQ2, LD = C::LD, LDS = C::LDS;
  constexpr int TM = C::TM, TN = C::TN, CS = C::CS, TJ = C::TJ;
  float* sk = smem;                 // [BKV][LD]  scale * k
  float* sv = sk + BKV * LD;        // [BKV][LD]
  float* sqd = sv + BKV * LD;       // [2 stages][q, dO][BQ2][LD]
  float* sp = sqd + 4 * BQ2 * LD;   // [BQ2][LDS]  P of the tile
  float* sds = sp + BQ2 * LDS;      // [BQ2][LDS]  dS of the tile

  const int D = a.D;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  // the dk/dv thread: keys 4 kg .. 4 kg + 3, column chunks at 4 oc + CS u
  const int kg = threadIdx.x / C::CG, oc = threadIdx.x % C::CG;
  const size_t qo = (size_t)bh * a.Tq * D;
  const T* qb = static_cast<const T*>(a.q) + qo;
  const T* dob = static_cast<const T*>(a.dout) + qo;

  // causal: rows before the tile's first key see none of its keys
  const int qstart = a.causal ? (k0 / BQ2) * BQ2 : 0;
  const int ntiles = a.Tq > qstart ? (a.Tq - qstart + BQ2 - 1) / BQ2 : 0;
  auto issue = [&](int t) {
    float* st = sqd + (t & 1) * 2 * BQ2 * LD;
    stage<BQ2, DMAX>(st, LD, qb, qstart + t * BQ2, a.Tq, D, a.async);
    stage<BQ2, DMAX>(st + BQ2 * LD, LD, dob, qstart + t * BQ2, a.Tq, D,
                     a.async);
    cp_async_commit();
  };
  if (ntiles > 0) issue(0);
  const size_t ko = (size_t)bh * a.Tk * D;
  stage_sync<BKV, DMAX>(sk, LD, static_cast<const T*>(a.k) + ko, k0, a.Tk, D,
                        a.scale);
  stage_sync<BKV, DMAX>(sv, LD, static_cast<const T*>(a.v) + ko, k0, a.Tk, D,
                        1.f);

  float dk[4][4 * TJ] = {}, dv[4][4 * TJ] = {};
  for (int t = 0; t < ntiles; ++t) {
    const int q0 = qstart + t * BQ2;
    float lse[TM], delta[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + rg + 16 * i;
      const size_t ri = (size_t)bh * a.Tq + row;
      lse[i] = row < a.Tq ? load_row(a.lse, ri, a.rows_bf16) : 0.f;
      delta[i] = row < a.Tq ? load_row(a.delta, ri, a.rows_bf16) : 0.f;
    }
    if (t + 1 < ntiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and k, v) are in shared memory
    const float* sq = sqd + (t & 1) * 2 * BQ2 * LD;
    const float* sdo = sq + BQ2 * LD;

    float s[TM][TN] = {}, dp[TM][TN] = {};
    nt<TM, TN, DMAX>(s, sq + rg * LD, 16 * LD, sk + cg * LD, 16 * LD);
    nt<TM, TN, DMAX>(dp, sdo + rg * LD, 16 * LD, sv + cg * LD, 16 * LD);
    const bool edge = edge_tile(q0, BQ2, k0, BKV, a.Tq, a.Tk, a.causal);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = q0 + rg + 16 * i, col = k0 + cg + 16 * j;
        const bool vis = !edge || visible(row, col, a.Tq, a.Tk, a.causal);
        const float p = vis ? expf(s[i][j] - lse[i]) : 0.f;
        const int o = (rg + 16 * i) * LDS + cg + 16 * j;
        sp[o] = p;
        sds[o] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();  // every row's P and dS of the tile are written
    tn<TJ, CS, BQ2>(dv, sp + 4 * kg, LDS, sdo + 4 * oc, LD);
    tn<TJ, CS, BQ2>(dk, sds + 4 * kg, LDS, sq + 4 * oc, LD);
    __syncthreads();  // tile t, P and dS are consumed
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = k0 + 4 * kg + e;
    if (key >= a.Tk) continue;
    const size_t o = ((size_t)bh * a.Tk + key) * D;
    T* dko = static_cast<T*>(a.dk) + o;
    T* dvo = static_cast<T*>(a.dv) + o;
#pragma unroll
    for (int u = 0; u < TJ; ++u)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int c = CS * u + 4 * oc + f;
        if (c < D) {
          dko[c] = from_f32<T>(dk[e][4 * u + f] * a.scale);
          dvo[c] = from_f32<T>(dv[e][4 * u + f]);
        }
      }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(DqTiles<DMAX>::kFloats))
    flash_bwd_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  // causal: the last query tiles have the most keys, so they start first
  dq_tile<T, DMAX>(a, blockIdx.y,
                   (gridDim.x - 1 - blockIdx.x) * DqTiles<DMAX>::BQ,
                   reinterpret_cast<float*>(smem4));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(DkvTiles<DMAX>::kFloats))
    flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  // causal: the first key tiles have the most query rows
  dkv_tile<T, DMAX>(a, blockIdx.y, blockIdx.x * DkvTiles<DMAX>::BKV,
                    reinterpret_cast<float*>(smem4));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(FusedFloats<DMAX>()))
    flash_bwd_fused_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  if (i * DqTiles<DMAX>::BQ < a.Tq)
    dq_tile<T, DMAX>(a, blockIdx.y, i * DqTiles<DMAX>::BQ, smem);
  __syncthreads();  // the phases share the shared memory
  if (i * DkvTiles<DMAX>::BKV < a.Tk)
    dkv_tile<T, DMAX>(a, blockIdx.y, i * DkvTiles<DMAX>::BKV, smem);
}

enum Which { kDq = 0, kDkv = 1, kFused = 2 };

template <typename Kern>
cudaError_t launch_one(Kern kern, dim3 grid, size_t smem, const Args& a,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, int BH, int which, cudaStream_t stream) {
  using Q = DqTiles<DMAX>;
  using K = DkvTiles<DMAX>;
  const int nq = (a.Tq + Q::BQ - 1) / Q::BQ;
  const int nk = (a.Tk + K::BKV - 1) / K::BKV;
  if (which == kDq)
    return launch_one(flash_bwd_dq_kernel<T, DMAX>, dim3(nq, BH),
                      Q::kFloats * sizeof(float), a, stream);
  if (which == kDkv)
    return launch_one(flash_bwd_dkv_kernel<T, DMAX>, dim3(nk, BH),
                      K::kFloats * sizeof(float), a, stream);
  return launch_one(flash_bwd_fused_kernel<T, DMAX>,
                    dim3(nq > nk ? nq : nk, BH),
                    FusedFloats<DMAX>() * sizeof(float), a, stream);
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int BH, int which,
                       cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(a, BH, which, stream);
  if (a.D <= 128) return launch<T, 128>(a, BH, which, stream);
  return launch<T, 256>(a, BH, which, stream);
}

}  // namespace

// q, dout: (BH, Tq, D); k, v: (BH, Tk, D), contiguous in one dtype (0 =
// f32, 1 = bf16); lse, delta: (BH, Tq) rows, f32 or (rows_bf16) bf16.
// which = 0 writes dq (K2), 1 writes dk and dv (K3), 2 writes all three
// (K4, Tq == Tk). Outputs take the inputs' dtype. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int mxt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int BH, int Tq, int Tk, int D, float scale,
                             int causal, int dtype, int rows_bf16, int which,
                             void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 256 ||
      which < kDq || which > kFused || (which == kFused && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  // streamed tiles (k, v for dq; q, dO for dk/dv) go by cp.async where
  // they are 16-byte aligned f32 rows
  const int async = dtype == 0 && D % 4 == 0 && aligned16(q) &&
                    aligned16(k) && aligned16(v) && aligned16(dout);
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               Tq, Tk, D, scale, causal, rows_bf16, async};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(a, BH, which, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(a, BH, which, s);
  return (int)cudaErrorInvalidValue;
}
