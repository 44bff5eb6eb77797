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
// log-sum-exp, P = exp(s - lse) with s = (scale q) . k, and takes the row
// term Delta = rowsum(dO * O) - dlse from the launcher (computed outside
// any kernel, as the reference does):
//   dP = dO . V^T,  dS = P * (dP - Delta),
//   dq = scale * dS . K,  dk = dS^T . (scale q),  dv = P^T . dO.
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
// peak (NVIDIA H100 80GB HBM3, 700 W). These bodies run the products on
// the CUDA cores in f32 (no wgmma, no TMA), at 2.7, 3.1 and 5.0 ms there
// (PERF.md): their ceiling is the f32 FMA rate and, within it, the
// shared-memory load rate. As K1 does, the design keeps the T x Tk
// probabilities out of device memory and gives every output element
// exactly one writer, so there are no atomics and the result does not
// depend on the order the blocks run in:
//   K2  one block owns 64 query rows (4 threads per row, D/4 columns of dq
//       each in registers) and streams 32-key K/V tiles through shared
//       memory up to the causal diagonal;
//   K3  one block owns BKV key rows (64, or 32 at D > 128 so that the dk
//       and dv accumulators stay in registers: 256/BKV threads per key row,
//       D/(256/BKV) columns of each) and streams 32-row q/dO tiles from the
//       tile holding its first key (the causal start) to the end;
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
// K2 tiles (K1's layout)
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int QLANES = NTHREADS / BQ;  // threads per query row
// K3 tiles: BKV key rows per block (a template argument), BQ2 query rows
// per shared-memory tile
constexpr int BQ2 = 32;

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
};

// Shared floats each phase needs (its layout is in the function below).
__host__ __device__ constexpr size_t dq_smem_floats(int D) {
  return (size_t)(2 * BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1);
}
__host__ __device__ constexpr size_t dkv_smem_floats(int D, int bkv) {
  return (size_t)(2 * bkv + 2 * BQ2) * (D + 1) +
         (size_t)2 * BQ2 * (bkv + 1) + 2 * BQ2;
}

// dq for query rows [q0, q0 + BQ) of head bh (K2's body).
template <typename T, int DMAX>
__device__ __forceinline__ void dq_tile(const Args& a, int bh, int q0,
                                        float* smem) {
  const int D = a.D, ld = D + 1;  // odd row stride: distinct banks
  float* sq = smem;               // [BQ][ld]  scale * q
  float* sdo = sq + BQ * ld;      // [BQ][ld]  dO
  float* sk = sdo + BQ * ld;      // [BK][ld]
  float* sv = sk + BK * ld;       // [BK][ld]
  float* sds = sv + BK * ld;      // [BQ][BK + 1]  dS of the tile

  const int tid = threadIdx.x;
  const int row = tid / QLANES;
  const int lane = tid % QLANES;
  const int grow = q0 + row;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.Tq * D;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.Tq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.Tk * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.Tk * D;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e - r * D;
    const bool ok = q0 + r < a.Tq;
    const size_t g = (size_t)(q0 + r) * D + c;
    sq[r * ld + c] = ok ? to_f32(qb[g]) * a.scale : 0.f;
    sdo[r * ld + c] = ok ? to_f32(dob[g]) : 0.f;
  }
  const bool row_ok = grow < a.Tq;
  const size_t ri = (size_t)bh * a.Tq + grow;
  const float lse = row_ok ? load_row(a.lse, ri, a.rows_bf16) : 0.f;
  const float delta = row_ok ? load_row(a.delta, ri, a.rows_bf16) : 0.f;

  float acc[DMAX / QLANES];
#pragma unroll
  for (int i = 0; i < DMAX / QLANES; ++i) acc[i] = 0.f;

  // causal: keys past the tile's last row are masked for every row in it
  const int kend = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; sq/sdo are staged
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D;
      const bool ok = k0 + r < a.Tk;
      const size_t g = (size_t)(k0 + r) * D + c;
      sk[r * ld + c] = ok ? to_f32(kb[g]) : 0.f;
      sv[r * ld + c] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[BK / QLANES], dp[BK / QLANES];
#pragma unroll
    for (int t = 0; t < BK / QLANES; ++t) s[t] = dp[t] = 0.f;
    const float* qr = sq + row * ld;
    const float* dor = sdo + row * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dod = dor[d];
#pragma unroll
      for (int t = 0; t < BK / QLANES; ++t) {
        const int kr = (lane + QLANES * t) * ld + d;
        s[t] = fmaf(qd, sk[kr], s[t]);
        dp[t] = fmaf(dod, sv[kr], dp[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < BK / QLANES; ++t) {
      const int col = k0 + lane + QLANES * t;
      const bool vis = row_ok && col < a.Tk && !(a.causal && col > grow);
      const float p = vis ? expf(s[t] - lse) : 0.f;
      sds[row * (BK + 1) + lane + QLANES * t] = p * (dp[t] - delta);
    }
    __syncwarp();  // a row's dS comes from its own quad

    const float* dsr = sds + row * (BK + 1);
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = dsr[kk];
      const float* kr = sk + kk * ld;
#pragma unroll
      for (int i = 0; i < DMAX / QLANES; ++i) {
        const int c = lane + QLANES * i;
        if (c < D) acc[i] = fmaf(ds, kr[c], acc[i]);
      }
    }
  }

  if (row_ok) {
    T* out = static_cast<T*>(a.dq) + ri * D;
#pragma unroll
    for (int i = 0; i < DMAX / QLANES; ++i) {
      const int c = lane + QLANES * i;
      if (c < D) out[c] = from_f32<T>(acc[i] * a.scale);
    }
  }
}

// dk, dv for key rows [k0, k0 + BKV) of head bh (K3's body).
template <typename T, int DMAX, int BKV>
__device__ __forceinline__ void dkv_tile(const Args& a, int bh, int k0,
                                         float* smem) {
  constexpr int LANES = NTHREADS / BKV;  // threads per key row
  constexpr int NS = BQ2 / LANES;        // query rows per thread per tile
  constexpr int NC = DMAX / LANES;       // columns per thread
  const int D = a.D, ld = D + 1;
  float* sk = smem;                 // [BKV][ld]
  float* sv = sk + BKV * ld;        // [BKV][ld]
  float* sq = sv + BKV * ld;        // [BQ2][ld]  scale * q
  float* sdo = sq + BQ2 * ld;       // [BQ2][ld]
  float* sp = sdo + BQ2 * ld;       // [BQ2][BKV + 1]  P of the tile
  float* sds = sp + BQ2 * (BKV + 1);  // [BQ2][BKV + 1]  dS of the tile
  float* slse = sds + BQ2 * (BKV + 1);  // [BQ2]
  float* sdel = slse + BQ2;             // [BQ2]

  const int tid = threadIdx.x;
  const int key = tid / LANES;
  const int lane = tid % LANES;
  const int gkey = k0 + key;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.Tq * D;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.Tq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.Tk * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.Tk * D;

  for (int e = tid; e < BKV * D; e += NTHREADS) {
    const int r = e / D, c = e - r * D;
    const bool ok = k0 + r < a.Tk;
    const size_t g = (size_t)(k0 + r) * D + c;
    sk[r * ld + c] = ok ? to_f32(kb[g]) : 0.f;
    sv[r * ld + c] = ok ? to_f32(vb[g]) : 0.f;
  }

  float dk[NC], dv[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk[i] = dv[i] = 0.f;

  // causal: rows before the tile's first key see none of its keys
  const int qstart = a.causal ? (k0 / BQ2) * BQ2 : 0;
  for (int q0 = qstart; q0 < a.Tq; q0 += BQ2) {
    __syncthreads();  // the previous tile is consumed; sk/sv are staged
    for (int e = tid; e < BQ2 * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D;
      const bool ok = q0 + r < a.Tq;
      const size_t g = (size_t)(q0 + r) * D + c;
      sq[r * ld + c] = ok ? to_f32(qb[g]) * a.scale : 0.f;
      sdo[r * ld + c] = ok ? to_f32(dob[g]) : 0.f;
    }
    for (int r = tid; r < BQ2; r += NTHREADS) {
      const bool ok = q0 + r < a.Tq;
      const size_t ri = (size_t)bh * a.Tq + q0 + r;
      slse[r] = ok ? load_row(a.lse, ri, a.rows_bf16) : 0.f;
      sdel[r] = ok ? load_row(a.delta, ri, a.rows_bf16) : 0.f;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t] = dp[t] = 0.f;
    const float* kr = sk + key * ld;
    const float* vr = sv + key * ld;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int qr = (lane + LANES * t) * ld + d;
        s[t] = fmaf(sq[qr], kd, s[t]);
        dp[t] = fmaf(sdo[qr], vd, dp[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int r = lane + LANES * t;
      const int grow = q0 + r;
      const bool vis =
          grow < a.Tq && gkey < a.Tk && !(a.causal && gkey > grow);
      const float p = vis ? expf(s[t] - slse[r]) : 0.f;
      sp[r * (BKV + 1) + key] = p;
      sds[r * (BKV + 1) + key] = p * (dp[t] - sdel[r]);
    }
    __syncwarp();  // a key's P and dS come from its own lane group

    for (int r = 0; r < BQ2; ++r) {
      const float p = sp[r * (BKV + 1) + key];
      const float ds = sds[r * (BKV + 1) + key];
      const float* qrow = sq + r * ld;
      const float* dorow = sdo + r * ld;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + LANES * i;
        if (c < D) {
          dv[i] = fmaf(p, dorow[c], dv[i]);
          dk[i] = fmaf(ds, qrow[c], dk[i]);  // scale rides in through q
        }
      }
    }
  }

  if (gkey < a.Tk) {
    const size_t o = ((size_t)bh * a.Tk + gkey) * D;
    T* dko = static_cast<T*>(a.dk) + o;
    T* dvo = static_cast<T*>(a.dv) + o;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + LANES * i;
      if (c < D) {
        dko[c] = from_f32<T>(dk[i]);
        dvo[c] = from_f32<T>(dv[i]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  // causal: the last query tiles have the most keys, so they start first
  dq_tile<T, DMAX>(a, blockIdx.y, (gridDim.x - 1 - blockIdx.x) * BQ, smem);
}

template <typename T, int DMAX, int BKV>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  // causal: the first key tiles have the most query rows
  dkv_tile<T, DMAX, BKV>(a, blockIdx.y, blockIdx.x * BKV, smem);
}

template <typename T, int DMAX, int BKV>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_fused_kernel(Args a) {
  extern __shared__ float smem[];
  const int i = blockIdx.x;
  if (i * BQ < a.Tq) dq_tile<T, DMAX>(a, blockIdx.y, i * BQ, smem);
  __syncthreads();  // the phases share the shared memory
  if (i * BKV < a.Tk) dkv_tile<T, DMAX, BKV>(a, blockIdx.y, i * BKV, smem);
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
  kern<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, int BH, int which, cudaStream_t stream) {
  // dk/dv accumulators in registers: 2 * DMAX / (256 / BKV) floats a thread
  constexpr int BKV = DMAX <= 128 ? 64 : 32;
  const int nq = (a.Tq + BQ - 1) / BQ;
  const int nk = (a.Tk + BKV - 1) / BKV;
  const size_t fq = dq_smem_floats(a.D), fkv = dkv_smem_floats(a.D, BKV);
  if (which == kDq)
    return launch_one(flash_bwd_dq_kernel<T, DMAX>, dim3(nq, BH),
                      fq * sizeof(float), a, stream);
  if (which == kDkv)
    return launch_one(flash_bwd_dkv_kernel<T, DMAX, BKV>, dim3(nk, BH),
                      fkv * sizeof(float), a, stream);
  return launch_one(flash_bwd_fused_kernel<T, DMAX, BKV>,
                    dim3(nq > nk ? nq : nk, BH),
                    (fq > fkv ? fq : fkv) * sizeof(float), a, stream);
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
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               Tq, Tk, D, scale, causal, rows_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(a, BH, which, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(a, BH, which, s);
  return (int)cudaErrorInvalidValue;
}
