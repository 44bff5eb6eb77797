// Flash-attention backward dk and dv for Hopper's tensor cores (sm_90a),
// bf16 with a head dim D that is a multiple of 8 and at most 128: K3's
// sm90 route.
//
// Replaces the Pallas TPU kernel mxtpu/ops/attention.py:
// _flash_bwd_dkv_kernel (launched by _flash_backward_pallas), as
// flash_bwd.cu's dkv_tile does for f32 and the other head dims. For one
// tile of keys it recomputes the probabilities from the forward's saved
// log-sum-exp and takes the row term Delta = rowsum(dO * O) - dlse from
// the launcher:
//   P = exp(scale q.k - lse),  dP = dO . v,  dS = P * (dP - Delta),
//   dv = sum over rows of P dO,  dk = scale * sum over rows of dS q.
// Causal masking is top-left (key j is visible to row i iff j <= i);
// masked and out-of-range entries get P = 0. lse and Delta arrive as f32
// rows, or bf16 rows under MXTPU_FLASH_LSE=bf16, widened here; all sums
// are f32.
//
// What bounds it on the card: at the training shape (B 8, H 16, T 1024,
// D 64, causal) its four T x T x D products, halved by causality, are
// 3.4e10 flops, 0.0348 ms at the 989 TFLOP/s bf16 peak, against 0.0304 ms
// for its bytes at 3.35 TB/s: operations bound it, at 0.0348 ms (NVIDIA
// H100 80GB HBM3, 700 W). The f32 CUDA-core body (flash_bwd.cu's
// dkv_tile) ran at 1% of that bound; this one puts the four products on
// the tensor cores:
//   - one block owns 128 keys of one (batch*head) at D <= 64 (64 at
//     D <= 128): a consumer warpgroup for each 64 keys, whose K and V rows
//     are loaded once by TMA and whose dk and dv accumulate in registers
//     (64 x D f32 each a warpgroup), and one producer warp;
//   - the producer streams tiles of BQ query rows through a ring of 4
//     shared-memory stages, each guarded by a full and an empty mbarrier,
//     starting at the tile that holds the block's first key (the causal
//     start): q and dO by TMA, their lse and Delta rows by the warp's
//     lanes, widened to f32 (a 1-D TMA box over the flat (BH * T) rows
//     faulted on the card where a tile's rows start off a 16-byte
//     boundary, as at T = 77);
//   - the transposes are computed directly, S^T = K Q^T and dP^T = V dO^T
//     (wgmma with M = keys, both operands from shared memory, K-major), so
//     P^T and dS^T land in registers in the layout the next products take
//     as their A operand: dV += P^T dO and dK += dS^T Q (wgmma m64n64k16,
//     A from registers rounded to bf16, B from shared memory, MN-major);
//   - every output element has one writer: no atomics, and the result does
//     not depend on the order the blocks run in. The first key tiles have
//     the most query rows under causal masking and start first.

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int STAGES = 4;              // q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

// NWG consumer warpgroups of 64 keys each, and BQ query rows a tile: two
// groups and 64 rows at D <= 64; one group and 32 rows at D <= 128, so
// that the four accumulators stay in registers (ptxas allows a block of
// two groups and a warp 168 registers a thread, of one group 255).
template <int DP>
struct Cfg {
  static constexpr int NH = DP / 64;                       // column slabs
  static constexpr int NWG = DP == 64 ? 2 : 1;
  static constexpr int BQ = DP == 64 ? 64 : 32;
  static constexpr int BKV = 64 * NWG;                     // keys per block
  static constexpr int NCONS = 128 * NWG;
  static constexpr int NTHREADS = NCONS + 32;              // + producer warp
  static constexpr uint32_t KV_BYTES = NH * BKV * 128;     // K or V
  static constexpr uint32_t T_BYTES = NH * BQ * 128;       // a q or dO tile
  // a stage: q, dO, then the tile's lse and Delta rows in f32
  static constexpr uint32_t STAGE_BYTES =
      (2 * T_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * STAGE_BYTES;
};

// The SS product of one k16 step, N = BQ.
template <int BQ>
__device__ __forceinline__ void mma_ss(float (&d)[BQ / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (BQ == 64)
    wgmma_m64n64k16_ss<0>(d, da, db, accumulate);
  else
    wgmma_m64n32k16_ss<0>(d, da, db, accumulate);
}

__device__ __forceinline__ float load_row(const void* p, size_t i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const void* __restrict__ lse,
                          const void* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Tq, int Tk,
                          int D, float scale, int causal, int rows_bf16) {
  using C = Cfg<DP>;
  constexpr int NH = C::NH, BQ = C::BQ, BKV = C::BKV;
  constexpr int NC = BQ / 2;  // accumulator floats of S^T and dP^T
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];
  uint8_t* sk = align_1024(smem_raw);
  uint8_t* sv = sk + C::KV_BYTES;
  uint8_t* ring = sv + C::KV_BYTES;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  // causal: rows before the block's first key see none of its keys
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = qstart < Tq ? (Tq - qstart + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's arrival with the tile bytes, and one arrival a
      // producer lane once its share of the rows is stored
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], C::NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NCONS) {  // the producer warp
    const int lane = threadIdx.x - C::NCONS;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * C::KV_BYTES);
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(sk + h * BKV * 128, &tk, &kv_full, 64 * h, k0, bh);
        tma_load_3d(sv + h * BKV * 128, &tv, &kv_full, 64 * h, k0, bh);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const int q0 = qstart + it * BQ;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      uint8_t* st = ring + s * C::STAGE_BYTES;
      if (lane == 0) {  // q and dO by TMA
        mbar_expect_tx(&full[s], 2 * C::T_BYTES);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(st + h * BQ * 128, &tq, &full[s], 64 * h, q0, bh);
          tma_load_3d(st + C::T_BYTES + h * BQ * 128, &tdo, &full[s],
                      64 * h, q0, bh);
        }
      }
      // the rows by the lanes, widened to f32; rows past Tq are masked
      // below
      float* rows = reinterpret_cast<float*>(st + 2 * C::T_BYTES);
      for (int i = lane; i < BQ; i += 32) {
        const int qi = q0 + i;
        const size_t ri = (size_t)bh * Tq + qi;
        rows[i] = qi < Tq ? load_row(lse, ri, rows_bf16) : 0.f;
        rows[BQ + i] = qi < Tq ? load_row(delta, ri, rows_bf16) : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int kw = k0 + 64 * wg;                     // this warpgroup's keys
  const int key0 = kw + 16 * warp + lane / 4;      // this thread's keys:
                                                   // key0 and key0 + 8
  const int cq = 2 * (lane % 4);                   // first column in a block
  const float sl = scale * kLog2e;

  float dka[NH][32], dva[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.f;

  const uint32_t ka = smem_u32(sk) + wg * 64 * 128;
  const uint32_t va = smem_u32(sv) + wg * 64 * 128;
  mbar_wait(&kv_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const int q0 = qstart + it * BQ;
    mbar_wait(&full[s], (it / STAGES) & 1);
    // a tile wholly before this warpgroup's first key (causal), or a
    // warpgroup wholly past Tk, has nothing to add
    if (kw < Tk && !(causal && q0 + BQ - 1 < kw)) {
      const uint8_t* st = ring + s * C::STAGE_BYTES;
      const uint32_t qa = smem_u32(st);
      const uint32_t doa = qa + C::T_BYTES;
      const float* rows = reinterpret_cast<const float*>(st + 2 * C::T_BYTES);
      float sc[NC], dp[NC];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_ss<BQ>(sc, desc_k(ka + (kk / 4) * BKV * 128, kk % 4),
                   desc_k(qa + (kk / 4) * BQ * 128, kk % 4), kk > 0);
        mma_ss<BQ>(dp, desc_k(va + (kk / 4) * BKV * 128, kk % 4),
                   desc_k(doa + (kk / 4) * BQ * 128, kk % 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = (causal && kw + 63 > q0) || q0 + BQ > Tq ||
                        kw + 64 > Tk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + cq + c;  // query row q0 + col
          const float lse2 = rows[col] * kLog2e;
          const float del = rows[BQ + col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + c;
            float p = ex2(fmaf(sc[i], sl, -lse2));
            if (edge) {
              const int key = key0 + 8 * r, qi = q0 + col;
              if (qi >= Tq || key >= Tk || (causal && key > qi)) p = 0.f;
            }
            sc[i] = p;
            dp[i] = p * (dp[i] - del);
          }
        }

      // P^T and dS^T in the A operand's layout; the fence orders these
      // register writes before the products read them
      uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        pack_a(sc, kk, ap[kk]);
        pack_a(dp, kk, ads[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          wgmma_m64n64k16_rs<1>(dva[h], ap[kk],
                                desc_mn(doa + h * BQ * 128, kk));
          wgmma_m64n64k16_rs<1>(dka[h], ads[kk],
                                desc_mn(qa + h * BQ * 128, kk));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        fence_regs(dka[h]);
        fence_regs(dva[h]);
      }
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Tk) continue;
    const size_t o = ((size_t)bh * Tk + key) * D;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * h + 8 * j + cq;
        if (col < D) {  // D % 8 == 0: col + 1 < D too
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(dk + o + col) =
              __floats2bfloat162_rn(dka[h][i] * scale,
                                    dka[h][i + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + o + col) =
              __floats2bfloat162_rn(dva[h][i], dva[h][i + 1]);
        }
      }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int BH, int Tq, int Tk, int D,
                   float scale, int causal, int rows_bf16,
                   cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90_host::map_heads(&tq, q, BH, Tq, D, C::BQ) ||
      !sm90_host::map_heads(&tk, k, BH, Tk, D, C::BKV) ||
      !sm90_host::map_heads(&tv, v, BH, Tk, D, C::BKV) ||
      !sm90_host::map_heads(&tdo, dout, BH, Tq, D, C::BQ))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_sm90_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + C::BKV - 1) / C::BKV, BH);
  kern<<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Tq, Tk, D, scale, causal, rows_bf16);
  return cudaGetLastError();
}

}  // namespace

// q, dout: (BH, Tq, D); k, v, dk, dv: (BH, Tk, D); contiguous bf16,
// 16-byte aligned, D % 8 == 0 and D <= 128. lse, delta: (BH, Tq) rows, f32
// or (rows_bf16) bf16. Launches on `stream`; returns a cudaError_t
// (cudaErrorInvalidValue for shapes this route does not take, or when a
// tensor map cannot be made).
extern "C" int mxt_flash_bwd_dkv_sm90(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int BH, int Tq,
                                      int Tk, int D, float scale, int causal,
                                      int rows_bf16, void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return (int)launch<64>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, D,
                           scale, causal, rows_bf16, s);
  return (int)launch<128>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, D,
                          scale, causal, rows_bf16, s);
}
