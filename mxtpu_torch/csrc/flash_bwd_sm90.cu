// Flash-attention backward for Hopper's tensor cores (sm_90a), bf16 with a
// head dim D that is a multiple of 8 and at most 128: the sm90 route of K2
// (dq), K3 (dk, dv) and the fused K4 (all three in one launch).
//
// Replaces the Pallas TPU kernels of mxtpu/ops/attention.py, launched by
// _flash_backward_pallas, as flash_bwd.cu does for f32 and the other head
// dims:
//   K2  _flash_bwd_dq_kernel     dq for one tile of query rows
//   K3  _flash_bwd_dkv_kernel    dk, dv for one tile of keys
//   K4  _flash_bwd_fused_kernel  tile i in both roles (MXTPU_FLASH_BWD=fused)
// Each recomputes the probabilities from the forward's saved log-sum-exp
// and takes the row term Delta = rowsum(dO * O) - dlse from the launcher:
//   P = exp(scale q.k - lse),  dP = dO . v,  dS = P * (dP - Delta),
//   dq = scale * dS K,  dv = P^T dO,  dk = scale * dS^T q.
// Causal masking is top-left (key j is visible to row i iff j <= i);
// masked and out-of-range entries get P = 0. lse and Delta arrive as f32
// rows, or bf16 rows under MXTPU_FLASH_LSE=bf16, widened here; all sums
// are f32, and P and dS are rounded to bf16 before the products that take
// them.
//
// What bounds them on the card: at the training shape (B 8, H 16, T 1024,
// D 64, causal) K2's three T x T x D products, halved by causality, are
// 2.6e10 flops, 0.0261 ms at the 989 TFLOP/s bf16 peak, above the 0.0254
// ms its bytes take at 3.35 TB/s; K3's four are 0.0348 ms and K4's five
// 0.0435 ms: operations bound all three (NVIDIA H100 80GB HBM3, 700 W).
// The f32 CUDA-core bodies (flash_bwd.cu) ran at 1% of that; these put
// every product on the tensor cores and take 0.1332, 0.1646 and 0.2560 ms
// there (5.1, 4.7 and 5.9 times their bounds; PERF.md). One set of tile
// constants and two tile bodies serve the three kernels, so K4's dq is
// K2's and its dk, dv are K3's, bit for bit:
//   - a block owns BM = 128 rows at D <= 64 (64 at D <= 128): a consumer
//     warpgroup for each 64, whose rows stay in shared memory and whose
//     sums stay in registers, and one producer warp that streams the other
//     side's tiles through a ring of 4 shared-memory stages with TMA, each
//     guarded by a full and an empty mbarrier;
//   - dq body: the block's q and dO rows are loaded once; 64-key K and V
//     tiles stream up to the causal diagonal. S = Q K^T and dP = dO V^T are
//     wgmma with both operands from shared memory, K-major, M = query rows;
//     dS lands in registers in the A operand's layout, so dQ += dS K is
//     wgmma with A from registers and the K tile read MN-major. Each thread
//     keeps the lse and Delta of its two rows in registers;
//   - dk/dv body: the block's K and V rows are loaded once; tiles of BQ
//     query rows (64, or 32 at D > 64 to keep four accumulators in
//     registers) stream from the tile holding the block's first key (the
//     causal start), their lse and Delta rows copied into the stage by the
//     producer's lanes (a 1-D TMA box over the flat rows faulted where a
//     tile starts off a 16-byte boundary, as at T = 77). The transposes are
//     computed directly, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T land
//     in the A operand's layout of dV += P^T dO and dK += dS^T Q;
//   - K4: block i runs the dq body for query tile i, then the dk/dv body
//     for key tile i, in one shared-memory region (the larger body's) with
//     a barrier between them and a set of mbarriers for each body; under
//     causal masking every block then does about the same work;
//   - a warpgroup skips a tile that lies wholly past its rows (causal);
//     the longest blocks start first; every output element has one writer:
//     no atomics, and the result does not depend on the order the blocks
//     run in.
// Every tile is 64-column slabs of 128-byte-swizzled rows (sm90.cuh); the
// q and dO maps take boxes of BQ rows and the K and V maps of 64, so one
// map per tensor serves both bodies.

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int STAGES = 4;              // ring depth of both bodies
constexpr int BN = 64;                 // keys per K/V tile of the dq body
constexpr float kLog2e = 1.4426950408889634f;

// NWG consumer warpgroups of 64 rows each: two at D <= 64; one at D <= 128,
// where ptxas allows a block of two groups and a warp 168 registers a
// thread and of one group 255.
template <int DP>
struct Cfg {
  static constexpr int NH = DP / 64;                      // column slabs
  static constexpr int NWG = DP == 64 ? 2 : 1;
  static constexpr int BM = 64 * NWG;                     // a block's rows
  static constexpr int BQ = DP == 64 ? 64 : 32;           // dk/dv q tile
  static constexpr int NCONS = 128 * NWG;
  static constexpr int NTHREADS = NCONS + 32;             // + producer warp
  static constexpr uint32_t RES_BYTES = NH * BM * 128;    // q, dO or K, V
  static constexpr uint32_t KT_BYTES = NH * BN * 128;     // a K or V tile
  static constexpr uint32_t QT_BYTES = NH * BQ * 128;     // a q or dO tile
  // a dq stage: K, V; a dk/dv stage: q, dO, the tile's lse and Delta rows
  static constexpr uint32_t DQ_STAGE = 2 * KT_BYTES;
  static constexpr uint32_t DKV_STAGE =
      (2 * QT_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr size_t DQ_SMEM = 1024 + 2 * RES_BYTES + STAGES * DQ_STAGE;
  static constexpr size_t DKV_SMEM =
      1024 + 2 * RES_BYTES + STAGES * DKV_STAGE;
  static constexpr size_t FUSED_SMEM =
      DQ_SMEM > DKV_SMEM ? DQ_SMEM : DKV_SMEM;
};

struct Args {
  const void* lse;    // (BH, Tq) f32 or bf16
  const void* delta;  // (BH, Tq) f32 or bf16
  __nv_bfloat16* dq;  // (BH, Tq, D)
  __nv_bfloat16* dk;  // (BH, Tk, D)
  __nv_bfloat16* dv;  // (BH, Tk, D)
  int Tq, Tk, D;
  float scale;
  int causal;
  int rows_bf16;
};

struct Maps {
  const CUtensorMap* q;   // boxes of BQ rows
  const CUtensorMap* k;   // boxes of 64 rows
  const CUtensorMap* v;   // boxes of 64 rows
  const CUtensorMap* dout;  // boxes of BQ rows
};

// A body's mbarriers: its resident rows, and the ring's full and empty.
struct Bars {
  uint64_t res, full[STAGES], empty[STAGES];
};

__device__ __forceinline__ void init_bars(Bars& b, uint32_t full_count,
                                          uint32_t ncons) {
  mbar_init(&b.res, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&b.full[s], full_count);
    mbar_init(&b.empty[s], ncons);
  }
}

__device__ __forceinline__ float load_row(const void* p, size_t i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Loads the n resident rows from r0 of every column slab of one head into
// dst (n rows a slab), in boxes of `box` rows, completing `bar`. A box that
// starts at or past T is not loaded: its rows belong to results that are
// never written.
template <int NH>
__device__ __forceinline__ void load_resident(uint8_t* dst,
                                              const CUtensorMap* m0,
                                              const CUtensorMap* m1,
                                              uint64_t* bar, int r0, int n,
                                              int box, int T, int bh) {
  const int nb = min(n / box, (T - r0 + box - 1) / box);
  mbar_expect_tx(bar, 2u * NH * nb * box * 128);
  for (int h = 0; h < NH; ++h)
    for (int b = 0; b < nb; ++b) {
      const uint32_t off = h * n * 128 + b * box * 128;
      tma_load_3d(dst + off, m0, bar, 64 * h, r0 + b * box, bh);
      tma_load_3d(dst + NH * n * 128 + off, m1, bar, 64 * h, r0 + b * box,
                  bh);
    }
}

// The SS product of one k16 step with N = BQ.
template <int BQ>
__device__ __forceinline__ void mma_ss(float (&d)[BQ / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (BQ == 64)
    wgmma_m64n64k16_ss<0>(d, da, db, accumulate);
  else
    wgmma_m64n32k16_ss<0>(d, da, db, accumulate);
}

// The consumers' part of the dq body: S, dP and dS of each key tile, and
// dQ += dS K in registers.
template <int DP>
__device__ __forceinline__ void dq_consume(const Args& a, int bh, int q0,
                                           int ntiles, uint8_t* smem,
                                           Bars& b) {
  using C = Cfg<DP>;
  constexpr int NH = C::NH, BM = C::BM;
  const uint8_t* ring = smem + 2 * C::RES_BYTES;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + 64 * wg;                  // this warpgroup's rows
  const int row0 = r0 + 16 * warp + lane / 4;   // this thread's rows: row0
                                                // and row0 + 8
  const int cq = 2 * (lane % 4);                // first column in a block
  const float sl = a.scale * kLog2e;
  // tiles with keys this warpgroup's rows see: none past Tq; under causal
  // masking the block's last tile may lie wholly past its last row
  const int nmine = r0 >= a.Tq ? 0
                    : a.causal ? min(ntiles, (r0 + 63) / BN + 1)
                               : ntiles;

  // rows past Tq take 0: their results are never written
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t ri = (size_t)bh * a.Tq + row;
    lse2[r] = row < a.Tq ? load_row(a.lse, ri, a.rows_bf16) * kLog2e : 0.f;
    del[r] = row < a.Tq ? load_row(a.delta, ri, a.rows_bf16) : 0.f;
  }
  float dqa[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[h][i] = 0.f;

  const uint32_t qa = smem_u32(smem) + wg * 64 * 128;   // q, then dO
  const uint32_t doa = qa + C::RES_BYTES;
  mbar_wait(&b.res, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&b.full[s], (it / STAGES) & 1);
    if (it < nmine) {
      const uint32_t ka = smem_u32(ring + s * C::DQ_STAGE);
      const uint32_t va = ka + C::KT_BYTES;
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_m64n64k16_ss<0>(sc, desc_k(qa + (kk / 4) * BM * 128, kk % 4),
                              desc_k(ka + (kk / 4) * BN * 128, kk % 4),
                              kk > 0);
        wgmma_m64n64k16_ss<0>(dp, desc_k(doa + (kk / 4) * BM * 128, kk % 4),
                              desc_k(va + (kk / 4) * BN * 128, kk % 4),
                              kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const int k0 = it * BN;
      const bool edge = (a.causal && k0 + BN - 1 > r0) || k0 + BN > a.Tk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1, x = 4 * j + i;
          float p = ex2(fmaf(sc[x], sl, -lse2[r]));
          if (edge) {
            const int key = k0 + 8 * j + cq + (i & 1), row = row0 + 8 * r;
            if (key >= a.Tk || (a.causal && key > row)) p = 0.f;
          }
          dp[x] = p * (dp[x] - del[r]);
        }

      // dS in the A operand's layout; the fence orders these register
      // writes before the products read them
      uint32_t ads[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(dp, kk, ads[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_m64n64k16_rs<1>(dqa[h], ads[kk],
                                desc_mn(ka + h * BN * 128, kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs(dqa[h]);
    }
    mbar_arrive(&b.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Tq) continue;
    __nv_bfloat16* out = a.dq + ((size_t)bh * a.Tq + row) * a.D;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * h + 8 * j + cq;
        if (col < a.D) {  // D % 8 == 0: col + 1 < D too
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dqa[h][i] * a.scale,
                                    dqa[h][i + 1] * a.scale);
        }
      }
  }
}

// dq for query rows [q0, q0 + BM) of head bh (K2's body).
template <int DP>
__device__ __forceinline__ void dq_body(const Maps& m, const Args& a,
                                        int bh, int q0, uint8_t* smem,
                                        Bars& b) {
  using C = Cfg<DP>;
  constexpr int NH = C::NH, BM = C::BM;
  // causal: keys past the block's last row are masked for every row in it
  const int kend = a.causal ? min(a.Tk, q0 + BM) : a.Tk;
  const int ntiles = (kend + BN - 1) / BN;
  if (threadIdx.x < C::NCONS) {
    dq_consume<DP>(a, bh, q0, ntiles, smem, b);
  } else if (threadIdx.x == C::NCONS) {  // one producer thread issues TMA
    load_resident<NH>(smem, m.q, m.dout, &b.res, q0, BM, C::BQ, a.Tq, bh);
    uint8_t* ring = smem + 2 * C::RES_BYTES;   // stage s: K, then V
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&b.empty[s], ((it / STAGES) - 1) & 1);
      mbar_expect_tx(&b.full[s], C::DQ_STAGE);
      uint8_t* st = ring + s * C::DQ_STAGE;
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(st + h * BN * 128, m.k, &b.full[s], 64 * h, it * BN, bh);
        tma_load_3d(st + C::KT_BYTES + h * BN * 128, m.v, &b.full[s],
                    64 * h, it * BN, bh);
      }
    }
  }
}

// The consumers' part of the dk/dv body: S^T, dP^T, P^T and dS^T of each
// query tile, and dV += P^T dO, dK += dS^T Q in registers.
template <int DP>
__device__ __forceinline__ void dkv_consume(const Args& a, int bh, int k0,
                                            int qstart, int ntiles,
                                            uint8_t* smem, Bars& b) {
  using C = Cfg<DP>;
  constexpr int NH = C::NH, BQ = C::BQ, BM = C::BM;
  constexpr int NC = BQ / 2;  // accumulator floats of S^T and dP^T
  const uint8_t* ring = smem + 2 * C::RES_BYTES;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int kw = k0 + 64 * wg;                     // this warpgroup's keys
  const int key0 = kw + 16 * warp + lane / 4;      // this thread's keys:
                                                   // key0 and key0 + 8
  const int cq = 2 * (lane % 4);                   // first column in a block
  const float sl = a.scale * kLog2e;

  float dka[NH][32], dva[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.f;

  const uint32_t ka = smem_u32(smem) + wg * 64 * 128;   // K, then V
  const uint32_t va = ka + C::RES_BYTES;
  mbar_wait(&b.res, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const int q0 = qstart + it * BQ;
    mbar_wait(&b.full[s], (it / STAGES) & 1);
    // a tile wholly before this warpgroup's first key (causal), or a
    // warpgroup wholly past Tk, has nothing to add
    if (kw < a.Tk && !(a.causal && q0 + BQ - 1 < kw)) {
      const uint8_t* st = ring + s * C::DKV_STAGE;
      const uint32_t qa = smem_u32(st);
      const uint32_t doa = qa + C::QT_BYTES;
      const float* rows =
          reinterpret_cast<const float*>(st + 2 * C::QT_BYTES);
      float sc[NC], dp[NC];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_ss<BQ>(sc, desc_k(ka + (kk / 4) * BM * 128, kk % 4),
                   desc_k(qa + (kk / 4) * BQ * 128, kk % 4), kk > 0);
        mma_ss<BQ>(dp, desc_k(va + (kk / 4) * BM * 128, kk % 4),
                   desc_k(doa + (kk / 4) * BQ * 128, kk % 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = (a.causal && kw + 63 > q0) || q0 + BQ > a.Tq ||
                        kw + 64 > a.Tk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + cq + c;  // query row q0 + col
          const float lse2 = rows[col] * kLog2e;
          const float d = rows[BQ + col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + c;
            float p = ex2(fmaf(sc[i], sl, -lse2));
            if (edge) {
              const int key = key0 + 8 * r, qi = q0 + col;
              if (qi >= a.Tq || key >= a.Tk || (a.causal && key > qi))
                p = 0.f;
            }
            sc[i] = p;
            dp[i] = p * (dp[i] - d);
          }
        }

      // P^T and dS^T in the A operand's layout
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
    mbar_arrive(&b.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Tk) continue;
    const size_t o = ((size_t)bh * a.Tk + key) * a.D;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * h + 8 * j + cq;
        if (col < a.D) {  // D % 8 == 0: col + 1 < D too
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(a.dk + o + col) =
              __floats2bfloat162_rn(dka[h][i] * a.scale,
                                    dka[h][i + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + o + col) =
              __floats2bfloat162_rn(dva[h][i], dva[h][i + 1]);
        }
      }
  }
}

// dk, dv for keys [k0, k0 + BM) of head bh (K3's body).
template <int DP>
__device__ __forceinline__ void dkv_body(const Maps& m, const Args& a,
                                         int bh, int k0, uint8_t* smem,
                                         Bars& b) {
  using C = Cfg<DP>;
  constexpr int NH = C::NH, BQ = C::BQ;
  // causal: rows before the block's first key see none of its keys
  const int qstart = a.causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = qstart < a.Tq ? (a.Tq - qstart + BQ - 1) / BQ : 0;
  if (threadIdx.x < C::NCONS) {
    dkv_consume<DP>(a, bh, k0, qstart, ntiles, smem, b);
    return;
  }
  // the producer warp: one thread issues TMA, every lane copies rows
  const int lane = threadIdx.x - C::NCONS;
  if (lane == 0)
    load_resident<NH>(smem, m.k, m.v, &b.res, k0, C::BM, 64, a.Tk, bh);
  uint8_t* ring = smem + 2 * C::RES_BYTES;     // stage s: q, dO, rows
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const int q0 = qstart + it * BQ;
    if (it >= STAGES) mbar_wait(&b.empty[s], ((it / STAGES) - 1) & 1);
    uint8_t* st = ring + s * C::DKV_STAGE;
    if (lane == 0) {  // q and dO by TMA
      mbar_expect_tx(&b.full[s], 2 * C::QT_BYTES);
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(st + h * BQ * 128, m.q, &b.full[s], 64 * h, q0, bh);
        tma_load_3d(st + C::QT_BYTES + h * BQ * 128, m.dout, &b.full[s],
                    64 * h, q0, bh);
      }
    }
    // the rows by the lanes, widened to f32; rows past Tq are masked by
    // the consumers
    float* rows = reinterpret_cast<float*>(st + 2 * C::QT_BYTES);
    for (int i = lane; i < BQ; i += 32) {
      const int qi = q0 + i;
      const size_t ri = (size_t)bh * a.Tq + qi;
      rows[i] = qi < a.Tq ? load_row(a.lse, ri, a.rows_bf16) : 0.f;
      rows[BQ + i] = qi < a.Tq ? load_row(a.delta, ri, a.rows_bf16) : 0.f;
    }
    mbar_arrive(&b.full[s]);
  }
}

// The dk/dv body's full barrier takes the TMA thread's arrival with the
// tile bytes and one arrival a producer lane once its rows are stored.
constexpr uint32_t kDkvFull = 1 + 32;

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Bars b;
  if (threadIdx.x == 0) {
    init_bars(b, 1, Cfg<DP>::NCONS);
    mbar_fence_init();
  }
  __syncthreads();
  // causal: the last query tiles have the most keys, so they start first
  dq_body<DP>(Maps{&tq, &tk, &tv, &tdo}, a, blockIdx.y,
              (gridDim.x - 1 - blockIdx.x) * Cfg<DP>::BM,
              align_1024(smem_raw), b);
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Bars b;
  if (threadIdx.x == 0) {
    init_bars(b, kDkvFull, Cfg<DP>::NCONS);
    mbar_fence_init();
  }
  __syncthreads();
  // causal: the first key tiles have the most query rows
  dkv_body<DP>(Maps{&tq, &tk, &tv, &tdo}, a, blockIdx.y,
               blockIdx.x * Cfg<DP>::BM, align_1024(smem_raw), b);
}

// Tq == Tk: block i runs the dq body for query tile i, then the dk/dv body
// for key tile i. Each body has its own mbarriers, so neither inherits the
// other's phases; the barrier between them keeps the dk/dv body's loads off
// the shared memory until the dq body has read its last tile.
template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS, 1)
flash_bwd_fused_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Bars bq, bkv;
  if (threadIdx.x == 0) {
    init_bars(bq, 1, Cfg<DP>::NCONS);
    init_bars(bkv, kDkvFull, Cfg<DP>::NCONS);
    mbar_fence_init();
  }
  __syncthreads();
  const Maps m{&tq, &tk, &tv, &tdo};
  uint8_t* smem = align_1024(smem_raw);
  const int i0 = blockIdx.x * Cfg<DP>::BM;
  dq_body<DP>(m, a, blockIdx.y, i0, smem, bq);
  __syncthreads();
  dkv_body<DP>(m, a, blockIdx.y, i0, smem, bkv);
}

enum Which { kDq = 0, kDkv = 1, kFused = 2 };

template <int DP, typename Kern>
cudaError_t launch_one(Kern kern, int nblocks, int BH, size_t smem,
                       const CUtensorMap (&maps)[4], const Args& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nblocks, BH), Cfg<DP>::NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const Args& a, int BH, int which,
                   cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap maps[4];
  if (!sm90_host::map_heads(&maps[0], q, BH, a.Tq, a.D, C::BQ) ||
      !sm90_host::map_heads(&maps[1], k, BH, a.Tk, a.D, BN) ||
      !sm90_host::map_heads(&maps[2], v, BH, a.Tk, a.D, BN) ||
      !sm90_host::map_heads(&maps[3], dout, BH, a.Tq, a.D, C::BQ))
    return cudaErrorInvalidValue;
  const int nq = (a.Tq + C::BM - 1) / C::BM;
  const int nk = (a.Tk + C::BM - 1) / C::BM;
  if (which == kDq)
    return launch_one<DP>(flash_bwd_dq_sm90_kernel<DP>, nq, BH, C::DQ_SMEM,
                          maps, a, stream);
  if (which == kDkv)
    return launch_one<DP>(flash_bwd_dkv_sm90_kernel<DP>, nk, BH,
                          C::DKV_SMEM, maps, a, stream);
  return launch_one<DP>(flash_bwd_fused_sm90_kernel<DP>, nq, BH,
                        C::FUSED_SMEM, maps, a, stream);
}

}  // namespace

// q, dout: (BH, Tq, D); k, v: (BH, Tk, D); contiguous bf16, 16-byte
// aligned, D % 8 == 0 and D <= 128. lse, delta: (BH, Tq) rows, f32 or
// (rows_bf16) bf16. which = 0 writes dq (K2), 1 writes dk and dv (K3), 2
// writes all three (K4, Tq == Tk); the outputs are bf16, shaped as q, k,
// v. Launches on `stream`; returns a cudaError_t (cudaErrorInvalidValue
// for shapes this route does not take, or when a tensor map cannot be
// made).
extern "C" int mxt_flash_bwd_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int BH,
                                  int Tq, int Tk, int D, float scale,
                                  int causal, int rows_bf16, int which,
                                  void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || which < kDq || which > kFused ||
      (which == kFused && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  const Args a{lse, delta, static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), Tq, Tk, D, scale, causal,
               rows_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)launch<64>(q, k, v, dout, a, BH, which, s);
  return (int)launch<128>(q, k, v, dout, a, BH, which, s);
}
