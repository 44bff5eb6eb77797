// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16 with a
// head dim D that is a multiple of 8 and at most 128: K1's sm90 route.
//
// Replaces the Pallas TPU kernel mxtpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_pallas), as flash_fwd.cu does for f32 and
// the other head dims. Per (batch*head) and query row i it takes the
// online softmax over the key axis and writes the normalised output O
// (bf16) and the row's f32 log-sum-exp. Causal masking is top-left (key j
// is visible to row i iff j <= i); key tiles past a query tile's last row
// are never loaded.
//
// What bounds it on the card: at the training shape (B 8, H 16, T 1024,
// D 64, causal) the 1.7e10 flops of its two products take 0.0174 ms at the
// 989 TFLOP/s bf16 peak and reading q, k, v and writing O and lse take
// 0.0202 ms at 3.35 TB/s, so bytes bound it, at 0.0202 ms (NVIDIA H100
// 80GB HBM3, 700 W). The f32 CUDA-core body (flash_fwd.cu) ran at 1% of
// that bound; this one puts both products on the tensor cores and keeps
// the T x T scores out of device memory:
//   - one block owns 128 query rows of one (batch*head) at D <= 64 (64 at
//     D <= 128): a consumer warpgroup for each 64 rows, and one producer
//     warp;
//   - the producer loads Q once and streams 64-key K and V tiles into a
//     ring of 4 shared-memory stages with TMA, each stage guarded by a
//     full and an empty mbarrier, so loads run ahead of the products;
//   - S = Q K^T is wgmma m64n64k16 with both operands from shared memory,
//     K-major; the scale, the masks and the online softmax (running max,
//     sum, rescale) run on the accumulator registers, a row in one quad of
//     threads;
//   - O += P V is wgmma m64n64k16 with P from registers and V from shared
//     memory, MN-major. P enters as two bf16 terms, hi (p cut to its top
//     16 bits) and lo = bf16(p - hi): one bf16 rounding of P moves some
//     outputs of magnitude 2 to 4 by one bf16 step (0.0156), past the
//     1e-2 check, at the training shape; the pair keeps P to about 16
//     bits;
//   - a warpgroup computes tile j's scores and softmax while tile j-1's
//     P V runs on the tensor cores;
//   - blocks with the longest rows start first.
// Masked and out-of-range keys are masked in registers; rows and columns
// past T and D are zero-filled by TMA and never written.

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int BN = 64;                 // keys per tile
constexpr int STAGES = 4;              // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// NWG consumer warpgroups of 64 query rows each: two at D <= 64, one at
// D <= 128, where a warpgroup's 64 x 128 f32 output would not fit the 168
// registers a thread ptxas allows a block of two groups and a warp.
template <int DP>
struct Cfg {
  static constexpr int NH = DP / 64;                      // column slabs
  static constexpr int NWG = DP == 64 ? 2 : 1;
  static constexpr int BM = 64 * NWG;                     // rows per block
  static constexpr int NCONS = 128 * NWG;
  static constexpr int NTHREADS = NCONS + 32;             // + producer warp
  static constexpr uint32_t Q_BYTES = NH * BM * 128;
  static constexpr uint32_t KV_BYTES = NH * BN * 128;     // K or V tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
};

// P of one k16 step as two bf16 terms in the A operand's layout: hi, p
// cut to bf16 (its top 16 bits), and lo = bf16(p - hi). Their sum holds p
// to about 2^-16 of itself.
__device__ __forceinline__ void split_a(const float (&p)[32], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b0 = __float_as_uint(p[8 * kk + 2 * i]);
    const uint32_t b1 = __float_as_uint(p[8 * kk + 2 * i + 1]);
    hi[i] = __byte_perm(b0, b1, 0x7632);
    lo[i] = pack_bf16(p[8 * kk + 2 * i] - __uint_as_float(b0 & 0xffff0000u),
                      p[8 * kk + 2 * i + 1] -
                          __uint_as_float(b1 & 0xffff0000u));
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Tq, int Tk, int D,
                      float scale, int causal) {
  using C = Cfg<DP>;
  constexpr int NH = C::NH, BM = C::BM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  uint8_t* sq = align_1024(smem_raw);
  uint8_t* ring = sq + C::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  // causal: keys past the block's last row are masked for every row in it
  const int kend = causal ? min(Tk, q0 + BM) : Tk;
  const int ntiles = (kend + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NCONS) {  // the producer warp: one thread issues TMA
    if (threadIdx.x == C::NCONS) {
      mbar_expect_tx(&q_full, C::Q_BYTES);
      for (int h = 0; h < NH; ++h)
        tma_load_3d(sq + h * BM * 128, &tq, &q_full, 64 * h, q0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        uint8_t* st = ring + s * C::STAGE_BYTES;
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(st + h * BN * 128, &tk, &full[s], 64 * h, it * BN, bh);
          tma_load_3d(st + C::KV_BYTES + h * BN * 128, &tv, &full[s], 64 * h,
                      it * BN, bh);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r0 + 16 * warp + lane / 4;  // this thread's rows: row0
                                               // and row0 + 8
  const int cq = 2 * (lane % 4);               // its first column in a block
  const float sl = scale * kLog2e;             // scores to the log2 domain
  // tiles with keys this warpgroup's rows see: under causal masking the
  // block's last tile may lie wholly past its last row; none past Tq
  const int nmine = r0 >= Tq ? 0
                    : causal ? min(ntiles, (r0 + 63) / BN + 1)
                             : ntiles;

  float o[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  // running max of the raw scores (finite, so a masked tile gives p = 0
  // and never inf - inf) and this thread's share of the row sums
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};
  float sc[32];
  uint32_t hi[BN / 16][4], lo[BN / 16][4];  // P of the tile in flight

  const uint32_t qa = smem_u32(sq) + wg * 64 * 128;
  auto stage = [&](int it) { return smem_u32(ring + (it % STAGES) *
                                                        C::STAGE_BYTES); };
  // S = Q K^T of tile it into sc, committed as one group
  auto issue_s = [&](int it) {
    const uint32_t ka = stage(it);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss<0>(sc, desc_k(qa + (kk / 4) * BM * 128, kk % 4),
                            desc_k(ka + (kk / 4) * BN * 128, kk % 4), kk > 0);
    wgmma_commit();
  };
  // O += P V of tile it, P from hi and lo, committed as one group
  auto issue_pv = [&](int it) {
    const uint32_t va = stage(it) + C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t dv = desc_mn(va + h * BN * 128, kk);
        wgmma_m64n64k16_rs<1>(o[h], hi[kk], dv);
        wgmma_m64n64k16_rs<1>(o[h], lo[kk], dv);
      }
    wgmma_commit();
  };
  // masks sc, moves the running max, turns sc into p = exp(s - max) and
  // adds it to the row sums; returns each row's rescale factor in corr
  auto softmax = [&](int it, float (&corr)[2]) {
    const int k0 = it * BN;
    float mt[2] = {-INFINITY, -INFINITY};
    const bool edge = (causal && k0 + BN - 1 > r0) || k0 + BN > Tk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[4 * j + i];
        if (edge) {
          // past the key axis, or after the row (causal): no weight. The
          // reference fills the latter with -1e30, which gives the same
          // weights, since every row sees key 0 (in tile 0)
          const int col = k0 + 8 * j + cq + (i & 1);
          if (col >= Tk || (causal && col > row0 + 8 * (i >> 1)))
            x = -INFINITY;
        }
        sc[4 * j + i] = x;
        mt[i >> 1] = fmaxf(mt[i >> 1], x);
      }
    float msl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      corr[r] = ex2((m[r] - mn) * sl);
      m[r] = mn;
      msl[r] = mn * sl;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(sc[i], sl, -msl[(i >> 1) & 1]));
      l[(i >> 1) & 1] += p;
      sc[i] = p;
    }
  };

  mbar_wait(&q_full, 0);
  if (nmine > 0) {
    float corr[2];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, corr);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) split_a(sc, kk, hi[kk], lo[kk]);
    // tile it's scores run on the CUDA cores while tile it - 1's P V runs
    // on the tensor cores
    for (int it = 1; it < nmine; ++it) {
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      wgmma_fence();
      issue_s(it);
      issue_pv(it - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(it, corr);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs(o[h]);
      mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[h][i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) split_a(sc, kk, hi[kk], lo[kk]);
    }
    wgmma_fence();
    issue_pv(nmine - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(o[h]);
    mbar_arrive(&empty[(nmine - 1) % STAGES]);
  }
  for (int it = nmine; it < ntiles; ++it) {  // tiles this group skips
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    mbar_arrive(&empty[it % STAGES]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const size_t obase = (size_t)bh * Tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = out + (obase + row) * D;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * h + 8 * j + cq;
        if (col < D)  // D % 8 == 0: col + 1 < D too
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[h][4 * j + 2 * r] * inv,
                                    o[h][4 * j + 2 * r + 1] * inv);
      }
    if (lane % 4 == 0) lse[obase + row] = (m[r] * sl + log2f(l[r])) * kLn2;
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int Tq, int Tk, int D, float scale,
                   int causal, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv;
  if (!sm90_host::map_heads(&tq, q, BH, Tq, D, C::BM) ||
      !sm90_host::map_heads(&tk, k, BH, Tk, D, BN) ||
      !sm90_host::map_heads(&tv, v, BH, Tk, D, BN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_sm90_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + C::BM - 1) / C::BM, BH);
  kern<<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (BH, T, D) contiguous bf16, 16-byte aligned, D % 8 == 0 and
// D <= 128; lse: (BH, Tq) f32. Launches on `stream`; returns a cudaError_t
// (cudaErrorInvalidValue for shapes this route does not take, or when a
// tensor map cannot be made).
extern "C" int mxt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int BH, int Tq,
                                  int Tk, int D, float scale, int causal,
                                  void* stream) {
  if (BH <= 0 || BH > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return (int)launch<64>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal,
                           s);
  return (int)launch<128>(q, k, v, out, lse, BH, Tq, Tk, D, scale, causal, s);
}
