// Building blocks shared by the CUDA-core ("simt") flash-attention kernels,
// flash_fwd.cu (K1) and flash_bwd.cu (K2, K3, K4): tile staging with
// cp.async, three tile products on register micro-tiles, and the masking
// rule. Every sum is an f32 FMA on the CUDA cores.
//
// Tiles. A tile of q, k, v or dO rows sits in shared memory as f32, row
// major, DMAX + 4 floats a row. Rows start on 16-byte boundaries, so a
// thread reads 4 floats with one 16-byte load, and the 4 spare floats shift
// each row by 4 banks, so the rows a warp reads at once fall in distinct
// banks. Columns D..DMAX-1 hold zeros: products run over DMAX columns with
// no test of D. Probability tiles (P, dS) have BC + 16 floats a row, which
// shifts neighbouring rows by 16 banks.
//
// Threads. A block has 256 threads, 16 row groups by 16 column groups:
// thread t has rg = t / 16 and cg = t % 16, so a row group is one
// half-warp. In a score tile (rows x keys) the thread owns rows rg + 16 i
// and keys cg + 16 j; in an output tile (rows x head columns) the same rows
// and the 4-column chunks at 4 cg + 64 u. Its row max and row sums reduce
// with shuffles within its half-warp, and the probabilities its rows need
// for an output tile were written by its own half-warp.
//
// Products. Per step along the reduction axis a thread loads one 16-byte
// fragment of each operand row or column chunk it owns and issues 16 FMAs
// for each pair of fragments (a 4 x 4 micro-tile), so two 16-byte shared
// loads feed 16 to 64 FMAs where a scalar design spends one load per FMA.
// The sums run in a fixed order, so equal inputs give equal bits in every
// kernel that calls the same body.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simt {

constexpr int kThreads = 256;
constexpr int kPad = 4;             // spare floats a q/k/v/dO row
constexpr int kPadP = 16;           // spare floats a P/dS row
constexpr float kMasked = -1e30f;   // the reference's causal fill value

// Blocks an SM holds at `floats` of shared memory each (228 KB an SM, 1 KB
// of it reserved per block): the launch bound that tells the compiler the
// registers each thread may take (2 blocks: 128).
__host__ __device__ constexpr int min_blocks(size_t floats) {
  return floats * 4 + 1024 <= 114 * 1024 ? 2 : 1;
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------- staging

// Whether a tensor's rows can go by cp.async: 16-byte aligned (the host
// checks this; f32 rows with D % 4 == 0 then keep the alignment).
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a row-major (n, D) tensor into dst (ld floats a
// row) as f32 times mul, zero past row n and past column D up to DMAX.
template <int ROWS, int DMAX, typename T>
__device__ __forceinline__ void stage_sync(float* dst, int ld, const T* src,
                                           int r0, int n, int D, float mul) {
  constexpr int CH = DMAX / 4;  // 4-float chunks a row
  for (int e = threadIdx.x; e < ROWS * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) {
      const T* s = src + (size_t)(r0 + r) * D;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < D) x[u] = to_f32(s[c + u]) * mul;
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The same rows unscaled, by cp.async where `async` (f32, D % 4 == 0,
// 16-byte aligned tensor): the copy lands while the block computes, and is
// complete after cp_async_wait and a block barrier. Otherwise (bf16, or
// rows that are not 16-byte aligned) staged at once, widened to f32.
template <int ROWS, int DMAX>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int r0, int n, int D, bool async) {
  if (!async) return stage_sync<ROWS, DMAX>(dst, ld, src, r0, n, D, 1.f);
  constexpr int CH = DMAX / 4;
  for (int e = threadIdx.x; e < ROWS * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool fill = r0 + r < n && c < D;
    cp_async16(dst + r * ld + c, fill ? src + (size_t)(r0 + r) * D + c : src,
               fill);
  }
}
template <int ROWS, int DMAX>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const __nv_bfloat16* src, int r0, int n,
                                      int D, bool) {
  stage_sync<ROWS, DMAX>(dst, ld, src, r0, n, D, 1.f);
}

// ------------------------------------------------------------- products

// Scores: acc[i][j] += sum_{d < R} a[i * as + d] * b[j * bs + d], the
// thread's TM rows of A and TN rows of B both read along d.
template <int TM, int TN, int R>
__device__ __forceinline__ void nt(float (&acc)[TM][TN], const float* a,
                                   int as, const float* b, int bs) {
#pragma unroll 4
  for (int d = 0; d < R; d += 4) {
    float4 x[TM], y[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = ld4(a + i * as + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = ld4(b + j * bs + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows of an output: acc[i][4u + e] += sum_{k < R} a[i * as + k] *
// b[k * ldb + 64 u + e], A (probabilities) read along k, B (k or v rows)
// read along its columns: the thread's TJ chunks, 64 columns apart.
template <int TM, int TJ, int R>
__device__ __forceinline__ void nn(float (&acc)[TM][4 * TJ], const float* a,
                                   int as, const float* b, int ldb) {
#pragma unroll 2
  for (int k = 0; k < R; k += 4) {
    float4 x[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = ld4(a + i * as + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 y[TJ];
#pragma unroll
      for (int u = 0; u < TJ; ++u) y[u] = ld4(b + (k + kk) * ldb + 64 * u);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xi = lane(x[i], kk);
#pragma unroll
        for (int u = 0; u < TJ; ++u) {
          acc[i][4 * u + 0] = fmaf(xi, y[u].x, acc[i][4 * u + 0]);
          acc[i][4 * u + 1] = fmaf(xi, y[u].y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(xi, y[u].z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(xi, y[u].w, acc[i][4 * u + 3]);
        }
      }
    }
  }
}

// Rows of a key-side output: acc[e][4u + f] += sum_{r < R} a[r * lda + e] *
// b[r * ldb + CS u + f], A (P or dS, 4 keys) and B (dO or q rows, TJ
// chunks CS columns apart) both read along their columns.
template <int TJ, int CS, int R>
__device__ __forceinline__ void tn(float (&acc)[4][4 * TJ], const float* a,
                                   int lda, const float* b, int ldb) {
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const float4 x = ld4(a + r * lda);
    float4 y[TJ];
#pragma unroll
    for (int u = 0; u < TJ; ++u) y[u] = ld4(b + r * ldb + CS * u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xe = lane(x, e);
#pragma unroll
      for (int u = 0; u < TJ; ++u) {
        acc[e][4 * u + 0] = fmaf(xe, y[u].x, acc[e][4 * u + 0]);
        acc[e][4 * u + 1] = fmaf(xe, y[u].y, acc[e][4 * u + 1]);
        acc[e][4 * u + 2] = fmaf(xe, y[u].z, acc[e][4 * u + 2]);
        acc[e][4 * u + 3] = fmaf(xe, y[u].w, acc[e][4 * u + 3]);
      }
    }
  }
}

// ------------------------------------------------------------- masking

// Whether the score of query row `row` against key `col` counts: inside
// both axes and, under the top-left causal mask, col <= row.
__device__ __forceinline__ bool visible(int row, int col, int Tq, int Tk,
                                        int causal) {
  return row < Tq && col < Tk && !(causal && col > row);
}

// Whether a tile of query rows [q0, q0 + bq) and keys [k0, k0 + bk) needs
// the mask at all: it crosses an edge or the causal diagonal.
__device__ __forceinline__ bool edge_tile(int q0, int bq, int k0, int bk,
                                          int Tq, int Tk, int causal) {
  return q0 + bq > Tq || k0 + bk > Tk || (causal && k0 + bk - 1 > q0);
}

// Sum / max over the 16 lanes of a half-warp (a row group).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace simt
