// The f32 GEMM mainloop on the CUDA cores shared by the f32 routes of
// kernel A (fused_qkv_attention.cu), kernel B (mlp_block.cu) and their
// backward kernels #4 (fused_qkv_attention_bwd.cu) and #6
// (mlp_block_bwd.cu), the f32 counterpart of wgmma.cuh: a block of NT
// threads computes a BM x BN tile of C = A . B, f32 operands in device
// memory, f32 sums in registers, and hands the caller's epilogue each run
// of four neighbouring columns.
//
// True f32: every product is an fmaf on the CUDA cores, one per (row,
// column, k), summed in ascending k. No TF32 and no split of an operand
// into TF32 parts (the numeric policy of models/precision.py).
//
// What bounds it on the H100: FMA issue (67 TFLOP/s f32 at 700 W). The
// threads form an (NT / 16) x 16 grid; thread (ty, tx) owns a register
// tile of rows kRowSpan g + 4 ty + i and columns 64 j + 4 tx + c (8 x 8 at
// B's 128 x 128 tiles of 256 threads, 4 x 8 at its 32 x 128 tiles of 128
// and at #6's 128 x 128 tiles of 512, 4 x 12 at A's 128 or 160 x 192 tiles
// of 512 or 640), so a step of depth reads TM / 4 + TN / 4 float4s from
// shared memory for TM x TN FMAs. A warp holds 4 row groups by 8 column
// groups (ty = 4 (warp / 2) + lane / 8, tx = 8 (warp % 2) + lane % 8):
// each float4 load of A is 64 contiguous bytes and each of B 128, one
// shared-memory wavefront apiece. The fragments of step k + 1 are loaded
// before the FMAs of step k (double-buffered registers), so a load's
// latency hides behind them. On an H100 (700 W), B's two products and its
// LayerNorm run at 38 TFLOP/s at ViT-B/32, B = 256, S = 50, where cuBLAS's
// f32 GEMM gives 43 on the two products alone (chip_smoke.py, phase 3).
//
// Staging: K streams through a ring of kStages stages of kBK in dynamic
// shared memory, filled by cp.async copies kStages - 1 stages ahead of the
// FMAs; one barrier a stage. A stage holds A k-major ([k][m], rows BM + 4
// floats apart) so that its fragments are float4 reads along m, and B as
// [k][n]. Each operand comes in one of two layouts in device memory (the
// Major of wgmma.cuh):
//   A K-major, A (M, K) row-major (x of a forward product, dqkv of #4's
//     dx): 4-byte copies transpose it on the way in, a warp's 32 copies 4
//     rows of 8 consecutive k (one 32-byte sector a row in device
//     memory), which land on 32 distinct banks;
//   A MN-major, A^T (K, M) row-major (x of dW = x^T . dy): the stage's own
//     layout, 16-byte copies of 4 consecutive m;
//   B MN-major, B (K, N) row-major: 16-byte copies, B's rows BN floats
//     apart in the stage;
//   B K-major, B^T (N, K) row-major (W of dx = dy . W^T): 4-byte copies
//     that transpose as A's do, a warp's 32 copies 4 columns of 8
//     consecutive k, into rows BN + 4 floats apart, so that they land on 32
//     distinct banks.
// B's BN columns are BN / 64 boxes of 64 at the caller's columns
// (consecutive for a plain product, a head's q, k and v columns for kernel
// A). Rows of A at or past m_end are zero-filled without a read; K is a
// multiple of kBK, or (kRaggedK, the weight gradients, whose K is the row
// count B * S) the stage's k at or past k_end is zero-filled without a
// read, which adds nothing to a sum; the columns lie inside B.
//
// Deterministic: one block owns an output tile and walks all of K in a
// fixed order; there is no split of K and no atomic, so a repeat gives the
// same bits.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace orbit {
namespace sg {

constexpr int kThreads = 256;  // the default block: 16 x 16 threads
constexpr int kBK = 32;        // depth of a stage
constexpr int kStages = 3;     // stages of the ring (16 x 4 and, for A, 32 x 4 read
                               // slower: scripts/f32_ablation_torch.py)
constexpr int kAPad = 4;       // keeps A's k rows 16-byte aligned

// An operand's layout in device memory: A K-major is A (M, K) row-major, A
// MN-major its transpose A^T (K, M); B MN-major is B (K, N) row-major, B
// K-major B^T (N, K)
enum class Major { K, MN };

// A block of NT threads as (NT / 16) x 16: thread (ty, tx) owns rows
// kRowSpan g + 4 ty + i and columns 64 j + 4 tx + c
template <int BM, int BN, int NT = kThreads, Major kA = Major::K, Major kB = Major::MN>
struct Tile {
  static_assert(NT % 64 == 0 && NT <= 1024, "whole pairs of warps");
  static_assert(BN % 64 == 0 && BN <= 192, "column tiles of 64, 128 or 192");
  static constexpr int kRowSpan = 4 * (NT / 16);     // rows of one 4-row group across ty
  static_assert(BM % kRowSpan == 0, "whole row groups");
  static constexpr int kRowGroups = BM / kRowSpan;   // 4-row groups of a thread
  static constexpr int kColGroups = BN / 64;         // 4-column groups, 64 columns apart
  static constexpr int kTM = 4 * kRowGroups;
  static constexpr int kTN = 4 * kColGroups;
  static constexpr int kALd = BM + kAPad;
  static constexpr int kBLd = kB == Major::K ? BN + kAPad : BN;  // transposed rows padded
  static constexpr int kAFloats = kBK * kALd;
  static constexpr int kStageFloats = kAFloats + kBK * kBLd;
  static constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
  static constexpr int kACopies = BM * kBK / NT;             // 4-byte copies a thread (K-major)
  static constexpr int kAChunks = kBK * BM / 4;              // 16-byte copies a stage (MN-major)
  static constexpr int kBChunks = kBK * BN / 4;              // 16-byte copies a stage (MN-major)
  static constexpr int kBCopies = BN * kBK / NT;             // 4-byte copies a thread (K-major)
  static_assert(kA == Major::MN || kACopies % (kBK / 8) == 0,
                "each run of copies covers one row's kBK k");
  static_assert(kB == Major::MN || kBCopies % (kBK / 8) == 0,
                "each run of copies covers one column's kBK k");
};

__device__ __forceinline__ int thread_row() {  // ty
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 2) * 4 + lane / 8;
}

__device__ __forceinline__ int thread_col() {  // tx
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 2) * 8 + lane % 8;
}

template <int BM, int BN, int NT = kThreads>
using Acc = float[Tile<BM, BN, NT>::kTM][Tile<BM, BN, NT>::kTN];

// acc = A[m0 : m0 + BM, :K] . B[:K, cols] (A's rows < m_end; with
// kRaggedK the k < k_end), A and B in the layouts kA and kB with leading
// dimensions lda and ldb (A K-major: a[m * lda + k]; MN-major: a[k * lda +
// m]; B MN-major: b[k * ldb + n]; K-major: b[n * ldb + k]); nk stages of
// kBK (K / kBK, or ceil(k_end / kBK) when ragged); ring holds
// Tile<BM, BN, NT, kA, kB>::kSmemBytes. Returns with every copy landed but
// without a barrier: a caller that reuses the ring must synchronise first.
template <int BM, int BN, int NT = kThreads, Major kA = Major::K, Major kB = Major::MN,
          bool kRaggedK = false>
__device__ __forceinline__ void mainloop(const float* __restrict__ a, int lda, int m0, int m_end,
                                         const float* __restrict__ b, int ldb,
                                         const int (&cols)[BN / 64], int nk, float* ring,
                                         Acc<BM, BN, NT>& acc, int k_end = 0) {
  using L = Tile<BM, BN, NT, kA, kB>;
  const int tid = threadIdx.x;
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int i = 0; i < L::kTM; ++i)
#pragma unroll
    for (int j = 0; j < L::kTN; ++j) acc[i][j] = 0.f;
  // the column of device memory each of this thread's B copies starts at
  // (MN-major: 16-byte chunks e = tid + NT q, column 4 (e % (BN / 4)); K-major:
  // copy q -> column (q / (kBK / 8)) (NT / 8) + tid / 8)
  constexpr int kBCols = kB == Major::MN ? (L::kBChunks + NT - 1) / NT : L::kBCopies / (kBK / 8);
  int bcol[kBCols];
#pragma unroll
  for (int q = 0; q < kBCols; ++q) {
    const int cc = kB == Major::MN ? ((tid + NT * q) % (BN / 4)) * 4 : q * (NT / 8) + tid / 8;
    bcol[q] = cols[cc / 64] + cc % 64;
  }

  // A K-major: copy q -> row (q / (kBK / 8)) (NT / 8) + tid / 8, k = 8 (q %
  // (kBK / 8)) + tid % 8; A MN-major: 16-byte chunks e = tid + NT q, k = e /
  // (BM / 4), rows 4 (e % (BM / 4)) ..; B as bcol, MN-major row e / (BN / 4),
  // K-major k = 8 (q % (kBK / 8)) + tid % 8
  const auto issue = [&](int s) {
    if (s < nk) {
      float* as = ring + (s % kStages) * L::kStageFloats;
      float* bs = as + L::kAFloats;
      const int k0 = s * kBK;
      if constexpr (kA == Major::K) {
#pragma unroll
        for (int q = 0; q < L::kACopies; ++q) {
          const int m = (q / (kBK / 8)) * (NT / 8) + tid / 8, k = (q % (kBK / 8)) * 8 + tid % 8;
          const bool live = m0 + m < m_end && (!kRaggedK || k0 + k < k_end);
          __pipeline_memcpy_async(as + k * L::kALd + m,
                                  live ? a + static_cast<size_t>(m0 + m) * lda + k0 + k : a, 4,
                                  live ? 0 : 4);
        }
      } else {
#pragma unroll
        for (int q = 0; q < (L::kAChunks + NT - 1) / NT; ++q) {
          const int e = tid + NT * q;
          if (L::kAChunks % NT == 0 || e < L::kAChunks) {
            const int k = e / (BM / 4), m = (e % (BM / 4)) * 4;
            const bool live = m0 + m < m_end && (!kRaggedK || k0 + k < k_end);
            __pipeline_memcpy_async(as + k * L::kALd + m,
                                    live ? a + static_cast<size_t>(k0 + k) * lda + m0 + m : a,
                                    16, live ? 0 : 16);
          }
        }
      }
      if constexpr (kB == Major::MN) {
#pragma unroll
        for (int q = 0; q < (L::kBChunks + NT - 1) / NT; ++q) {
          const int e = tid + NT * q;
          if (L::kBChunks % NT == 0 || e < L::kBChunks) {
            const int kr = e / (BN / 4), cc = (e % (BN / 4)) * 4;
            if constexpr (kRaggedK) {
              const bool live = k0 + kr < k_end;
              __pipeline_memcpy_async(bs + kr * L::kBLd + cc,
                                      live ? b + static_cast<size_t>(k0 + kr) * ldb + bcol[q] : b,
                                      16, live ? 0 : 16);
            } else {
              __pipeline_memcpy_async(bs + kr * L::kBLd + cc,
                                      b + static_cast<size_t>(k0 + kr) * ldb + bcol[q], 16);
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < L::kBCopies; ++q) {
          const int n = (q / (kBK / 8)) * (NT / 8) + tid / 8, k = (q % (kBK / 8)) * 8 + tid % 8;
          const bool live = !kRaggedK || k0 + k < k_end;
          __pipeline_memcpy_async(
              bs + k * L::kBLd + n,
              live ? b + static_cast<size_t>(bcol[q / (kBK / 8)]) * ldb + k0 + k : b, 4,
              live ? 0 : 4);
        }
      }
    }
    __pipeline_commit();  // an empty group past the last stage keeps the count
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < nk; ++s) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of stage s landed
    // every thread's copies of stage s landed, and every thread is done with
    // stage s - 1, whose slot the next copies take
    __syncthreads();
    issue(s + kStages - 1);
    const float* as = ring + (s % kStages) * L::kStageFloats;
    const float* bs = as + L::kAFloats;
    float fa[2][L::kTM], fb[2][L::kTN];
    const auto load = [&](int buf, int kk) {
#pragma unroll
      for (int g = 0; g < L::kRowGroups; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + kk * L::kALd + L::kRowSpan * g + 4 * ty);
        fa[buf][4 * g] = v.x; fa[buf][4 * g + 1] = v.y;
        fa[buf][4 * g + 2] = v.z; fa[buf][4 * g + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < L::kColGroups; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * L::kBLd + 64 * j + 4 * tx);
        fb[buf][4 * j] = v.x; fb[buf][4 * j + 1] = v.y;
        fb[buf][4 * j + 2] = v.z; fb[buf][4 * j + 3] = v.w;
      }
    };
    load(0, 0);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk + 1 < kBK) load((kk + 1) % 2, kk + 1);
#pragma unroll
      for (int i = 0; i < L::kTM; ++i)
#pragma unroll
        for (int j = 0; j < L::kTN; ++j)
          acc[i][j] = fmaf(fa[kk % 2][i], fb[kk % 2][j], acc[i][j]);
    }
  }
  __pipeline_wait_prior(0);
}

// fn(r, c, v) for every run of four columns of the thread's tile: tile row
// r, tile columns c .. c + 3, their sums v
template <int BM, int BN, int NT = kThreads, class Fn>
__device__ __forceinline__ void for_each_acc(const Acc<BM, BN, NT>& acc, Fn fn) {
  using L = Tile<BM, BN, NT>;
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int g = 0; g < L::kRowGroups; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < L::kColGroups; ++j) {
        const float* v = &acc[4 * g + i][4 * j];
        fn(L::kRowSpan * g + 4 * ty + i, 64 * j + 4 * tx, make_float4(v[0], v[1], v[2], v[3]));
      }
}

// Raise a kernel's dynamic shared-memory limit and prefer shared memory
// over L1 in the SM's carveout, so that two 128 x 128 blocks share an SM.
template <typename Kernel>
inline int configure(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *configured = true;
  return 0;
}

}  // namespace sg
}  // namespace orbit
