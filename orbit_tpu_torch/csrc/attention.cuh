// Per-(batch row, head) attention stages shared by kernel A (fused qkv
// projection + attention, fused_qkv_attention.cu), its backward (#4,
// fused_qkv_attention_bwd.cu: the f32 route's block) and the unfused
// attention on a raw qkv (#1 and #2, tiny_attention.cu). Each stage works
// on one head of one batch row, S <= 64 tokens of head width 64, with the TPU kernels'
// rounding points (orbit_tpu/ops/tiny_attention.py::_head_softmax,
// _attend_blocked, _attend_blocked_bwd):
//   scores = (q k^T) * (1/sqrt(hd)) in f32, p = softmax_f32(scores),
//   out = cast_T(f32(cast_T(p) v));
//   backward, for the cotangent g of out: dv = cast_T(p)^T g, dp = g v^T,
//   ds = p * (dp - rowsum(dp * p)), dq = cast_T(ds * scale) k,
//   dk = cast_T(ds * scale)^T q, all summed in f32.
// The TPU kernels stack 8 batch rows into one block-diagonal operand to
// fill the 128x128 MXU; here one thread block owns one (batch row, head),
// so a row attends over its own S tokens and needs no mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace orbit {
namespace attn {

constexpr int kHeadDim = 64;     // hd of every supported ViT
constexpr int kMaxTokens = 64;   // S <= 64 (50 at 224 px, 5 at 84 px)
constexpr int kThreads = 256;    // 8 warps per block

// ---------------------------------------------------------------------------
// mma.sync helpers of the tensor-core attention stages (kernel A's forward,
// #4's backward): ldmatrix of four 8 x 8 bf16 tiles (rows of 16 bytes; lane
// l gives the address of row l % 8 of tile l / 8), plain or transposed, and
// the m16n8k16 product with f32 accumulators.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Forward on the CUDA cores (f32 FMA): q, k, v hold the f32 values of their
// T elements in shared memory at row stride kQkvLd (rows < S are read); sc
// is kMaxTokens x kScoreLd floats of scratch; ob points at out[b, 0, h*hd]
// of a (B, S, D) output. Ends without a barrier.
// ---------------------------------------------------------------------------
constexpr int kQkvLd = kHeadDim + 1;     // padded row stride: conflict-free k[j][d]
constexpr int kScoreLd = kMaxTokens + 1;

template <typename T>
__device__ void attend_fma(const float* qs, const float* ks, const float* vs, float* sc,
                           T* __restrict__ ob, int S, int D) {
  const int tid = threadIdx.x;
  // ---- scores (f32), scaled after the dot ----
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  for (int e = tid; e < S * S; e += kThreads) {
    const int i = e / S, j = e % S;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < kHeadDim; ++d) s = fmaf(qs[i * kQkvLd + d], ks[j * kQkvLd + d], s);
    sc[i * kScoreLd + j] = s * scale;
  }
  __syncthreads();

  // ---- softmax (f32), one warp per row; p rounded to T before AV ----
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < S; i += kThreads / 32) {
    float* row = sc + i * kScoreLd;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j] / sum);
  }
  __syncthreads();

  // ---- out = cast_T(p @ v), f32 accumulation ----
  for (int e = tid; e < S * kHeadDim; e += kThreads) {
    const int i = e / kHeadDim, d = e % kHeadDim;
    float o = 0.f;
    for (int j = 0; j < S; ++j) o = fmaf(sc[i * kScoreLd + j], vs[j * kQkvLd + d], o);
    ob[static_cast<size_t>(i) * D + d] = from_float<T>(o);
  }
}

// ---------------------------------------------------------------------------
// Forward on the tensor cores (bf16 WMMA 16x16x16, f32 accumulate): q, k, v
// are 64-row bf16 tiles at row stride kTcLd whose rows >= S hold finite
// values (the products run over all 64 rows; p has zeros in every column
// >= S, so those rows of v add nothing); ps is a bf16 tile of the same
// shape, sc kMaxTokens x kTcScoreLd floats, wtiles 8 per-warp 16x16 f32
// tiles. Warp w computes the score and output tiles (w/2, 2*(w%2) + t),
// t = 0, 1. Ends without a barrier.
// ---------------------------------------------------------------------------
constexpr int kTcLd = kHeadDim + 8;         // bf16 tiles: rows stay 32-byte aligned
constexpr int kTcScoreLd = kMaxTokens + 4;  // f32 scores
constexpr int kTcTileBytes = sizeof(__nv_bfloat16) * kMaxTokens * kTcLd;  // 9216
constexpr int kTcScoreBytes = sizeof(float) * kMaxTokens * kTcScoreLd;
constexpr int kTcWarpTileBytes = sizeof(float) * (kThreads / 32) * 256;

__device__ inline void attend_tc(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                 const __nv_bfloat16* vs, __nv_bfloat16* ps, float* sc,
                                 float* wtiles, __nv_bfloat16* __restrict__ ob, int S,
                                 int D) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  float* tile = wtiles + warp * 256;

  // ---- scores = q k^T (f32) ----
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int si = warp / 2, sj = 2 * (warp % 2) + t;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
      wmma::load_matrix_sync(a, qs + si * 16 * kTcLd + kk, kTcLd);
      wmma::load_matrix_sync(kt, ks + sj * 16 * kTcLd + kk, kTcLd);  // k^T
      wmma::mma_sync(s, a, kt, s);
    }
#pragma unroll
    for (int e = 0; e < s.num_elements; ++e) s.x[e] *= scale;
    wmma::store_matrix_sync(sc + si * 16 * kTcScoreLd + sj * 16, s, kTcScoreLd,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // ---- softmax (f32), one warp per row; p in bf16, zero outside S x S ----
  for (int i = warp; i < kMaxTokens; i += kThreads / 32) {
    const float* row = sc + i * kTcScoreLd;
    bf16* prow = ps + i * kTcLd;
    if (i >= S) {
      for (int j = lane; j < kMaxTokens; j += 32) prow[j] = from_float<bf16>(0.f);
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < kMaxTokens; j += 32)
      prow[j] = from_float<bf16>(j < S ? expf(row[j] - m) / sum : 0.f);
  }
  __syncthreads();

  // ---- out = cast_bf16(p v), f32 accumulation: same tile split as the scores ----
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int oi = warp / 2, oj = 2 * (warp % 2) + t;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::fill_fragment(o, 0.f);
#pragma unroll
    for (int kk = 0; kk < kMaxTokens; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
      wmma::load_matrix_sync(a, ps + oi * 16 * kTcLd + kk, kTcLd);
      wmma::load_matrix_sync(v, vs + kk * kTcLd + oj * 16, kTcLd);
      wmma::mma_sync(o, a, v, o);
    }
    wmma::store_matrix_sync(tile, o, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int i = oi * 16 + e / 16;
      if (i < S) ob[static_cast<size_t>(i) * D + oj * 16 + e % 16] = from_float<bf16>(tile[e]);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Backward for one (batch row b, head h): q, k, v from a raw qkv (B, S, 3D)
// in T (columns [q heads | k heads | v heads]), g (B, S, D) in T; dq, dk, dv
// written to the head's columns of dqkv (B, S, 3D) in OutT (f32 for the
// workspace of #4, T for #2's output: the f32 sums rounded once, as the TPU
// kernel writes its dqkv block in qkv's dtype). smem holds kBwdSmemBytes.
// On the CUDA cores (f32 FMA) in both types.
// ---------------------------------------------------------------------------
constexpr int kLd = kHeadDim + 1;      // q, k, v, g rows in shared memory
constexpr int kPLd = kMaxTokens + 1;   // p and ds rows
constexpr size_t kBwdSmemBytes =
    sizeof(float) * (4 * kMaxTokens * kLd + 2 * kMaxTokens * kPLd);

template <typename T, typename OutT>
__device__ void attention_backward_block(const T* __restrict__ qkv, const T* __restrict__ g,
                                         OutT* __restrict__ dqkv, int b, int h, int S,
                                         int D, float* smem) {
  float* qs = smem;                      // [kMaxTokens][kLd]
  float* ks = qs + kMaxTokens * kLd;
  float* vs = ks + kMaxTokens * kLd;
  float* gs = vs + kMaxTokens * kLd;
  float* ps = gs + kMaxTokens * kLd;     // scores, then p (f32)   [kMaxTokens][kPLd]
  float* ds = ps + kMaxTokens * kPLd;    // dp, then cast_T(ds * scale)
  const int tid = threadIdx.x;
  const int d3 = 3 * D;
  const size_t row0 = static_cast<size_t>(b) * S;

  for (int e = tid; e < S * kHeadDim; e += kThreads) {
    const int i = e / kHeadDim, c = e % kHeadDim;
    const T* r = qkv + (row0 + i) * d3 + h * kHeadDim + c;
    qs[i * kLd + c] = to_float(r[0]);
    ks[i * kLd + c] = to_float(r[D]);
    vs[i * kLd + c] = to_float(r[2 * D]);
    gs[i * kLd + c] = to_float(g[(row0 + i) * D + h * kHeadDim + c]);
  }
  __syncthreads();

  // scores (scaled after the dot, as the forward) and dp = g v^T
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  for (int e = tid; e < S * S; e += kThreads) {
    const int i = e / S, j = e % S;
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < kHeadDim; ++d) {
      s = fmaf(qs[i * kLd + d], ks[j * kLd + d], s);
      dp = fmaf(gs[i * kLd + d], vs[j * kLd + d], dp);
    }
    ps[i * kPLd + j] = s * scale;
    ds[i * kPLd + j] = dp;
  }
  __syncthreads();

  // softmax (f32) as the forward, one warp per row; then
  // ds = cast_T(p * (dp - rowsum(dp * p)) * scale)
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < S; i += kThreads / 32) {
    float* row = ps + i * kPLd;
    float* drow = ds + i * kPLd;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    float t = 0.f;
    for (int j = lane; j < S; j += 32) {
      row[j] = row[j] / sum;
      t += drow[j] * row[j];
    }
    t = warp_sum(t);
    for (int j = lane; j < S; j += 32) drow[j] = round_to<T>(row[j] * (drow[j] - t) * scale);
  }
  __syncthreads();

  // dv = cast_T(p)^T g, dq = ds k, dk = ds^T q, all f32 sums
  for (int e = tid; e < S * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    float dv = 0.f, dq = 0.f, dk = 0.f;
    for (int t = 0; t < S; ++t) {
      dv = fmaf(round_to<T>(ps[t * kPLd + r]), gs[t * kLd + c], dv);
      dq = fmaf(ds[r * kPLd + t], ks[t * kLd + c], dq);
      dk = fmaf(ds[t * kPLd + r], qs[t * kLd + c], dk);
    }
    OutT* o = dqkv + (row0 + r) * d3 + h * kHeadDim + c;
    o[0] = from_float<OutT>(dq);
    o[D] = from_float<OutT>(dk);
    o[2 * D] = from_float<OutT>(dv);
  }
}

}  // namespace attn
}  // namespace orbit
