// Fused qkv projection + multi-head self-attention for ViT's short sequences.
//
// Replaces: orbit_tpu/ops/tiny_attention.py::_fused_qkv_kernel (via
// _pallas_qkv_attention). Computes, for x (B,S,D), W (D,3D) in (in, out)
// layout and b (3D,):
//   qkv = cast_T(f32(x @ W) + b)                     (never stored to memory)
//   per (batch row, head): out = cast_T(f32(cast_T(softmax_f32(q k^T / sqrt(hd))) @ v))
// written to out[:, :, h*hd:(h+1)*hd] of a (B,S,D) tensor (pre output proj).
// The rounding points are the TPU kernel's: b arrives already in T, the
// f32 projection plus b is rounded to T, scores and softmax are f32, p is
// rounded to T before the AV product, AV accumulates in f32.
//
// What bounds it on the H100: the projection GEMM, 2*S*D*3D FLOPs per batch
// row (about 45 GFLOP per ViT-B/32 layer at B=256, S=50); attention itself
// is about 2% of that. In f32 the kernel runs FMA loops on the CUDA cores
// (true f32, as the f32 path must be), bound by FMA issue and shared-memory
// bandwidth. In bf16 it runs WMMA tiles on the tensor cores; there it is
// bound by fragment loads: W fragments come straight from L2 and are
// re-read by the four warps that share a column tile, and one block per
// (batch row, head) re-reads its 295 KB slice of W. Staging W tiles in
// shared memory, and wgmma with TMA, are later work.
//
// Design (f32): one thread block per (batch row, head). The block streams
// x[b] (S x D) and the head's 3*hd columns of W over D in KT-wide tiles
// through shared memory and accumulates q, k and v (S x 3*hd, f32 in
// registers, 4 x 12 per thread, read from shared memory as float4s), so the
// (B,S,3D) qkv tensor never reaches
// device memory. q, k, v (rounded to T) then stay in shared memory for the
// scores, the per-row softmax (one warp per row) and the AV product. The
// bf16 design (below) keeps the same block and the same stages on the
// tensor cores. The TPU's 8-row block-diagonal stacking (made for the
// 128x128 MXU) is not carried over: each block attends over its own S
// tokens only, and rows >= S of the padded 64-row tile are masked out of
// every product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

using orbit::from_float;
using orbit::round_to;
using orbit::to_float;

constexpr int kHeadDim = 64;          // hd of every supported ViT
constexpr int kMaxTokens = 64;        // S <= 64 (50 at 224 px, 5 at 84 px)
constexpr int kTileK = 32;            // D tile streamed per step
constexpr int kThreads = 256;         // 16 x 16 thread grid in the projection
constexpr int kCols = 3 * kHeadDim;   // q | k | v columns of one head
constexpr int kQkvLd = kHeadDim + 1;  // padded row stride: conflict-free k[j][d]
constexpr int kXLd = kTileK + 4;      // float4-aligned rows
constexpr int kScoreLd = kMaxTokens + 1;

constexpr int kQkvFloats = 3 * kMaxTokens * kQkvLd;
constexpr int kStageFloats = kMaxTokens * kXLd + kTileK * kCols;
constexpr int kScoreFloats = kMaxTokens * kScoreLd;
constexpr int kUnionFloats = kStageFloats > kScoreFloats ? kStageFloats : kScoreFloats;
constexpr size_t kSmemBytes = sizeof(float) * (kQkvFloats + kUnionFloats);

constexpr int kRowsPerThread = kMaxTokens / 16;  // 4
constexpr int kColsPerThread = kCols / 16;       // 12: 4 of each of q, k, v

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out,
                           int S, int D, int H) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kMaxTokens][kQkvLd]
  float* ks = qs + kMaxTokens * kQkvLd;
  float* vs = ks + kMaxTokens * kQkvLd;
  float* stage = vs + kMaxTokens * kQkvLd;
  float* xs = stage;                       // [kMaxTokens][kXLd]   (projection)
  float* ws = stage + kMaxTokens * kXLd;   // [kTileK][kCols]     (projection)
  float* sc = stage;                       // [kMaxTokens][kScoreLd] (attention)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * D;
  const T* xb = x + static_cast<size_t>(b) * S * D;

  // ---- projection: rows ty*4+i; columns part*64 + tx*4 + v of [q | k | v] ----
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kTileK) {
    for (int e = tid; e < kMaxTokens * kTileK; e += kThreads) {
      const int r = e / kTileK, c = e % kTileK;
      xs[r * kXLd + c] = r < S ? to_float(xb[static_cast<size_t>(r) * D + k0 + c]) : 0.f;
    }
    for (int e = tid; e < kTileK * kCols; e += kThreads) {
      const int r = e / kCols, lc = e % kCols;
      const int part = lc / kHeadDim, c = lc % kHeadDim;
      ws[r * kCols + lc] =
          to_float(w[static_cast<size_t>(k0 + r) * d3 + part * D + h * kHeadDim + c]);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kTileK; kk += 4) {
      float a[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + (ty * kRowsPerThread + i) * kXLd + kk);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[kColsPerThread];
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (kk + q) * kCols + part * kHeadDim + tx * 4);
          bv[part * 4 + 0] = v.x; bv[part * 4 + 1] = v.y;
          bv[part * 4 + 2] = v.z; bv[part * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i][q], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // qkv = cast_T(f32 GEMM + b): the TPU kernel's first rounding point
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int part = j / 4, c = tx * 4 + j % 4;
    const float bj = to_float(bias[part * D + h * kHeadDim + c]);
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      dst[r * kQkvLd + c] = round_to<T>(acc[i][j] + bj);
    }
  }
  __syncthreads();  // the staging tiles are dead from here: sc reuses them

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
    m = orbit::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = orbit::warp_sum(sum);
    for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j] / sum);
  }
  __syncthreads();

  // ---- out = cast_T(p @ v), f32 accumulation ----
  T* ob = out + static_cast<size_t>(b) * S * D + h * kHeadDim;
  for (int e = tid; e < S * kHeadDim; e += kThreads) {
    const int i = e / kHeadDim, d = e % kHeadDim;
    float o = 0.f;
    for (int j = 0; j < S; ++j) o = fmaf(sc[i * kScoreLd + j], vs[j * kQkvLd + d], o);
    ob[static_cast<size_t>(i) * D + d] = from_float<T>(o);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (WMMA 16x16x16, f32 accumulate). Same math and
// rounding points as the FMA kernel above; the projection, q k^T and p v
// run as 16x16 tiles on the tensor cores. One block of 8 warps per (batch
// row, head). The projection streams x[b] through shared memory in
// kTcTileK-wide slices (rows >= S zero) and reads W fragments straight from
// L2; warp w owns output row tile w/2 and six of the twelve column tiles of
// [q | k | v]. q, k and v are rounded to bf16 in shared memory; the scores
// go to f32 shared memory for the softmax, whose bf16 p has zeros in every
// column >= S, so the padded rows of v (bias only) add nothing to p v.
// ---------------------------------------------------------------------------
constexpr int kTcTileK = 64;
constexpr int kTcLd = kHeadDim + 8;      // bf16 tiles: rows stay 32-byte aligned
constexpr int kTcScoreLd = kMaxTokens + 4;  // f32 scores
constexpr int kTcTileBytes = sizeof(__nv_bfloat16) * kMaxTokens * kTcLd;  // 9216
constexpr size_t kTcSmemBytes =
    5 * kTcTileBytes                                  // x slice, q, k, v, p
    + sizeof(float) * kMaxTokens * kTcScoreLd         // scores
    + sizeof(float) * (kThreads / 32) * 256;          // per-warp f32 tile

__global__ void __launch_bounds__(kThreads)
fused_qkv_attention_tc_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w,
                              const __nv_bfloat16* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int S, int D, int H) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* xs = reinterpret_cast<bf16*>(tc_smem);
  bf16* qs = reinterpret_cast<bf16*>(tc_smem + kTcTileBytes);
  bf16* ks = reinterpret_cast<bf16*>(tc_smem + 2 * kTcTileBytes);
  bf16* vs = reinterpret_cast<bf16*>(tc_smem + 3 * kTcTileBytes);
  bf16* ps = reinterpret_cast<bf16*>(tc_smem + 4 * kTcTileBytes);
  float* sc = reinterpret_cast<float*>(tc_smem + 5 * kTcTileBytes);
  float* wtiles = sc + kMaxTokens * kTcScoreLd;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d3 = 3 * D;
  const bf16* xb = x + static_cast<size_t>(b) * S * D;
  float* tile = wtiles + warp * 256;

  // ---- projection: row tile warp/2, column tiles (warp%2)*6 .. +6 of [q|k|v] ----
  const int pr = warp / 2;
  const int pc0 = (warp % 2) * 6;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < D; k0 += kTcTileK) {
    for (int e = tid; e < kMaxTokens * kTcTileK; e += kThreads) {
      const int r = e / kTcTileK, c = e % kTcTileK;
      xs[r * kTcLd + c] = r < S ? xb[static_cast<size_t>(r) * D + k0 + c]
                                : from_float<bf16>(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcTileK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + pr * 16 * kTcLd + kk, kTcLd);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int lc = (pc0 + j) * 16;  // local column in [q | k | v] of this head
        const int part = lc / kHeadDim, c = lc % kHeadDim;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(
            bf, w + static_cast<size_t>(k0 + kk) * d3 + part * D + h * kHeadDim + c, d3);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    __syncthreads();  // xs is refilled by the next slice
  }
  // qkv = cast_bf16(f32 GEMM + b), through the warp's f32 tile
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int lc = (pc0 + j) * 16;
    const int part = lc / kHeadDim, c = lc % kHeadDim;
    bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    wmma::store_matrix_sync(tile, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, cc = e % 16;
      const float bj = to_float(bias[part * D + h * kHeadDim + c + cc]);
      dst[(pr * 16 + r) * kTcLd + c + cc] = from_float<bf16>(tile[e] + bj);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- scores = q k^T (f32): warp w computes tiles (w/2, 2*(w%2)) and (w/2, 2*(w%2)+1) ----
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
    m = orbit::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) sum += expf(row[j] - m);
    sum = orbit::warp_sum(sum);
    for (int j = lane; j < kMaxTokens; j += 32)
      prow[j] = from_float<bf16>(j < S ? expf(row[j] - m) / sum : 0.f);
  }
  __syncthreads();

  // ---- out = cast_bf16(p v), f32 accumulation: same tile split as the scores ----
  bf16* ob = out + static_cast<size_t>(b) * S * D + h * kHeadDim;
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

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int S,
           int D, int H, void* stream) {
  if (B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim || D % kTcTileK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static bool configured = false;  // one flag per instantiation
    if (const int e = orbit::set_smem(fused_qkv_attention_tc_kernel, kTcSmemBytes, &configured))
      return e;
    fused_qkv_attention_tc_kernel<<<B * H, kThreads, kTcSmemBytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
        static_cast<T*>(out), S, D, H);
  } else {
    static bool configured = false;
    if (const int e = orbit::set_smem(fused_qkv_attention_kernel<T>, kSmemBytes, &configured))
      return e;
    fused_qkv_attention_kernel<T><<<B * H, kThreads, kSmemBytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
        static_cast<T*>(out), S, D, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int orbit_fused_qkv_attention_f32(const void* x, const void* w, const void* bias,
                                             void* out, int B, int S, int D, int H,
                                             void* stream) {
  return launch<float>(x, w, bias, out, B, S, D, H, stream);
}

extern "C" int orbit_fused_qkv_attention_bf16(const void* x, const void* w, const void* bias,
                                              void* out, int B, int S, int D, int H,
                                              void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, out, B, S, D, H, stream);
}
