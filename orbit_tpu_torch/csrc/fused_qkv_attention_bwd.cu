// Backward of the fused qkv projection + multi-head attention (kernel A).
//
// Replaces: orbit_tpu/ops/tiny_attention.py::_fused_qkv_bwd_kernel (TPU
// kernel #4, via _pallas_qkv_attention_bwd). For x (B,S,D), W (D,3D), b
// (3D,) in T and the cotangent g (B,S,D) in T of out = attention(cast_T(x @
// W + b)), it computes
//   dx (B,S,D) in T, dW (D,3D) in f32, db (3D,) in f32
// with the TPU kernel's rounding points:
//   qkv  = cast_T(f32(x @ W) + b)                       (recomputed)
//   per (batch row, head), in f32: p = softmax(q k^T / sqrt(hd)),
//   dv = cast_T(p)^T g, dp = g v^T, ds = p * (dp - rowsum(dp * p)),
//   dq = cast_T(ds * scale) k, dk = cast_T(ds * scale)^T q  -> dqkv (f32)
//   dx = cast_T(f32(cast_T(dqkv) @ W^T)),  dW = x^T @ cast_T(dqkv),
//   db = colsum(dqkv)
//
// What bounds it on the H100: operations. At ViT-B/32, B = 256 (12,800 rows,
// D 768) it is about 141 GFLOP: the qkv recompute 45, the attention 5, dx 45
// and dW 45. Compute-bound: about 0.14 ms at 989 TFLOP/s in bf16 and 2.1 ms
// at 67 TFLOP/s in f32; the bytes it must move (x, g, W in, dx, dW out,
// about 70 MB in bf16) take about 0.02 ms at 3.35 TB/s. The TPU kernel keeps
// qkv and dqkv in VMEM per batch block; a simple design spends beyond the
// bound on an f32 dqkv's round trips (118 MB at B = 256, written once and
// read three times), on products off the Hopper tensor-core path and on an
// attention stage in f32 FMA loops.
//
// bf16, D a multiple of 128 (every supported ViT): four launches.
// 1. qkv = cast(x . W + b) on wgmma.cuh's mainloop, 128 x 128 tiles, into
//    a bf16 (B,S,3D) workspace.
// 2. The attention backward, one block of 4 warps per (batch row, head),
//    on the tensor cores (mma.sync m16n8k16, as kernel A's forward stage):
//    q, k, v and g of the head in shared memory (64 rows, zero past S);
//    warp w computes the scores and dp for query rows 16w.. in registers,
//    the softmax, ds and dq = cast(ds * scale) . k, and leaves cast(p) and
//    cast(ds * scale) in shared memory; then, for key rows 16w..,
//    dv = cast(p)^T . g and dk = cast(ds * scale)^T . q read them back
//    through transposing ldmatrix. dq, dk and dv leave as bf16 (the
//    cast_T(dqkv) that dx and dW consume) into a (B,S,3D) workspace, and
//    their f32 column sums over the row's S tokens, the warps added in a
//    fixed order, as one row of a (B, 3D) buffer of db's partials.
// 3. grads.cuh's launch: dW = x^T . cast(dqkv) (both MN-major, K = rows)
//    and dx = cast(cast(dqkv) . W^T) (both K-major), the longer walk first.
// 4. db: the partials added over the batch rows in order.
// No atomics: every output and partial has one writer, so two calls agree
// bit for bit.
//
// f32, and bf16 at other widths: the same stages on the CUDA cores (true
// f32): the products as common.cuh's FMA loops, the attention backward as
// attention.cuh's block (shared with #2, tiny_attention.cu) writing an f32
// dqkv, db as a two-pass column sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention.cuh"
#include "common.cuh"
#include "grads.cuh"
#include "wgmma.cuh"

namespace {

using orbit::from_float;
using orbit::Mat;
using orbit::MatT;
using orbit::to_float;
using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::ldsm_x4;
using orbit::attn::ldsm_x4_t;
using orbit::attn::mma_16816;
using orbit::attn::pack_bf16;

// ---------------------------------------------------------------------------
// f32, and bf16 off the wgmma route
// ---------------------------------------------------------------------------
// qkv = cast_T(sum + b): the recompute's rounding point
template <typename T>
struct QkvEpi {
  const T* bias;
  T* qkv;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    qkv[static_cast<size_t>(m) * ld + n] = from_float<T>(v + to_float(bias[n]));
  }
};

// one block per (batch row, head), blockIdx.x = b * H + h; dq, dk, dv to
// the f32 workspace dqkv (B,S,3D)
template <typename T>
__global__ void __launch_bounds__(orbit::attn::kThreads)
attention_backward_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                          float* __restrict__ dqkv, int S, int D, int H) {
  extern __shared__ float smem[];
  orbit::attn::attention_backward_block<T, float>(qkv, g, dqkv, blockIdx.x / H,
                                                  blockIdx.x % H, S, D, smem);
}

template <typename T>
int launch_fma(const T* x, const T* w, const T* bias, const T* g, T* qkv, float* dqkv,
               float* partial, T* dx, float* dw, float* db, int B, int S, int D, int H,
               cudaStream_t s) {
  const int rows = B * S, d3 = 3 * D;
  if (const int e = orbit::gemm(Mat<T>{x, D}, Mat<T>{w, d3}, QkvEpi<T>{bias, qkv, d3}, rows, d3,
                                D, s))
    return e;
  static bool configured = false;  // one flag per instantiation
  constexpr size_t smem = orbit::attn::kBwdSmemBytes;
  if (const int e = orbit::set_smem(attention_backward_kernel<T>, smem, &configured)) return e;
  attention_backward_kernel<T><<<B * H, orbit::attn::kThreads, smem, s>>>(qkv, g, dqkv, S, D, H);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const Mat<float, T> dqkv_t{dqkv, d3};
  if (const int e = orbit::gemm(dqkv_t, MatT<T>{w, d3}, orbit::StoreEpi<T>{dx, D}, rows, D, d3,
                                s))
    return e;
  if (const int e = orbit::gemm(MatT<T>{x, D}, dqkv_t, orbit::StoreEpi<float>{dw, d3}, D, d3,
                                rows, s))
    return e;
  return orbit::colsum(orbit::Column<float>{dqkv, d3}, partial, db, rows, d3, s);
}

// ---------------------------------------------------------------------------
// bf16 on the wgmma route
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTile = 128;
constexpr int kProjStages = 3;  // two blocks an SM
using ProjRing = orbit::wg::Ring<kTile, kProjStages>;

// 1. qkv = cast_bf16(f32(x . W) + b), one 128 x 128 tile a block
__global__ void __launch_bounds__(orbit::wg::kThreads, 2)
qkv_recompute_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ bias,
                     bf16* __restrict__ qkv, int rows, int d3, int nk) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = orbit::wg::ring_base(wg_smem);
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int cols[2] = {n0, n0 + orbit::wg::kBoxN};
  float acc[kTile / 2];
  orbit::wg::mainloop<kTile, kProjStages>(&map_x, &map_w, m0, cols, nk, base, acc);
  if (threadIdx.x >= 256) return;
  orbit::wg::for_each_acc<kTile>(acc, [&](int r, int c, float v0, float v1) {
    if (m0 + r >= rows) return;
    const size_t o = static_cast<size_t>(m0 + r) * d3 + n0 + c;
    *reinterpret_cast<uint32_t*>(qkv + o) =
        pack_bf16(v0 + to_float(bias[n0 + c]), v1 + to_float(bias[n0 + c + 1]));
  });
}

// 2. the attention backward on the tensor cores
constexpr int kAttnWarps = kMaxTokens / 16;  // one 16-row strip of queries, then of keys, each
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kLd = kHeadDim + 8;  // bf16 row stride (144 bytes): ldmatrix rows on distinct banks
constexpr int kTileElems = kMaxTokens * kLd;
constexpr int kCols = 3 * kHeadDim;  // dq | dk | dv columns of one head
// q, k, v, g, cast(p), cast(ds * scale) tiles (the column sums' scratch
// reuses v's): 55 KB, four blocks an SM
constexpr size_t kAttnSmem = 6 * kTileElems * sizeof(bf16);
static_assert(kAttnWarps * kCols * sizeof(float) <= kTileElems * sizeof(bf16),
              "the column sums' scratch must fit in v's tile");

// rows q0.. q0 + 15 of a 16 x 64 f32 strip held as mma.sync C fragments:
// fragment t covers columns 8t.., and this lane holds rows q0 + lane / 4
// (c[0], c[1]) and q0 + lane / 4 + 8 (c[2], c[3]), columns 8t + 2 (lane % 4)
// + {0, 1}. Stores the rows below S, rounded to bf16, at out (row 0, the
// strip's first column; rows ld apart), and the strip's f32 column sums
// over those rows at red[8t + 2 (lane % 4) + {0, 1}].
__device__ __forceinline__ void store_strip(const float (&c)[8][4], int q0, int S,
                                            bf16* __restrict__ out, size_t ld, float* red) {
  const int lane = threadIdx.x % 32;
  const int r = q0 + lane / 4, c2 = 2 * (lane % 4);
  const bool live0 = r < S, live1 = r + 8 < S;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (live0)
      *reinterpret_cast<uint32_t*>(out + r * ld + 8 * t + c2) = pack_bf16(c[t][0], c[t][1]);
    if (live1)
      *reinterpret_cast<uint32_t*>(out + (r + 8) * ld + 8 * t + c2) =
          pack_bf16(c[t][2], c[t][3]);
    float s0 = (live0 ? c[t][0] : 0.f) + (live1 ? c[t][2] : 0.f);
    float s1 = (live0 ? c[t][1] : 0.f) + (live1 ? c[t][3] : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // the strip's 16 rows, in a fixed order
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) {
      red[8 * t + c2] = s0;
      red[8 * t + c2 + 1] = s1;
    }
  }
}

__global__ void __launch_bounds__(kAttnThreads, 4)
attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                         bf16* __restrict__ dqkv, float* __restrict__ part, int S, int D,
                         int H) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  bf16* qs = reinterpret_cast<bf16*>(attn_smem);
  bf16* ks = qs + kTileElems;
  bf16* vs = ks + kTileElems;
  bf16* gs = vs + kTileElems;
  bf16* ps = gs + kTileElems;   // cast(p): [query][key]
  bf16* dss = ps + kTileElems;  // cast(ds * scale): [query][key]
  float* red = reinterpret_cast<float*>(vs);  // [warp][kCols], once v is dead
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int d3 = 3 * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // q, k, v and g of the head, 16 bytes a thread, rows >= S zero
  for (int e = threadIdx.x; e < kMaxTokens * 4 * (kHeadDim / 8); e += kAttnThreads) {
    const int r = e / (4 * (kHeadDim / 8)), part = (e / (kHeadDim / 8)) % 4;
    const int c = (e % (kHeadDim / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < S)
      v = *reinterpret_cast<const uint4*>(
          part < 3 ? qkv + (row0 + r) * d3 + part * D + h * kHeadDim + c
                   : g + (row0 + r) * D + h * kHeadDim + c);
    *reinterpret_cast<uint4*>(qs + part * kTileElems + r * kLd + c) = v;
  }
  __syncthreads();

  const int g4 = lane / 4, c2 = 2 * (lane % 4);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  float dq[8][4] = {};
  const int q0 = 16 * warp;
  if (q0 < S) {
    // ---- scores = q k^T and dp = g v^T: 16 query rows x 64 key slots, f32 ----
    float sc[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      uint32_t aq[4], ag[4];
      const int arow = (q0 + (lane % 8) + 8 * ((lane / 8) % 2)) * kLd + kk + 8 * (lane / 16);
      ldsm_x4(qs + arow, aq);
      ldsm_x4(gs + arow, ag);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // key slots 16 np .. 16 np + 15
        const int brow = (16 * np + (lane % 8) + 8 * (lane / 16)) * kLd + kk + 8 * ((lane / 8) % 2);
        uint32_t bk[4], bv[4];
        ldsm_x4(ks + brow, bk);
        ldsm_x4(vs + brow, bv);
        mma_16816(sc[2 * np], aq, bk[0], bk[1]);
        mma_16816(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma_16816(dp[2 * np], ag, bv[0], bv[1]);
        mma_16816(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }
    // ---- softmax (f32) over the S real keys, scaled after the dot ----
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * t + c2 + (e % 2);
        sc[t][e] = j < S ? sc[t][e] * scale : -INFINITY;
        m[e / 2] = fmaxf(m[e / 2], sc[t][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[t][e] = expf(sc[t][e] - m[e / 2]);  // 0 past S
        sum[e / 2] += sc[t][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
    // ---- p = e / sum; rowsum(dp * p); ds = p (dp - rowsum) * scale ----
    float tr[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[t][e] = sc[t][e] / sum[e / 2];
        tr[e / 2] += dp[t][e] * sc[t][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tr[i] += __shfl_xor_sync(0xffffffffu, tr[i], 1);
      tr[i] += __shfl_xor_sync(0xffffffffu, tr[i], 2);
    }
    // query rows >= S hold zeros in p and ds, so they add nothing to dv, dk
    const bool live[2] = {q0 + g4 < S, q0 + g4 + 8 < S};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = live[e / 2];
        dp[t][e] = on ? sc[t][e] * (dp[t][e] - tr[e / 2]) * scale : 0.f;  // ds * scale
        sc[t][e] = on ? sc[t][e] : 0.f;
      }
    // cast(p) and cast(ds * scale) for the key-side products
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = (q0 + g4 + 8 * half) * kLd + 8 * t + c2;
        *reinterpret_cast<uint32_t*>(ps + o) = pack_bf16(sc[t][2 * half], sc[t][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dss + o) = pack_bf16(dp[t][2 * half], dp[t][2 * half + 1]);
      }
    // ---- dq = cast(ds * scale) . k: ds is the A operand as it lies ----
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {  // key slots 16 k16 .. + 15
      const uint32_t a[4] = {pack_bf16(dp[2 * k16][0], dp[2 * k16][1]),
                             pack_bf16(dp[2 * k16][2], dp[2 * k16][3]),
                             pack_bf16(dp[2 * k16 + 1][0], dp[2 * k16 + 1][1]),
                             pack_bf16(dp[2 * k16 + 1][2], dp[2 * k16 + 1][3])};
#pragma unroll
      for (int n16 = 0; n16 < 4; ++n16) {  // head columns 16 n16 .. + 15
        uint32_t bk[4];
        ldsm_x4_t(ks + (16 * k16 + (lane % 8) + 8 * ((lane / 8) % 2)) * kLd + 16 * n16 +
                      8 * (lane / 16),
                  bk);
        mma_16816(dq[2 * n16], a, bk[0], bk[1]);
        mma_16816(dq[2 * n16 + 1], a, bk[2], bk[3]);
      }
    }
  }
  __syncthreads();  // cast(p) and cast(ds * scale) of every query row

  // ---- dv = cast(p)^T . g and dk = cast(ds * scale)^T . q, key rows k0.. ----
  float dk[8][4] = {}, dv[8][4] = {};
  const int k0 = 16 * warp;
  if (k0 < S) {
    for (int kq = 0; kq < (S + 15) / 16; ++kq) {  // query rows 16 kq .. + 15
      // A = the transpose of a 16 x 16 block of p (ds): ldmatrix.trans of
      // its stored [query][key] rows
      const int arow = (16 * kq + (lane % 8) + 8 * (lane / 16)) * kLd + k0 + 8 * ((lane / 8) % 2);
      uint32_t ap[4], ads[4];
      ldsm_x4_t(ps + arow, ap);
      ldsm_x4_t(dss + arow, ads);
#pragma unroll
      for (int n16 = 0; n16 < 4; ++n16) {
        const int brow =
            (16 * kq + (lane % 8) + 8 * ((lane / 8) % 2)) * kLd + 16 * n16 + 8 * (lane / 16);
        uint32_t bg[4], bq[4];
        ldsm_x4_t(gs + brow, bg);
        ldsm_x4_t(qs + brow, bq);
        mma_16816(dv[2 * n16], ap, bg[0], bg[1]);
        mma_16816(dv[2 * n16 + 1], ap, bg[2], bg[3]);
        mma_16816(dk[2 * n16], ads, bq[0], bq[1]);
        mma_16816(dk[2 * n16 + 1], ads, bq[2], bq[3]);
      }
    }
  }

  // ---- dq | dk | dv to dqkv (bf16), their column sums to red ----
  bf16* out = dqkv + row0 * d3 + h * kHeadDim;
  store_strip(dq, q0, S, out, d3, red + warp * kCols);
  store_strip(dk, k0, S, out + D, d3, red + warp * kCols + kHeadDim);
  store_strip(dv, k0, S, out + 2 * D, d3, red + warp * kCols + 2 * kHeadDim);
  __syncthreads();
  for (int c = threadIdx.x; c < kCols; c += kAttnThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) s += red[w * kCols + c];
    part[static_cast<size_t>(b) * d3 + (c / kHeadDim) * D + h * kHeadDim + c % kHeadDim] = s;
  }
}

int launch_wgmma(const bf16* x, const bf16* w, const bf16* bias, const bf16* g, bf16* qkv,
                 bf16* dqkv, float* partial, bf16* dx, float* dw, float* db, int B, int S,
                 int D, int H, cudaStream_t s) {
  const int rows = B * S, d3 = 3 * D;
  CUtensorMap map_x, map_w;
  if (!orbit::wg::make_tmap_2d(&map_x, x, rows, D, D, orbit::wg::kBM) ||
      !orbit::wg::make_tmap_2d(&map_w, w, D, d3, d3, orbit::wg::kBoxN))
    return static_cast<int>(cudaErrorInvalidValue);
  orbit::grads::Plan<bf16> plan{};
  plan.rows = rows;
  plan.n_weight = 1;
  plan.x_out = dx;
  plan.x_n = D;
  plan.x_k = d3;
  if (!orbit::grads::set_weight(plan, 0, x, D, dqkv, d3, dw))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false, configured_attn = false;
  if (const int e = orbit::set_smem(qkv_recompute_kernel, ProjRing::kSmemBytes, &configured))
    return e;
  if (const int e = orbit::set_smem(attention_bwd_mma_kernel, kAttnSmem, &configured_attn))
    return e;

  qkv_recompute_kernel<<<dim3(d3 / kTile, (rows + kTile - 1) / kTile), orbit::wg::kThreads,
                         ProjRing::kSmemBytes, s>>>(map_x, map_w, bias, qkv, rows, d3,
                                                    D / orbit::wg::kBK);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  attention_bwd_mma_kernel<<<B * H, kAttnThreads, kAttnSmem, s>>>(qkv, g, dqkv, partial, S, D,
                                                                   H);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = orbit::grads::launch(plan, dqkv, w, s)) return e;
  const orbit::Partials job{partial, db, B, d3};
  return orbit::sum_partials(&job, 1, s);
}

template <typename T>
int launch(const void* x_, const void* w_, const void* bias_, const void* g_, void* qkv_,
           void* dqkv_, void* partial, void* dx_, void* dw, void* db, int B, int S, int D,
           int H, void* stream) {
  if (B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  const T* bias = static_cast<const T*>(bias_);
  const T* g = static_cast<const T*>(g_);
  if constexpr (std::is_same<T, bf16>::value) {
    if (D % kTile == 0)
      return launch_wgmma(x, w, bias, g, static_cast<T*>(qkv_), static_cast<T*>(dqkv_),
                          static_cast<float*>(partial), static_cast<T*>(dx_),
                          static_cast<float*>(dw), static_cast<float*>(db), B, S, D, H, s);
  }
  return launch_fma<T>(x, w, bias, g, static_cast<T*>(qkv_), static_cast<float*>(dqkv_),
                       static_cast<float*>(partial), static_cast<T*>(dx_),
                       static_cast<float*>(dw), static_cast<float*>(db), B, S, D, H, s);
}

}  // namespace

// x, W, b, g in T; workspaces qkv (B,S,3D) in T, dqkv (B,S,3D: bf16 on the
// bf16 route for D a multiple of 128, f32 otherwise) and the partial sums
// of db (f32: B x 3D on the bf16 route, ceil(B*S/256) x 3D otherwise);
// outputs dx (B,S,D) in T, dW (D,3D) and db (3D) in f32. Returns
// cudaGetLastError() of the launches.
extern "C" int orbit_fused_qkv_attention_bwd_f32(const void* x, const void* w, const void* b,
                                                 const void* g, void* qkv, void* dqkv,
                                                 void* partial, void* dx, void* dw, void* db,
                                                 int B, int S, int D, int H, void* stream) {
  return launch<float>(x, w, b, g, qkv, dqkv, partial, dx, dw, db, B, S, D, H, stream);
}

extern "C" int orbit_fused_qkv_attention_bwd_bf16(const void* x, const void* w, const void* b,
                                                  const void* g, void* qkv, void* dqkv,
                                                  void* partial, void* dx, void* dw, void* db,
                                                  int B, int S, int D, int H, void* stream) {
  return launch<bf16>(x, w, b, g, qkv, dqkv, partial, dx, dw, db, B, S, D, H, stream);
}
