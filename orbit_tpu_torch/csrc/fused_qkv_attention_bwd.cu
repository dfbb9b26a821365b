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
//    on the tensor cores (mma.sync m16n8k16; attention.cuh's strips, which
//    #2 shares):
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
// attention.cuh's f32 block in 4 x 4 register tiles (shared with #2,
// tiny_attention.cu) writing an f32 dqkv, db as a two-pass column sum.
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
  orbit::attn::attention_backward_block(qkv, g, dqkv, blockIdx.x / H, blockIdx.x % H, S, D,
                                        smem);
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

// 2. the attention backward on the tensor cores (attention.cuh's strips,
// shared with #2)
constexpr int kAttnWarps = kMaxTokens / 16;  // one 16-row strip of queries, then of keys, each
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kLd = orbit::attn::kSLd;  // bf16 row stride: 144 bytes
constexpr int kTileElems = kMaxTokens * kLd;
constexpr int kCols = 3 * kHeadDim;  // dq | dk | dv columns of one head
// q, k, v, g, cast(p), cast(ds * scale) tiles (the column sums' scratch
// reuses v's): 55 KB, four blocks an SM
constexpr size_t kAttnSmem = 6 * kTileElems * sizeof(bf16);
static_assert(kAttnWarps * kCols * sizeof(float) <= kTileElems * sizeof(bf16),
              "the column sums' scratch must fit in v's tile");

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
  const int warp = threadIdx.x / 32;

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

  // warp w: the scores and dp of query rows 16w.., the softmax, ds and dq;
  // cast(p) and cast(ds * scale) to shared memory for the key side
  float dq[8][4] = {};
  const int q0 = 16 * warp;
  if (q0 < S) {
    float sc[8][4], dp[8][4];
    uint32_t p16[8][2], ds16[8][2];
    orbit::attn::scores_dp_strip(qs, ks, vs, gs, q0, sc, dp);
    orbit::attn::softmax_ds_strip(sc, dp, q0, S);
    orbit::attn::pack_strip(sc, p16);
    orbit::attn::pack_strip(dp, ds16);
    orbit::attn::store_p_ds(p16, ds16, q0, ps, dss);
    orbit::attn::dq_strip(ds16, ks, dq);
  }
  __syncthreads();  // cast(p) and cast(ds * scale) of every query row

  // dv = cast(p)^T . g and dk = cast(ds * scale)^T . q, key rows 16w..
  float dk[8][4] = {}, dv[8][4] = {};
  const int k0 = 16 * warp;
  if (k0 < S) orbit::attn::dk_dv_strip(ps, dss, gs, qs, k0, S, dk, dv);

  // ---- dq | dk | dv to dqkv (bf16), their column sums to red ----
  bf16* out = dqkv + row0 * d3 + h * kHeadDim;
  orbit::attn::store_strip<true, false>(dq, q0, S, out, d3, red + warp * kCols, nullptr);
  orbit::attn::store_strip<true, false>(dk, k0, S, out + D, d3, red + warp * kCols + kHeadDim,
                                        nullptr);
  orbit::attn::store_strip<true, false>(dv, k0, S, out + 2 * D, d3,
                                        red + warp * kCols + 2 * kHeadDim, nullptr);
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
