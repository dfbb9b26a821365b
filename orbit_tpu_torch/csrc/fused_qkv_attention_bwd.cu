// Backward of the fused qkv projection + multi-head attention (kernel A).
//
// Replaces: orbit_tpu/ops/tiny_attention.py::_fused_qkv_bwd_kernel (via
// _pallas_qkv_attention_bwd). For x (B,S,D), W (D,3D), b (3D,) in T and the
// cotangent g (B,S,D) in T of out = attention(cast_T(x @ W + b)), it computes
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
// about 70 MB in bf16) take about 0.02 ms at 3.35 TB/s.
//
// Design, the simple version: three stages, each a plain kernel.
// 1. The recompute runs as a tiled product into a (B,S,3D) workspace in T
//    (the TPU kernel keeps it in VMEM).
// 2. One block per (batch row, head) holds that head's q, k, v and g in
//    shared memory, recomputes the softmax and writes dq, dk, dv into an f32
//    (B,S,3D) workspace. The block is attention.cuh's device function on a
//    raw qkv, which the backward of the unfused attention (TPU kernel #2,
//    tiny_attention.cu) runs too, writing its dqkv in T.
// 3. dx, dW and db as tiled products and a column sum over all B*S rows
//    (common.cuh). The TPU kernel adds dW and db into accumulators that stay
//    resident across its sequential grid; blocks here run in no order, so
//    each tile of dW is owned by one block that walks all rows, and db is a
//    two-pass column sum: no atomics, and two calls agree bit for bit.
// The products run on the tensor cores (WMMA, 128 x 128 tiles) in bf16 and
// as FMA loops in f32. What a later PR would change: keep qkv and dqkv out
// of device memory by fusing stages 1-3 per batch tile, split K for dW (its
// 6 x 18 tiles at ViT-B/32 fill 108 of the 132 SMs), wgmma with TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "attention.cuh"
#include "common.cuh"

namespace {

using orbit::from_float;
using orbit::Mat;
using orbit::MatT;
using orbit::to_float;

using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::kThreads;

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

// Stage 2: one block per (batch row, head), blockIdx.x = b * H + h; dq,
// dk, dv to the f32 workspace dqkv (B,S,3D)
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_backward_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                          float* __restrict__ dqkv, int S, int D, int H) {
  extern __shared__ float smem[];
  orbit::attn::attention_backward_block<T, float>(qkv, g, dqkv, blockIdx.x / H,
                                                  blockIdx.x % H, S, D, smem);
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
  const T* g = static_cast<const T*>(g_);
  T* qkv = static_cast<T*>(qkv_);
  float* dqkv = static_cast<float*>(dqkv_);
  const int rows = B * S, d3 = 3 * D;

  // 1. qkv = cast_T(x @ W + b)
  if (const int e = orbit::gemm<T>(Mat<T>{x, D}, Mat<T>{w, d3},
                                   QkvEpi<T>{static_cast<const T*>(bias_), qkv, d3},
                                   rows, d3, D, s))
    return e;
  // 2. attention backward per (batch row, head) -> dqkv (f32)
  static bool configured = false;  // one flag per instantiation
  constexpr size_t smem = orbit::attn::kBwdSmemBytes;
  if (const int e = orbit::set_smem(attention_backward_kernel<T>, smem, &configured)) return e;
  attention_backward_kernel<T><<<B * H, kThreads, smem, s>>>(qkv, g, dqkv, S, D, H);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  // 3. dx = cast_T(cast_T(dqkv) @ W^T); dW = x^T @ cast_T(dqkv); db = colsum(dqkv)
  const Mat<float, T> dqkv_t{dqkv, d3};
  if (const int e = orbit::gemm<T>(dqkv_t, MatT<T>{w, d3},
                                   orbit::StoreEpi<T>{static_cast<T*>(dx_), D}, rows, D,
                                   d3, s))
    return e;
  if (const int e = orbit::gemm<T>(MatT<T>{x, D}, dqkv_t,
                                   orbit::StoreEpi<float>{static_cast<float*>(dw), d3}, D,
                                   d3, rows, s))
    return e;
  return orbit::colsum(orbit::Column<float>{dqkv, d3}, static_cast<float*>(partial),
                       static_cast<float*>(db), rows, d3, s);
}

}  // namespace

// x, W, b, g in T; workspaces qkv (B,S,3D) in T, dqkv (B,S,3D) f32 and the
// column-sum partials (ceil(B*S/256) x 3D f32); outputs dx (B,S,D) in T,
// dW (D,3D) and db (3D) in f32. Returns cudaGetLastError() of the launches.
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
  return launch<__nv_bfloat16>(x, w, b, g, qkv, dqkv, partial, dx, dw, db, B, S, D, H,
                               stream);
}
