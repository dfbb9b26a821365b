// Backward of the fused transformer MLP half-block (kernel B):
// y = x + fc2(gelu(fc1(LayerNorm(x)))).
//
// Replaces: orbit_tpu/ops/mlp_block.py::_mlp_bwd_kernel (via _pallas_mlp_bwd).
// On the rows = B*S rows of x (rows, D) in T, with gamma, beta, b1 in f32,
// W1 (D, Hd) and W2 (Hd, D) in T and the cotangent g (rows, D) in T, it
// computes dx in T and the six parameter gradients in f32, with the TPU
// kernel's rounding points:
//   recompute: mean, rstd two-pass in f32; xhat = (x - mean) * rstd;
//              xn = cast_T(xhat * gamma + beta); hpre = f32(xn @ W1) + b1;
//              hg = cast_T(0.5 * hpre * (1 + erf(hpre / sqrt 2)))
//   dhg   = g @ W2^T (f32)           dW2 = hg^T @ g        db2 = colsum(g)
//   dhpre = dhg * (0.5 (1 + erf) + hpre * phi(hpre))      db1 = colsum(dhpre)
//   dxn   = cast_T(dhpre) @ W1^T     dW1 = xn^T @ cast_T(dhpre)
//   dgamma = colsum(dxn * xhat)      dbeta = colsum(dxn)
//   dx    = cast_T(rstd * (dxn*gamma - mean(dxn*gamma) - xhat * mean(dxn*gamma*xhat)) + g)
// erf is CUDA's erff, as in kernel B (the TPU kernel uses a polynomial,
// |err| <= 1.5e-7).
//
// What bounds it on the H100: operations. At ViT-B/32, B = 256 (12,800 rows,
// D 768, Hd 3072) its five products (fc1 recompute, dhg, dxn, dW1, dW2) are
// 60 GFLOP each, about 302 GFLOP: about 0.31 ms at 989 TFLOP/s in bf16 and
// 4.5 ms at 67 TFLOP/s in f32. The bytes it must move (x, g, W1, W2 in; dx,
// dW1, dW2 out, about 80 MB in bf16) take about 0.02 ms.
//
// Design, the simple version: a row-wise LayerNorm kernel, then the five
// products as tiled products (common.cuh) whose epilogues apply the bias,
// GELU and GELU' elementwise, then a row-wise LayerNorm-backward kernel and
// the column sums. The (rows, Hd) hidden tensors live in two workspaces: hg
// in T, and h in f32, which holds hpre and is overwritten in place with
// dhpre by the dhg product's epilogue (each element read and written by
// the one thread that owns it). Parameter gradients are products and
// column sums over all rows, each output tile owned by one block: no
// atomics, two calls agree bit for bit. The products run on the tensor
// cores (WMMA, 128 x 128 tiles) in bf16 and as FMA loops in f32; D and Hd
// must be multiples of 8 for the tensor-core path's 16-byte loads. What a
// later PR would change: keep the hidden tensors on chip per row tile (the
// TPU kernel keeps them in VMEM), split K for dW1 and dW2 (6 x 24 tiles at
// ViT-B/32, little more than one wave on 132 SMs), wgmma with TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

using orbit::from_float;
using orbit::Mat;
using orbit::MatT;
using orbit::to_float;

constexpr int kThreads = 256;   // 8 warps, one row each in the row kernels
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// LayerNorm recompute, one warp per row: stats[2r] = mean, stats[2r+1] =
// rstd, xn = cast_T(xhat * gamma + beta), as kernel B computes them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gam,
                  const float* __restrict__ bet, float* __restrict__ stats,
                  T* __restrict__ xn, int rows, int D, float eps) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* xr = x + static_cast<size_t>(r) * D;
  float s = 0.f;
  for (int k = lane; k < D; k += 32) s += to_float(xr[k]);
  const float mean = orbit::warp_sum(s) / D;
  float v = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float c = to_float(xr[k]) - mean;
    v += c * c;
  }
  const float rstd = 1.0f / sqrtf(orbit::warp_sum(v) / D + eps);
  T* xnr = xn + static_cast<size_t>(r) * D;
  for (int k = lane; k < D; k += 32)
    xnr[k] = from_float<T>((to_float(xr[k]) - mean) * rstd * gam[k] + bet[k]);
  if (lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
}

// fc1 recompute: h = hpre = sum + b1 (f32), hg = cast_T(gelu(hpre))
template <typename T>
struct Fc1Epi {
  const float* b1;
  float* h;
  T* hg;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const size_t i = static_cast<size_t>(m) * ld + n;
    const float hp = v + b1[n];
    h[i] = hp;
    hg[i] = from_float<T>(0.5f * hp * (1.0f + erff(hp * kInvSqrt2)));
  }
};

// dhg = sum; h: hpre -> dhpre = dhg * gelu'(hpre), in place
struct GeluBackwardEpi {
  float* h;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const size_t i = static_cast<size_t>(m) * ld + n;
    const float hp = h[i];
    const float erf = erff(hp * kInvSqrt2);
    const float phi = expf(-0.5f * hp * hp) * kInvSqrt2Pi;
    h[i] = v * (0.5f * (1.0f + erf) + hp * phi);
  }
};

// LayerNorm backward plus the residual, one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ gam, const float* __restrict__ stats,
                           const float* __restrict__ dxn, T* __restrict__ dx, int rows,
                           int D) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t o = static_cast<size_t>(r) * D;
  const float mean = stats[2 * r], rstd = stats[2 * r + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float dxhat = dxn[o + k] * gam[k];
    m1 += dxhat;
    m2 += dxhat * (to_float(x[o + k]) - mean) * rstd;
  }
  m1 = orbit::warp_sum(m1) / D;
  m2 = orbit::warp_sum(m2) / D;
  for (int k = lane; k < D; k += 32) {
    const float xhat = (to_float(x[o + k]) - mean) * rstd;
    const float dxhat = dxn[o + k] * gam[k];
    dx[o + k] = from_float<T>(rstd * (dxhat - m1 - xhat * m2) + to_float(g[o + k]));
  }
}

// dgamma's element: dxn * xhat
template <typename T>
struct DxnXhat {
  const float* dxn;
  const T* x;
  const float* stats;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const size_t i = static_cast<size_t>(r) * ld + c;
    return dxn[i] * ((to_float(x[i]) - stats[2 * r]) * stats[2 * r + 1]);
  }
};

template <typename T>
int launch(const void* x_, const void* g_, const void* gam_, const void* bet_, const void* w1_,
           const void* b1_, const void* w2_, void* stats_, void* xn_, void* hg_, void* h_,
           void* dxn_, void* partial_, void* dx_, void* dgam, void* dbet, void* dw1,
           void* db1, void* dw2, void* db2, int rows, int D, int Hd, float eps,
           void* stream) {
  if (rows < 1 || D < 1 || Hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  const float* gam = static_cast<const float*>(gam_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  float* stats = static_cast<float*>(stats_);
  T* xn = static_cast<T*>(xn_);
  T* hg = static_cast<T*>(hg_);
  float* h = static_cast<float*>(h_);
  float* dxn = static_cast<float*>(dxn_);
  float* partial = static_cast<float*>(partial_);
  const int row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;

  // recompute: LayerNorm, then fc1 + b1 and GELU
  layer_norm_kernel<T><<<row_blocks, kThreads, 0, s>>>(
      x, gam, static_cast<const float*>(bet_), stats, xn, rows, D, eps);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = orbit::gemm<T>(Mat<T>{xn, D}, Mat<T>{w1, Hd},
                                   Fc1Epi<T>{static_cast<const float*>(b1_), h, hg, Hd},
                                   rows, Hd, D, s))
    return e;
  // dhg = g @ W2^T, and h becomes dhpre
  if (const int e = orbit::gemm<T>(Mat<T>{g, D}, MatT<T>{w2, D},
                                   GeluBackwardEpi{h, Hd}, rows, Hd, D, s))
    return e;
  // dxn = cast_T(dhpre) @ W1^T, then the LayerNorm backward and the residual
  const Mat<float, T> dh_t{h, Hd};
  if (const int e = orbit::gemm<T>(dh_t, MatT<T>{w1, Hd}, orbit::StoreEpi<float>{dxn, D},
                                   rows, D, Hd, s))
    return e;
  layer_norm_backward_kernel<T><<<row_blocks, kThreads, 0, s>>>(
      x, g, gam, stats, dxn, static_cast<T*>(dx_), rows, D);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  // weight gradients over all rows
  if (const int e = orbit::gemm<T>(MatT<T>{xn, D}, dh_t,
                                   orbit::StoreEpi<float>{static_cast<float*>(dw1), Hd}, D,
                                   Hd, rows, s))
    return e;
  if (const int e = orbit::gemm<T>(MatT<T>{hg, Hd}, Mat<T>{g, D},
                                   orbit::StoreEpi<float>{static_cast<float*>(dw2), D}, Hd,
                                   D, rows, s))
    return e;
  // vector gradients: column sums
  if (const int e = orbit::colsum(orbit::Column<float>{h, Hd}, partial,
                                  static_cast<float*>(db1), rows, Hd, s))
    return e;
  if (const int e = orbit::colsum(orbit::Column<T>{g, D}, partial,
                                  static_cast<float*>(db2), rows, D, s))
    return e;
  if (const int e = orbit::colsum(DxnXhat<T>{dxn, x, stats, D}, partial,
                                  static_cast<float*>(dgam), rows, D, s))
    return e;
  return orbit::colsum(orbit::Column<float>{dxn, D}, partial, static_cast<float*>(dbet),
                       rows, D, s);
}

}  // namespace

// x, g, W1, W2 in T; gamma, beta, b1 in f32; workspaces stats (rows x 2),
// xn (rows x D) in T, hg (rows x Hd) in T, h (rows x Hd) f32, dxn (rows x D)
// f32 and the column-sum partials (ceil(rows/256) x Hd f32); outputs dx
// (rows x D) in T and dgamma, dbeta, dW1, db1, dW2, db2 in f32. Returns
// cudaGetLastError() of the launches.
#define ORBIT_MLP_BWD_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const void* x, const void* g, const void* gam, const void* bet,     \
                      const void* w1, const void* b1, const void* w2, void* stats,        \
                      void* xn, void* hg, void* h, void* dxn, void* partial, void* dx,    \
                      void* dgam, void* dbet, void* dw1, void* db1, void* dw2, void* db2, \
                      int rows, int D, int Hd, float eps, void* stream) {                 \
    return launch<T>(x, g, gam, bet, w1, b1, w2, stats, xn, hg, h, dxn, partial, dx,      \
                     dgam, dbet, dw1, db1, dw2, db2, rows, D, Hd, eps, stream);           \
  }

ORBIT_MLP_BWD_ENTRY(orbit_fused_mlp_block_bwd_f32, float)
ORBIT_MLP_BWD_ENTRY(orbit_fused_mlp_block_bwd_bf16, __nv_bfloat16)
