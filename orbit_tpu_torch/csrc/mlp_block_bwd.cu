// Backward of the fused transformer MLP half-block (kernel B):
// y = x + fc2(gelu(fc1(LayerNorm(x)))).
//
// Replaces: orbit_tpu/ops/mlp_block.py::_mlp_bwd_kernel (TPU kernel #6, via
// _pallas_mlp_bwd). On the rows = B*S rows of x (rows, D) in T, with gamma,
// beta, b1 in f32, W1 (D, Hd) and W2 (Hd, D) in T and the cotangent g
// (rows, D) in T, it computes dx in T and the six parameter gradients in
// f32, with the TPU kernel's rounding points:
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
// dW1, dW2 out, about 80 MB in bf16) take about 0.02 ms. The TPU kernel
// keeps the (rows, Hd) hidden tensors in VMEM per row block; what a simple
// design spends beyond the bound is their round trips through device
// memory (hpre and dhpre in f32 alone: 157 MB at B = 256, passed about six
// times) and products off the Hopper tensor-core path.
//
// bf16, D and Hd multiples of 128 (every supported ViT): five launches,
// every product on wgmma.cuh's mainloop (TMA, wgmma, f32 accumulators):
//   1. LayerNorm recompute, one warp a row: xn (bf16) and mean, rstd;
//   2. the hidden kernel, one block per (128-row tile, 128 hidden columns):
//      hpre = xn . W1[:, j] (B MN-major) and dhg = g . W2[j, :]^T (B K-major)
//      as two products through one ring into two register accumulators;
//      the epilogue forms hg and dhpre in registers (one block an SM: 168
//      registers) and writes only hg and cast(dhpre) (bf16), and the
//      tile's f32 column sums of dhpre (db1's partials, one row of a
//      (row tiles, Hd) buffer): no f32 hidden tensor reaches device
//      memory;
//   3. grads.cuh's launch: dW1 = xn^T . cast(dhpre), dW2 = hg^T . g (both
//      MN-major, K = rows) and dxn = cast(dhpre) . W1^T (f32 out), the long
//      weight tiles first and the short dxn tiles filling the tail;
//   4. the LayerNorm backward and the residual, 64 rows a block: dx, and
//      the block's partial column sums of dgamma, dbeta and db2 = colsum(g);
//   5. one pass adding every partial buffer in a fixed order (db1, dgamma,
//      dbeta, db2).
// No atomics: each partial has one writer and is summed in one order, so
// two calls agree bit for bit.
//
// f32 (the CLI's default --compute_dtype), D and Hd multiples of 128: the
// same five launches, every product on sgemm.cuh's f32 mainloop (true f32
// FMA on the CUDA cores, TF32 off) and every workspace in f32:
//   1. the LayerNorm recompute as above, xn in f32;
//   2. the hidden kernel in f32, one block of 4 x BM threads per (BM-row
//      tile, 128 hidden columns): hpre = xn . W1[:, j] (B MN-major) and
//      dhg = g . W2[j, :]^T (B K-major) through one ring into two register
//      accumulators of 4 x 8 sums a thread (so that the two fit in 128
//      registers); the epilogue forms hg and dhpre in registers and writes
//      both, and the tile's column sums of dhpre (db1's partials); hpre
//      never reaches device memory. BM is 128 (512 threads, one block an
//      SM), or 64 (256 threads, two an SM) where 128-row tiles would give
//      an SM fewer than two blocks (B 13 and 16 at S 50, S 5: the caller's
//      plan, kernels/plans.py::hidden_f32_rows);
//   3. sgemm_grads.cuh's launch: dW1 = xn^T . dhpre, dW2 = hg^T . g (A and
//      B MN-major, ragged K = rows, in runs of K doing no more work than a
//      dxn block)
//      and dxn = dhpre . W1^T (A and B K-major), the longer walk first;
//      where the runs are more than one, their partials added in run order
//      (one more launch, sgemm_grads.cuh's sum_runs);
//   4. and 5. as above.
// Bound by FMA issue: five 60-GFLOP products at ViT-B/32, B = 256, S = 50
// (4.5 ms at 67 TFLOP/s).
//
// bf16 and f32 at other widths: the products as FMA loops on the CUDA
// cores (common.cuh; true f32, the numeric policy keeps TF32 off) whose
// epilogues apply the bias, GELU and GELU', with hpre and then dhpre in an
// f32 (rows, Hd) workspace; db1's partials from common.cuh's column sums;
// then launches 4 and 5 as above. D is at most 1024 (the LayerNorm
// backward's registers) and a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "grads.cuh"
#include "sgemm.cuh"
#include "sgemm_grads.cuh"
#include "wgmma.cuh"

namespace {

using orbit::from_float;
using orbit::Mat;
using orbit::MatT;
using orbit::to_float;
using orbit::wg::Major;

constexpr int kThreads = 256;   // 8 warps, one row each in the LayerNorms
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kLnRows = 64;     // rows a block of the LayerNorm backward
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

// ---- the FMA route's epilogues ----
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

// ---- the bf16 route's hidden kernel (launch 2) ----
constexpr int kTile = 128;     // rows and hidden columns of a block
constexpr int kHidStages = 5;  // one block an SM: two accumulators of 64 floats a thread
using HidRing = orbit::wg::Ring<kTile, kHidStages>;

__global__ void __launch_bounds__(orbit::wg::kThreads, 1)
mlp_bwd_hidden_kernel(const __grid_constant__ CUtensorMap map_xn,  // A K-major: xn (rows, D)
                      const __grid_constant__ CUtensorMap map_w1,  // B MN-major: W1 (D, Hd)
                      const __grid_constant__ CUtensorMap map_g,   // A K-major: g (rows, D)
                      const __grid_constant__ CUtensorMap map_w2,  // B K-major: W2 (Hd, D)
                      const float* __restrict__ b1, __nv_bfloat16* __restrict__ hg,
                      __nv_bfloat16* __restrict__ dhb, float* __restrict__ part_db1,
                      int rows, int Hd, int nk) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = orbit::wg::ring_base(wg_smem);
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int cols[2] = {n0, n0 + orbit::wg::kBoxN};
  orbit::wg::ring_init<kTile, kHidStages>(base);
  uint32_t it = 0;
  float hacc[kTile / 2], dacc[kTile / 2];
  orbit::wg::run<kTile, kHidStages, Major::K, Major::MN>(&map_xn, &map_w1, m0, cols, 0, nk,
                                                         base, hacc, it);
  orbit::wg::run<kTile, kHidStages, Major::K, Major::K>(&map_g, &map_w2, m0, cols, 0, nk, base,
                                                        dacc, it);
  __syncthreads();  // every stage consumed: the column sums reuse the ring
  float* red = reinterpret_cast<float*>(base);  // [8 consumer warps][kTile columns]
  if (threadIdx.x < 256) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    // wgmma's m64nN layout (wgmma.cuh's for_each_acc): this thread holds
    // rows r0 and r0 + 8 of columns 8j + 2 (lane % 4) + {0, 1}
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, i = 4 * j + 2 * half;
        float gel[2], dh[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float hp = hacc[i + q] + b1[n0 + c + q];
          const float erf = erff(hp * kInvSqrt2);
          const float phi = expf(-0.5f * hp * hp) * kInvSqrt2Pi;
          gel[q] = 0.5f * hp * (1.0f + erf);
          dh[q] = dacc[i + q] * (0.5f * (1.0f + erf) + hp * phi);
        }
        if (m0 + r < rows) {
          const size_t o = static_cast<size_t>(m0 + r) * Hd + n0 + c;
          *reinterpret_cast<__nv_bfloat162*>(hg + o) = __floats2bfloat162_rn(gel[0], gel[1]);
          *reinterpret_cast<__nv_bfloat162*>(dhb + o) = __floats2bfloat162_rn(dh[0], dh[1]);
          s[0] += dh[0];
          s[1] += dh[1];
        }
      }
      // the warp's 16 rows: the lanes with this lane % 4 hold columns c, c + 1
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
        s[1] += __shfl_xor_sync(0xffffffffu, s[1], o);
      }
      if (lane < 4) {
        red[warp * kTile + c] = s[0];
        red[warp * kTile + c + 1] = s[1];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kTile) {  // the tile's 128 rows, warp by warp in order
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * kTile + threadIdx.x];
    part_db1[static_cast<size_t>(blockIdx.y) * Hd + n0 + threadIdx.x] = s;
  }
}

// ---- the f32 route's hidden kernel (launch 2) ----
// A tile of BM rows (64 or 128) x 128 hidden columns, 4 x BM threads with
// 4 x 8 sums a product
template <int BM>
struct HidF32 {
  static constexpr int kThreads = 4 * BM;
  static constexpr int kPerSm = BM == kTile ? 1 : 2;
  using Ring = orbit::sg::Tile<BM, kTile, kThreads, orbit::sg::Major::K,
                               orbit::sg::Major::K>;  // the larger stage of the two
  static_assert(orbit::sg::Tile<BM, kTile, kThreads>::kSmemBytes <= Ring::kSmemBytes,
                "both products' stages fit the ring");
};

template <int BM>
__global__ void __launch_bounds__(HidF32<BM>::kThreads, HidF32<BM>::kPerSm)
mlp_bwd_hidden_f32_kernel(const float* __restrict__ xn, const float* __restrict__ w1,
                          const float* __restrict__ g, const float* __restrict__ w2,
                          const float* __restrict__ b1, float* __restrict__ hg,
                          float* __restrict__ dh, float* __restrict__ part_db1, int rows, int D,
                          int Hd) {
  using orbit::sg::Major;
  constexpr int NT = HidF32<BM>::kThreads;
  using L = orbit::sg::Tile<BM, kTile, NT>;
  extern __shared__ __align__(16) float hid_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kTile;
  const int cols[2] = {n0, n0 + 64};
  orbit::sg::Acc<BM, kTile, NT> hacc, dacc;
  orbit::sg::mainloop<BM, kTile, NT, Major::K, Major::MN>(xn, D, m0, rows, w1, Hd, cols,
                                                          D / orbit::sg::kBK, hid_smem, hacc);
  __syncthreads();  // every thread is done with the ring's stages
  orbit::sg::mainloop<BM, kTile, NT, Major::K, Major::K>(g, D, m0, rows, w2, D, cols,
                                                         D / orbit::sg::kBK, hid_smem, dacc);
  __syncthreads();  // the column sums reuse the ring
  // thread (ty, tx) holds rows 4 ty + i and columns 64 j + 4 tx + c
  // (sgemm.cuh's for_each_acc); its columns' sums over its rows below rows
  const int ty = orbit::sg::thread_row(), tx = orbit::sg::thread_col();
  float sums[L::kTN] = {};
#pragma unroll
  for (int i = 0; i < L::kTM; ++i) {
    const int r = L::kRowSpan * (i / 4) + 4 * ty + i % 4;
#pragma unroll
    for (int j = 0; j < L::kColGroups; ++j) {
      const int c = 64 * j + 4 * tx;
      const float4 b = *reinterpret_cast<const float4*>(b1 + n0 + c);
      const float bv[4] = {b.x, b.y, b.z, b.w};
      float gel[4], dv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float hp = hacc[i][4 * j + q] + bv[q];
        const float erf = erff(hp * kInvSqrt2);
        const float phi = expf(-0.5f * hp * hp) * kInvSqrt2Pi;
        gel[q] = 0.5f * hp * (1.0f + erf);
        dv[q] = dacc[i][4 * j + q] * (0.5f * (1.0f + erf) + hp * phi);
      }
      if (m0 + r < rows) {
        const size_t o = static_cast<size_t>(m0 + r) * Hd + n0 + c;
        *reinterpret_cast<float4*>(hg + o) = make_float4(gel[0], gel[1], gel[2], gel[3]);
        *reinterpret_cast<float4*>(dh + o) = make_float4(dv[0], dv[1], dv[2], dv[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) sums[4 * j + q] += dv[q];
      }
    }
  }
  // the warp's 4 row groups (lane / 8), then the NT / 64 warps of each
  // column half (warp % 2) in warp order: a fixed order
#pragma unroll
  for (int o = 8; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < L::kTN; ++q) sums[q] += __shfl_xor_sync(0xffffffffu, sums[q], o);
  float* red = hid_smem;  // [warp / 2][kTile columns]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < 8)
#pragma unroll
    for (int j = 0; j < L::kColGroups; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[(warp / 2) * kTile + 64 * j + 4 * tx + q] = sums[4 * j + q];
  __syncthreads();
  if (threadIdx.x < kTile) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 64; ++w) t += red[w * kTile + threadIdx.x];
    part_db1[static_cast<size_t>(blockIdx.y) * Hd + n0 + threadIdx.x] = t;
  }
}

// ---- the LayerNorm backward plus the residual (launch 4) ----
// 8 consecutive values at p as f32 (32-byte aligned for f32, 16 for bf16),
// and 8 f32 values stored to p rounded to T
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  orbit::load_vec<float, 4>(p, o);
  orbit::load_vec<float, 4>(p + 4, o + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  orbit::load_vec<__nv_bfloat16, 4>(p, o);
  orbit::load_vec<__nv_bfloat16, 4>(p + 4, o + 4);
}
__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&y)[8]) {
  uint4 out;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) op[e] = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = out;
}

// One block per kLnRows rows (D a multiple of 8, at most 256 kPerLane),
// one warp a row, 8 columns a lane per load: the row read twice (its means
// of dxhat = dxn * gamma and dxhat * xhat, then dx); each lane keeps its
// columns' partial sums of dgamma, dbeta and db2 over the warp's rows in
// registers, and the block adds its 8 warps' sums in warp order through
// shared memory into part[(q * chunks + block) * D + c], q = 0, 1, 2
// (chunks = the grid).
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
layer_norm_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ gam, const float* __restrict__ stats,
                           const float* __restrict__ dxn, T* __restrict__ dx,
                           float* __restrict__ part, int rows, int D) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][kPerLane * 256];
  const int r0 = blockIdx.x * kLnRows;
  const int nr = min(kLnRows, rows - r0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nv = D / 8;  // 8-column vectors of a row
  float sum[3][kPerLane][8] = {};  // dgamma, dbeta, db2
  for (int i = warp; i < nr; i += kWarps) {
    const size_t o = static_cast<size_t>(r0 + i) * D;
    const float mean = stats[2 * (r0 + i)], rstd = stats[2 * (r0 + i) + 1];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (lane + 32 * q >= nv) continue;
      float xv[8], dv[8], gm[8];
      load8(x + o + c, xv);
      load8(dxn + o + c, dv);
      load8(gam + c, gm);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dxhat = dv[e] * gm[e];
        m1 += dxhat;
        m2 += dxhat * (xv[e] - mean) * rstd;
      }
    }
    m1 = orbit::warp_sum(m1) / D;
    m2 = orbit::warp_sum(m2) / D;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = 8 * (lane + 32 * q);
      if (lane + 32 * q >= nv) continue;
      float xv[8], dv[8], gm[8], gv[8], y[8];
      load8(x + o + c, xv);
      load8(dxn + o + c, dv);
      load8(gam + c, gm);
      load8(g + o + c, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xv[e] - mean) * rstd;
        y[e] = rstd * (dv[e] * gm[e] - m1 - xhat * m2) + gv[e];
        sum[0][q][e] += dv[e] * xhat;
        sum[1][q][e] += dv[e];
        sum[2][q][e] += gv[e];
      }
      store8(dx + o + c, y);
    }
  }
  const size_t chunks = gridDim.x;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      if (lane + 32 * q < nv)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp][8 * (lane + 32 * q) + e] = sum[s][q][e];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][c];
      part[(s * chunks + blockIdx.x) * D + c] = t;
    }
    __syncthreads();
  }
}

template <typename T>
int layer_norm_backward(const T* x, const T* g, const float* gam, const float* stats,
                        const float* dxn, T* dx, float* part_ln, int rows, int D,
                        cudaStream_t s) {
  const int chunks = (rows + kLnRows - 1) / kLnRows;
  switch ((D + 255) / 256) {  // 8-column vectors a lane
#define ORBIT_LN_BWD_CASE(P)                                                                \
  case P:                                                                                   \
    layer_norm_backward_kernel<T, P><<<chunks, kThreads, 0, s>>>(x, g, gam, stats, dxn, dx, \
                                                                 part_ln, rows, D);         \
    break;
    case 1:  // D <= 256: the two-vector instantiation, half its lanes idle or more
    ORBIT_LN_BWD_CASE(2)
    ORBIT_LN_BWD_CASE(3)
    ORBIT_LN_BWD_CASE(4)
#undef ORBIT_LN_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- launch 5: db1, dgamma, dbeta and db2 from their partials ----
int finish_partials(const float* part_db1, int db1_chunks, const float* part_ln, float* dgam,
                    float* dbet, float* db1, float* db2, int rows, int D, int Hd,
                    cudaStream_t s) {
  const int ln_chunks = (rows + kLnRows - 1) / kLnRows;
  const size_t ln = static_cast<size_t>(ln_chunks) * D;
  const orbit::Partials jobs[4] = {{part_db1, db1, db1_chunks, Hd},
                                   {part_ln, dgam, ln_chunks, D},
                                   {part_ln + ln, dbet, ln_chunks, D},
                                   {part_ln + 2 * ln, db2, ln_chunks, D}};
  return orbit::sum_partials(jobs, 4, s);
}

int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* g, const float* gam,
                 const float* bet, const __nv_bfloat16* w1, const float* b1,
                 const __nv_bfloat16* w2, float* stats, __nv_bfloat16* xn,
                 __nv_bfloat16* hg, __nv_bfloat16* dhb, float* dxn, float* partial,
                 __nv_bfloat16* dx, float* dgam, float* dbet, float* dw1, float* db1,
                 float* dw2, float* db2, int rows, int D, int Hd, float eps, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int row_tiles = (rows + kTile - 1) / kTile;
  CUtensorMap maps[4];
  if (!orbit::wg::make_tmap_2d(&maps[0], xn, rows, D, D, orbit::wg::kBM) ||
      !orbit::wg::make_tmap_2d(&maps[1], w1, D, Hd, Hd, orbit::wg::kBoxN) ||
      !orbit::wg::make_tmap_2d(&maps[2], g, rows, D, D, orbit::wg::kBM) ||
      !orbit::wg::make_tmap_2d(&maps[3], w2, Hd, D, D, orbit::wg::kBoxN))
    return static_cast<int>(cudaErrorInvalidValue);
  orbit::grads::Plan<float> plan{};
  plan.rows = rows;
  plan.n_weight = 2;
  plan.x_out = dxn;
  plan.x_n = D;
  plan.x_k = Hd;
  if (!orbit::grads::set_weight(plan, 0, xn, D, dhb, Hd, dw1) ||
      !orbit::grads::set_weight(plan, 1, hg, Hd, g, D, dw2))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (const int e = orbit::set_smem(mlp_bwd_hidden_kernel, HidRing::kSmemBytes, &configured))
    return e;

  layer_norm_kernel<bf16><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
      x, gam, bet, stats, xn, rows, D, eps);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  mlp_bwd_hidden_kernel<<<dim3(Hd / kTile, row_tiles), orbit::wg::kThreads,
                          HidRing::kSmemBytes, s>>>(maps[0], maps[1], maps[2], maps[3], b1, hg,
                                                    dhb, partial, rows, Hd, D / orbit::wg::kBK);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = orbit::grads::launch(plan, dhb, w1, s)) return e;
  float* part_ln = partial + static_cast<size_t>(row_tiles) * Hd;
  if (const int e = layer_norm_backward(x, g, gam, stats, dxn, dx, part_ln, rows, D, s)) return e;
  return finish_partials(partial, row_tiles, part_ln, dgam, dbet, db1, db2, rows, D, Hd, s);
}

// The hidden kernel on BM-row tiles; part_db1 takes a row of partials a tile
template <int BM>
int launch_hidden_f32(const float* xn, const float* w1, const float* g, const float* w2,
                      const float* b1, float* hg, float* dh, float* part_db1, int rows, int D,
                      int Hd, cudaStream_t s) {
  constexpr size_t bytes = HidF32<BM>::Ring::kSmemBytes;
  static bool configured = false;  // one flag per instantiation
  if (const int e = orbit::sg::configure(mlp_bwd_hidden_f32_kernel<BM>, bytes, &configured))
    return e;
  mlp_bwd_hidden_f32_kernel<BM><<<dim3(Hd / kTile, (rows + BM - 1) / BM),
                                  HidF32<BM>::kThreads, bytes, s>>>(xn, w1, g, w2, b1, hg, dh,
                                                                    part_db1, rows, D, Hd);
  return static_cast<int>(cudaGetLastError());
}

// hid_rows: the hidden kernel's tile rows (128 or 64), x_rows, wsplit: the
// grads launch's data tile rows and runs of the weight gradients' K (the
// caller's plan), sms the card's SMs; partial: db1's partials (a row a
// hidden tile) and the LayerNorm backward's, then (wsplit > 1) dW1's runs
// and dW2's
int launch_f32_tiled(const float* x, const float* g, const float* gam, const float* bet,
                     const float* w1, const float* b1, const float* w2, float* stats, float* xn,
                     float* hg, float* dh, float* dxn, float* partial, float* dx, float* dgam,
                     float* dbet, float* dw1, float* db1, float* dw2, float* db2, int rows, int D,
                     int Hd, float eps, int hid_rows, int x_rows, int wsplit, int sms,
                     cudaStream_t s) {
  if (hid_rows != kTile && hid_rows != kTile / 2) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (rows + hid_rows - 1) / hid_rows;
  layer_norm_kernel<float><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
      x, gam, bet, stats, xn, rows, D, eps);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = hid_rows == kTile
                        ? launch_hidden_f32<kTile>(xn, w1, g, w2, b1, hg, dh, partial, rows, D,
                                                   Hd, s)
                        : launch_hidden_f32<kTile / 2>(xn, w1, g, w2, b1, hg, dh, partial, rows,
                                                       D, Hd, s))
    return e;
  float* part_ln = partial + static_cast<size_t>(row_tiles) * Hd;
  float* w_part = part_ln + 3ull * ((rows + kLnRows - 1) / kLnRows) * D;
  orbit::sgrads::Plan<2> plan{};
  plan.wsplit = wsplit;
  plan.w_part = w_part;
  plan.x_rows = x_rows;
  plan.wa[0] = xn;  // dW1 = xn^T . dhpre
  plan.wb[0] = dh;
  plan.w_out[0] = dw1;
  plan.w_m[0] = D;
  plan.w_n[0] = Hd;
  plan.wa[1] = hg;  // dW2 = hg^T . g
  plan.wb[1] = g;
  plan.w_out[1] = dw2;
  plan.w_m[1] = Hd;
  plan.w_n[1] = D;
  plan.xa = dh;     // dxn = dhpre . W1^T
  plan.xb = w1;
  plan.x_out = dxn;
  plan.x_n = D;
  plan.x_k = Hd;
  plan.rows = rows;
  if (const int e = orbit::sgrads::launch(plan, s)) return e;
  if (wsplit > 1) {
    const int n = D * Hd;
    const orbit::sgrads::Runs runs[2] = {{w_part, dw1, wsplit, n},
                                         {w_part + static_cast<size_t>(wsplit) * n, dw2, wsplit, n}};
    if (const int e = orbit::sgrads::sum_runs(runs, 2, sms, s)) return e;
  }
  if (const int e = layer_norm_backward(x, g, gam, stats, dxn, dx, part_ln, rows, D, s)) return e;
  return finish_partials(partial, row_tiles, part_ln, dgam, dbet, db1, db2, rows, D, Hd, s);
}

template <typename T>
int launch_fma(const T* x, const T* g, const float* gam, const float* bet, const T* w1,
               const float* b1, const T* w2, float* stats, T* xn, T* hg, float* h, float* dxn,
               float* partial, T* dx, float* dgam, float* dbet, float* dw1, float* db1,
               float* dw2, float* db2, int rows, int D, int Hd, float eps, cudaStream_t s) {
  const int row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  // recompute: LayerNorm, then fc1 + b1 and GELU
  layer_norm_kernel<T><<<row_blocks, kThreads, 0, s>>>(x, gam, bet, stats, xn, rows, D, eps);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = orbit::gemm(Mat<T>{xn, D}, Mat<T>{w1, Hd}, Fc1Epi<T>{b1, h, hg, Hd}, rows,
                                Hd, D, s))
    return e;
  // dhg = g @ W2^T, and h becomes dhpre
  if (const int e = orbit::gemm(Mat<T>{g, D}, MatT<T>{w2, D}, GeluBackwardEpi{h, Hd}, rows, Hd,
                                D, s))
    return e;
  // dxn = cast_T(dhpre) @ W1^T; the weight gradients over all rows
  const Mat<float, T> dh_t{h, Hd};
  if (const int e = orbit::gemm(dh_t, MatT<T>{w1, Hd}, orbit::StoreEpi<float>{dxn, D}, rows, D,
                                Hd, s))
    return e;
  if (const int e = orbit::gemm(MatT<T>{xn, D}, dh_t, orbit::StoreEpi<float>{dw1, Hd}, D, Hd,
                                rows, s))
    return e;
  if (const int e = orbit::gemm(MatT<T>{hg, Hd}, Mat<T>{g, D}, orbit::StoreEpi<float>{dw2, D},
                                Hd, D, rows, s))
    return e;
  // db1's partials, then the LayerNorm backward and every vector gradient
  const int chunks = orbit::colsum_chunks(rows);
  if (const int e = orbit::colsum_partials(orbit::Column<float>{h, Hd}, partial, rows, Hd, s))
    return e;
  float* part_ln = partial + static_cast<size_t>(chunks) * Hd;
  if (const int e = layer_norm_backward(x, g, gam, stats, dxn, dx, part_ln, rows, D, s)) return e;
  return finish_partials(partial, chunks, part_ln, dgam, dbet, db1, db2, rows, D, Hd, s);
}

template <typename T>
int launch(const void* x, const void* g, const void* gam, const void* bet, const void* w1,
           const void* b1, const void* w2, void* stats, void* xn, void* hg, void* hid,
           void* dxn, void* partial, void* dx, void* dgam, void* dbet, void* dw1, void* db1,
           void* dw2, void* db2, int rows, int D, int Hd, float eps, int hid_rows, int x_rows,
           int wsplit, int sms, void* stream) {
  if (rows < 1 || D < 1 || Hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % kTile == 0 && Hd % kTile == 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_wgmma(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(gam),
          static_cast<const float*>(bet), static_cast<const T*>(w1),
          static_cast<const float*>(b1), static_cast<const T*>(w2), static_cast<float*>(stats),
          static_cast<T*>(xn), static_cast<T*>(hg), static_cast<T*>(hid),
          static_cast<float*>(dxn), static_cast<float*>(partial), static_cast<T*>(dx),
          static_cast<float*>(dgam), static_cast<float*>(dbet), static_cast<float*>(dw1),
          static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2), rows, D,
          Hd, eps, s);
    else
      return launch_f32_tiled(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(gam), static_cast<const float*>(bet),
          static_cast<const float*>(w1), static_cast<const float*>(b1),
          static_cast<const float*>(w2), static_cast<float*>(stats), static_cast<float*>(xn),
          static_cast<float*>(hg), static_cast<float*>(hid), static_cast<float*>(dxn),
          static_cast<float*>(partial), static_cast<float*>(dx), static_cast<float*>(dgam),
          static_cast<float*>(dbet), static_cast<float*>(dw1), static_cast<float*>(db1),
          static_cast<float*>(dw2), static_cast<float*>(db2), rows, D, Hd, eps, hid_rows, x_rows,
          wsplit, sms, s);
  }
  return launch_fma<T>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(gam),
      static_cast<const float*>(bet), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<float*>(stats), static_cast<T*>(xn),
      static_cast<T*>(hg), static_cast<float*>(hid), static_cast<float*>(dxn),
      static_cast<float*>(partial), static_cast<T*>(dx), static_cast<float*>(dgam),
      static_cast<float*>(dbet), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), rows, D, Hd, eps, s);
}

}  // namespace

// x, g, W1, W2 in T; gamma, beta, b1 in f32; workspaces stats (rows x 2)
// f32, xn (rows x D) and hg (rows x Hd) in T, hid (rows x Hd: cast(dhpre)
// in T on the tiled routes, for D and Hd multiples of 128, f32 hpre/dhpre
// otherwise), dxn (rows x D) f32 and the partial sums (f32: db1's,
// ceil(rows/128) x Hd on the bf16 tiled route, ceil(rows/hid_rows) x Hd on
// the f32 one and ceil(rows/256) x Hd otherwise, then the LayerNorm
// backward's 3 x ceil(rows/64) x D, then on the f32 tiled route with wsplit
// > 1 dW1's and dW2's runs, wsplit x D x Hd each); outputs dx (rows x D) in
// T and dgamma, dbeta, dW1, db1, dW2, db2 in f32; f32: hid_rows, the hidden
// kernel's tile rows (kernels/plans.py::hidden_f32_rows), x_rows and
// wsplit, the grads launch's data tile rows and runs of the weight
// gradients' K (plans.py::sgemm_grads_plan), sms the card's SMs. Returns
// cudaGetLastError() of the launches.
extern "C" int orbit_fused_mlp_block_bwd_f32(const void* x, const void* g, const void* gam,
                                             const void* bet, const void* w1, const void* b1,
                                             const void* w2, void* stats, void* xn, void* hg,
                                             void* hid, void* dxn, void* partial, void* dx,
                                             void* dgam, void* dbet, void* dw1, void* db1,
                                             void* dw2, void* db2, int rows, int D, int Hd,
                                             float eps, int hid_rows, int x_rows, int wsplit,
                                             int sms, void* stream) {
  return launch<float>(x, g, gam, bet, w1, b1, w2, stats, xn, hg, hid, dxn, partial, dx, dgam,
                       dbet, dw1, db1, dw2, db2, rows, D, Hd, eps, hid_rows, x_rows, wsplit, sms,
                       stream);
}

extern "C" int orbit_fused_mlp_block_bwd_bf16(const void* x, const void* g, const void* gam,
                                              const void* bet, const void* w1, const void* b1,
                                              const void* w2, void* stats, void* xn, void* hg,
                                              void* hid, void* dxn, void* partial, void* dx,
                                              void* dgam, void* dbet, void* dw1, void* db1,
                                              void* dw2, void* db2, int rows, int D, int Hd,
                                              float eps, void* stream) {
  return launch<__nv_bfloat16>(x, g, gam, bet, w1, b1, w2, stats, xn, hg, hid, dxn, partial, dx,
                               dgam, dbet, dw1, db1, dw2, db2, rows, D, Hd, eps, 0, 0, 0, 0,
                               stream);
}
