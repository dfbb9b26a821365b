// The last products of the backward kernels' bf16 routes (#4 in
// fused_qkv_attention_bwd.cu, #6 in mlp_block_bwd.cu), in one launch on
// wgmma.cuh's mainloop:
//   weight gradients dW_j = A_j^T . B_j over all rows (one or two of them),
//     both operands (rows x M) and (rows x N) row-major: A MN-major, B
//     MN-major, K = rows, f32 out (M x N);
//   the data gradient Y = X . W^T, X (rows x K) and W (N x K) row-major:
//     A K-major, B K-major, out (rows x N) in OutX.
// Every 128 x 128 output tile belongs to one block, which walks all of its
// K in a fixed order: no split, no atomics, the same bits on every call.
// The TPU kernels add dW into accumulators that stay resident across their
// sequential grid; here each dW tile (K = rows: 200 stages at ViT-B/32,
// B = 256) would leave SMs idle alone (#4's dW is 108 tiles on 132 SMs),
// so the short data-gradient tiles share the launch and fill the SMs that
// the long tiles leave. The product with the longer K goes first (blocks
// start in index order), so that the short tiles fill the tail.
// The plan is mirrored in orbit_tpu_torch/kernels/plans.py::grads_schedule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace orbit {
namespace grads {
namespace {  // internal linkage: every source that includes this file has its own

constexpr int kTile = 128;    // output tile, both sides
constexpr int kStages = 3;    // ring stages a block: two blocks an SM
using GradRing = wg::Ring<kTile, kStages>;

template <typename OutX>
struct Plan {
  CUtensorMap map_wa[2], map_wb[2];  // the weight products' A^T and B (box 64 x 64)
  CUtensorMap map_xa, map_xb;        // X (box 128 rows) and W (box 64 rows)
  float* w_out[2];
  int w_m[2], w_n[2];                // each weight gradient's shape
  int n_weight;                      // 1 or 2
  OutX* x_out;
  int x_n, x_k;                      // Y's columns and the data product's K
  int rows;                          // the rows: weight products' K, Y's rows
  int weights_first;                 // 1: the weight tiles take the first blocks
};

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__host__ __device__ inline int tiles(int m, int n) {
  return ((m + kTile - 1) / kTile) * (n / kTile);
}

template <typename OutX>
__global__ void __launch_bounds__(wg::kThreads, 2)
grads_kernel(const __grid_constant__ Plan<OutX> p) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = wg::ring_base(wg_smem);
  const int n_w0 = tiles(p.w_m[0], p.w_n[0]);
  const int n_w = n_w0 + (p.n_weight > 1 ? tiles(p.w_m[1], p.w_n[1]) : 0);
  const int n_x = tiles(p.rows, p.x_n);
  int t = blockIdx.x;
  const bool data = p.weights_first ? t >= n_w : t < n_x;
  if (p.weights_first) {
    if (data) t -= n_w;
  } else if (!data) {
    t -= n_x;
  }

  wg::ring_init<kTile, kStages>(base);
  uint32_t it = 0;
  float acc[kTile / 2];
  float* out_f = nullptr;
  OutX* out_x = nullptr;
  int m0, n0, ld, m_end;
  if (data) {
    const int tn = p.x_n / kTile;
    m0 = (t / tn) * kTile;
    n0 = (t % tn) * kTile;
    const int cols[2] = {n0, n0 + wg::kBoxN};
    wg::run<kTile, kStages, wg::Major::K, wg::Major::K>(&p.map_xa, &p.map_xb, m0, cols, 0,
                                                         (p.x_k + wg::kBK - 1) / wg::kBK, base,
                                                         acc, it);
    out_x = p.x_out;
    ld = p.x_n;
    m_end = p.rows;
  } else {
    // constant indices into the parameter: its descriptors must stay in
    // parameter space for TMA
    const bool j = t >= n_w0;
    if (j) t -= n_w0;
    const int wn = j ? p.w_n[1] : p.w_n[0];
    const int tn = wn / kTile;
    m0 = (t / tn) * kTile;
    n0 = (t % tn) * kTile;
    const int cols[2] = {n0, n0 + wg::kBoxN};
    wg::run<kTile, kStages, wg::Major::MN, wg::Major::MN>(
        j ? &p.map_wa[1] : &p.map_wa[0], j ? &p.map_wb[1] : &p.map_wb[0], m0, cols, 0,
        (p.rows + wg::kBK - 1) / wg::kBK, base, acc, it);
    out_f = j ? p.w_out[1] : p.w_out[0];
    ld = wn;
    m_end = j ? p.w_m[1] : p.w_m[0];
  }
  if (threadIdx.x >= 256) return;  // the producer warp
  wg::for_each_acc<kTile>(acc, [&](int r, int c, float v0, float v1) {
    if (m0 + r >= m_end) return;
    const size_t o = static_cast<size_t>(m0 + r) * ld + n0 + c;
    if (data) store_pair(out_x + o, v0, v1);
    else store_pair(out_f + o, v0, v1);
  });
}

// Encodes the data product's descriptors and launches the plan (the weight
// products' descriptors set by the caller). Returns a cudaError_t code.
template <typename OutX>
inline int launch(Plan<OutX>& p, const __nv_bfloat16* x, const __nv_bfloat16* w,
                  cudaStream_t stream) {
  if (!wg::make_tmap_2d(&p.map_xa, x, p.rows, p.x_k, p.x_k, wg::kBM) ||
      !wg::make_tmap_2d(&p.map_xb, w, p.x_n, p.x_k, p.x_k, wg::kBoxN))
    return static_cast<int>(cudaErrorInvalidValue);
  // the longer walk first: the weight tiles' K is the rows
  p.weights_first = p.rows >= p.x_k;
  static bool configured = false;  // one flag per instantiation
  constexpr size_t bytes = GradRing::kSmemBytes;
  if (const int e = set_smem(grads_kernel<OutX>, bytes, &configured)) return e;
  int blocks = tiles(p.rows, p.x_n);
  for (int j = 0; j < p.n_weight; ++j) blocks += tiles(p.w_m[j], p.w_n[j]);
  grads_kernel<OutX><<<blocks, wg::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The descriptors of weight product j: A^T stored (rows x m), B (rows x n).
template <typename OutX>
inline bool set_weight(Plan<OutX>& p, int j, const __nv_bfloat16* a, int m,
                       const __nv_bfloat16* b, int n, float* out) {
  p.w_m[j] = m;
  p.w_n[j] = n;
  p.w_out[j] = out;
  return wg::make_tmap_2d(&p.map_wa[j], a, p.rows, m, m, wg::kBoxN) &&
         wg::make_tmap_2d(&p.map_wb[j], b, p.rows, n, n, wg::kBoxN);
}

}  // namespace
}  // namespace grads
}  // namespace orbit
