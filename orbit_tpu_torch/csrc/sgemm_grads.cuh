// The last products of the f32 routes of the backward kernels (#4 in
// fused_qkv_attention_bwd.cu, #6 in mlp_block_bwd.cu), in one launch on
// sgemm.cuh's f32 mainloop, the f32 counterpart of grads.cuh:
//   weight gradients dW_j = A_j^T . B_j over all rows (NW = 1 or 2 of
//     them), both operands (rows x M) and (rows x N) row-major: A MN-major,
//     B MN-major, K = rows (ragged: the stage's rows past it zero-filled),
//     f32 out (M x N);
//   the data gradient Y = X . W^T, X (rows x K) and W (N x K) row-major:
//     A K-major, B K-major, f32 out (rows x N).
// Every output tile belongs to one block of 256 threads (128 x 128 tiles
// with 8 x 8 sums a thread, two blocks an SM; data tiles of 64 rows and 4
// x 8 sums where 128-row ones would leave SMs idle, as at S = 5), which
// walks its K in ascending order: no atomics, the same bits on every call.
// A weight tile's K is the rows (400 stages at ViT-B/32, B = 256, S = 50),
// and #4's dW alone is 6 x 18 = 108 tiles on 132 SMs, so the short data
// tiles share the launch and fill the SMs the long tiles leave, the longer
// walk first (blocks start in index order). Where a weight tile's walk
// would do more work than a data block, its K is cut into wsplit runs of
// whole stages, each run's block writing its own partial tile, and the
// second pass (sum_runs below) adds the runs in order: one writer a
// partial, a fixed order of sums. The plan (the data tile's
// rows, wsplit, the block order) is the caller's, mirrored in
// orbit_tpu_torch/kernels/plans.py::sgemm_grads_plan and
// sgemm_grads_schedule.
//
// What bounds it on the H100: FMA issue, 2 (M N rows) FLOPs a weight
// product and 2 rows N K the data product (45 GFLOP each of #4's at
// ViT-B/32, B = 256, S = 50: about 0.67 ms each at 67 TFLOP/s).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "sgemm.cuh"

namespace orbit {
namespace sgrads {
namespace {  // internal linkage: every source that includes this file has its own

constexpr int kTile = 128;     // output tile, both sides
constexpr int kThreads = 256;  // 8 x 8 sums a thread
using WeightTile = sg::Tile<kTile, kTile, kThreads, sg::Major::MN, sg::Major::MN>;
using DataTile = sg::Tile<kTile, kTile, kThreads, sg::Major::K, sg::Major::K>;
constexpr size_t kSmemBytes = WeightTile::kSmemBytes > DataTile::kSmemBytes
                                  ? WeightTile::kSmemBytes
                                  : DataTile::kSmemBytes;  // 99 KB: two blocks an SM

template <int NW>
struct Plan {
  const float* wa[NW];  // weight product j: A^T stored (rows x w_m[j])
  const float* wb[NW];  //   and B (rows x w_n[j])
  float* w_out[NW];     //   into (w_m[j] x w_n[j])
  int w_m[NW], w_n[NW];
  int wsplit;           // runs of each weight product's K, 1 or more
  float* w_part;        // wsplit > 1: run q of product j at (j's offset + q w_m w_n)
  const float* xa;      // the data product: X (rows x x_k)
  const float* xb;      //   W (x_n x x_k)
  float* x_out;         //   into (rows x x_n)
  int x_n, x_k;
  int x_rows;           // rows of a data tile: kTile or kTile / 2
  int rows;             // the weight products' K, the data product's rows
  int weights_first;    // 1: the weight tiles take the first blocks
};

__host__ __device__ inline int tiles(int m, int n) {
  return ((m + kTile - 1) / kTile) * (n / kTile);
}

// stages of one run of a weight product's K
__host__ __device__ inline int run_stages(int rows, int wsplit) {
  const int nk = (rows + sg::kBK - 1) / sg::kBK;
  return (nk + wsplit - 1) / wsplit;
}

// One data tile of BM rows: Y[m0.., n0..] = X . W^T
template <int BM, int NW>
__device__ __forceinline__ void data_tile(const Plan<NW>& p, int m0, int n0, float* smem) {
  sg::Acc<BM, kTile, kThreads> acc;
  const int cols[2] = {n0, n0 + 64};
  sg::mainloop<BM, kTile, kThreads, sg::Major::K, sg::Major::K>(
      p.xa, p.x_k, m0, p.rows, p.xb, p.x_k, cols, p.x_k / sg::kBK, smem, acc);
  sg::for_each_acc<BM, kTile, kThreads>(acc, [&](int r, int c, float4 v) {
    if (m0 + r < p.rows)
      *reinterpret_cast<float4*>(p.x_out + static_cast<size_t>(m0 + r) * p.x_n + n0 + c) = v;
  });
}

template <int NW>
__global__ void __launch_bounds__(kThreads, 2)
sgemm_grads_kernel(const __grid_constant__ Plan<NW> p) {
  extern __shared__ __align__(16) float sgrads_smem[];
  int n_w = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) n_w += tiles(p.w_m[j], p.w_n[j]) * p.wsplit;
  const int n_x = ((p.rows + p.x_rows - 1) / p.x_rows) * (p.x_n / kTile);
  int t = blockIdx.x;
  const bool data = p.weights_first ? t >= n_w : t < n_x;
  if (p.weights_first) {
    if (data) t -= n_w;
  } else if (!data) {
    t -= n_x;
  }
  if (data) {
    const int tn = p.x_n / kTile;
    const int m0 = (t / tn) * p.x_rows, n0 = (t % tn) * kTile;
    if (p.x_rows == kTile)
      data_tile<kTile>(p, m0, n0, sgrads_smem);
    else
      data_tile<kTile / 2>(p, m0, n0, sgrads_smem);
    return;
  }
  // weight product j, its tile t (row by row), run q of its K
  int j = 0;
  size_t part = 0;  // floats of the partials before product j's
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i)
    if (t >= tiles(p.w_m[j], p.w_n[j]) * p.wsplit) {
      t -= tiles(p.w_m[j], p.w_n[j]) * p.wsplit;
      part += static_cast<size_t>(p.wsplit) * p.w_m[j] * p.w_n[j];
      ++j;
    }
  const int q = t % p.wsplit;
  t /= p.wsplit;
  const int m = p.w_m[j], n = p.w_n[j];
  const int m0 = (t / (n / kTile)) * kTile, n0 = (t % (n / kTile)) * kTile;
  const int cols[2] = {n0, n0 + 64};
  const int per = run_stages(p.rows, p.wsplit);
  const int k0 = min(q * per * sg::kBK, p.rows), k1 = min((q + 1) * per * sg::kBK, p.rows);
  sg::Acc<kTile, kTile, kThreads> acc;
  sg::mainloop<kTile, kTile, kThreads, sg::Major::MN, sg::Major::MN, true>(
      p.wa[j] + static_cast<size_t>(k0) * m, m, m0, m, p.wb[j] + static_cast<size_t>(k0) * n, n,
      cols, (k1 - k0 + sg::kBK - 1) / sg::kBK, sgrads_smem, acc, k1 - k0);
  float* out = p.wsplit == 1 ? p.w_out[j] : p.w_part + part + static_cast<size_t>(q) * m * n;
  sg::for_each_acc<kTile, kTile, kThreads>(acc, [&](int r, int c, float4 v) {
    *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * n + n0 + c) = v;
  });
}

// Launches the plan (its operands, shapes, outputs, data tile rows and
// runs set by the caller; with wsplit > 1 the caller adds the partials).
// The weight tiles go first when a run of their K is at least the data
// product's. Every width a multiple of kTile, the data product's K of
// sg::kBK. Returns a cudaError_t code.
template <int NW>
inline int launch(Plan<NW>& p, cudaStream_t stream) {
  if (p.x_n % kTile || p.x_k % sg::kBK || p.rows < 1 || p.wsplit < 1 ||
      (p.wsplit > 1 && !p.w_part) || (p.x_rows != kTile && p.x_rows != kTile / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = ((p.rows + p.x_rows - 1) / p.x_rows) * (p.x_n / kTile);
  for (int j = 0; j < NW; ++j) {
    if (p.w_m[j] % kTile || p.w_n[j] % kTile) return static_cast<int>(cudaErrorInvalidValue);
    blocks += tiles(p.w_m[j], p.w_n[j]) * p.wsplit;
  }
  p.weights_first = run_stages(p.rows, p.wsplit) * sg::kBK >= p.x_k;
  static bool configured = false;  // one flag per instantiation
  if (const int e = sg::configure(sgemm_grads_kernel<NW>, kSmemBytes, &configured)) return e;
  sgemm_grads_kernel<NW><<<blocks, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The second pass over runs of partial sums: out[c] = the sum over runs r
// of part[r n + c], added in run order, 4 columns a thread (n a multiple of
// 4), grid-stride; up to kMaxRuns buffers, blockIdx.y choosing one. Bound
// by bytes: each partial read once, each output written once.
struct Runs {
  const float* part;  // runs x n
  float* out;
  int runs, n;
};
constexpr int kMaxRuns = 2;
struct RunsBatch {
  Runs job[kMaxRuns];
};

__global__ void __launch_bounds__(256) sum_runs_kernel(RunsBatch batch) {
  const Runs p = batch.job[blockIdx.y];
  for (int c = 4 * (blockIdx.x * blockDim.x + threadIdx.x); c < p.n;
       c += 4 * gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(p.part + c);
    for (int r = 1; r < p.runs; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(p.part + static_cast<size_t>(r) * p.n + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(p.out + c) = s;
  }
}

// Adds the runs of `count` (<= kMaxRuns) buffers in one launch; returns
// the launch's error code.
inline int sum_runs(const Runs* jobs, int count, int sms, cudaStream_t stream) {
  if (count < 1 || count > kMaxRuns) return static_cast<int>(cudaErrorInvalidValue);
  RunsBatch batch{};
  for (int i = 0; i < count; ++i) {
    if (jobs[i].n % 4) return static_cast<int>(cudaErrorInvalidValue);
    batch.job[i] = jobs[i];
  }
  sum_runs_kernel<<<dim3(4 * sms, count), 256, 0, stream>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sgrads
}  // namespace orbit
