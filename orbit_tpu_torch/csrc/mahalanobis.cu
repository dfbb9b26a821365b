// Mahalanobis logits of the SimpleCNAPs head:
//   logits[m, c] = -scale * (f_m - mu_c)^T P_c (f_m - mu_c),  -1e30 where
//   class c is padding
//
// Replaces: orbit_tpu/ops/mahalanobis.py::_kernel (via _pallas_logits).
// f (M, D), mu (C, D), P (C, D, D), class mask (C,), all f32; out (M, C)
// f32. All arithmetic is f32 FMA on the CUDA cores, no TF32 (the heads
// compute in true f32).
//
// What bounds it on the H100: operations. 2*M*D^2*C FLOPs (4.2 GFLOP at
// M = 256, D = 1280, C = 5) against C*D^2*4 bytes of precisions (33 MB):
// about 128 FLOP per byte, above the f32 ridge of 20, so the bound is the
// 67 TFLOP/s f32 peak.
//
// Why not the TPU layout: the TPU grid (class, M tile, D tile) carries a
// (TILE_M, D) "half" accumulator across its sequential D steps in VMEM
// (327 KB at TILE_M = 64, D = 1280): too large for shared memory, and
// blocks on the card run in no order. Instead a block owns (class c, a
// 64-row M tile, a 64-column N tile of half = diff @ P_c): it accumulates
// that 64 x 64 product over all of D in registers (a shared-memory tiled
// SGEMM, 4 x 4 outputs a thread, 16-byte loads into double-buffered
// 16-deep stages, diff = f - mu_c formed as the A tile is staged; D must be
// a multiple of 4), then dots each row with diff[:, N tile] and reduces the 16
// threads of a row in a fixed order into one partial sum per (c, N tile,
// row). A second kernel sums the partials of each (row, class) in N-tile
// order and applies the scale and the class mask. Padded classes (mask 0;
// 11 of the 16 class slots of a 5-object episode) skip both kernels and
// read no precision: their logit is -1e30 whatever P_c holds. No atomics: a
// repeat gives the same bits. The symmetry of P_c is not used (an inverse is symmetric
// only to rounding, and the plain version does not use it either).
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;        // rows of f per block
constexpr int kTN = 64;        // columns of half per block (a tile of D)
constexpr int kTK = 16;        // depth of one shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
mahalanobis_partial_kernel(const float* __restrict__ f, const float* __restrict__ mu,
                           const float* __restrict__ P, const float* __restrict__ class_mask,
                           float* __restrict__ partial, int M, int D) {
  if (class_mask[blockIdx.z] <= 0.0f) return;  // a padded class: the whole block leaves

  __shared__ __align__(16) float As[2][kTK][kTM + 4];  // diff^T stages: As[.][k][m]
  __shared__ __align__(16) float Bs[2][kTK][kTN];
  __shared__ float red[kTM][17];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * kTM, e0 = blockIdx.x * kTN;
  const float* mu_c = mu + static_cast<size_t>(c) * D;
  const float* P_c = P + static_cast<size_t>(c) * D * D;

  // this thread's share of a stage: one float4 of diff (row am, depth
  // ak..ak+3) and one of P_c (depth bk, columns be..be+3); D % 4 == 0, so
  // a vector is wholly inside or wholly outside
  const int am = tid / 4, ak = (tid % 4) * 4;
  const int bk = tid / 16, be = (tid % 16) * 4;
  float4 a_next, b_next;
  const auto fetch = [&](int k0) {
    const int gm = m0 + am, gk = k0 + ak;
    a_next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gm < M && gk < D) {
      const float4 fv = *reinterpret_cast<const float4*>(f + static_cast<size_t>(gm) * D + gk);
      const float4 mv = *reinterpret_cast<const float4*>(mu_c + gk);
      a_next = make_float4(fv.x - mv.x, fv.y - mv.y, fv.z - mv.z, fv.w - mv.w);
    }
    const int gkb = k0 + bk, ge = e0 + be;
    b_next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gkb < D && ge < D)
      b_next = *reinterpret_cast<const float4*>(P_c + static_cast<size_t>(gkb) * D + ge);
  };
  const auto stage = [&](int buf) {
    As[buf][ak + 0][am] = a_next.x;
    As[buf][ak + 1][am] = a_next.y;
    As[buf][ak + 2][am] = a_next.z;
    As[buf][ak + 3][am] = a_next.w;
    *reinterpret_cast<float4*>(&Bs[buf][bk][be]) = b_next;
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // double-buffered stages: the next stage's loads are in flight while
  // this one is multiplied; one barrier a stage
  fetch(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += kTK) {
    const bool more = k0 + kTK < D;
    if (more) fetch(k0 + kTK);
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // each row's dot with diff over this N tile: per thread 4 columns, then
  // the 16 threads of a row summed in order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx * 4 + j;
      if (m < M && e < D) s = fmaf(acc[i][j], f[static_cast<size_t>(m) * D + e] - mu_c[e], s);
    }
    red[ty * 4 + i][tx] = s;
  }
  __syncthreads();
  if (tid < kTM && m0 + tid < M) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[tid][t];
    partial[(static_cast<size_t>(c) * gridDim.x + blockIdx.x) * M + m0 + tid] = s;
  }
}

__global__ void mahalanobis_finish_kernel(const float* __restrict__ partial,
                                          const float* __restrict__ class_mask,
                                          float* __restrict__ out, int M, int C, int n_tiles,
                                          float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * C) return;
  const int m = i / C, c = i % C;
  if (class_mask[c] <= 0.0f) {
    out[i] = -1e30f;
    return;
  }
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(static_cast<size_t>(c) * n_tiles + t) * M + m];
  out[i] = -scale * s;
}

}  // namespace

// partial: workspace of C * ceil(D / 64) * M floats
extern "C" int orbit_mahalanobis_logits(const void* f, const void* mu, const void* P,
                                        const void* class_mask, void* partial, void* out,
                                        int M, int D, int C, float scale, void* stream) {
  if (M < 1 || D < 4 || D % 4 || C < 1 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (D + kTN - 1) / kTN;
  const dim3 grid(n_tiles, (M + kTM - 1) / kTM, C);
  mahalanobis_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(f), static_cast<const float*>(mu),
      static_cast<const float*>(P), static_cast<const float*>(class_mask),
      static_cast<float*>(partial), M, D);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int total = M * C;
  mahalanobis_finish_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(class_mask),
      static_cast<float*>(out), M, C, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}
