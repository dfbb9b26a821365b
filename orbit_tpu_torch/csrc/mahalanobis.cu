// Mahalanobis logits of the SimpleCNAPs head:
//   logits[m, c] = -scale * (f_m - mu_c)^T P_c (f_m - mu_c),  -1e30 where
//   class c is padding
//
// Replaces: orbit_tpu/ops/mahalanobis.py::_kernel (via _pallas_logits).
// f (M, D), mu (C, D), P (C, D, D), class mask (C,), all f32; out (M, C)
// f32. All arithmetic is f32 FMA on the CUDA cores, no TF32 (the heads
// compute in true f32).
//
// What bounds it on the H100: operations. 2*M*D^2 FLOPs a real class (16.4
// GFLOP at the SimpleCNAPs path's M = 1000, D = 1280, 5 real classes)
// against D^2*4 bytes of precisions a real class (33 MB): about 500 FLOP a
// byte, far above the f32 ridge of 20, so the bound is the 67 TFLOP/s f32
// peak, 0.2445 ms at the path's shape.
//
// Why not the TPU layout: the TPU grid (class, M tile, D tile) carries a
// (TILE_M, D) "half" accumulator across its sequential D steps in VMEM
// (327 KB at TILE_M = 64, D = 1280): too large for shared memory, and
// blocks on the card run in no order. Instead a block owns (class c, a
// 128-row M tile, a 128-column N tile of half = diff @ P_c) and accumulates
// that 128 x 128 product over all of D in registers, then dots each row
// with diff[:, N tile] and reduces the 16 threads of a row in a fixed order
// into one partial sum per (c, N tile, row). A second kernel sums the
// partials of each (row, class) in N-tile order and applies the scale and
// the class mask. No atomics: a repeat gives the same bits.
//
// The product: a shared-memory tiled SGEMM on the CUDA cores (true f32 FMA,
// no TF32), 256 threads as 16 x 16, each 8 x 8 outputs (rows ty*4 + i and
// 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j): per step of depth,
// 4 16-byte shared loads feed 64 FMAs, and a warp holds 4 row groups by 8
// column groups, so each of its loads is one 128-byte wavefront (4 a step
// for 2,048 FMAs). D
// streams through a 4-stage ring of 16-deep stages in dynamic shared
// memory, filled by 16-byte cp.async copies three stages ahead of the
// FMAs: P_c's rows straight into their stage; f's rows raw, then the thread
// that copied a chunk forms diff = f - mu_c (the same subtraction as the
// plain version, mu from L1) and writes it transposed into one of two A
// buffers. One barrier a stage. Zero-filled copies cover a ragged M or D
// (D a multiple of 4).
//
// Waves: blocks of 128 x 128 tiles hold 82 KB of shared memory and at most
// 128 registers a thread, 2 an SM, 264 at a time. D is cut into `splits`
// ranges, each a block with a partial sum of its own, so that a class has
// about 400 blocks (plans.py::maha_splits): at the SimpleCNAPs query's
// shape (M 1000, D 1280, 16 class slots, 5 real) 8 M tiles x 10 N tiles x
// 5 splits x 5 real classes = 2,000 blocks of 16 stages, 7.6 waves, where
// one split (1.5 waves) read 15% slower. Padded classes (mask 0; 11 of the
// 16 class slots of a 5-object episode) leave at once and read no
// precision: their logit is -1e30 whatever P_c holds. The symmetry of P_c
// is not used (an inverse is symmetric only to rounding, and the plain
// version does not use it either).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTM = 128;       // rows of f per block
constexpr int kTN = 128;       // columns of half per block (a tile of D)
constexpr int kTK = 16;        // depth of one stage
constexpr int kStages = 4;     // stages of the cp.async ring (3 read 4.7% slower on an H100)
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kAPad = 4;       // pads the transposed A rows off the same banks

struct Smem {
  float a[2][kTK][kTM + kAPad];   // diff^T of a stage, [k][m]
  float raw[kStages][kTM][kTK];   // f rows as copied, [m][k]; the row sums after the loop
  float b[kStages][kTK][kTN];     // P_c rows, [k][e]
};

__global__ void __launch_bounds__(kThreads, 2)
mahalanobis_partial_kernel(const float* __restrict__ f, const float* __restrict__ mu,
                           const float* __restrict__ P, const float* __restrict__ class_mask,
                           float* __restrict__ partial, int M, int D, int splits,
                           int split_stages) {
  if (class_mask[blockIdx.z] <= 0.0f) return;  // a padded class: the whole block leaves

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  // a warp holds 4 row groups x 8 column groups: its A fragments are 4
  // distinct 16-byte words and its B fragments 8, one shared-memory
  // wavefront each
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int c = blockIdx.z;
  // block x: N tile x / splits, stages of depth from (x % splits) *
  // split_stages on
  const int m0 = blockIdx.y * kTM, e0 = (blockIdx.x / splits) * kTN;
  const float* mu_c = mu + static_cast<size_t>(c) * D;
  const float* P_c = P + static_cast<size_t>(c) * D * D;
  const int s_first = (blockIdx.x % splits) * split_stages;
  const int n_stages = min((D + kTK - 1) / kTK - s_first, split_stages);

  // this thread's copies of a stage: A chunks q = tid, tid + 256 (row q / 4,
  // depth (q % 4) * 4) and B chunks (depth q / 32, columns (q % 32) * 4)
  const auto issue = [&](int s) {
    if (s < n_stages) {
      const int k0 = (s_first + s) * kTK, slot = s % kStages;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + i * kThreads;
        const int am = q / 4, ak = (q % 4) * 4;
        const bool a_in = m0 + am < M && k0 + ak < D;
        __pipeline_memcpy_async(&sm.raw[slot][am][ak],
                                a_in ? f + static_cast<size_t>(m0 + am) * D + k0 + ak : f,
                                16, a_in ? 0 : 16);
        const int bk = q / 32, be = (q % 32) * 4;
        const bool b_in = k0 + bk < D && e0 + be < D;
        __pipeline_memcpy_async(&sm.b[slot][bk][be],
                                b_in ? P_c + static_cast<size_t>(k0 + bk) * D + e0 + be : P_c,
                                16, b_in ? 0 : 16);
      }
    }
    __pipeline_commit();
  };
  // this thread's A chunks of stage s: diff = f - mu_c, transposed
  const auto transpose = [&](int s) {
    const int k0 = (s_first + s) * kTK, slot = s % kStages;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;
      const int am = q / 4, ak = (q % 4) * 4;
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + am < M && k0 + ak < D) {
        const float4 fv = *reinterpret_cast<const float4*>(&sm.raw[slot][am][ak]);
        const float4 mv = *reinterpret_cast<const float4*>(mu_c + k0 + ak);
        d = make_float4(fv.x - mv.x, fv.y - mv.y, fv.z - mv.z, fv.w - mv.w);
      }
      float* col = &sm.a[s % 2][ak][am];
      col[0] = d.x;
      col[kTM + kAPad] = d.y;
      col[2 * (kTM + kAPad)] = d.z;
      col[3 * (kTM + kAPad)] = d.w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n_stages; ++s) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of stage s landed
    transpose(s);
    // stage s is visible to every thread, and every thread has finished
    // stage s - 1, whose ring slot the next copies take
    __syncthreads();
    issue(s + kStages - 1);
    const float(*as)[kTM + kAPad] = sm.a[s % 2];
    const float(*bs)[kTN] = sm.b[s % kStages];
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __pipeline_wait_prior(0);

  // each row's dot with diff over this N tile: per thread its 8 columns in
  // order, then the 16 threads of a row summed in order (the raw ring,
  // which no thread reads after its last stage, holds the row sums)
  float(*red)[17] = reinterpret_cast<float(*)[17]>(&sm.raw[0][0][0]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + i % 4;
    const int m = m0 + r;
    float s = 0.0f;
    if (m < M) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + h * 64 + tx * 4;
        if (e < D) {
          const float4 fv = *reinterpret_cast<const float4*>(f + static_cast<size_t>(m) * D + e);
          const float4 mv = *reinterpret_cast<const float4*>(mu_c + e);
          const float dv[4] = {fv.x - mv.x, fv.y - mv.y, fv.z - mv.z, fv.w - mv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) s = fmaf(acc[i][h * 4 + j], dv[j], s);
        }
      }
    }
    red[r][tx] = s;
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
                                          float* __restrict__ out, int M, int C, int n_parts,
                                          float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * C) return;
  const int m = i / C, c = i % C;
  if (class_mask[c] <= 0.0f) {
    out[i] = -1e30f;
    return;
  }
  float s = 0.0f;
  for (int t = 0; t < n_parts; ++t) s += partial[(static_cast<size_t>(c) * n_parts + t) * M + m];
  out[i] = -scale * s;
}

}  // namespace

// splits: the ranges of D a tile's product is cut into
// (orbit_tpu_torch/kernels/plans.py::maha_splits), each its own partial sum;
// partial: workspace of C * ceil(D / 128) * splits * M floats
extern "C" int orbit_mahalanobis_logits(const void* f, const void* mu, const void* P,
                                        const void* class_mask, void* partial, void* out,
                                        int M, int D, int C, int splits, float scale,
                                        void* stream) {
  const int n_stages = (D + kTK - 1) / kTK;
  if (M < 1 || D < 4 || D % 4 || C < 1 || C > 65535 || (M + kTM - 1) / kTM > 65535 ||
      splits < 1 || splits > n_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split_stages = (n_stages + splits - 1) / splits;
  if ((splits - 1) * split_stages >= n_stages) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (const int e = orbit::set_smem(mahalanobis_partial_kernel, sizeof(Smem), &configured))
    return e;
  const int n_parts = (D + kTN - 1) / kTN * splits;
  const dim3 grid(n_parts, (M + kTM - 1) / kTM, C);
  mahalanobis_partial_kernel<<<grid, kThreads, sizeof(Smem), s>>>(
      static_cast<const float*>(f), static_cast<const float*>(mu),
      static_cast<const float*>(P), static_cast<const float*>(class_mask),
      static_cast<float*>(partial), M, D, splits, split_stages);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int total = M * C;
  mahalanobis_finish_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(class_mask),
      static_cast<float*>(out), M, C, n_parts, scale);
  return static_cast<int>(cudaGetLastError());
}
