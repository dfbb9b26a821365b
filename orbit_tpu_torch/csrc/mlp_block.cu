// Fused transformer MLP half-block: y = x + fc2(gelu(fc1(LayerNorm(x)))).
//
// Replaces: orbit_tpu/ops/mlp_block.py::_mlp_kernel (via _pallas_mlp). On
// the B*S independent rows of x (rows, D), with LayerNorm scale/bias, b1 and
// b2 in f32 and W1 (D, Hd), W2 (Hd, D) in T:
//   xf   = f32(x); mean, var two-pass in f32; rstd = 1/sqrt(var + eps)
//   xn   = cast_T((xf - mean) * rstd * gamma + beta)
//   h    = cast_T(gelu_erf(f32(xn @ W1) + b1))
//   y    = cast_T(f32(h @ W2) + b2 + xf)
// The rounding points are the TPU kernel's. GELU is the exact erf form; the
// TPU kernel approximates erf with a polynomial (|err| <= 1.5e-7), here
// CUDA's erff is used.
//
// What bounds it on the H100: the two GEMMs, 4*rows*D*Hd FLOPs (about
// 121 GFLOP per ViT-B/32 layer at B=256, 0.122 ms at the bf16 peak). The
// TPU kernel keeps h in VMEM because its weights stay resident there; on
// the H100 a block's shared memory cannot hold them, and keeping h on chip
// makes every row tile re-stream all of W1 and W2 (9.4 MB) from L2.
//
// bf16, D a multiple of 128 (the ViTs): three launches, described at their
// kernels below. The two products run on wgmma.cuh's mainloop (TMA-fed
// shared-memory stages, wgmma with f32 accumulators) in 128 x 128 tiles
// that read each weight tile once per row tile; h goes to
// device memory once as bf16 (78.6 MB at B = 256, about 0.047 ms of the
// 3.35 TB/s each way), which is cheaper than re-streaming the weights.
//
// f32, and bf16 at other widths: the FMA kernel on the CUDA cores (true
// f32; the numeric policy keeps TF32 off), bound by FMA issue and the
// shared-memory reads that feed it; at D 768 a thread holds 4 x 24
// accumulators (252 registers), so one block fills an SM and 400 blocks
// make 4 waves on 132 SMs, the last nearly empty. Blocks of 8 warps; each
// warp owns 4 rows from the LayerNorm to the store. The warp normalises its
// rows into shared memory, then walks the hidden dimension in chunks of
// kChunk columns: the chunk's activations h_c = gelu(xn @ W1[:, c] + b1[c])
// (2 columns per lane) go to shared memory only, and y_acc += h_c @ W2[c, :]
// accumulates in registers (4 rows x D/32 columns per lane). W1 and W2
// stream through double-buffered shared-memory stages (cp.async) that the
// block's 8 warps share, and h never reaches device memory. D is a
// template parameter so the accumulator tile lives in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using orbit::from_float;
using orbit::round_to;
using orbit::to_float;

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kRows = kWarps * kRowsPerThread;  // 32 rows per block
constexpr int kChunk = 64;                     // hidden columns per step
constexpr int kStageK1 = 32;                   // W1 rows per shared-memory stage
constexpr int kStageK2 = 8;                    // W2 rows per shared-memory stage

// shared memory: xn f32 [kRows][D], h f32 [kRows][kChunk], then two W1
// stage buffers [kStageK1][kChunk] and two W2 stage buffers [kStageK2][D]
// in T
template <typename T, int D>
struct FmaLayout {
  static constexpr size_t kXnBytes = sizeof(float) * kRows * D;
  static constexpr size_t kHBytes = sizeof(float) * kRows * kChunk;
  static constexpr size_t kW1Bytes = sizeof(T) * kStageK1 * kChunk;
  static constexpr size_t kW2Bytes = sizeof(T) * kStageK2 * D;
  static constexpr size_t kBytes = kXnBytes + kHBytes + 2 * kW1Bytes + 2 * kW2Bytes;
};

// Stage s of the block's weight stream into shared memory, asynchronously
// (cp.async, 16 bytes a copy). Per hidden chunk the stream is D/kStageK1
// slices of W1[:, chunk] and then kChunk/kStageK2 slices of W2[chunk, :].
template <typename T, int D>
__device__ __forceinline__ void issue_stage(int s, const T* __restrict__ w1,
                                            const T* __restrict__ w2, int hidden,
                                            T* w1s, T* w2s) {
  constexpr int kN1 = D / kStageK1, kN2 = kChunk / kStageK2;
  constexpr int kPer16 = 16 / sizeof(T);
  const int c0 = (s / (kN1 + kN2)) * kChunk;
  const int j = s % (kN1 + kN2);
  if (j < kN1) {
    T* dst = w1s + (j % 2) * kStageK1 * kChunk;
    const T* src = w1 + static_cast<size_t>(j * kStageK1) * hidden + c0;
    for (int p = threadIdx.x; p < kStageK1 * kChunk / kPer16; p += kThreads) {
      const int r = p / (kChunk / kPer16), c = (p % (kChunk / kPer16)) * kPer16;
      __pipeline_memcpy_async(dst + r * kChunk + c, src + static_cast<size_t>(r) * hidden + c, 16);
    }
  } else {
    const int j2 = j - kN1;
    T* dst = w2s + (j2 % 2) * kStageK2 * D;
    const T* src = w2 + static_cast<size_t>(c0 + j2 * kStageK2) * D;
    for (int p = threadIdx.x; p < kStageK2 * D / kPer16; p += kThreads)
      __pipeline_memcpy_async(dst + p * kPer16, src + p * kPer16, 16);
  }
  __pipeline_commit();
}

// Each warp owns kRowsPerThread rows from the LayerNorm to the store: the
// warp's lanes share those rows' xn and h values by broadcast reads of
// shared memory and split the columns. The weights stream through shared
// memory in double-buffered stages shared by the block's 8 warps.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ ln_b, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, T* __restrict__ out, int rows,
                       int hidden, float eps) {
  using L = FmaLayout<T, D>;
  constexpr int kVec = D % 128 == 0 ? 4 : 2;     // fc2 columns per vector load
  constexpr int kGroups = D / (32 * kVec);       // fc2 column groups per lane
  constexpr int kN1 = D / kStageK1, kN2 = kChunk / kStageK2;
  extern __shared__ __align__(16) unsigned char fma_smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wrow0 = blockIdx.x * kRows + warp * kRowsPerThread;  // this warp's rows
  float* xn = reinterpret_cast<float*>(fma_smem) + warp * kRowsPerThread * D;
  float* hs = reinterpret_cast<float*>(fma_smem + L::kXnBytes) + warp * kRowsPerThread * kChunk;
  T* w1s = reinterpret_cast<T*>(fma_smem + L::kXnBytes + L::kHBytes);
  T* w2s = reinterpret_cast<T*>(fma_smem + L::kXnBytes + L::kHBytes + 2 * L::kW1Bytes);

  const int stages = (hidden / kChunk) * (kN1 + kN2);
  issue_stage<T, D>(0, w1, w2, hidden, w1s, w2s);  // overlaps the LayerNorm

  // ---- LayerNorm (f32, two-pass), one row at a time ----
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = wrow0 + i;
    float* xr_n = xn + i * D;
    if (gr < rows) {
      const T* xr = x + static_cast<size_t>(gr) * D;
      float s = 0.f;
      for (int k = lane; k < D; k += 32) s += to_float(xr[k]);
      const float mean = orbit::warp_sum(s) / D;
      float v = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float c = to_float(xr[k]) - mean;
        v += c * c;
      }
      const float rstd = 1.0f / sqrtf(orbit::warp_sum(v) / D + eps);
      for (int k = lane; k < D; k += 32) {
        const float xhat = (to_float(xr[k]) - mean) * rstd;
        xr_n[k] = round_to<T>(xhat * ln_g[k] + ln_b[k]);
      }
    } else {
      for (int k = lane; k < D; k += 32) xr_n[k] = 0.f;
    }
  }
  __syncwarp();

  // fc2 output: lane owns columns g*32*kVec + lane*kVec + v of its 4 rows;
  // fc1 output: lane owns chunk columns 2*lane and 2*lane + 1
  float yacc[kRowsPerThread][kGroups * kVec];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kGroups * kVec; ++j) yacc[i][j] = 0.f;
  float hacc[kRowsPerThread][2];

  for (int s = 0; s < stages; ++s) {
    __pipeline_wait_prior(0);  // this thread's copies of stage s landed
    __syncthreads();           // ...and everyone's; stage s-1's buffer is free
    if (s + 1 < stages) issue_stage<T, D>(s + 1, w1, w2, hidden, w1s, w2s);
    const int c0 = (s / (kN1 + kN2)) * kChunk;
    const int j = s % (kN1 + kN2);
    if (j < kN1) {
      // ---- fc1, rows j*kStageK1 .. +kStageK1 of W1[:, chunk] ----
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) hacc[i][0] = hacc[i][1] = 0.f;
      }
      const T* wt = w1s + (j % 2) * kStageK1 * kChunk + 2 * lane;
      const float* xk = xn + j * kStageK1;
#pragma unroll 2
      for (int k = 0; k < kStageK1; k += 4) {
        float a[kRowsPerThread][4];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xk + i * D + k);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[2];
          orbit::load_vec<T, 2>(wt + (k + kk) * kChunk, w);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            hacc[i][0] = fmaf(a[i][kk], w[0], hacc[i][0]);
            hacc[i][1] = fmaf(a[i][kk], w[1], hacc[i][1]);
          }
        }
      }
      if (j == kN1 - 1) {
        // ---- + b1, exact-erf GELU in f32, rounded to T ----
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 2 * lane + q;
            const float hp = hacc[i][q] + b1[c0 + col];
            const float g = 0.5f * hp * (1.0f + erff(hp * 0.70710678118654752f));
            hs[i * kChunk + col] = round_to<T>(g);
          }
        __syncwarp();  // the warp's h rows are read only by the warp
      }
    } else {
      // ---- fc2: y_acc += h[:, rows of this stage] @ W2 stage ----
      const int j2 = j - kN1;
      const T* wt = w2s + (j2 % 2) * kStageK2 * D + lane * kVec;
#pragma unroll
      for (int kk = 0; kk < kStageK2; ++kk) {
        float a[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) a[i] = hs[i * kChunk + j2 * kStageK2 + kk];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float w[kVec];
          orbit::load_vec<T, kVec>(wt + kk * D + g * 32 * kVec, w);
#pragma unroll
          for (int v = 0; v < kVec; ++v)
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i)
              yacc[i][g * kVec + v] = fmaf(a[i], w[v], yacc[i][g * kVec + v]);
        }
      }
      if (j2 == kN2 - 1) __syncwarp();  // h is rewritten by the next chunk
    }
  }

  // ---- y = cast_T(f32 GEMM + b2 + xf) ----
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = wrow0 + i;
    if (gr >= rows) continue;
    const T* xr = x + static_cast<size_t>(gr) * D;
    T* yr = out + static_cast<size_t>(gr) * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int col = g * 32 * kVec + lane * kVec + v;
        yr[col] = from_float<T>(yacc[i][g * kVec + v] + b2[col] + to_float(xr[col]));
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper's tensor cores, for D and hidden multiples of 128: three
// launches behind one op call, the two products on
// the wgmma mainloop of wgmma.cuh.
//   1. LayerNorm: one warp per row, f32 two-pass statistics, xn rounded to
//      bf16 into a (rows, D) workspace;
//   2. fc1: h = cast_bf16(gelu_erf(f32(xn @ W1) + b1)) into a (rows, hidden)
//      workspace;
//   3. fc2: y = cast_bf16(f32(h @ W2) + b2 + f32(x)).
// Both products run 128 x 128 tiles, two blocks an SM on a 3-stage ring
// each, so that one block's epilogue (fc1's: an erf per element) overlaps
// the other block's products.
// The rounding points are those of the other routes: h is rounded to bf16
// where the TPU kernel rounds hg. Writing h once and reading it back costs
// 2 x 78.6 MB at ViT-B/32, B = 256 (about 0.047 ms at 3.35 TB/s); keeping
// it on chip instead would make every row tile re-stream all of W1 and W2.
// ---------------------------------------------------------------------------
using orbit::wg::kBM;
using orbit::wg::kBK;
constexpr int kLnWarps = 8;
constexpr int kTileN = 128;  // tile columns of fc1 and fc2
constexpr int kStages = 3;   // ring stages a block: two blocks an SM
using MlpRing = orbit::wg::Ring<kTileN, kStages>;

template <int D>
__global__ void __launch_bounds__(32 * kLnWarps)
fused_mlp_block_layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                                 const float* __restrict__ ln_g,
                                 const float* __restrict__ ln_b,
                                 __nv_bfloat16* __restrict__ xn, int rows, float eps) {
  constexpr int kVecs = D / 8;                  // 16-byte vectors of a row
  constexpr int kPerLane = (kVecs + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * D);
  float v[kPerLane][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < kVecs) {
      const uint4 raw = xr[c];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(p[q]);
        v[i][2 * q] = f.x;
        v[i][2 * q + 1] = f.y;
        s += f.x + f.y;
      }
    }
  }
  const float mean = orbit::warp_sum(s) / D;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    if (lane + 32 * i < kVecs)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = v[i][e] - mean;
        var += c * c;
      }
  const float rstd = 1.0f / sqrtf(orbit::warp_sum(var) / D + eps);
  uint4* out = reinterpret_cast<uint4*>(xn + static_cast<size_t>(row) * D);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < kVecs) {
      uint4 raw;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 8 * c + 2 * q;
        p[q] = __floats2bfloat162_rn((v[i][2 * q] - mean) * rstd * ln_g[k] + ln_b[k],
                                     (v[i][2 * q + 1] - mean) * rstd * ln_g[k + 1] +
                                         ln_b[k + 1]);
      }
      out[c] = raw;
    }
  }
}

// fc1's epilogue: h = cast_bf16(gelu_erf(f32 sum + b1))
struct GeluStore {
  const float* b1;
  __nv_bfloat16* h;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) const {
    const float p0 = v0 + b1[c], p1 = v1 + b1[c + 1];
    const float g0 = 0.5f * p0 * (1.0f + erff(p0 * 0.70710678118654752f));
    const float g1 = 0.5f * p1 * (1.0f + erff(p1 * 0.70710678118654752f));
    *reinterpret_cast<__nv_bfloat162*>(h + static_cast<size_t>(r) * ld + c) =
        __floats2bfloat162_rn(g0, g1);
  }
};

// fc2's epilogue: y = cast_bf16(f32 sum + b2 + f32(x))
struct ResidualStore {
  const float* b2;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) const {
    const size_t o = static_cast<size_t>(r) * ld + c;
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
    *reinterpret_cast<__nv_bfloat162*>(out + o) =
        __floats2bfloat162_rn(v0 + b2[c] + xf.x, v1 + b2[c + 1] + xf.y);
  }
};

// One 128 x 128 tile of fc1 or fc2: the mainloop over K = 64 nk, then the
// epilogue on every element of a row below rows.
template <class Epi>
__global__ void __launch_bounds__(orbit::wg::kThreads, 2)
fused_mlp_block_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_b, Epi epi, int rows,
                            int nk) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = orbit::wg::ring_base(wg_smem);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kTileN;
  const int cols[2] = {n0, n0 + 64};
  float acc[kTileN / 2];
  orbit::wg::mainloop<kTileN, kStages>(&map_a, &map_b, m0, cols, nk, base, acc);
  if (threadIdx.x >= 256) return;  // the producer warp
  orbit::wg::for_each_acc<kTileN>(acc, [&](int r, int c, float v0, float v1) {
    if (m0 + r < rows) epi(m0 + r, n0 + c, v0, v1);
  });
}

template <int D>
int launch_wgmma(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out, void* xn,
                 void* h, int rows, int hidden, float eps, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap maps[4];
  if (!orbit::wg::make_tmap_2d(&maps[0], xn, rows, D, D, kBM) ||
      !orbit::wg::make_tmap_2d(&maps[1], w1, D, hidden, hidden, kBK) ||
      !orbit::wg::make_tmap_2d(&maps[2], h, rows, hidden, hidden, kBM) ||
      !orbit::wg::make_tmap_2d(&maps[3], w2, hidden, D, D, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = MlpRing::kSmemBytes;
  static bool configured1 = false, configured2 = false;
  if (const int e = orbit::set_smem(fused_mlp_block_gemm_kernel<GeluStore>, bytes, &configured1))
    return e;
  if (const int e =
          orbit::set_smem(fused_mlp_block_gemm_kernel<ResidualStore>, bytes, &configured2))
    return e;
  fused_mlp_block_layernorm_kernel<D><<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0,
                                        stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<bf16*>(xn), rows, eps);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int row_tiles = (rows + kBM - 1) / kBM;
  fused_mlp_block_gemm_kernel<<<dim3(hidden / kTileN, row_tiles), orbit::wg::kThreads, bytes,
                                stream>>>(
      maps[0], maps[1], GeluStore{static_cast<const float*>(b1), static_cast<bf16*>(h), hidden},
      rows, D / kBK);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  fused_mlp_block_gemm_kernel<<<dim3(D / kTileN, row_tiles), orbit::wg::kThreads, bytes,
                                stream>>>(
      maps[2], maps[3],
      ResidualStore{static_cast<const float*>(b2), static_cast<const bf16*>(x),
                    static_cast<bf16*>(out), D},
      rows, hidden / kBK);
  return static_cast<int>(cudaGetLastError());
}

// The routes: bf16 with D and hidden multiples of 128
// takes the wgmma route (xn and h are its workspaces); every other shape
// and f32 take the FMA kernel.
template <typename T, int D>
int launch_d(const void* x, const void* ln_g, const void* ln_b, const void* w1,
             const void* b1, const void* w2, const void* b2, void* out, void* xn, void* h,
             int rows, int hidden, float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D % 128 == 0) {
    if (hidden % kTileN == 0) {
      if (!xn || !h) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wgmma<D>(x, ln_g, ln_b, w1, b1, w2, b2, out, xn, h, rows, hidden, eps,
                             stream);
    }
  }
  constexpr size_t bytes = FmaLayout<T, D>::kBytes;
  static bool configured = false;  // one flag per instantiation
  if (const int e = orbit::set_smem(fused_mlp_block_kernel<T, D>, bytes, &configured)) return e;
  const int blocks = (rows + kRows - 1) / kRows;
  fused_mlp_block_kernel<T, D><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), rows, hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, void* xn, void* h, int rows, int D,
           int hidden, float eps, void* stream) {
  if (rows < 1 || hidden < kChunk || hidden % kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {  // the widths of the supported ViTs and of the tests
#define ORBIT_MLP_CASE(W)                                                                 \
  case W:                                                                                 \
    return launch_d<T, W>(x, ln_g, ln_b, w1, b1, w2, b2, out, xn, h, rows, hidden, eps, s);
    ORBIT_MLP_CASE(64)
    ORBIT_MLP_CASE(128)
    ORBIT_MLP_CASE(384)
    ORBIT_MLP_CASE(768)
#undef ORBIT_MLP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int orbit_fused_mlp_block_f32(const void* x, const void* ln_g, const void* ln_b,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, void* out, int rows, int D,
                                         int hidden, float eps, void* stream) {
  return launch<float>(x, ln_g, ln_b, w1, b1, w2, b2, out, nullptr, nullptr, rows, D, hidden,
                       eps, stream);
}

// xn (rows, D) and h (rows, hidden) are the wgmma route's bf16 workspaces
// (may be null where the FMA kernel takes the shape: D not a multiple of
// 128, or hidden not a multiple of 128)
extern "C" int orbit_fused_mlp_block_bf16(const void* x, const void* ln_g, const void* ln_b,
                                          const void* w1, const void* b1, const void* w2,
                                          const void* b2, void* out, void* xn, void* h,
                                          int rows, int D, int hidden, float eps,
                                          void* stream) {
  return launch<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, b2, out, xn, h, rows, D, hidden,
                               eps, stream);
}
