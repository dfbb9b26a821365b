// Fused transformer MLP half-block: y = x + fc2(gelu(fc1(LayerNorm(x)))).
//
// Replaces: orbit_tpu/ops/mlp_block.py::_mlp_kernel (via _pallas_mlp). On
// the B*S independent rows of x (rows, D), with LayerNorm scale/bias, b1 and
// b2 in f32 and W1 (D, Hd), W2 (Hd, D) in T:
//   xf   = f32(x); mean, var two-pass in f32; rstd = 1/sqrt(var + eps)
//   xn   = cast_T((xf - mean) * rstd * gamma + beta)
//   h    = cast_T(gelu_erf(f32(xn @ W1) + b1))     (never stored to memory)
//   y    = cast_T(f32(h @ W2) + b2 + xf)
// The rounding points are the TPU kernel's. GELU is the exact erf form; the
// TPU kernel approximates erf with a polynomial (|err| <= 1.5e-7), here
// CUDA's erff is used.
//
// What bounds it on the H100: the two GEMMs, 4*rows*D*Hd FLOPs (about
// 121 GFLOP per ViT-B/32 layer at B=256). In f32 the kernel runs FMA loops
// on the CUDA cores (true f32; the numeric policy keeps TF32 off), bound by
// FMA issue and the shared-memory reads that feed it; at D 768 a thread
// holds 4 x 24 accumulators (252 registers), so one block fills an SM and
// 400 blocks make 4 waves on 132 SMs, the last nearly empty. In bf16 (D a
// multiple of 128) the GEMMs run as WMMA tiles on the tensor cores; there
// the bound is the weight traffic (each 32-row block re-reads W1 and W2,
// 9.4 MB, from L2 as fragments) and the serial 48-step fc1 chain of each
// warp. wgmma with TMA and a weight tile shared by a cluster are later work.
//
// Design (f32, and bf16 at other D): blocks of 8 warps; each warp owns 4
// rows from the LayerNorm to the store. The warp normalises its rows into
// shared memory, then walks the hidden dimension in chunks of kChunk
// columns: the chunk's activations h_c = gelu(xn @ W1[:, c] + b1[c])
// (2 columns per lane) go to shared memory only, and y_acc += h_c @ W2[c, :]
// accumulates in registers (4 rows x D/32 columns per lane). W1 and W2
// stream through double-buffered shared-memory stages (cp.async) that the
// block's 8 warps share. The (rows, Hd) hidden tensor never reaches device
// memory. D is a template parameter so the accumulator tile lives in
// registers. The bf16 tensor-core design is described at its kernel below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

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
// bf16 on the tensor cores (WMMA 16x16x16, f32 accumulate), for D a
// multiple of 128. Same math and rounding points as the FMA kernel above;
// only the two GEMMs move to the tensor cores. One block of 8 warps per
// kTcRows rows: the block normalises its rows into shared memory (bf16), and
// per hidden chunk of 64 columns each warp computes one 16x16 tile of
// xn @ W1[:, c] (W1 fragments straight from L2), the block applies bias +
// GELU into a bf16 tile, and each warp adds that tile times its D/8-column
// stripe of W2[c, :] into its accumulator fragments (2 x D/128 of them).
// ---------------------------------------------------------------------------
constexpr int kTcRows = 32;
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;

template <int D>
struct TcLayout {
  static constexpr int kXLd = D + 8;            // bf16 elements; rows stay 32-byte aligned
  static constexpr int kHLd = kChunk + 8;       // bf16
  static constexpr int kSLd = kChunk + 4;       // f32
  static constexpr size_t kXBytes = sizeof(__nv_bfloat16) * kTcRows * kXLd;
  static constexpr size_t kHBytes = sizeof(__nv_bfloat16) * kTcRows * kHLd;
  static constexpr size_t kStageBytes = sizeof(float) * kTcRows * kSLd;
  static constexpr size_t kWarpTileBytes = sizeof(float) * kTcWarps * 256;
  static constexpr size_t kBytes = kXBytes + kHBytes + kStageBytes + kWarpTileBytes;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fused_mlp_block_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_g,
                          const float* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w1,
                          const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                          const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                          int rows, int hidden, float eps) {
  using namespace nvcuda;
  using L = TcLayout<D>;
  constexpr int kStripe = D / 16 / kTcWarps;  // fc2 column tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kXBytes);
  float* hstage = reinterpret_cast<float*>(smem_raw + L::kXBytes + L::kHBytes);
  float* wtile = reinterpret_cast<float*>(smem_raw + L::kXBytes + L::kHBytes + L::kStageBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kTcRows;

  // ---- LayerNorm (f32, two-pass), one warp per row, xn rounded to bf16 ----
  for (int r = warp; r < kTcRows; r += kTcWarps) {
    const int gr = row0 + r;
    __nv_bfloat16* xr_n = xn + r * L::kXLd;
    if (gr < rows) {
      const __nv_bfloat16* xr = x + static_cast<size_t>(gr) * D;
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
        xr_n[k] = from_float<__nv_bfloat16>(xhat * ln_g[k] + ln_b[k]);
      }
    } else {
      for (int k = lane; k < D; k += 32) xr_n[k] = from_float<__nv_bfloat16>(0.f);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[2][kStripe];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kStripe; ++j) wmma::fill_fragment(yacc[i][j], 0.f);

  const int tr = warp / 4, tc = warp % 4;  // this warp's fc1 tile of the chunk
  for (int c0 = 0; c0 < hidden; c0 += kChunk) {
    {  // ---- fc1: hpre tile (tr, tc) = xn[tr rows] @ W1[:, c0 + tc*16 ...] ----
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.f);
      const __nv_bfloat16* a_ptr = xn + tr * 16 * L::kXLd;
      const __nv_bfloat16* b_ptr = w1 + c0 + tc * 16;
#pragma unroll 4
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, a_ptr + k, L::kXLd);
        wmma::load_matrix_sync(b, b_ptr + static_cast<size_t>(k) * hidden, hidden);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      wmma::store_matrix_sync(hstage + tr * 16 * L::kSLd + tc * 16, hacc, L::kSLd,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // ---- + b1, exact-erf GELU in f32, rounded to bf16 ----
    for (int e = tid; e < kTcRows * kChunk; e += kTcThreads) {
      const int r = e / kChunk, c = e % kChunk;
      const float hp = hstage[r * L::kSLd + c] + b1[c0 + c];
      const float g = 0.5f * hp * (1.0f + erff(hp * 0.70710678118654752f));
      hs[r * L::kHLd + c] = from_float<__nv_bfloat16>(g);
    }
    __syncthreads();
    // ---- fc2: y stripe += h_c @ W2[c0:c0+kChunk, stripe] ----
#pragma unroll
    for (int k = 0; k < kChunk; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, hs + k, L::kHLd);
      wmma::load_matrix_sync(a1, hs + 16 * L::kHLd + k, L::kHLd);
      const __nv_bfloat16* b_row = w2 + static_cast<size_t>(c0 + k) * D + warp * kStripe * 16;
#pragma unroll
      for (int j = 0; j < kStripe; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_row + j * 16, D);
        wmma::mma_sync(yacc[0][j], a0, b, yacc[0][j]);
        wmma::mma_sync(yacc[1][j], a1, b, yacc[1][j]);
      }
    }
  }

  // ---- y = cast_bf16(f32 GEMM + b2 + xf), through a per-warp f32 tile ----
  float* tile = wtile + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kStripe; ++j) {
      wmma::store_matrix_sync(tile, yacc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + i * 16 + e / 16;
        const int col = (warp * kStripe + j) * 16 + e % 16;
        if (gr < rows) {
          const size_t o = static_cast<size_t>(gr) * D + col;
          out[o] = from_float<__nv_bfloat16>(tile[e] + b2[col] + to_float(x[o]));
        }
      }
      __syncwarp();
    }
}

template <typename T, int D>
int launch_d(const void* x, const void* ln_g, const void* ln_b, const void* w1,
             const void* b1, const void* w2, const void* b2, void* out, int rows,
             int hidden, float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D % 128 == 0) {
    constexpr size_t bytes = TcLayout<D>::kBytes;
    static bool configured = false;  // one flag per instantiation
    if (const int e = orbit::set_smem(fused_mlp_block_tc_kernel<D>, bytes, &configured)) return e;
    const int blocks = (rows + kTcRows - 1) / kTcRows;
    fused_mlp_block_tc_kernel<D><<<blocks, kTcThreads, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<const __nv_bfloat16*>(w1),
        static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
        static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), rows, hidden, eps);
  } else {
    constexpr size_t bytes = FmaLayout<T, D>::kBytes;
    static bool configured = false;
    if (const int e = orbit::set_smem(fused_mlp_block_kernel<T, D>, bytes, &configured)) return e;
    const int blocks = (rows + kRows - 1) / kRows;
    fused_mlp_block_kernel<T, D><<<blocks, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<const T*>(w1),
        static_cast<const float*>(b1), static_cast<const T*>(w2),
        static_cast<const float*>(b2), static_cast<T*>(out), rows, hidden, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int rows, int D, int hidden,
           float eps, void* stream) {
  if (rows < 1 || hidden < kChunk || hidden % kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {  // the widths of the supported ViTs and of the tests
    case 64: return launch_d<T, 64>(x, ln_g, ln_b, w1, b1, w2, b2, out, rows, hidden, eps, s);
    case 128: return launch_d<T, 128>(x, ln_g, ln_b, w1, b1, w2, b2, out, rows, hidden, eps, s);
    case 384: return launch_d<T, 384>(x, ln_g, ln_b, w1, b1, w2, b2, out, rows, hidden, eps, s);
    case 768: return launch_d<T, 768>(x, ln_g, ln_b, w1, b1, w2, b2, out, rows, hidden, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int orbit_fused_mlp_block_f32(const void* x, const void* ln_g, const void* ln_b,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, void* out, int rows, int D,
                                         int hidden, float eps, void* stream) {
  return launch<float>(x, ln_g, ln_b, w1, b1, w2, b2, out, rows, D, hidden, eps, stream);
}

extern "C" int orbit_fused_mlp_block_bf16(const void* x, const void* ln_g, const void* ln_b,
                                          const void* w1, const void* b1, const void* w2,
                                          const void* b2, void* out, int rows, int D,
                                          int hidden, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, b2, out, rows, D, hidden, eps,
                               stream);
}
