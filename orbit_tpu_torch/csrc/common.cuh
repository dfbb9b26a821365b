// Shared device helpers for the port's kernels: conversions between the
// storage type (float or __nv_bfloat16) and the f32 the kernels compute in,
// the rounding step that copies a JAX ``.astype(x.dtype)``, warp
// reductions, and the tiled FMA matrix products and column sums of the
// backward kernels' routes off the wgmma mainloop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace orbit {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype(bfloat16)
}

// f32 value rounded through T and back: the rounding point of a cast to T
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// V consecutive elements of T at p (aligned to V elements), as floats, in
// one vector load; p may point to global or shared memory
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* o);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* p, float* o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(const __nv_bfloat16* p, float* o) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x; o[1] = v.y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise a kernel's dynamic shared-memory limit once (above 48 KB it must be
// requested); returns a cudaError_t code, 0 on success.
template <typename Kernel>
inline int set_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *configured = true;
  return 0;
}


// ---------------------------------------------------------------------------
// Tiled matrix products for the backward kernels' routes off the wgmma
// mainloop (f32, and bf16 at widths that are not multiples of 128): C (M x
// N) = A (M x K) . B (K x N) with f32 accumulation, every output tile owned
// by one block that walks all of K itself. No atomics and a fixed
// summation order, so two calls give the same bits. The parameter
// gradients, which the TPU kernels accumulate across a sequential grid in
// VMEM, are products over all B*S rows here: K is the row count, and one
// block owns each tile of dW.
//
// An operand is a row-major or column-major view (a transpose is the other
// layout over the same memory) whose elements are read as f32 and rounded
// through R: a product with cast_T(t) of an f32 workspace t reads it with
// R = T. The epilogue functor receives (row, column, f32 sum) and stores.
// The products run as FMA loops on the CUDA cores (true f32: the numeric
// policy keeps TF32 off).
// ---------------------------------------------------------------------------
template <typename S, typename R = float, bool kColMajor = false>
struct Mat {
  static constexpr bool kCol = kColMajor;
  const S* p;
  long long ld;  // element (r, c) is p[r * ld + c], or p[r + c * ld] if kColMajor
  __device__ __forceinline__ float at(long long r, long long c) const {
    return round_to<R>(to_float(kColMajor ? p[r + c * ld] : p[r * ld + c]));
  }
};

// the transpose view: element (r, c) at p[r + c * ld]
template <typename S, typename R = float>
using MatT = Mat<S, R, true>;

constexpr int kGemmThreads = 256;

// ---- 64 x 64 tiles, a 16 x 16 thread grid, 4 x 4 outputs a thread ----
constexpr int kFmaTile = 64;
constexpr int kFmaK = 16;  // K slice per stage

// Stage a tile of A (rows m0.., K columns k0..) through put(m, k, value),
// the operand's contiguous dimension fastest so that neighbouring threads
// read neighbouring addresses; elements outside the matrix are 0.
template <int kRows, int kDepth, class A, class Put>
__device__ __forceinline__ void stage_a(const A& a, int m0, int k0, int M, int K, Put put) {
  for (int e = threadIdx.x; e < kRows * kDepth; e += blockDim.x) {
    const int mm = A::kCol ? e % kRows : e / kDepth;
    const int kk = A::kCol ? e / kRows : e % kDepth;
    const int gm = m0 + mm, gk = k0 + kk;
    put(mm, kk, (gm < M && gk < K) ? a.at(gm, gk) : 0.f);
  }
}

// The same for a tile of B (K rows k0.., columns n0..), put(k, n, value).
template <int kDepth, int kCols, class B, class Put>
__device__ __forceinline__ void stage_b(const B& b, int k0, int n0, int K, int N, Put put) {
  for (int e = threadIdx.x; e < kDepth * kCols; e += blockDim.x) {
    const int kk = B::kCol ? e % kDepth : e / kCols;
    const int nn = B::kCol ? e / kDepth : e % kCols;
    const int gk = k0 + kk, gn = n0 + nn;
    put(kk, nn, (gk < K && gn < N) ? b.at(gk, gn) : 0.f);
  }
}

template <class A, class B, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_fma_kernel(A a, B b, Epi epi, int M, int N, int K) {
  __shared__ __align__(16) float as[kFmaK][kFmaTile + 4];  // [k][m]
  __shared__ __align__(16) float bs[kFmaK][kFmaTile + 4];  // [k][n]
  const int m0 = blockIdx.y * kFmaTile, n0 = blockIdx.x * kFmaTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFmaK) {
    stage_a<kFmaTile, kFmaK>(a, m0, k0, M, K, [&](int m, int k, float v) { as[k][m] = v; });
    stage_b<kFmaK, kFmaTile>(b, k0, n0, K, N, [&](int k, int n, float v) { bs[k][n] = v; });
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) epi(m, n, acc[i][j]);
    }
}

// C = A . B with epilogue epi; returns the launch's error code.
template <class A, class B, class Epi>
inline int gemm(const A& a, const B& b, const Epi& epi, int M, int N, int K,
                cudaStream_t stream) {
  const dim3 grid((N + kFmaTile - 1) / kFmaTile, (M + kFmaTile - 1) / kFmaTile);
  gemm_fma_kernel<<<grid, kGemmThreads, 0, stream>>>(a, b, epi, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Store the f32 sum, rounded to T: C[m, n] at out[m * ld + n].
template <typename T>
struct StoreEpi {
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    out[static_cast<size_t>(m) * ld + n] = from_float<T>(v);
  }
};

// ---------------------------------------------------------------------------
// Column sums over rows, deterministic: blocks of 32 columns x kSumRows rows
// write partial sums (each in a fixed order) to a workspace of
// colsum_chunks(rows) x N floats, and a second pass adds the partials of
// each column in chunk order. val(r, c) gives element (r, c) in f32.
// ---------------------------------------------------------------------------
constexpr int kSumRows = 256;

inline int colsum_chunks(int rows) { return (rows + kSumRows - 1) / kSumRows; }

template <class V>
__global__ void __launch_bounds__(256)
colsum_partial_kernel(V val, float* __restrict__ partial, int rows, int N) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * kSumRows;
  const int r1 = min(rows, r0 + kSumRows);
  float s = 0.f;
  if (c < N)
    for (int r = r0 + threadIdx.y; r < r1; r += 8) s += val(r, c);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.y) * N + c] = t;
  }
}

// The second pass over partial sums, deterministic: out[c] = the sum over
// the chunks i of partial[i * n + c] in a fixed order (thread row y of a
// block adds chunks y, y + 8, ..., then the 8 sums are added in row
// order). One launch takes up to kMaxSums buffers, blockIdx.y choosing one.
struct Partials {
  const float* partial;  // chunks x n
  float* out;
  int chunks, n;
};
constexpr int kMaxSums = 4;
struct PartialsBatch {
  Partials job[kMaxSums];
};

namespace {  // internal linkage: every source that includes this file has its own

__global__ void __launch_bounds__(256) sum_partials_kernel(PartialsBatch batch) {
  __shared__ float red[8][33];
  const Partials p = batch.job[blockIdx.y];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < p.n)
    for (int i = threadIdx.y; i < p.chunks; i += 8)
      s += p.partial[static_cast<size_t>(i) * p.n + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < p.n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
    p.out[c] = t;
  }
}

}  // namespace

// Adds the partials of `count` (<= kMaxSums) buffers in one launch; returns
// the launch's error code.
inline int sum_partials(const Partials* jobs, int count, cudaStream_t stream) {
  if (count < 1 || count > kMaxSums) return static_cast<int>(cudaErrorInvalidValue);
  PartialsBatch batch{};
  int n = 0;
  for (int i = 0; i < count; ++i) {
    batch.job[i] = jobs[i];
    n = jobs[i].n > n ? jobs[i].n : n;
  }
  sum_partials_kernel<<<dim3((n + 31) / 32, count), dim3(32, 8), 0, stream>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

// The first pass alone: partial (colsum_chunks(rows) x N) of val's columns.
template <class V>
inline int colsum_partials(const V& val, float* partial, int rows, int N, cudaStream_t stream) {
  colsum_partial_kernel<<<dim3((N + 31) / 32, colsum_chunks(rows)), dim3(32, 8), 0, stream>>>(
      val, partial, rows, N);
  return static_cast<int>(cudaGetLastError());
}

// out[c] = sum over rows r of val(r, c); returns the launches' error code.
template <class V>
inline int colsum(const V& val, float* partial, float* out, int rows, int N,
                  cudaStream_t stream) {
  if (const int e = colsum_partials(val, partial, rows, N, stream)) return e;
  const Partials job{partial, out, colsum_chunks(rows), N};
  return sum_partials(&job, 1, stream);
}

// Element (r, c) of a row-major matrix with leading dimension ld, as f32.
template <typename S>
struct Column {
  const S* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_float(p[static_cast<size_t>(r) * ld + c]);
  }
};

}  // namespace orbit
