// Shared device helpers for the port's kernels: conversions between the
// storage type (float or __nv_bfloat16) and the f32 the kernels compute in,
// the rounding step that copies a JAX ``.astype(x.dtype)``, warp
// reductions, and the tiled matrix products and column sums of the
// backward kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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
// Tiled matrix products for the backward kernels: C (M x N) = A (M x K) .
// B (K x N) with f32 accumulation, every output tile owned by one block
// that walks all of K itself. No atomics and a fixed summation order, so
// two calls give the same bits. The parameter gradients, which the TPU
// kernels accumulate across a sequential grid in VMEM, are products over
// all B*S rows here: K is the row count, and one block owns each tile of
// dW.
//
// An operand is a row-major or column-major view (a transpose is the other
// layout over the same memory) whose elements are read as f32 and rounded
// through R: a product with cast_T(t) of an f32 workspace t reads it with
// R = T. The epilogue functor receives (row, column, f32 sum) and stores.
// In f32 the products run as FMA loops on the CUDA cores (true f32: the
// numeric policy keeps TF32 off). In bf16, where every operand holds bf16
// values, they run as WMMA 16x16x16 tiles on the tensor cores: 128 x 128
// output tiles, each of 8 warps owning 64 x 32, the operands staged through
// shared memory 8 elements (16 bytes) at a time along their contiguous
// dimension, with the next K slice loaded into registers while the tensor
// cores work on the current one.
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

// ---- f32: 64 x 64 tiles, a 16 x 16 thread grid, 4 x 4 outputs a thread ----
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

// ---- bf16: 128 x 128 tiles on the tensor cores ----
constexpr int kTcTileM = 128, kTcTileN = 128, kTcTileK = 32;
constexpr int kTcVec = 8;  // elements staged per 16-byte vector
// shared-memory leading dimensions (bf16 elements) of the staged tiles:
// along K when K is contiguous, along the 128-wide side otherwise; rows stay
// 32-byte aligned, as WMMA's loads need
constexpr int kTcLdK = kTcTileK + 8, kTcLdMN = kTcTileM + 8;
constexpr int kTcStage = kTcTileM * kTcLdK > kTcTileK * kTcLdMN ? kTcTileM * kTcLdK
                                                                 : kTcTileK * kTcLdMN;

// 8 consecutive elements at p as 8 bf16 (one uint4): a 16-byte load of
// bf16 storage, or two float4 loads of f32 storage rounded to bf16 (the
// rounding point of cast_T for an f32 workspace read with R = bf16)
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
  o[0] = __floats2bfloat162_rn(lo.x, lo.y);
  o[1] = __floats2bfloat162_rn(lo.z, lo.w);
  o[2] = __floats2bfloat162_rn(hi.x, hi.y);
  o[3] = __floats2bfloat162_rn(hi.z, hi.w);
  return out;
}

// The operand tile of a 128 x 32 (or 32 x 128) slice as 512 vectors of 8
// along its contiguous dimension, two a thread: vector v of this thread
// covers (outer, inner..inner+7); vectors outside the matrix are zero. For
// A (M x K) outer/inner are (m, k) row-major and (k, m) column-major; for
// B (K x N) (k, n) row-major and (n, k) column-major.
template <int kInner, class Op>
__device__ __forceinline__ void load_tile(const Op& op, int outer0, int inner0, int outer_n,
                                          int inner_n, uint4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kGemmThreads;
    const int o = v / (kInner / kTcVec), in = (v % (kInner / kTcVec)) * kTcVec;
    const int go = outer0 + o, gi = inner0 + in;
    r[i] = (go < outer_n && gi < inner_n)
               ? load8_bf16(op.p + static_cast<long long>(go) * op.ld + gi)
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int kInner>
__device__ __forceinline__ void store_tile(__nv_bfloat16* smem, int ld, const uint4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kGemmThreads;
    const int o = v / (kInner / kTcVec), in = (v % (kInner / kTcVec)) * kTcVec;
    *reinterpret_cast<uint4*>(smem + o * ld + in) = r[i];
  }
}

template <class A, class B>
__device__ __forceinline__ void load_slices(const A& a, const B& b, int m0, int n0, int k0,
                                            int M, int N, int K, uint4 (&ra)[2],
                                            uint4 (&rb)[2]) {
  if constexpr (A::kCol) load_tile<kTcTileM>(a, k0, m0, K, M, ra);
  else load_tile<kTcTileK>(a, m0, k0, M, K, ra);
  if constexpr (B::kCol) load_tile<kTcTileK>(b, n0, k0, N, K, rb);
  else load_tile<kTcTileN>(b, k0, n0, K, N, rb);
}

template <class A, class B, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_wmma_kernel(A a, B b, Epi epi, int M, int N, int K) {
  using namespace nvcuda;
  using LayoutA = typename std::conditional<A::kCol, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<B::kCol, wmma::col_major, wmma::row_major>::type;
  constexpr int kLdA = A::kCol ? kTcLdMN : kTcLdK;
  constexpr int kLdB = B::kCol ? kTcLdK : kTcLdMN;
  __shared__ __align__(32) __nv_bfloat16 as[kTcStage];
  __shared__ __align__(32) __nv_bfloat16 bs[kTcStage];
  __shared__ __align__(32) float tiles[kGemmThreads / 32][256];
  const int m0 = blockIdx.y * kTcTileM, n0 = blockIdx.x * kTcTileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // this warp's 64 x 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  load_slices(a, b, m0, n0, 0, M, N, K, ra, rb);
  for (int k0 = 0; k0 < K; k0 += kTcTileK) {
    if constexpr (A::kCol) store_tile<kTcTileM>(as, kLdA, ra);
    else store_tile<kTcTileK>(as, kLdA, ra);
    if constexpr (B::kCol) store_tile<kTcTileK>(bs, kLdB, rb);
    else store_tile<kTcTileN>(bs, kLdB, rb);
    __syncthreads();
    if (k0 + kTcTileK < K)  // the next slice, in flight under the products
      load_slices(a, b, m0, n0, k0 + kTcTileK, M, N, K, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kTcTileK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + j * 16;
        wmma::load_matrix_sync(fb[j], bs + (B::kCol ? n * kLdB + kk : kk * kLdB + n), kLdB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + i * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> fa;
        wmma::load_matrix_sync(fa, as + (A::kCol ? kk * kLdA + m : m * kLdA + kk), kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  // each fragment leaves through the warp's f32 tile
  float* tile = tiles[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(tile, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm + i * 16 + e / 16, n = n0 + wn + j * 16 + e % 16;
        if (m < M && n < N) epi(m, n, tile[e]);
      }
      __syncwarp();
    }
}

// The contiguous extent of an operand (K or M for A, K or N for B) and its
// leading dimension must be multiples of kTcVec, and its pointer 16-byte
// aligned, for the tensor-core path's vector loads.
template <class Op>
inline bool vector_ready(const Op& op, int contiguous_extent) {
  return contiguous_extent % kTcVec == 0 && op.ld % kTcVec == 0 &&
         reinterpret_cast<size_t>(op.p) % 16 == 0;
}

// C = A . B with epilogue epi, on the tensor cores when T is bf16 (every
// operand must then hold bf16 values); returns the launch's error code.
template <typename T, class A, class B, class Epi>
inline int gemm(const A& a, const B& b, const Epi& epi, int M, int N, int K,
                cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!vector_ready(a, A::kCol ? M : K) || !vector_ready(b, B::kCol ? K : N))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kTcTileN - 1) / kTcTileN, (M + kTcTileM - 1) / kTcTileM);
    gemm_wmma_kernel<<<grid, kGemmThreads, 0, stream>>>(a, b, epi, M, N, K);
  } else {
    const dim3 grid((N + kFmaTile - 1) / kFmaTile, (M + kFmaTile - 1) / kFmaTile);
    gemm_fma_kernel<<<grid, kGemmThreads, 0, stream>>>(a, b, epi, M, N, K);
  }
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

namespace {  // internal linkage: every source that includes this file has its own

__global__ void __launch_bounds__(256)
colsum_final_kernel(const float* __restrict__ partial, float* __restrict__ out, int chunks,
                    int N) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= N) return;
  float s = 0.f;
  for (int i = 0; i < chunks; ++i) s += partial[static_cast<size_t>(i) * N + c];
  out[c] = s;
}

}  // namespace

// out[c] = sum over rows r of val(r, c); returns the launches' error code.
template <class V>
inline int colsum(const V& val, float* partial, float* out, int rows, int N,
                  cudaStream_t stream) {
  const int chunks = colsum_chunks(rows);
  colsum_partial_kernel<<<dim3((N + 31) / 32, chunks), dim3(32, 8), 0, stream>>>(
      val, partial, rows, N);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  colsum_final_kernel<<<(N + 255) / 256, 256, 0, stream>>>(partial, out, chunks, N);
  return static_cast<int>(cudaGetLastError());
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
