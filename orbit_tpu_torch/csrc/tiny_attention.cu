// Multi-head self-attention on a raw qkv projection, and its backward.
//
// Replaces: orbit_tpu/ops/tiny_attention.py::_attn_kernel (TPU kernel #1,
// via _pallas_attention) and ::_attn_bwd_kernel (#2, via
// _pallas_attention_bwd). For qkv (B,S,3D) in T, columns [q | k | v] with
// heads contiguous inside each:
//   forward:  out (B,S,D) in T, per (batch row, head)
//             out = cast_T(f32(cast_T(softmax_f32(q k^T / sqrt(hd))) @ v));
//   backward: for the cotangent g (B,S,D) in T, dqkv (B,S,3D) in T with
//             attention.cuh's rounding points, each f32 sum rounded once to
//             T as it is written (the TPU kernel writes its block in qkv's
//             dtype), so no f32 workspace and no separate cast pass.
//
// What bounds it on the H100: bytes. At ViT-B/32 (B 256, S 50, D 768) the
// forward reads 59 MB of qkv and writes 20 MB in bf16 against about 2
// GFLOP of products (0.024 ms at 3.35 TB/s, 0.002 ms at 989 TFLOP/s); the
// backward reads qkv and g and writes dqkv, about 138 MB (0.041 ms).
//
// Design: the attention stages of kernel A (attention.cuh), fed from the
// (B,S,3D) tensor instead of the projection. One block of 256 threads per
// (batch row, head) loads its head's q, k, v (and g) into shared memory
// once, 16 bytes a thread where the type allows, and keeps scores, p and
// the products there; each block writes only its own head's columns, so
// two calls give the same bits. bf16 forward: WMMA 16x16x16 tiles on the
// tensor cores, rows >= S zero-filled. f32 forward and both backwards: FMA
// loops on the CUDA cores (true f32). The TPU's 8-row block-diagonal
// stacking, made for the 128x128 MXU, is not carried over, and a ragged
// batch needs no padding. Later work: several heads or rows per block to
// amortise the 256-thread block over S = 50, and the backward on the
// tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "attention.cuh"
#include "common.cuh"

namespace {

using orbit::to_float;
using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::kQkvLd;
using orbit::attn::kScoreLd;
using orbit::attn::kTcLd;
using orbit::attn::kTcTileBytes;
using orbit::attn::kThreads;

// ---- forward, f32 FMA: q, k, v as f32 values at row stride kQkvLd ----
constexpr size_t kSmemBytes = sizeof(float) * (3 * kMaxTokens * kQkvLd + kMaxTokens * kScoreLd);

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiny_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S, int D, int H) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kMaxTokens * kQkvLd;
  float* vs = ks + kMaxTokens * kQkvLd;
  float* sc = vs + kMaxTokens * kQkvLd;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int d3 = 3 * D;
  const T* base = qkv + static_cast<size_t>(b) * S * d3 + h * kHeadDim;
  for (int e = threadIdx.x; e < S * 3 * kHeadDim; e += kThreads) {
    const int r = e / (3 * kHeadDim), part = (e / kHeadDim) % 3, c = e % kHeadDim;
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    dst[r * kQkvLd + c] = to_float(base[static_cast<size_t>(r) * d3 + part * D + c]);
  }
  __syncthreads();
  orbit::attn::attend_fma<T>(qs, ks, vs, sc, out + static_cast<size_t>(b) * S * D + h * kHeadDim,
                             S, D);
}

// ---- forward, bf16 on the tensor cores: 64-row bf16 tiles, rows >= S zero ----
constexpr size_t kTcSmemBytes = 4 * kTcTileBytes  // q, k, v, p
                                + orbit::attn::kTcScoreBytes + orbit::attn::kTcWarpTileBytes;
constexpr int kVec = 8;  // bf16 elements per 16-byte load

__global__ void __launch_bounds__(kThreads)
tiny_attention_tc_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                         int S, int D, int H) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* ks = reinterpret_cast<bf16*>(tc_smem + kTcTileBytes);
  bf16* vs = reinterpret_cast<bf16*>(tc_smem + 2 * kTcTileBytes);
  bf16* ps = reinterpret_cast<bf16*>(tc_smem + 3 * kTcTileBytes);
  float* sc = reinterpret_cast<float*>(tc_smem + 4 * kTcTileBytes);
  float* wtiles = sc + kMaxTokens * orbit::attn::kTcScoreLd;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int d3 = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * S * d3 + h * kHeadDim;
  // every row offset is a multiple of 8 elements (D = H * 64), so each
  // thread moves 16 aligned bytes
  constexpr int kRowVecs = 3 * kHeadDim / kVec;  // 24 per token: q, k, v
  for (int e = threadIdx.x; e < kMaxTokens * kRowVecs; e += kThreads) {
    const int r = e / kRowVecs, part = (e % kRowVecs) / (kHeadDim / kVec);
    const int c = (e % (kHeadDim / kVec)) * kVec;
    bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    const uint4 v = r < S ? *reinterpret_cast<const uint4*>(
                                base + static_cast<size_t>(r) * d3 + part * D + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * kTcLd + c) = v;
  }
  __syncthreads();
  orbit::attn::attend_tc(qs, ks, vs, ps, sc, wtiles,
                         out + static_cast<size_t>(b) * S * D + h * kHeadDim, S, D);
}

// ---- backward: attention.cuh's block, dqkv written in T ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiny_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                          T* __restrict__ dqkv, int S, int D, int H) {
  extern __shared__ float smem[];
  orbit::attn::attention_backward_block<T, T>(qkv, g, dqkv, blockIdx.x / H, blockIdx.x % H,
                                              S, D, smem);
}

bool bad_shape(int B, int S, int D, int H) {
  return B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim;
}

template <typename T>
int launch_forward(const void* qkv, void* out, int B, int S, int D, int H, void* stream) {
  if (bad_shape(B, S, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;  // one flag per instantiation
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (const int e = orbit::set_smem(tiny_attention_tc_kernel, kTcSmemBytes, &configured))
      return e;
    tiny_attention_tc_kernel<<<B * H, kThreads, kTcSmemBytes, s>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), S, D, H);
  } else {
    if (const int e = orbit::set_smem(tiny_attention_kernel<T>, kSmemBytes, &configured))
      return e;
    tiny_attention_kernel<T><<<B * H, kThreads, kSmemBytes, s>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), S, D, H);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* qkv, const void* g, void* dqkv, int B, int S, int D, int H,
                    void* stream) {
  if (bad_shape(B, S, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  constexpr size_t smem = orbit::attn::kBwdSmemBytes;
  if (const int e = orbit::set_smem(tiny_attention_bwd_kernel<T>, smem, &configured)) return e;
  tiny_attention_bwd_kernel<T><<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv), S, D, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B,S,3D) -> out (B,S,D), both in T. Returns cudaGetLastError().
extern "C" int orbit_tiny_attention_f32(const void* qkv, void* out, int B, int S, int D, int H,
                                        void* stream) {
  return launch_forward<float>(qkv, out, B, S, D, H, stream);
}

extern "C" int orbit_tiny_attention_bf16(const void* qkv, void* out, int B, int S, int D,
                                         int H, void* stream) {
  return launch_forward<__nv_bfloat16>(qkv, out, B, S, D, H, stream);
}

// qkv (B,S,3D), g (B,S,D) -> dqkv (B,S,3D), all in T. Returns cudaGetLastError().
extern "C" int orbit_tiny_attention_bwd_f32(const void* qkv, const void* g, void* dqkv, int B,
                                            int S, int D, int H, void* stream) {
  return launch_backward<float>(qkv, g, dqkv, B, S, D, H, stream);
}

extern "C" int orbit_tiny_attention_bwd_bf16(const void* qkv, const void* g, void* dqkv, int B,
                                             int S, int D, int H, void* stream) {
  return launch_backward<__nv_bfloat16>(qkv, g, dqkv, B, S, D, H, stream);
}
