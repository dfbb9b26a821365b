// Shared device helpers for the port's kernels: conversions between the
// storage type (float or __nv_bfloat16) and the f32 the kernels compute in,
// the rounding step that copies a JAX ``.astype(x.dtype)``, and warp
// reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace orbit
