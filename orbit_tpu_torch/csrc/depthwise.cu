// Fused MBConv depthwise tail, stride 1:
//   y = act2(a2 * dwconv_SAME(act1(a1 * x + b1), w) + b2)
//
// Replaces: orbit_tpu/ops/depthwise.py::_dw_kernel (via _pallas_fused_dw).
// x (N, H, W, C) NHWC in T (float or bf16); taps (K*K, C) f32 holding
// values already rounded to T (row di*K + dj); a1, b1, a2, b2 (C,) f32.
// The rounding points are the TPU kernel's: the pre-affine and SiLU in f32,
// rounded to T; the K*K products accumulated in f32; the post-affine and
// SiLU in f32; one cast to T at the store. TF-SAME padding: positions
// outside the image are ZERO AFTER the pre-affine and SiLU (the TPU kernel
// masks them with an iota after its affine), so the halo is zero-filled in
// shared memory after the activation, never before it.
//
// What bounds it on the H100: bytes. Each output needs K*K FMAs (9 or 25)
// against one input read and one output write, about 5-13 FLOP per byte in
// bf16, far below the card's 20 FLOP of f32 FMA rate per byte of
// device memory. The design reads each activation once from device memory
// (plus the halo of a tile, from L2) and writes each output once: the
// activated input never round-trips through device memory.
//
// Design: one block of 256 threads per (image, 8-row x TW-column output
// tile, 64 channels), TW = 16, or 8 for images at most 8 wide. The block
// stages its (8+K-1) x (TW+K-1) x 64 input halo, activated and rounded, in
// shared memory in T (exact: the values are T already), with the slice's
// taps and affines in f32. A thread owns 8 consecutive channels (16-byte
// vector loads and stores in bf16) of TW/4 neighbouring outputs of one row:
// for each tap row it holds that row's K taps in registers and slides a
// window along the TW/4+K-1 inputs it needs, so each input vector is read
// from shared memory once per tap row instead of once per tap (about 3x
// fewer shared-memory reads than one output a thread). C must be a multiple
// of 8 (every EfficientNet width is). Each output sums its K*K products in
// (row, column) order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTile = 8;      // output rows per block
constexpr int kSlice = 64;    // channels per block
constexpr int kVec = 8;       // channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* o);

template <>
__device__ __forceinline__ void load8<float>(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    o[2 * i] = v.x;
    o[2 * i + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v);

template <>
__device__ __forceinline__ void store8<float>(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  unsigned int* words = reinterpret_cast<unsigned int*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned int*>(&pair);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, int K, int TW>
struct Layout {
  static constexpr int kHaloH = kTile + K - 1, kHaloW = TW + K - 1;
  static constexpr size_t kIn = size_t(kHaloH) * kHaloW * kSlice * sizeof(T);
  static constexpr size_t kTaps = size_t(K) * K * kSlice * sizeof(float);
  static constexpr size_t kBytes = kIn + kTaps + 4 * kSlice * sizeof(float);
};

template <typename T, int K, int TW>
__global__ void __launch_bounds__(kThreads)
fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                const float* __restrict__ a1, const float* __restrict__ b1,
                const float* __restrict__ a2, const float* __restrict__ b2,
                T* __restrict__ out, int H, int W, int C, int pad_top, int pad_left,
                int tiles_w, bool act1, bool act2) {
  using L = Layout<T, K, TW>;
  constexpr int kVecs = kSlice / kVec;
  constexpr int kOut = TW / 4;  // outputs a thread computes along its row
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);                          // [kHaloH * kHaloW][kSlice]
  float* s_w = reinterpret_cast<float*>(smem + L::kIn);           // [K * K][kSlice]
  float* s_aff = reinterpret_cast<float*>(smem + L::kIn + L::kTaps);  // [4][kSlice]

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * kSlice;
  const int oy0 = (blockIdx.x / tiles_w) * kTile;
  const int ox0 = (blockIdx.x % tiles_w) * TW;

  for (int i = tid; i < K * K * kSlice; i += kThreads) {
    const int c = c0 + i % kSlice;
    s_w[i] = c < C ? taps[(i / kSlice) * C + c] : 0.0f;
  }
  for (int i = tid; i < 4 * kSlice; i += kThreads) {
    const int c = c0 + i % kSlice;
    const float* src = i < kSlice ? a1 : i < 2 * kSlice ? b1 : i < 3 * kSlice ? a2 : b2;
    s_aff[i] = c < C ? src[c] : 0.0f;
  }
  __syncthreads();

  // stage the halo: pre-affine and SiLU in f32, rounded to T; zero outside
  // the image (after the activation: TF-SAME zero padding)
  const T* xn = x + static_cast<size_t>(n) * H * W * C;
  for (int i = tid; i < L::kHaloH * L::kHaloW * kVecs; i += kThreads) {
    const int p = i / kVecs, v = i % kVecs;
    const int iy = oy0 - pad_top + p / L::kHaloW, ix = ox0 - pad_left + p % L::kHaloW;
    const int c = c0 + v * kVec;
    float vals[kVec];
    if (c < C && iy >= 0 && iy < H && ix >= 0 && ix < W) {
      load8<T>(xn + (static_cast<size_t>(iy) * W + ix) * C + c, vals);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float h = fmaf(vals[j], s_aff[v * kVec + j], s_aff[kSlice + v * kVec + j]);
        if (act1) h = silu(h);
        vals[j] = h;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.0f;
    }
    store8<T>(s_in + p * kSlice + v * kVec, vals);  // the rounding point
  }
  __syncthreads();

  // this thread: channel vector v of outputs x0 .. x0 + kOut - 1 of row r
  const int v = tid % kVecs;
  const int r = (tid / kVecs) % kTile;
  const int x0 = (tid / (kVecs * kTile)) * kOut;
  const int oy = oy0 + r, c = c0 + v * kVec;
  if (oy >= H || c >= C) return;
  float acc[kOut][kVec];
#pragma unroll
  for (int o = 0; o < kOut; ++o)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[o][j] = 0.0f;
#pragma unroll
  for (int di = 0; di < K; ++di) {
    float w[K][kVec];
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
      const float4* src = reinterpret_cast<const float4*>(s_w + (di * K + dj) * kSlice + v * kVec);
      const float4 lo = src[0], hi = src[1];
      w[dj][0] = lo.x; w[dj][1] = lo.y; w[dj][2] = lo.z; w[dj][3] = lo.w;
      w[dj][4] = hi.x; w[dj][5] = hi.y; w[dj][6] = hi.z; w[dj][7] = hi.w;
    }
    const T* row = s_in + ((r + di) * L::kHaloW + x0) * kSlice + v * kVec;
#pragma unroll
    for (int col = 0; col < kOut + K - 1; ++col) {
      float in[kVec];
      load8<T>(row + col * kSlice, in);
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        const int o = col - dj;  // the output this input meets at tap dj
        if (o < 0 || o >= kOut) continue;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[o][j] = fmaf(in[j], w[dj][j], acc[o][j]);
      }
    }
  }
  T* on = out + static_cast<size_t>(n) * H * W * C;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int ox = ox0 + x0 + o;
    if (ox >= W) break;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float y = fmaf(acc[o][j], s_aff[2 * kSlice + v * kVec + j],
                           s_aff[3 * kSlice + v * kVec + j]);
      acc[o][j] = act2 ? silu(y) : y;
    }
    store8<T>(on + (static_cast<size_t>(oy) * W + ox) * C + c, acc[o]);
  }
}

template <typename T, int K, int TW>
int launch_k(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
             const void* b2, void* out, int N, int H, int W, int C, int pad_top,
             int pad_left, int act1, int act2, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, K, TW>::kBytes;
  static bool configured = false;
  if (const int e = orbit::set_smem(fused_dw_kernel<T, K, TW>, bytes, &configured)) return e;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + kTile - 1) / kTile;
  const dim3 grid(tiles_h * tiles_w, (C + kSlice - 1) / kSlice, N);
  fused_dw_kernel<T, K, TW><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const float*>(a2),
      static_cast<const float*>(b2), static_cast<T*>(out), H, W, C, pad_top, pad_left,
      tiles_w, act1 != 0, act2 != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_tw(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
              const void* b2, void* out, int N, int H, int W, int C, int pad_top,
              int pad_left, int act1, int act2, cudaStream_t s) {
  return W <= 8 ? launch_k<T, K, 8>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top,
                                    pad_left, act1, act2, s)
                : launch_k<T, K, 16>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top,
                                     pad_left, act1, act2, s);
}

template <typename T>
int launch(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
           const void* b2, void* out, int N, int H, int W, int C, int K, int pad_top,
           int pad_left, int act1, int act2, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < kVec || C % kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {  // the depthwise kernel sizes of EfficientNet-B0 and V2-S
    case 3:
      return launch_tw<T, 3>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top, pad_left,
                             act1, act2, s);
    case 5:
      return launch_tw<T, 5>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top, pad_left,
                             act1, act2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int orbit_fused_dw_f32(const void* x, const void* taps, const void* a1,
                                  const void* b1, const void* a2, const void* b2, void* out,
                                  int N, int H, int W, int C, int K, int pad_top, int pad_left,
                                  int act1, int act2, void* stream) {
  return launch<float>(x, taps, a1, b1, a2, b2, out, N, H, W, C, K, pad_top, pad_left, act1,
                       act2, stream);
}

extern "C" int orbit_fused_dw_bf16(const void* x, const void* taps, const void* a1,
                                   const void* b1, const void* a2, const void* b2, void* out,
                                   int N, int H, int W, int C, int K, int pad_top, int pad_left,
                                   int act1, int act2, void* stream) {
  return launch<__nv_bfloat16>(x, taps, a1, b1, a2, b2, out, N, H, W, C, K, pad_top, pad_left,
                               act1, act2, stream);
}
