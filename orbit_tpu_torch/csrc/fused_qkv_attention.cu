// Fused qkv projection + multi-head self-attention for ViT's short sequences.
//
// Replaces: orbit_tpu/ops/tiny_attention.py::_fused_qkv_kernel (via
// _pallas_qkv_attention). Computes, for x (B,S,D), W (D,3D) in (in, out)
// layout and b (3D,):
//   qkv = cast_T(f32(x @ W) + b)                     (never stored to memory)
//   per (batch row, head): out = cast_T(f32(cast_T(softmax_f32(q k^T / sqrt(hd))) @ v))
// written to out[:, :, h*hd:(h+1)*hd] of a (B,S,D) tensor (pre output proj).
// The rounding points are the TPU kernel's: b arrives already in T, the
// f32 projection plus b is rounded to T, scores and softmax are f32, p is
// rounded to T before the AV product, AV accumulates in f32.
//
// What bounds it on the H100: the projection GEMM, 2*S*D*3D FLOPs per batch
// row (about 45 GFLOP per ViT-B/32 layer at B=256, S=50, 0.048 ms at the
// bf16 peak); attention itself is about 2% of that. Writing qkv to device
// memory and reading it back (118 MB) would cost more than half of that
// bound, so q, k and v stay on chip, as in the TPU kernel.
//
// bf16 (every supported ViT): the projection runs on wgmma.cuh's mainloop
// (TMA-fed shared-memory stages, wgmma with f32 accumulators) over row
// tiles that pack whole sequences, so a block reads each 64-wide slice of
// x and of its head's W once, and only 22% of the rows are padding at
// S = 50 (the WMMA kernel it replaces padded every sequence to 64 rows and
// read W fragments from L2 once per warp); the attention runs on the
// tensor cores (mma.sync) from the tile's q, k and v in shared memory.
// Design at the kernel below.
//
// f32: one thread block per (batch row, head), FMA loops on the CUDA cores
// (true f32, as the f32 path must be), bound by FMA issue and shared-memory
// bandwidth. The block streams x[b] (S x D) and the head's 3*hd columns of
// W over D in KT-wide tiles through shared memory and accumulates q, k and
// v (S x 3*hd, f32 in registers, 4 x 12 per thread, read from shared memory
// as float4s). q, k, v (rounded to T) then stay in shared memory for
// attention.cuh's f32 stage attend_f32 (shared with #1): the scores, the
// softmax and the AV product in 4 x 4 register tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using orbit::round_to;
using orbit::to_float;
using orbit::attn::pack_bf16;
using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::kFLd;
using orbit::attn::kFTile;
using orbit::attn::kSLd;  // bf16 row stride of q, k, v: 144 bytes
using orbit::attn::kThreads;  // 16 x 16 thread grid in the projection

constexpr int kTileK = 32;            // D tile streamed per step
constexpr int kCols = 3 * kHeadDim;   // q | k | v columns of one head
constexpr int kXLd = kTileK + 4;      // float4-aligned rows

constexpr int kQkvFloats = 3 * kFTile;
constexpr int kStageFloats = kMaxTokens * kXLd + kTileK * kCols;
constexpr int kUnionFloats = kStageFloats > kFTile ? kStageFloats : kFTile;
constexpr size_t kSmemBytes = sizeof(float) * (kQkvFloats + kUnionFloats);

constexpr int kRowsPerThread = kMaxTokens / 16;  // 4
constexpr int kColsPerThread = kCols / 16;       // 12: 4 of each of q, k, v

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out,
                           int S, int D, int H) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kMaxTokens][kFLd]
  float* ks = qs + kFTile;
  float* vs = ks + kFTile;
  float* stage = vs + kFTile;
  float* xs = stage;                       // [kMaxTokens][kXLd]   (projection)
  float* ws = stage + kMaxTokens * kXLd;   // [kTileK][kCols]     (projection)
  float* ps = stage;                       // [kMaxTokens][kFLd]    (attention: p)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * D;
  const T* xb = x + static_cast<size_t>(b) * S * D;

  // ---- projection: rows ty*4+i; columns part*64 + tx*4 + v of [q | k | v] ----
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kTileK) {
    for (int e = tid; e < kMaxTokens * kTileK; e += kThreads) {
      const int r = e / kTileK, c = e % kTileK;
      xs[r * kXLd + c] = r < S ? to_float(xb[static_cast<size_t>(r) * D + k0 + c]) : 0.f;
    }
    for (int e = tid; e < kTileK * kCols; e += kThreads) {
      const int r = e / kCols, lc = e % kCols;
      const int part = lc / kHeadDim, c = lc % kHeadDim;
      ws[r * kCols + lc] =
          to_float(w[static_cast<size_t>(k0 + r) * d3 + part * D + h * kHeadDim + c]);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kTileK; kk += 4) {
      float a[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + (ty * kRowsPerThread + i) * kXLd + kk);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[kColsPerThread];
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (kk + q) * kCols + part * kHeadDim + tx * 4);
          bv[part * 4 + 0] = v.x; bv[part * 4 + 1] = v.y;
          bv[part * 4 + 2] = v.z; bv[part * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i][q], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // qkv = cast_T(f32 GEMM + b): the TPU kernel's first rounding point
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int part = j / 4, c = tx * 4 + j % 4;
    const float bj = to_float(bias[part * D + h * kHeadDim + c]);
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      dst[r * kFLd + c] = round_to<T>(acc[i][j] + bj);
    }
  }
  __syncthreads();  // the staging tiles are dead from here: p reuses them
  orbit::attn::attend_f32(qs, ks, vs, ps, out + static_cast<size_t>(b) * S * D + h * kHeadDim,
                          S, D);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper's tensor cores. One block of 288 threads per (row tile,
// head): a row tile packs nseq = floor(128 / S) whole sequences densely
// (2 x 50 = 100 of 128 rows at 224 px, 25 x 5 = 125 at 84 px), as the TPU
// kernel stacks 8 batch rows for its MXU, and no sequence straddles two
// tiles. The projection runs on wgmma.cuh's mainloop: the tile's 128 rows
// of x against the head's 192 columns of W, three 64-column boxes at
// h*64, D + h*64 and 2D + h*64, as one m64n192 product per consumer
// warpgroup. Epilogue: + b (already bf16), rounded to bf16 into shared
// memory (q, k, v of the tile; the pipeline's stages are dead by then and
// the tiles reuse them). Then every warp of the block attends per
// (sequence, 16 query rows) with mma.sync m16n8k16 tiles: the scores for
// all 64 key slots in registers (f32), masked past S, scaled, softmax in
// f32, p rounded to bf16 and fed straight back as the A operand of p v, and
// the output rows < S written to out.
// ---------------------------------------------------------------------------
constexpr int kWgCols = 3 * kHeadDim;                 // 192: [q | k | v] of one head
constexpr int kWgStages = 5;
using WgRing = orbit::wg::Ring<kWgCols, kWgStages>;
constexpr int kQkvRows = orbit::wg::kBM + kMaxTokens;  // a sequence's 64 key slots stay inside
constexpr size_t kQkvBytes = 3ull * kQkvRows * kSLd * sizeof(__nv_bfloat16);
constexpr size_t kWgSmemBytes = WgRing::kSmemBytes;
static_assert(kQkvBytes <= WgRing::kStages * WgRing::kStageBytes,
              "q, k, v must fit in the pipeline's stages");

__global__ void __launch_bounds__(orbit::wg::kThreads, 1)
fused_qkv_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                                 const __grid_constant__ CUtensorMap map_w,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, int B, int S, int D,
                                 int nseq) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = orbit::wg::ring_base(wg_smem);
  const int h = blockIdx.x;
  const int seq0 = blockIdx.y * nseq;            // first sequence of the tile
  const int nseq_here = min(nseq, B - seq0);
  const int row0 = seq0 * S;                     // its first row of x
  const int cols[3] = {h * kHeadDim, D + h * kHeadDim, 2 * D + h * kHeadDim};
  float acc[kWgCols / 2];
  orbit::wg::mainloop<kWgCols, kWgStages>(&map_x, &map_w, row0, cols, D / orbit::wg::kBK,
                                          base, acc);
  __syncthreads();  // every stage consumed: q, k, v reuse them

  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = qs + kQkvRows * kSLd;
  bf16* vs = ks + kQkvRows * kSLd;
  if (threadIdx.x < 256) {
    // qkv = cast_bf16(f32 GEMM + b): the TPU kernel's first rounding point
    orbit::wg::for_each_acc<kWgCols>(acc, [&](int r, int c, float v0, float v1) {
      const int part = c / kHeadDim, cc = c % kHeadDim;
      const bf16* bp = bias + part * D + h * kHeadDim + cc;
      bf16* dst = (part == 0 ? qs : (part == 1 ? ks : vs)) + r * kSLd + cc;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(v0 + to_float(bp[0]), v1 + to_float(bp[1]));
    });
  }
  // the key slots past the tile's last row hold zeros
  for (int e = threadIdx.x; e < 3 * kMaxTokens * kSLd / 2; e += orbit::wg::kThreads) {
    const int part = e / (kMaxTokens * kSLd / 2), i = e % (kMaxTokens * kSLd / 2);
    reinterpret_cast<uint32_t*>(qs + (part * kQkvRows + orbit::wg::kBM) * kSLd)[i] = 0u;
  }
  __syncthreads();

  const int qtiles = (S + 15) / 16;
  for (int u = threadIdx.x / 32; u < nseq_here * qtiles; u += orbit::wg::kThreads / 32) {
    const int q = u / qtiles, q0 = (u % qtiles) * 16;
    orbit::attn::attend_rows(qs, ks, vs, q * S, q0, S,
                             out + static_cast<size_t>(row0 + q * S) * D + h * kHeadDim, D);
  }
}

// nseq: whole sequences per row tile of the bf16 route (the caller's plan,
// floor(128 / S) in orbit_tpu_torch/ops/tiny_attention.py::sequence_tiles)
template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int S, int D,
           int H, int nseq, void* stream) {
  if (B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap map_x, map_w;
    if (!orbit::wg::make_tmap_2d(&map_x, x, B * S, D, D, orbit::wg::kBM) ||
        !orbit::wg::make_tmap_2d(&map_w, w, D, 3 * D, 3 * D, orbit::wg::kBK))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool configured = false;  // one flag per instantiation
    if (const int e =
            orbit::set_smem(fused_qkv_attention_wgmma_kernel, kWgSmemBytes, &configured))
      return e;
    if (nseq < 1 || nseq * S > orbit::wg::kBM) return static_cast<int>(cudaErrorInvalidValue);
    fused_qkv_attention_wgmma_kernel<<<dim3(H, (B + nseq - 1) / nseq), orbit::wg::kThreads,
                                       kWgSmemBytes, s>>>(
        map_x, map_w, static_cast<const T*>(bias), static_cast<T*>(out), B, S, D, nseq);
  } else {
    static bool configured = false;
    if (const int e = orbit::set_smem(fused_qkv_attention_kernel<T>, kSmemBytes, &configured))
      return e;
    fused_qkv_attention_kernel<T><<<B * H, kThreads, kSmemBytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
        static_cast<T*>(out), S, D, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int orbit_fused_qkv_attention_f32(const void* x, const void* w, const void* bias,
                                             void* out, int B, int S, int D, int H,
                                             void* stream) {
  return launch<float>(x, w, bias, out, B, S, D, H, 0, stream);
}

extern "C" int orbit_fused_qkv_attention_bf16(const void* x, const void* w, const void* bias,
                                              void* out, int B, int S, int D, int H, int nseq,
                                              void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, out, B, S, D, H, nseq, stream);
}
