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
// backward reads qkv and g and writes dqkv, about 138 MB (0.041 ms). So
// the design keeps the loads in flight while the tensor cores work, and
// moves every byte in 16-byte pieces.
//
// bf16 forward (tiny_attention_tile_kernel): the row tiles of kernel A.
// A tile packs nseq = floor(128 / S) whole sequences of one head (2 x 50
// rows at 224 px, 25 x 5 at 84 px), no sequence straddles two tiles, and
// tile t holds sequences (t / H) nseq.. of head t % H. Its q, k and v are
// three 64-column boxes of the (B S, 3D) view at columns h 64, D + h 64
// and 2D + h 64, copied by 16-byte cp.async into `rows` = (nseq - 1) S + 64
// rows of 144 bytes each (so the last sequence's 64 key slots stay inside;
// rows past the tile's sequences are zero-filled, not read). Persistent
// blocks walk the tiles in a fixed order (block k: tiles k, k + grid, ...)
// through a ring of two stages: tile n + 1's copies are in flight while the
// block's 8 warps run attention.cuh's attend_strip on tile n, one warp per
// (sequence, 16 query rows), the scores and p in registers. Each output
// row leaves as eight 16-byte stores through the warp's 2 KB staging
// strip. Shared memory: 2 stages x 3 x rows x 144 bytes + 8 x 2 KB: 112 KB
// at S = 50 (two blocks an SM), 171 KB at S = 5 (one).
//
// bf16 backward (tiny_attention_bwd_mma_kernel): #4's attention stage
// (attention.cuh's strips) fed from the raw qkv. An item is one (batch
// row, head): 64-row tiles of q, k, v and g (rows past S zero-filled), 36 KB
// a stage; persistent blocks of 4 warps walk the items b H + h in a fixed
// order through a two-stage cp.async ring, item n + 1's copies in flight
// while item n's products run. Warp w takes query strip 16w (scores, dp,
// softmax, ds, dq) and then key strip 16w (dv, dk). Once every warp is past
// the query side, k and v are dead and cast(p) and cast(ds * scale) take
// their place, so a block needs 72 KB and three blocks share an SM (#4's
// block, which loads synchronously, keeps six tiles). dq, dk and dv leave
// as 16-byte row segments through a staging strip in the dead k tile.
//
// The bf16 entries take the plan (nseq, rows, blocks) from the wrapper
// (orbit_tpu_torch/kernels/plans.py, mirrored there with the emulated
// schedules).
//
// f32 forward and backward: attention.cuh's f32 stages, shared with kernel
// A and #4: true f32 on the CUDA cores (TF32 stays off), one block of 256
// threads per (batch row, head), every 64 x 64 product in 4 x 4 register
// tiles read as float4s from shared memory (three forward or two backward
// blocks an SM). Every output has one writer and no atomics: two calls
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using orbit::attn::cp_async16;
using orbit::attn::cp_async_commit;
using orbit::attn::cp_async_wait;
using orbit::attn::kFTile;
using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::kSLd;
using orbit::attn::kStripBytes;
using orbit::attn::kThreads;  // the f32 kernels' blocks

constexpr int kStages = 2;             // tiles (items) in the ring
constexpr int kRowTile = 128;          // kernel A's row tile
constexpr int kSmemLimit = 232448;     // shared memory one H100 block can use (227 KB)

// ---- f32 on the CUDA cores: attention.cuh's f32 stages ----
__global__ void __launch_bounds__(kThreads, 3)
tiny_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S, int D,
                      int H) {
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;
  float* ks = qs + kFTile;
  float* vs = ks + kFTile;
  float* ps = vs + kFTile;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row0 = static_cast<size_t>(b) * S;
  orbit::attn::load_tiles(qkv, static_cast<const float*>(nullptr), qs, row0, S, D, h, 3);
  orbit::attn::attend_f32(qs, ks, vs, ps, out + row0 * D + h * kHeadDim, S, D);
}

__global__ void __launch_bounds__(kThreads, 2)
tiny_attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                          float* __restrict__ dqkv, int S, int D, int H) {
  extern __shared__ __align__(16) float f32_smem[];
  orbit::attn::attention_backward_block(qkv, g, dqkv, blockIdx.x / H, blockIdx.x % H, S, D,
                                        f32_smem);
}

// ---- forward, bf16 on the tensor cores: packed row tiles, a 2-stage ring ----
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks of a row of one head

constexpr size_t fwd_smem(int rows) {
  return kStages * 3ull * rows * kSLd * sizeof(bf16) + kFwdWarps * kStripBytes;
}
// the most any S needs: rows = 127 + 64 at S = 1
static_assert(fwd_smem(kRowTile - 1 + kMaxTokens) <= kSmemLimit,
              "the forward's ring must fit in one block");

__global__ void __launch_bounds__(kFwdThreads, 2)
tiny_attention_tile_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int B, int S,
                           int D, int H, int nseq, int rows) {
  extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(fwd_smem_raw);
  const size_t stage_elems = 3ull * rows * kSLd;
  unsigned char* strip = fwd_smem_raw + kStages * stage_elems * sizeof(bf16) +
                         (threadIdx.x / 32) * kStripBytes;
  const int tiles = H * ((B + nseq - 1) / nseq);
  const int d3 = 3 * D;
  const int qtiles = (S + 15) / 16;

  // tile t: sequences (t / H) nseq.. of head t % H, into stage s
  auto load = [&](int t, int s) {
    const int h = t % H, seq0 = (t / H) * nseq;
    const int live = min(nseq, B - seq0) * S;
    const bf16* src = qkv + static_cast<size_t>(seq0) * S * d3 + h * kHeadDim;
    bf16* dst = ring + s * stage_elems;
    for (int e = threadIdx.x; e < rows * 3 * kChunks; e += kFwdThreads) {
      const int r = e / (3 * kChunks), part = (e / kChunks) % 3, c = (e % kChunks) * 8;
      const bool on = r < live;
      cp_async16(dst + (part * rows + r) * kSLd + c,
                 on ? src + static_cast<size_t>(r) * d3 + part * D + c : qkv, on);
    }
    cp_async_commit();
  };

  if (static_cast<int>(blockIdx.x) < tiles) load(blockIdx.x, 0);
  int n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    const int s = n % kStages;
    if (t + static_cast<int>(gridDim.x) < tiles) {
      load(t + gridDim.x, (n + 1) % kStages);  // in flight while tile n is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of tile n landed
    const bf16* qs = ring + s * stage_elems;
    const bf16* ks = qs + rows * kSLd;
    const bf16* vs = ks + rows * kSLd;
    const int h = t % H, seq0 = (t / H) * nseq;
    const int units = min(nseq, B - seq0) * qtiles;
    for (int u = threadIdx.x / 32; u < units; u += kFwdWarps) {
      const int q = u / qtiles, q0 = (u % qtiles) * 16;
      float o[8][4];
      orbit::attn::attend_strip(qs, ks, vs, q * S, q0, S, o);
      orbit::attn::store_strip<false, true>(
          o, q0, S, out + static_cast<size_t>(seq0 + q) * S * D + h * kHeadDim, D, nullptr,
          strip);
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }
}

// ---- backward, bf16 on the tensor cores: (row, head) items, a 2-stage ring ----
constexpr int kBwdWarps = kMaxTokens / 16;  // a query strip, then a key strip, each
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kTileElems = kMaxTokens * kSLd;
constexpr size_t kBwdStageElems = 4 * kTileElems;  // q, k, v, g
constexpr size_t kBwdSmem = kStages * kBwdStageElems * sizeof(bf16);  // 72 KB
static_assert(kBwdWarps * kStripBytes <= kTileElems * sizeof(bf16),
              "the warps' staging strips must fit in k's tile");

__global__ void __launch_bounds__(kBwdThreads, 3)
tiny_attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                              bf16* __restrict__ dqkv, int B, int S, int D, int H) {
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(bwd_smem_raw);
  const int items = B * H, d3 = 3 * D;
  const int warp = threadIdx.x / 32;

  // item i = b H + h into stage s: parts 0-2 from qkv, part 3 from g
  auto load = [&](int i, int s) {
    const size_t row0 = static_cast<size_t>(i / H) * S;
    const int col = (i % H) * kHeadDim;
    bf16* dst = ring + s * kBwdStageElems;
    for (int e = threadIdx.x; e < kMaxTokens * 4 * kChunks; e += kBwdThreads) {
      const int r = e / (4 * kChunks), part = (e / kChunks) % 4, c = (e % kChunks) * 8;
      const bool on = r < S;
      const bf16* src = !on ? qkv
                            : part < 3 ? qkv + (row0 + r) * d3 + part * D + col + c
                                       : g + (row0 + r) * D + col + c;
      cp_async16(dst + part * kTileElems + r * kSLd + c, src, on);
    }
    cp_async_commit();
  };

  if (static_cast<int>(blockIdx.x) < items) load(blockIdx.x, 0);
  int n = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
    const int s = n % kStages;
    if (i + static_cast<int>(gridDim.x) < items) {
      load(i + gridDim.x, (n + 1) % kStages);  // in flight while item n is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of item n landed
    bf16* qs = ring + s * kBwdStageElems;
    bf16* ks = qs + kTileElems;
    bf16* vs = ks + kTileElems;
    bf16* gs = vs + kTileElems;
    const int q0 = 16 * warp, k0 = 16 * warp;

    // query side: scores, dp, softmax, ds and dq = cast(ds * scale) . k
    float dq[8][4] = {};
    uint32_t p16[8][2], ds16[8][2];  // cast(p), cast(ds * scale)
    if (q0 < S) {
      float sc[8][4], dp[8][4];
      orbit::attn::scores_dp_strip(qs, ks, vs, gs, q0, sc, dp);
      orbit::attn::softmax_ds_strip(sc, dp, q0, S);
      orbit::attn::pack_strip(sc, p16);
      orbit::attn::pack_strip(dp, ds16);
      orbit::attn::dq_strip(ds16, ks, dq);
    }
    __syncthreads();  // k and v are dead: cast(p) and cast(ds * scale) take their tiles
    bf16* ps = ks;
    bf16* dss = vs;
    if (q0 < S) orbit::attn::store_p_ds(p16, ds16, q0, ps, dss);
    __syncthreads();

    // key side: dv = cast(p)^T . g and dk = cast(ds * scale)^T . q
    float dk[8][4] = {}, dv[8][4] = {};
    if (k0 < S) orbit::attn::dk_dv_strip(ps, dss, gs, qs, k0, S, dk, dv);
    __syncthreads();  // the stage is dead: warp w stages its rows in k's tile

    bf16* out = dqkv + static_cast<size_t>(i / H) * S * d3 + (i % H) * kHeadDim;
    unsigned char* strip = reinterpret_cast<unsigned char*>(ks) + warp * kStripBytes;
    if (q0 < S) orbit::attn::store_strip<false, true>(dq, q0, S, out, d3, nullptr, strip);
    if (k0 < S) {
      orbit::attn::store_strip<false, true>(dk, k0, S, out + D, d3, nullptr, strip);
      orbit::attn::store_strip<false, true>(dv, k0, S, out + 2 * D, d3, nullptr, strip);
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }
}

bool bad_shape(int B, int S, int D, int H) {
  return B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim;
}

// One configuration a kernel: its dynamic shared-memory limit, and the
// largest carveout, so that two forward or three backward blocks share an SM.
template <typename Kernel>
int configure(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  return orbit::set_smem(kernel, bytes, configured);
}

}  // namespace

// qkv (B,S,3D) -> out (B,S,D), in f32. Returns cudaGetLastError().
extern "C" int orbit_tiny_attention_f32(const void* qkv, void* out, int B, int S, int D, int H,
                                        void* stream) {
  if (bad_shape(B, S, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = orbit::attn::kFwdSmemBytes;
  static bool configured = false;
  if (const int e = configure(tiny_attention_kernel, smem, &configured)) return e;
  tiny_attention_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, D, H);
  return static_cast<int>(cudaGetLastError());
}

// The same in bf16, with the caller's plan
// (orbit_tpu_torch/kernels/plans.py::attn_fwd_plan): nseq whole sequences a
// tile, `rows` rows of each of a stage's q, k and v tiles, `blocks`
// persistent blocks. qkv and out 16-byte aligned.
extern "C" int orbit_tiny_attention_bf16(const void* qkv, void* out, int B, int S, int D, int H,
                                         int nseq, int rows, int blocks, void* stream) {
  if (bad_shape(B, S, D, H) || nseq < 1 || nseq * S > kRowTile ||
      rows < (nseq - 1) * S + kMaxTokens || fwd_smem(rows) > kSmemLimit || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (const int e = configure(tiny_attention_tile_kernel, kSmemLimit, &configured)) return e;
  tiny_attention_tile_kernel<<<blocks, kFwdThreads, fwd_smem(rows),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), B, S, D, H, nseq, rows);
  return static_cast<int>(cudaGetLastError());
}

// qkv (B,S,3D), g (B,S,D) -> dqkv (B,S,3D), in f32. Returns cudaGetLastError().
extern "C" int orbit_tiny_attention_bwd_f32(const void* qkv, const void* g, void* dqkv, int B,
                                            int S, int D, int H, void* stream) {
  if (bad_shape(B, S, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = orbit::attn::kBwdSmemBytes;
  static bool configured = false;
  if (const int e = configure(tiny_attention_bwd_kernel, smem, &configured)) return e;
  tiny_attention_bwd_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<float*>(dqkv),
      S, D, H);
  return static_cast<int>(cudaGetLastError());
}

// The same in bf16 with the caller's plan (plans.py::attn_bwd_plan):
// `blocks` persistent blocks. qkv, g and dqkv 16-byte aligned.
extern "C" int orbit_tiny_attention_bwd_bf16(const void* qkv, const void* g, void* dqkv, int B,
                                             int S, int D, int H, int blocks, void* stream) {
  if (bad_shape(B, S, D, H) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (const int e = configure(tiny_attention_bwd_mma_kernel, kBwdSmem, &configured)) return e;
  tiny_attention_bwd_mma_kernel<<<blocks, kBwdThreads, kBwdSmem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv), B, S,
      D, H);
  return static_cast<int>(cudaGetLastError());
}
