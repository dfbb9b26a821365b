// Per-head attention stages shared by kernel A (fused qkv projection +
// attention, fused_qkv_attention.cu), its backward (#4,
// fused_qkv_attention_bwd.cu) and the attention on a raw qkv (#1 and #2,
// tiny_attention.cu). Each stage works on one head, S <= 64 tokens of head
// width 64, with the TPU kernels' rounding points
// (orbit_tpu/ops/tiny_attention.py::_head_softmax, _attend_blocked,
// _attend_blocked_bwd):
//   scores = (q k^T) * (1/sqrt(hd)) in f32, p = softmax_f32(scores),
//   out = cast_T(f32(cast_T(p) v));
//   backward, for the cotangent g of out: dv = cast_T(p)^T g, dp = g v^T,
//   ds = p * (dp - rowsum(dp * p)), dq = cast_T(ds * scale) k,
//   dk = cast_T(ds * scale)^T q, all summed in f32.
// The f32 stages (attend_f32 of kernel A and #1, attention_backward_block
// of #4 and #2) run on the CUDA cores in 4 x 4 register tiles, one thread
// block per (batch row, head). The bf16 stages run on the tensor cores
// (mma.sync), one warp per 16-row strip: the forward's attend_strip
// (kernel A's and #1's), and the backward's strips (#4's and #2's); #4's
// backward off the wgmma route (bf16 at widths that are no multiple of
// 128) takes the f32 block. The TPU kernels stack 8 batch rows
// into one block-diagonal operand to fill the 128x128 MXU; here a strip
// attends over its own sequence's 64 key slots, masked past S.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace orbit {
namespace attn {

constexpr int kHeadDim = 64;     // hd of every supported ViT
constexpr int kMaxTokens = 64;   // S <= 64 (50 at 224 px, 5 at 84 px)
constexpr int kThreads = 256;    // 8 warps per block of the f32 stages

// ---------------------------------------------------------------------------
// mma.sync helpers of the tensor-core stages: ldmatrix of four 8 x 8 bf16
// tiles (rows of 16 bytes; lane l gives the address of row l % 8 of tile
// l / 8), plain or transposed, and the m16n8k16 product with f32
// accumulators.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, L2 only); zeros instead when !live (src is not read then).
// The copies a thread issued since its last commit form one group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The f32 stages on the CUDA cores (true f32; TF32 stays off), one block of
// kThreads per (batch row, head): kernel A's and #1's forward, #4's and
// #2's backward. q, k, v and g are 64-row f32 tiles in shared memory, rows
// kFLd floats apart (16 bytes aligned; the 16 rows a float4 read of a
// column block touches fall on distinct banks), rows >= S finite (zero when
// loaded, the bias when kernel A projects them). Every 64 x 64 product runs
// in 4 x 4 register tiles: thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 r and either columns tx + 16 r (the scores) or 4 tx .. 4 tx + 3
// (the outputs), so every shared-memory read is a float4 that 16 lanes
// share or that 16 lanes take from one row. Every sum runs in ascending
// order.
// ---------------------------------------------------------------------------
constexpr int kFLd = kHeadDim + 4;
constexpr int kFTile = kMaxTokens * kFLd;  // floats of a 64-row tile

// q, k, v (parts 0-2 of a qkv (B, S, 3D) in T, columns [q heads | k heads |
// v heads]) and g (part 3, (B, S, D) in T) of batch row row0 / S, head h,
// as f32 into `parts` tiles at dst, 16 bytes a load (cp.async for f32), rows
// >= S zero; returns after a barrier
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ qkv, const T* __restrict__ g,
                                           float* dst, size_t row0, int S, int D, int h,
                                           int parts) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kVecs = kHeadDim / kVec;
  for (int e = threadIdx.x; e < kMaxTokens * parts * kVecs; e += kThreads) {
    const int r = e / (parts * kVecs), part = (e / kVecs) % parts, c = (e % kVecs) * kVec;
    const bool on = r < S;
    const T* src = !on ? qkv
                       : part < 3 ? qkv + (row0 + r) * 3 * D + part * D + h * kHeadDim + c
                                  : g + (row0 + r) * D + h * kHeadDim + c;
    float* to = dst + part * kFTile + r * kFLd + c;
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(to, src, on);
    } else {
      const uint4 v = on ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
      const T* x = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) to[k] = to_float(x[k]);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// c = A B^T at rows ty + 16 ri, columns tx + 16 rj (A, B: 64 rows of hd)
__device__ __forceinline__ void tile_abt(const float* a, const float* b, float (&c)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHeadDim; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kFLd + d);
      bv[i] = *reinterpret_cast<const float4*>(b + (tx + 16 * i) * kFLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// c = P V at rows ty + 16 ri, columns 4 tx..; the sum over P's first n
// columns (a multiple of 4; P's columns past S are zero)
__device__ __forceinline__ void tile_pv(const float* p, const float* v, int n,
                                        float (&c)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  for (int j = 0; j < n; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kFLd + j);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 vv = *reinterpret_cast<const float4*>(v + (j + k) * kFLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = component(pv[i], k);
        c[i][0] = fmaf(pk, vv.x, c[i][0]);
        c[i][1] = fmaf(pk, vv.y, c[i][1]);
        c[i][2] = fmaf(pk, vv.z, c[i][2]);
        c[i][3] = fmaf(pk, vv.w, c[i][3]);
      }
    }
  }
}

// c = P^T V at rows ty + 16 ri (columns of P), columns 4 tx..; the sum
// over P's first n rows
__device__ __forceinline__ void tile_ptv(const float* p, const float* v, int n,
                                         float (&c)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  for (int r = 0; r < n; ++r) {
    const float4 vv = *reinterpret_cast<const float4*>(v + r * kFLd + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pr = p[r * kFLd + ty + 16 * i];
      c[i][0] = fmaf(pr, vv.x, c[i][0]);
      c[i][1] = fmaf(pr, vv.y, c[i][1]);
      c[i][2] = fmaf(pr, vv.z, c[i][2]);
      c[i][3] = fmaf(pr, vv.w, c[i][3]);
    }
  }
}

// row r of a 64-column tile is spread over the 16 lanes of a half warp
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// In place: the scores tile -> p = softmax_f32(s * scale) over the S real
// key columns (0 past S)
__device__ __forceinline__ void softmax_tile(float (&s)[4][4], int S) {
  const int tx = threadIdx.x % 16;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = tx + 16 * j < S ? s[i][j] * scale : -INFINITY;
      m = fmaxf(m, s[i][j]);
    }
    m = half_warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = expf(s[i][j] - m);
      sum += s[i][j];
    }
    sum = half_warp_sum(sum);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] / sum;
  }
}

// the tile's rows ty + 16 ri at columns tx + 16 rj of a [row][column]
// tile, each value rounded to T
template <typename T>
__device__ __forceinline__ void put_tile(const float (&c)[4][4], float* t) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[(ty + 16 * i) * kFLd + tx + 16 * j] = round_to<T>(c[i][j]);
}

// rows ty + 16 ri < S of an output tile, 16 bytes a row, at out (row 0;
// rows ld apart)
__device__ __forceinline__ void store_rows(const float (&c)[4][4], int S,
                                           float* __restrict__ out, size_t ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (ty + 16 * i < S)
      *reinterpret_cast<float4*>(out + (ty + 16 * i) * ld + 4 * tx) =
          make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
}

// The f32 forward of one (batch row, head): q, k, v tiles, the p tile's
// scratch ps; ob points at out[b, 0, h*hd] of a (B, S, D) output. Ends
// without a barrier.
constexpr size_t kFwdSmemBytes = 4 * kFTile * sizeof(float);  // q, k, v, p: 68 KB

__device__ __forceinline__ void attend_f32(const float* qs, const float* ks, const float* vs,
                                           float* ps, float* __restrict__ ob, int S, int D) {
  float c[4][4];
  tile_abt(qs, ks, c);  // the scores, scaled after the dot
  softmax_tile(c, S);
  put_tile<float>(c, ps);
  __syncthreads();
  tile_pv(ps, vs, (S + 3) & ~3, c);
  store_rows(c, S, ob, D);
}

// ---------------------------------------------------------------------------
// The f32 backward of one (batch row b, head h) on the CUDA cores: q, k, v
// from a qkv (B, S, 3D) in T, g (B, S, D) in T; dq, dk, dv written in f32
// to the head's columns of dqkv (B, S, 3D) (#2's output, #4's workspace).
// smem holds kBwdSmemBytes.
// ---------------------------------------------------------------------------
constexpr size_t kBwdSmemBytes = 6 * kFTile * sizeof(float);  // q, k, v, g, p, ds: 102 KB

template <typename T>
__device__ void attention_backward_block(const T* __restrict__ qkv, const T* __restrict__ g,
                                         float* __restrict__ dqkv, int b, int h, int S, int D,
                                         float* smem) {
  float* qs = smem;
  float* ks = qs + kFTile;
  float* vs = ks + kFTile;
  float* gs = vs + kFTile;
  float* ps = gs + kFTile;   // cast_T(p): [query][key]
  float* dss = ps + kFTile;  // cast_T(ds * scale): [query][key]
  const size_t row0 = static_cast<size_t>(b) * S;
  load_tiles(qkv, g, qs, row0, S, D, h, 4);

  // scores (scaled after the dot) and dp = g v^T; p, then
  // ds * scale = p (dp - rowsum(dp p)) scale
  float sc[4][4], dp[4][4];
  tile_abt(qs, ks, sc);
  tile_abt(gs, vs, dp);
  softmax_tile(sc, S);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) t += dp[i][j] * sc[i][j];
    t = half_warp_sum(t);
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[i][j] = sc[i][j] * (dp[i][j] - t) * scale;
  }
  put_tile<T>(sc, ps);
  put_tile<T>(dp, dss);
  __syncthreads();

  // dq = ds k, dk = ds^T q, dv = p^T g (query rows < S; ds is 0 past S
  // in the key columns)
  float* out = dqkv + row0 * 3 * D + h * kHeadDim;
  float c[4][4];
  tile_pv(dss, ks, (S + 3) & ~3, c);
  store_rows(c, S, out, 3 * D);
  tile_ptv(dss, qs, S, c);
  store_rows(c, S, out + D, 3 * D);
  tile_ptv(ps, gs, S, c);
  store_rows(c, S, out + 2 * D, 3 * D);
}

// ---------------------------------------------------------------------------
// The tensor-core stages (bf16, mma.sync m16n8k16, f32 sums) of kernel A's
// forward, #4's backward and #1's and #2's bf16 routes. Their operands are
// bf16 tiles in shared memory, rows kSLd elements (144 bytes) apart, so the
// eight rows an ldmatrix reads fall on distinct banks. A strip is the 16
// rows of a warp, held as mma.sync C fragments float c[8][4]: fragment t
// covers columns 8t.., and lane l holds row l / 4 (c[t][0], c[t][1]) and
// row l / 4 + 8 (c[t][2], c[t][3]), columns 8t + 2 (l % 4) + {0, 1}.
// ---------------------------------------------------------------------------
constexpr int kSLd = kHeadDim + 8;

// The forward of one warp: query rows q0..q0+15 of the sequence whose S
// rows start at row r0 of the q, k, v tiles, against its 64 key slots
// r0..r0+63: the scores in registers (f32), masked past S, scaled, the
// softmax in f32, p rounded to bf16 and fed straight back as the A operand
// of p v; o = f32(cast_bf16(p) v). Rows and key slots past S read finite
// values (the next sequence, or zeros) and are masked or not stored.
__device__ __forceinline__ void attend_strip(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                             const __nv_bfloat16* vs, int r0, int q0, int S,
                                             float (&o)[8][4]) {
  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  // ---- scores = q k^T: 16 rows x 64 key slots (8 tiles of 8), f32 ----
  float sc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 16) {
    uint32_t a[4];
    ldsm_x4(qs + (r0 + q0 + (lane % 8) + 8 * ((lane / 8) % 2)) * kSLd + kk + 8 * (lane / 16), a);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // key slots 16 np .. 16 np + 15
      uint32_t b[4];
      ldsm_x4(ks + (r0 + 16 * np + (lane % 8) + 8 * (lane / 16)) * kSLd + kk +
                  8 * ((lane / 8) % 2),
              b);
      mma_16816(sc[2 * np], a, b[0], b[1]);
      mma_16816(sc[2 * np + 1], a, b[2], b[3]);
    }
  }
  // ---- softmax (f32) over the S real keys, scaled after the dot ----
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * t + c2 + (e % 2);
      sc[t][e] = j < S ? sc[t][e] * scale : -INFINITY;
      m[e / 2] = fmaxf(m[e / 2], sc[t][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[t][e] = expf(sc[t][e] - m[e / 2]);  // 0 past S
      sum[e / 2] += sc[t][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  // ---- o = f32(cast_bf16(p) v): p is the A operand as it lies ----
#pragma unroll
  for (int t = 0; t < 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
  for (int ks16 = 0; ks16 < 4; ++ks16) {  // key slots 16 ks16 .. + 15
    const uint32_t a[4] = {
        pack_bf16(sc[2 * ks16][0] / sum[0], sc[2 * ks16][1] / sum[0]),
        pack_bf16(sc[2 * ks16][2] / sum[1], sc[2 * ks16][3] / sum[1]),
        pack_bf16(sc[2 * ks16 + 1][0] / sum[0], sc[2 * ks16 + 1][1] / sum[0]),
        pack_bf16(sc[2 * ks16 + 1][2] / sum[1], sc[2 * ks16 + 1][3] / sum[1])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {  // head columns 16 dp .. 16 dp + 15
      uint32_t b[4];
      ldsm_x4_t(vs + (r0 + 16 * ks16 + (lane % 8) + 8 * ((lane / 8) % 2)) * kSLd + 16 * dp +
                    8 * (lane / 16),
                b);
      mma_16816(o[2 * dp], a, b[0], b[1]);
      mma_16816(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// ---- the backward's strips, on one (batch row, head) in 64-row tiles ----
// q, k, v and g of the head (rows >= S zero), cast(p) and cast(ds * scale)
// as [query][key] tiles; query strip q0 = 16 w and key strip k0 = 16 w of
// warp w.

// The scores and dp of query rows q0..q0+15 against the 64 key slots:
// sc = q k^T and dp = g v^T, f32, unscaled.
__device__ __forceinline__ void scores_dp_strip(const __nv_bfloat16* qs,
                                                const __nv_bfloat16* ks,
                                                const __nv_bfloat16* vs,
                                                const __nv_bfloat16* gs, int q0,
                                                float (&sc)[8][4], float (&dp)[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = dp[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 16) {
    uint32_t aq[4], ag[4];
    const int arow = (q0 + (lane % 8) + 8 * ((lane / 8) % 2)) * kSLd + kk + 8 * (lane / 16);
    ldsm_x4(qs + arow, aq);
    ldsm_x4(gs + arow, ag);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // key slots 16 np .. 16 np + 15
      const int brow = (16 * np + (lane % 8) + 8 * (lane / 16)) * kSLd + kk + 8 * ((lane / 8) % 2);
      uint32_t bk[4], bv[4];
      ldsm_x4(ks + brow, bk);
      ldsm_x4(vs + brow, bv);
      mma_16816(sc[2 * np], aq, bk[0], bk[1]);
      mma_16816(sc[2 * np + 1], aq, bk[2], bk[3]);
      mma_16816(dp[2 * np], ag, bv[0], bv[1]);
      mma_16816(dp[2 * np + 1], ag, bv[2], bv[3]);
    }
  }
}

// In place: sc -> p = softmax_f32(sc * scale) over the S real key slots,
// dp -> ds * scale = p (dp - rowsum(dp p)) scale; both zero in the rows
// q0 + i >= S, so those rows add nothing to dv and dk.
__device__ __forceinline__ void softmax_ds_strip(float (&sc)[8][4], float (&dp)[8][4], int q0,
                                                 int S) {
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4, c2 = 2 * (lane % 4);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * t + c2 + (e % 2);
      sc[t][e] = j < S ? sc[t][e] * scale : -INFINITY;
      m[e / 2] = fmaxf(m[e / 2], sc[t][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[t][e] = expf(sc[t][e] - m[e / 2]);  // 0 past S
      sum[e / 2] += sc[t][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  // ---- p = e / sum; rowsum(dp * p); ds = p (dp - rowsum) * scale ----
  float tr[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[t][e] = sc[t][e] / sum[e / 2];
      tr[e / 2] += dp[t][e] * sc[t][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tr[i] += __shfl_xor_sync(0xffffffffu, tr[i], 1);
    tr[i] += __shfl_xor_sync(0xffffffffu, tr[i], 2);
  }
  const bool live[2] = {q0 + g4 < S, q0 + g4 + 8 < S};
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = live[e / 2];
      dp[t][e] = on ? sc[t][e] * (dp[t][e] - tr[e / 2]) * scale : 0.f;  // ds * scale
      sc[t][e] = on ? sc[t][e] : 0.f;
    }
}

// A strip rounded to bf16, as pairs: pk[t][half] holds row lane / 4 + 8 half,
// columns 8t + 2 (lane % 4) + {0, 1} (mma.sync's A-operand pairs too)
__device__ __forceinline__ void pack_strip(const float (&c)[8][4], uint32_t (&pk)[8][2]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      pk[t][half] = pack_bf16(c[t][2 * half], c[t][2 * half + 1]);
}

// cast(p) and cast(ds * scale) of the strip's rows into their tiles
__device__ __forceinline__ void store_p_ds(const uint32_t (&p)[8][2], const uint32_t (&ds)[8][2],
                                           int q0, __nv_bfloat16* ps, __nv_bfloat16* dss) {
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = (q0 + g4 + 8 * half) * kSLd + 8 * t + c2;
      *reinterpret_cast<uint32_t*>(ps + o) = p[t][half];
      *reinterpret_cast<uint32_t*>(dss + o) = ds[t][half];
    }
}

// dq += cast(ds * scale) . k: ds (packed) is the A operand as it lies
__device__ __forceinline__ void dq_strip(const uint32_t (&ds)[8][2], const __nv_bfloat16* ks,
                                         float (&dq)[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {  // key slots 16 k16 .. + 15
    const uint32_t a[4] = {ds[2 * k16][0], ds[2 * k16][1], ds[2 * k16 + 1][0],
                           ds[2 * k16 + 1][1]};
#pragma unroll
    for (int n16 = 0; n16 < 4; ++n16) {  // head columns 16 n16 .. + 15
      uint32_t bk[4];
      ldsm_x4_t(ks + (16 * k16 + (lane % 8) + 8 * ((lane / 8) % 2)) * kSLd + 16 * n16 +
                    8 * (lane / 16),
                bk);
      mma_16816(dq[2 * n16], a, bk[0], bk[1]);
      mma_16816(dq[2 * n16 + 1], a, bk[2], bk[3]);
    }
  }
}

// dv += cast(p)^T . g and dk += cast(ds * scale)^T . q for key rows
// k0..k0+15, over the query strips below S (the only rows of p and ds
// written)
__device__ __forceinline__ void dk_dv_strip(const __nv_bfloat16* ps, const __nv_bfloat16* dss,
                                            const __nv_bfloat16* gs, const __nv_bfloat16* qs,
                                            int k0, int S, float (&dk)[8][4],
                                            float (&dv)[8][4]) {
  const int lane = threadIdx.x % 32;
  for (int kq = 0; kq < (S + 15) / 16; ++kq) {  // query rows 16 kq .. + 15
    // A = the transpose of a 16 x 16 block of p (ds): ldmatrix.trans of
    // its stored [query][key] rows
    const int arow = (16 * kq + (lane % 8) + 8 * (lane / 16)) * kSLd + k0 + 8 * ((lane / 8) % 2);
    uint32_t ap[4], ads[4];
    ldsm_x4_t(ps + arow, ap);
    ldsm_x4_t(dss + arow, ads);
#pragma unroll
    for (int n16 = 0; n16 < 4; ++n16) {
      const int brow =
          (16 * kq + (lane % 8) + 8 * ((lane / 8) % 2)) * kSLd + 16 * n16 + 8 * (lane / 16);
      uint32_t bg[4], bq[4];
      ldsm_x4_t(gs + brow, bg);
      ldsm_x4_t(qs + brow, bq);
      mma_16816(dv[2 * n16], ap, bg[0], bg[1]);
      mma_16816(dv[2 * n16 + 1], ap, bg[2], bg[3]);
      mma_16816(dk[2 * n16], ads, bq[0], bq[1]);
      mma_16816(dk[2 * n16 + 1], ads, bq[2], bq[3]);
    }
  }
}

// A warp's staging strip for 16-byte row stores: 16 rows x 64 bf16 of 128
// bytes, the 16-byte chunk j of row r at chunk j ^ (r % 8), so the
// fragments' 4-byte writes (rows lane / 4) and the rows' 16-byte reads
// (eight lanes a row) fall on distinct banks.
constexpr int kStripBytes = 16 * kHeadDim * 2;

// Stores the rows q0 + i < S of a strip, rounded to bf16, at out (row 0,
// the strip's first column; rows ld apart). kWide: through the warp's
// staging strip (kStripBytes at `strip`, 16-byte aligned), each row's 128
// bytes as eight 16-byte stores; else 4 bytes a lane from the fragments.
// kColSums: also the strip's f32 column sums over those rows at
// red[8t + 2 (lane % 4) + {0, 1}] (#4's partial sums of db).
template <bool kColSums, bool kWide>
__device__ __forceinline__ void store_strip(const float (&c)[8][4], int q0, int S,
                                            __nv_bfloat16* __restrict__ out, size_t ld,
                                            float* red, unsigned char* strip) {
  const int lane = threadIdx.x % 32;
  const int r = q0 + lane / 4, c2 = 2 * (lane % 4);
  const bool live0 = r < S, live1 = r + 8 < S;
  if constexpr (kWide) {
    const int g = lane / 4;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      unsigned char* row = strip + g * 128 + ((t ^ g) * 16) + 2 * c2;
      *reinterpret_cast<uint32_t*>(row) = pack_bf16(c[t][0], c[t][1]);
      *reinterpret_cast<uint32_t*>(row + 8 * 128) = pack_bf16(c[t][2], c[t][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 32 * i + lane, row = e / 8, j = e % 8;
      if (q0 + row < S)
        *reinterpret_cast<uint4*>(out + (q0 + row) * ld + 8 * j) =
            *reinterpret_cast<const uint4*>(strip + row * 128 + ((j ^ (row % 8)) * 16));
    }
    __syncwarp();  // the strip may take the next rows
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if constexpr (!kWide) {
      if (live0)
        *reinterpret_cast<uint32_t*>(out + r * ld + 8 * t + c2) = pack_bf16(c[t][0], c[t][1]);
      if (live1)
        *reinterpret_cast<uint32_t*>(out + (r + 8) * ld + 8 * t + c2) =
            pack_bf16(c[t][2], c[t][3]);
    }
    if constexpr (kColSums) {
      float s0 = (live0 ? c[t][0] : 0.f) + (live1 ? c[t][2] : 0.f);
      float s1 = (live0 ? c[t][1] : 0.f) + (live1 ? c[t][3] : 0.f);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // the strip's 16 rows, in a fixed order
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        red[8 * t + c2] = s0;
        red[8 * t + c2 + 1] = s1;
      }
    }
  }
}

// Kernel A's stage: attend_strip, and the output rows < S written to ob
// (out[first row of the sequence, h*hd]; rows D apart), 4 bytes a lane.
__device__ __forceinline__ void attend_rows(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                            const __nv_bfloat16* vs, int r0, int q0, int S,
                                            __nv_bfloat16* __restrict__ ob, int D) {
  float o[8][4];
  attend_strip(qs, ks, vs, r0, q0, S, o);
  store_strip<false, false>(o, q0, S, ob, D, nullptr, nullptr);
}

}  // namespace attn
}  // namespace orbit
