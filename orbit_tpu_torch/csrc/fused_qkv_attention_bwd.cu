// Backward of the fused qkv projection + multi-head attention (kernel A).
//
// Replaces: orbit_tpu/ops/tiny_attention.py::_fused_qkv_bwd_kernel (TPU
// kernel #4, via _pallas_qkv_attention_bwd). For x (B,S,D), W (D,3D), b
// (3D,) in T and the cotangent g (B,S,D) in T of out = attention(cast_T(x @
// W + b)), it computes
//   dx (B,S,D) in T, dW (D,3D) in f32, db (3D,) in f32
// with the TPU kernel's rounding points:
//   qkv  = cast_T(f32(x @ W) + b)                       (recomputed)
//   per (batch row, head), in f32: p = softmax(q k^T / sqrt(hd)),
//   dv = cast_T(p)^T g, dp = g v^T, ds = p * (dp - rowsum(dp * p)),
//   dq = cast_T(ds * scale) k, dk = cast_T(ds * scale)^T q  -> dqkv (f32)
//   dx = cast_T(f32(cast_T(dqkv) @ W^T)),  dW = x^T @ cast_T(dqkv),
//   db = colsum(dqkv)
//
// What bounds it on the H100: operations. At ViT-B/32, B = 256 (12,800 rows,
// D 768) it is about 141 GFLOP: the qkv recompute 45, the attention 5, dx 45
// and dW 45. Compute-bound: about 0.14 ms at 989 TFLOP/s in bf16 and 2.1 ms
// at 67 TFLOP/s in f32; the bytes it must move (x, g, W in, dx, dW out,
// about 70 MB in bf16) take about 0.02 ms at 3.35 TB/s. The TPU kernel keeps
// qkv and dqkv in VMEM per batch block; a simple design spends beyond the
// bound on an f32 dqkv's round trips (118 MB at B = 256, written once and
// read three times), on products off the Hopper tensor-core path and on an
// attention stage in f32 FMA loops.
//
// bf16, D a multiple of 128 (every supported ViT): four launches.
// 1. qkv = cast(x . W + b) on wgmma.cuh's mainloop, 128 x 128 tiles, into
//    a bf16 (B,S,3D) workspace.
// 2. The attention backward, one block of 4 warps per (batch row, head),
//    on the tensor cores (mma.sync m16n8k16; attention.cuh's strips, which
//    #2 shares):
//    q, k, v and g of the head in shared memory (64 rows, zero past S);
//    warp w computes the scores and dp for query rows 16w.. in registers,
//    the softmax, ds and dq = cast(ds * scale) . k, and leaves cast(p) and
//    cast(ds * scale) in shared memory; then, for key rows 16w..,
//    dv = cast(p)^T . g and dk = cast(ds * scale)^T . q read them back
//    through transposing ldmatrix. dq, dk and dv leave as bf16 (the
//    cast_T(dqkv) that dx and dW consume) into a (B,S,3D) workspace, and
//    their f32 column sums over the row's S tokens, the warps added in a
//    fixed order, as one row of a (B, 3D) buffer of db's partials.
// 3. grads.cuh's launch: dW = x^T . cast(dqkv) (both MN-major, K = rows)
//    and dx = cast(cast(dqkv) . W^T) (both K-major), the longer walk first.
// 4. db: the partials added over the batch rows in order.
// No atomics: every output and partial has one writer, so two calls agree
// bit for bit.
//
// f32 (the CLI's default --compute_dtype), D a multiple of 128: three
// launches on sgemm.cuh's f32 mainloop (true f32 FMA on the CUDA cores,
// TF32 off).
// 1. One block of 4 x BM threads per (head, row tile), the tiles of kernel
//    A's f32 route (whole sequences packed into 128 or 160 rows,
//    kernels/plans.py::qkv_bwd_f32_rows): the recompute qkv = x . W + b of
//    the head's 192 columns (4 x 12 sums a thread) into shared memory, as
//    kernel A computes it, and g's head columns beside it; then
//    attention.cuh's attention_backward_packed_f32 with work sized to S
//    (at S = 5 the old per-(batch row, head) block of 64 rows spent 59 of
//    them on padding): dq, dk and dv to an f32 (B,S,3D) workspace, and the
//    tile's column sums as one row of db's partials. qkv never reaches
//    device memory.
// 2. sgemm_grads.cuh's launch: dW = x^T . dqkv (A MN-major, B MN-major,
//    ragged K = B*S, in runs of K doing no more work than a dx block) and
//    dx = dqkv . W^T (A K-major, B K-major), 128 x 128 tiles (dx's 64 rows
//    where they would leave SMs idle), the longer walk first.
// 3. db: the tiles' partials added in tile order; where dW's K ran in
//    runs, one more launch adds them in run order.
// The attention stage's shared memory (q | k | v, g, then p and ds of
// every sequence: 224 KB at 160 rows, S = 50) holds one block an SM.
//
// bf16 at other widths, and f32 at widths that are no multiple of 128: the
// same stages on the CUDA cores: the products as common.cuh's FMA loops,
// the attention backward as attention.cuh's f32 block in 4 x 4 register
// tiles (shared with #2, tiny_attention.cu) writing an f32 dqkv, db as a
// two-pass column sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention.cuh"
#include "common.cuh"
#include "grads.cuh"
#include "sgemm.cuh"
#include "sgemm_grads.cuh"
#include "wgmma.cuh"

namespace {

using orbit::from_float;
using orbit::Mat;
using orbit::MatT;
using orbit::to_float;
using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::pack_bf16;

// ---------------------------------------------------------------------------
// f32, and bf16 off the wgmma route
// ---------------------------------------------------------------------------
// qkv = cast_T(sum + b): the recompute's rounding point
template <typename T>
struct QkvEpi {
  const T* bias;
  T* qkv;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    qkv[static_cast<size_t>(m) * ld + n] = from_float<T>(v + to_float(bias[n]));
  }
};

// one block per (batch row, head), blockIdx.x = b * H + h; dq, dk, dv to
// the f32 workspace dqkv (B,S,3D)
template <typename T>
__global__ void __launch_bounds__(orbit::attn::kThreads)
attention_backward_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                          float* __restrict__ dqkv, int S, int D, int H) {
  extern __shared__ float smem[];
  orbit::attn::attention_backward_block(qkv, g, dqkv, blockIdx.x / H, blockIdx.x % H, S, D,
                                        smem);
}

template <typename T>
int launch_fma(const T* x, const T* w, const T* bias, const T* g, T* qkv, float* dqkv,
               float* partial, T* dx, float* dw, float* db, int B, int S, int D, int H,
               cudaStream_t s) {
  const int rows = B * S, d3 = 3 * D;
  if (const int e = orbit::gemm(Mat<T>{x, D}, Mat<T>{w, d3}, QkvEpi<T>{bias, qkv, d3}, rows, d3,
                                D, s))
    return e;
  static bool configured = false;  // one flag per instantiation
  constexpr size_t smem = orbit::attn::kBwdSmemBytes;
  if (const int e = orbit::set_smem(attention_backward_kernel<T>, smem, &configured)) return e;
  attention_backward_kernel<T><<<B * H, orbit::attn::kThreads, smem, s>>>(qkv, g, dqkv, S, D, H);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const Mat<float, T> dqkv_t{dqkv, d3};
  if (const int e = orbit::gemm(dqkv_t, MatT<T>{w, d3}, orbit::StoreEpi<T>{dx, D}, rows, D, d3,
                                s))
    return e;
  if (const int e = orbit::gemm(MatT<T>{x, D}, dqkv_t, orbit::StoreEpi<float>{dw, d3}, D, d3,
                                rows, s))
    return e;
  return orbit::colsum(orbit::Column<float>{dqkv, d3}, partial, db, rows, d3, s);
}

// ---------------------------------------------------------------------------
// f32 on sgemm.cuh's mainloop, D a multiple of 128
// ---------------------------------------------------------------------------
constexpr int kF32Cols = 3 * kHeadDim;  // 192: [q | k | v] of one head
constexpr int kQkvLd = kF32Cols + 4;    // 196 = 4 (mod 32): k rows on distinct banks
constexpr size_t kMaxSmem = 232448;     // shared memory an H100 block may take

// The shared memory of a tile of BM rows holding nseq sequences of S: the
// mainloop's ring, then q | k | v (BM x 196), g (BM x 64) and p and ds of
// every sequence (2 S sp, sp = S rounded up to 4); mirrored by
// kernels/plans.py::qkv_bwd_f32_smem
template <int BM>
inline size_t f32_bwd_smem(int nseq, int S) {
  const size_t ring = orbit::sg::Tile<BM, kF32Cols, 4 * BM>::kSmemBytes;
  const size_t attn = sizeof(float) * (static_cast<size_t>(BM) * (kQkvLd + kHeadDim) +
                                       2ull * nseq * S * orbit::attn::packed_ld(S));
  return ring > attn ? ring : attn;
}

// One block per (head, row tile of nseq whole sequences).
template <int BM>
__global__ void __launch_bounds__(4 * BM, 1)
qkv_attention_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ bias, const float* __restrict__ g,
                             float* __restrict__ dqkv, float* __restrict__ part, int B, int S,
                             int D, int nseq) {
  constexpr int NT = 4 * BM;
  extern __shared__ __align__(16) float bwd_smem[];
  const int h = blockIdx.x;
  const int seq0 = blockIdx.y * nseq;        // first sequence of the tile
  const int rows = min(nseq, B - seq0) * S;  // its real rows
  const int row0 = seq0 * S;                 // its first row of x
  const int cols[3] = {h * kHeadDim, D + h * kHeadDim, 2 * D + h * kHeadDim};
  orbit::sg::Acc<BM, kF32Cols, NT> acc;
  orbit::sg::mainloop<BM, kF32Cols, NT>(x, D, row0, row0 + rows, w, 3 * D, cols,
                                        D / orbit::sg::kBK, bwd_smem, acc);
  __syncthreads();  // every stage consumed: q, k, v and g reuse them
  // qkv = f32 GEMM + b: the TPU kernel's rounding point (the identity in f32)
  orbit::sg::for_each_acc<BM, kF32Cols, NT>(acc, [&](int r, int c, float4 v) {
    const float4 bv = *reinterpret_cast<const float4*>(
        bias + (c / kHeadDim) * D + h * kHeadDim + c % kHeadDim);
    *reinterpret_cast<float4*>(bwd_smem + r * kQkvLd + c) =
        make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
  });
  float* gs = bwd_smem + BM * kQkvLd;
  for (int e = threadIdx.x; e < rows * (kHeadDim / 4); e += NT) {
    const int r = e / (kHeadDim / 4), c = (e % (kHeadDim / 4)) * 4;
    orbit::attn::cp_async16(gs + r * kHeadDim + c,
                            g + static_cast<size_t>(row0 + r) * D + h * kHeadDim + c, true);
  }
  orbit::attn::cp_async_commit();
  orbit::attn::cp_async_wait<0>();
  __syncthreads();
  orbit::attn::attention_backward_packed_f32(
      bwd_smem, kQkvLd, gs, rows, S, gs + BM * kHeadDim,
      dqkv + static_cast<size_t>(row0) * 3 * D + h * kHeadDim, 3 * D, D, bwd_smem,
      part + static_cast<size_t>(blockIdx.y) * 3 * D + h * kHeadDim);
}

template <int BM>
int launch_attention_f32(const float* x, const float* w, const float* bias, const float* g,
                         float* dqkv, float* part, int B, int S, int D, int H, int nseq,
                         cudaStream_t s) {
  const size_t bytes = f32_bwd_smem<BM>(nseq, S);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // one flag per instantiation
  if (const int e =
          orbit::sg::configure(qkv_attention_bwd_f32_kernel<BM>, kMaxSmem, &configured))
    return e;
  qkv_attention_bwd_f32_kernel<BM><<<dim3(H, (B + nseq - 1) / nseq), 4 * BM, bytes, s>>>(
      x, w, bias, g, dqkv, part, B, S, D, nseq);
  return static_cast<int>(cudaGetLastError());
}

// nseq: whole sequences a row tile, x_rows and wsplit: the grads launch's
// data tile rows and runs of dW's K (the caller's plan), sms the card's
// SMs (the runs' second pass takes 4 blocks an SM); the tile is 128
// rows where they hold its sequences, else 160. partial: db's partials, a
// row a tile, then (wsplit > 1) dW's runs.
int launch_f32_tiled(const float* x, const float* w, const float* bias, const float* g,
                     float* dqkv, float* partial, float* dx, float* dw, float* db, int B, int S,
                     int D, int H, int nseq, int x_rows, int wsplit, int sms, cudaStream_t s) {
  if (nseq < 1 || nseq * S > 160) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (B + nseq - 1) / nseq, rows = B * S, d3 = 3 * D;
  if (const int e = nseq * S <= 128
                        ? launch_attention_f32<128>(x, w, bias, g, dqkv, partial, B, S, D, H,
                                                    nseq, s)
                        : launch_attention_f32<160>(x, w, bias, g, dqkv, partial, B, S, D, H,
                                                    nseq, s))
    return e;
  float* w_part = partial + static_cast<size_t>(row_tiles) * d3;
  orbit::sgrads::Plan<1> plan{};
  plan.wsplit = wsplit;
  plan.w_part = w_part;
  plan.x_rows = x_rows;
  plan.wa[0] = x;
  plan.wb[0] = dqkv;
  plan.w_out[0] = dw;
  plan.w_m[0] = D;
  plan.w_n[0] = d3;
  plan.xa = dqkv;
  plan.xb = w;
  plan.x_out = dx;
  plan.x_n = D;
  plan.x_k = d3;
  plan.rows = rows;
  if (const int e = orbit::sgrads::launch(plan, s)) return e;
  if (wsplit > 1) {
    const orbit::sgrads::Runs runs{w_part, dw, wsplit, D * d3};
    if (const int e = orbit::sgrads::sum_runs(&runs, 1, sms, s)) return e;
  }
  const orbit::Partials job{partial, db, row_tiles, d3};
  return orbit::sum_partials(&job, 1, s);
}

// ---------------------------------------------------------------------------
// bf16 on the wgmma route
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTile = 128;
constexpr int kProjStages = 3;  // two blocks an SM
using ProjRing = orbit::wg::Ring<kTile, kProjStages>;

// 1. qkv = cast_bf16(f32(x . W) + b), one 128 x 128 tile a block
__global__ void __launch_bounds__(orbit::wg::kThreads, 2)
qkv_recompute_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ bias,
                     bf16* __restrict__ qkv, int rows, int d3, int nk) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = orbit::wg::ring_base(wg_smem);
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int cols[2] = {n0, n0 + orbit::wg::kBoxN};
  float acc[kTile / 2];
  orbit::wg::mainloop<kTile, kProjStages>(&map_x, &map_w, m0, cols, nk, base, acc);
  if (threadIdx.x >= 256) return;
  orbit::wg::for_each_acc<kTile>(acc, [&](int r, int c, float v0, float v1) {
    if (m0 + r >= rows) return;
    const size_t o = static_cast<size_t>(m0 + r) * d3 + n0 + c;
    *reinterpret_cast<uint32_t*>(qkv + o) =
        pack_bf16(v0 + to_float(bias[n0 + c]), v1 + to_float(bias[n0 + c + 1]));
  });
}

// 2. the attention backward on the tensor cores (attention.cuh's strips,
// shared with #2)
constexpr int kAttnWarps = kMaxTokens / 16;  // one 16-row strip of queries, then of keys, each
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kLd = orbit::attn::kSLd;  // bf16 row stride: 144 bytes
constexpr int kTileElems = kMaxTokens * kLd;
constexpr int kCols = 3 * kHeadDim;  // dq | dk | dv columns of one head
// q, k, v, g, cast(p), cast(ds * scale) tiles (the column sums' scratch
// reuses v's): 55 KB, four blocks an SM
constexpr size_t kAttnSmem = 6 * kTileElems * sizeof(bf16);
static_assert(kAttnWarps * kCols * sizeof(float) <= kTileElems * sizeof(bf16),
              "the column sums' scratch must fit in v's tile");

__global__ void __launch_bounds__(kAttnThreads, 4)
attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                         bf16* __restrict__ dqkv, float* __restrict__ part, int S, int D,
                         int H) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  bf16* qs = reinterpret_cast<bf16*>(attn_smem);
  bf16* ks = qs + kTileElems;
  bf16* vs = ks + kTileElems;
  bf16* gs = vs + kTileElems;
  bf16* ps = gs + kTileElems;   // cast(p): [query][key]
  bf16* dss = ps + kTileElems;  // cast(ds * scale): [query][key]
  float* red = reinterpret_cast<float*>(vs);  // [warp][kCols], once v is dead
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int d3 = 3 * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int warp = threadIdx.x / 32;

  // q, k, v and g of the head, 16 bytes a thread, rows >= S zero
  for (int e = threadIdx.x; e < kMaxTokens * 4 * (kHeadDim / 8); e += kAttnThreads) {
    const int r = e / (4 * (kHeadDim / 8)), part = (e / (kHeadDim / 8)) % 4;
    const int c = (e % (kHeadDim / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < S)
      v = *reinterpret_cast<const uint4*>(
          part < 3 ? qkv + (row0 + r) * d3 + part * D + h * kHeadDim + c
                   : g + (row0 + r) * D + h * kHeadDim + c);
    *reinterpret_cast<uint4*>(qs + part * kTileElems + r * kLd + c) = v;
  }
  __syncthreads();

  // warp w: the scores and dp of query rows 16w.., the softmax, ds and dq;
  // cast(p) and cast(ds * scale) to shared memory for the key side
  float dq[8][4] = {};
  const int q0 = 16 * warp;
  if (q0 < S) {
    float sc[8][4], dp[8][4];
    uint32_t p16[8][2], ds16[8][2];
    orbit::attn::scores_dp_strip(qs, ks, vs, gs, q0, sc, dp);
    orbit::attn::softmax_ds_strip(sc, dp, q0, S);
    orbit::attn::pack_strip(sc, p16);
    orbit::attn::pack_strip(dp, ds16);
    orbit::attn::store_p_ds(p16, ds16, q0, ps, dss);
    orbit::attn::dq_strip(ds16, ks, dq);
  }
  __syncthreads();  // cast(p) and cast(ds * scale) of every query row

  // dv = cast(p)^T . g and dk = cast(ds * scale)^T . q, key rows 16w..
  float dk[8][4] = {}, dv[8][4] = {};
  const int k0 = 16 * warp;
  if (k0 < S) orbit::attn::dk_dv_strip(ps, dss, gs, qs, k0, S, dk, dv);

  // ---- dq | dk | dv to dqkv (bf16), their column sums to red ----
  bf16* out = dqkv + row0 * d3 + h * kHeadDim;
  orbit::attn::store_strip<true, false>(dq, q0, S, out, d3, red + warp * kCols, nullptr);
  orbit::attn::store_strip<true, false>(dk, k0, S, out + D, d3, red + warp * kCols + kHeadDim,
                                        nullptr);
  orbit::attn::store_strip<true, false>(dv, k0, S, out + 2 * D, d3,
                                        red + warp * kCols + 2 * kHeadDim, nullptr);
  __syncthreads();
  for (int c = threadIdx.x; c < kCols; c += kAttnThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) s += red[w * kCols + c];
    part[static_cast<size_t>(b) * d3 + (c / kHeadDim) * D + h * kHeadDim + c % kHeadDim] = s;
  }
}

int launch_wgmma(const bf16* x, const bf16* w, const bf16* bias, const bf16* g, bf16* qkv,
                 bf16* dqkv, float* partial, bf16* dx, float* dw, float* db, int B, int S,
                 int D, int H, cudaStream_t s) {
  const int rows = B * S, d3 = 3 * D;
  CUtensorMap map_x, map_w;
  if (!orbit::wg::make_tmap_2d(&map_x, x, rows, D, D, orbit::wg::kBM) ||
      !orbit::wg::make_tmap_2d(&map_w, w, D, d3, d3, orbit::wg::kBoxN))
    return static_cast<int>(cudaErrorInvalidValue);
  orbit::grads::Plan<bf16> plan{};
  plan.rows = rows;
  plan.n_weight = 1;
  plan.x_out = dx;
  plan.x_n = D;
  plan.x_k = d3;
  if (!orbit::grads::set_weight(plan, 0, x, D, dqkv, d3, dw))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false, configured_attn = false;
  if (const int e = orbit::set_smem(qkv_recompute_kernel, ProjRing::kSmemBytes, &configured))
    return e;
  if (const int e = orbit::set_smem(attention_bwd_mma_kernel, kAttnSmem, &configured_attn))
    return e;

  qkv_recompute_kernel<<<dim3(d3 / kTile, (rows + kTile - 1) / kTile), orbit::wg::kThreads,
                         ProjRing::kSmemBytes, s>>>(map_x, map_w, bias, qkv, rows, d3,
                                                    D / orbit::wg::kBK);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  attention_bwd_mma_kernel<<<B * H, kAttnThreads, kAttnSmem, s>>>(qkv, g, dqkv, partial, S, D,
                                                                   H);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = orbit::grads::launch(plan, dqkv, w, s)) return e;
  const orbit::Partials job{partial, db, B, d3};
  return orbit::sum_partials(&job, 1, s);
}

template <typename T>
int launch(const void* x_, const void* w_, const void* bias_, const void* g_, void* qkv_,
           void* dqkv_, void* partial, void* dx_, void* dw, void* db, int B, int S, int D,
           int H, int nseq, int x_rows, int wsplit, int sms, void* stream) {
  if (B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  const T* bias = static_cast<const T*>(bias_);
  const T* g = static_cast<const T*>(g_);
  if (D % kTile == 0) {
    if constexpr (std::is_same<T, bf16>::value)
      return launch_wgmma(x, w, bias, g, static_cast<T*>(qkv_), static_cast<T*>(dqkv_),
                          static_cast<float*>(partial), static_cast<T*>(dx_),
                          static_cast<float*>(dw), static_cast<float*>(db), B, S, D, H, s);
    else
      return launch_f32_tiled(x, w, bias, g, static_cast<float*>(dqkv_),
                              static_cast<float*>(partial), static_cast<float*>(dx_),
                              static_cast<float*>(dw), static_cast<float*>(db), B, S, D, H, nseq,
                              x_rows, wsplit, sms, s);
  }
  return launch_fma<T>(x, w, bias, g, static_cast<T*>(qkv_), static_cast<float*>(dqkv_),
                       static_cast<float*>(partial), static_cast<T*>(dx_),
                       static_cast<float*>(dw), static_cast<float*>(db), B, S, D, H, s);
}

}  // namespace

// x, W, b, g in T; workspaces qkv (B,S,3D) in T (unread and may be null on
// the f32 route at D a multiple of 128), dqkv (B,S,3D: bf16 on the bf16
// route for D a multiple of 128, f32 otherwise) and the partial sums of db
// (f32: B x 3D on the bf16 route, row tiles x 3D on the f32 route at D a
// multiple of 128, then wsplit x D x 3D for dW's runs where wsplit > 1,
// ceil(B*S/256) x 3D otherwise); outputs dx (B,S,D) in T, dW (D,3D) and db
// (3D) in f32; the f32 route's plan: nseq whole sequences a row tile
// (kernels/plans.py::qkv_bwd_f32_rows), the grads launch's data tile rows
// x_rows and dW's runs wsplit (plans.py::sgemm_grads_plan), the card's
// SMs. Returns cudaGetLastError() of the launches.
extern "C" int orbit_fused_qkv_attention_bwd_f32(const void* x, const void* w, const void* b,
                                                 const void* g, void* qkv, void* dqkv,
                                                 void* partial, void* dx, void* dw, void* db,
                                                 int B, int S, int D, int H, int nseq,
                                                 int x_rows, int wsplit, int sms,
                                                 void* stream) {
  return launch<float>(x, w, b, g, qkv, dqkv, partial, dx, dw, db, B, S, D, H, nseq, x_rows,
                       wsplit, sms, stream);
}

extern "C" int orbit_fused_qkv_attention_bwd_bf16(const void* x, const void* w, const void* b,
                                                  const void* g, void* qkv, void* dqkv,
                                                  void* partial, void* dx, void* dw, void* db,
                                                  int B, int S, int D, int H, void* stream) {
  return launch<bf16>(x, w, b, g, qkv, dqkv, partial, dx, dw, db, B, S, D, H, 0, 0, 0, 0,
                      stream);
}
