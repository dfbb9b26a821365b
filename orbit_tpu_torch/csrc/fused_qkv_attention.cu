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
// f32 (the CLI's default --compute_dtype): the same packed row tiles, on
// sgemm.cuh's mainloop (true f32 FMA on the CUDA cores, TF32 off). A block
// of 4 x BM threads projects its tile's BM rows against the head's 192
// columns of W (4 x 12 sums a thread, x and W staged through a 3-stage
// cp.async ring), so W's head slice is read once a row tile, not once a
// sequence. The tile holds 128 rows (25 sequences at S = 5, 125 real) or
// 160 (3 sequences at S = 50, 150 real; 128 rows hold 2, 100 real), the
// caller's plan (kernels/plans.py::qkv_f32_rows: the one whose launch, one
// block an SM, ends first). The epilogue adds b and leaves q | k | v of the
// tile in shared memory (BM x 196 f32; they never reach device memory);
// then attention.cuh's attend_packed_f32 gives each warp 4 query rows of
// one sequence at a time, with work sized to S (a lane a key for the
// scores, S steps of p v), not to 64 key slots. Bound by FMA issue in the
// projection (2 * BM * 768 * 192 FLOPs a block at D 768; the tile's padded
// rows, which the bound of real rows does not count, 6% of them at S = 50).
// One block an SM: registers (102 a thread at 640 threads) and the
// q | k | v tile (125 KB at 160 rows) hold it there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "attention.cuh"
#include "common.cuh"
#include "sgemm.cuh"
#include "wgmma.cuh"

namespace {

using orbit::to_float;
using orbit::attn::pack_bf16;
using orbit::attn::kHeadDim;
using orbit::attn::kMaxTokens;
using orbit::attn::kSLd;  // bf16 row stride of q, k, v: 144 bytes

// ---- f32 on the CUDA cores (sgemm.cuh): the projection, then the packed
// attention stage ----
constexpr int kF32Cols = 3 * kHeadDim;        // 192: [q | k | v] of one head
constexpr int kQkvLd = kF32Cols + 4;          // 196 = 4 (mod 32): k rows on distinct banks

// A tile of BM rows: BM * 4 threads, a 4 x 12 sum tile each (16 or 20
// warps, one block an SM; registers cap a thread at 102 at BM = 160)
template <int BM>
struct F32Plan {
  static constexpr int kThreads = 4 * BM;
  using Tile = orbit::sg::Tile<BM, kF32Cols, kThreads>;
  // q | k | v of the tile, then the attention's p scratch of every warp
  static constexpr size_t kQkvBytes =
      sizeof(float) * (BM * kQkvLd + kThreads / 32 * orbit::attn::kPackedScratch);
  static constexpr size_t kSmemBytes =
      Tile::kSmemBytes > kQkvBytes ? Tile::kSmemBytes : kQkvBytes;
};

// One block per (head, row tile); the tile packs nseq whole sequences.
template <int BM>
__global__ void __launch_bounds__(F32Plan<BM>::kThreads, 1)
fused_qkv_attention_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                               const float* __restrict__ bias, float* __restrict__ out, int B,
                               int S, int D, int nseq) {
  constexpr int NT = F32Plan<BM>::kThreads;
  extern __shared__ __align__(16) float f32_smem[];
  const int h = blockIdx.x;
  const int seq0 = blockIdx.y * nseq;            // first sequence of the tile
  const int rows = min(nseq, B - seq0) * S;      // its real rows
  const int row0 = seq0 * S;                     // its first row of x
  const int cols[3] = {h * kHeadDim, D + h * kHeadDim, 2 * D + h * kHeadDim};
  orbit::sg::Acc<BM, kF32Cols, NT> acc;
  orbit::sg::mainloop<BM, kF32Cols, NT>(x, D, row0, row0 + rows, w, 3 * D, cols,
                                        D / orbit::sg::kBK, f32_smem, acc);
  __syncthreads();  // every stage consumed: q, k, v reuse them
  // qkv = f32 GEMM + b: the TPU kernel's first rounding point (the identity in f32)
  orbit::sg::for_each_acc<BM, kF32Cols, NT>(acc, [&](int r, int c, float4 v) {
    const float4 bv = *reinterpret_cast<const float4*>(
        bias + (c / kHeadDim) * D + h * kHeadDim + c % kHeadDim);
    *reinterpret_cast<float4*>(f32_smem + r * kQkvLd + c) =
        make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
  });
  __syncthreads();
  orbit::attn::attend_packed_f32(f32_smem, kQkvLd, rows, S, f32_smem + BM * kQkvLd,
                                 out + static_cast<size_t>(row0) * D + h * kHeadDim, D);
}

template <int BM>
int launch_f32(const float* x, const float* w, const float* bias, float* out, int B, int S,
               int D, int H, int nseq, cudaStream_t stream) {
  constexpr size_t bytes = F32Plan<BM>::kSmemBytes;
  static bool configured = false;  // one flag per instantiation
  if (const int e =
          orbit::sg::configure(fused_qkv_attention_f32_kernel<BM>, bytes, &configured))
    return e;
  fused_qkv_attention_f32_kernel<BM><<<dim3(H, (B + nseq - 1) / nseq), F32Plan<BM>::kThreads,
                                       bytes, stream>>>(x, w, bias, out, B, S, D, nseq);
  return static_cast<int>(cudaGetLastError());
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

// nseq: whole sequences per row tile, at most `rows` rows (the caller's
// plan: bf16 floor(128 / S), orbit_tpu_torch/ops/tiny_attention.py::
// sequence_tiles; f32 floor(128 or 160 / S), kernels/plans.py::qkv_f32_rows)
int bad_shape(int B, int S, int D, int H, int nseq, int rows) {
  return B < 1 || S < 1 || S > kMaxTokens || H < 1 || D != H * kHeadDim || nseq < 1 ||
         nseq * S > rows;
}

}  // namespace

extern "C" int orbit_fused_qkv_attention_f32(const void* x, const void* w, const void* bias,
                                             void* out, int B, int S, int D, int H, int nseq,
                                             void* stream) {
  if (bad_shape(B, S, D, H, nseq, 160)) return static_cast<int>(cudaErrorInvalidValue);
  const auto xf = static_cast<const float*>(x), wf = static_cast<const float*>(w),
             bf = static_cast<const float*>(bias);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nseq * S <= 128)  // the smaller tile that holds the plan's sequences
    return launch_f32<128>(xf, wf, bf, static_cast<float*>(out), B, S, D, H, nseq, s);
  return launch_f32<160>(xf, wf, bf, static_cast<float*>(out), B, S, D, H, nseq, s);
}

extern "C" int orbit_fused_qkv_attention_bf16(const void* x, const void* w, const void* bias,
                                              void* out, int B, int S, int D, int H, int nseq,
                                              void* stream) {
  using bf16 = __nv_bfloat16;
  if (bad_shape(B, S, D, H, nseq, orbit::wg::kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!orbit::wg::make_tmap_2d(&map_x, x, B * S, D, D, orbit::wg::kBM) ||
      !orbit::wg::make_tmap_2d(&map_w, w, D, 3 * D, 3 * D, orbit::wg::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (const int e =
          orbit::set_smem(fused_qkv_attention_wgmma_kernel, kWgSmemBytes, &configured))
    return e;
  fused_qkv_attention_wgmma_kernel<<<dim3(H, (B + nseq - 1) / nseq), orbit::wg::kThreads,
                                     kWgSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, S, D, nseq);
  return static_cast<int>(cudaGetLastError());
}
