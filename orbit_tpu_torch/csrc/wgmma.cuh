// The Hopper GEMM mainloop shared by the bf16 routes of kernel A
// (fused_qkv_attention.cu), kernel B (mlp_block.cu) and their backward
// kernels #4 (fused_qkv_attention_bwd.cu) and #6 (mlp_block_bwd.cu): a
// block computes a 128 x BN tile of C = A . B, bf16 operands in device
// memory, with f32 sums in registers.
//
// Shape of a block (288 threads): warpgroups 0 and 1 are the consumers,
// warp 8 the producer. One producer thread keeps a ring of kStages
// shared-memory stages filled by TMA (cp.async.bulk.tensor, 128-byte
// swizzle), each stage 64 K-slices of A (16 KB) and BN/64 boxes of B (8 KB
// each), reporting completion to a "full" mbarrier per stage. Each consumer
// warpgroup owns 64 rows of the tile and issues wgmma.mma_async m64nBNk16
// (bf16 in, f32 accumulate) on every stage that has landed, keeps one
// stage's products in flight, and frees the stage before it on an "empty"
// mbarrier. The caller applies its epilogue to the accumulators
// (for_each_acc hands a functor each pair of neighbouring columns with its
// row and column). With a small ring two blocks share an SM, and one
// block's epilogue overlaps the other's products.
//
// Operand layouts (Major), each a row-major bf16 matrix in device memory:
//   A K-major:  A itself, (M x K), K contiguous: one 128-row x 64 box a stage;
//   A MN-major: A^T stored, (K x M), M contiguous: two 64 x 64 boxes a stage,
//               one per consumer warpgroup (dW = x^T . dy reads x so);
//   B MN-major: B itself, (K x N), N contiguous: the weights in their
//               (in, out) layout, no transposed copy;
//   B K-major:  B^T stored, (N x K), K contiguous (y . W^T reads W so).
// An MN-major operand goes through wgmma's transpose bit. In shared memory
// a K-major operand is rows of 128 bytes (64 K values), 8-row groups 1024
// bytes apart, and a product of 16 K values starts 32 bytes on; an
// MN-major one is 64-wide MN atoms (kBBoxBytes apart), each 64 K rows of
// 128 bytes, and 16 K values start 2048 bytes on. The boxes' positions are
// the caller's: consecutive tiles for a plain product, or the q, k and v
// columns of one head for kernel A.
//
// Deterministic: every output tile is owned by one block, which walks its
// K range itself in a fixed order; no atomics. A block may run several
// products through one ring (run(), the ring's position carried in `it`).
//
// Host side: make_tmap_2d encodes a TMA descriptor with libcuda's
// cuTensorMapEncodeTiled, whose address the CUDA runtime hands out
// (cudaGetDriverEntryPoint), so the library does not link libcuda. Descriptors are encoded on the host for
// every call and passed to the kernel as __grid_constant__ parameters. Rows
// and columns past a matrix's edge read as zeros (TMA fills the part of a
// box outside the tensor): ragged M, N and K need no masking of the sums,
// and the caller's epilogue drops the rows and columns past the output.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace orbit {
namespace wg {

constexpr int kConsumerWarps = 8;  // two consumer warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kBM = 128;           // rows of a tile: 64 per consumer warpgroup
constexpr int kBK = 64;            // K per stage: one 128-byte swizzle row of bf16
constexpr int kBoxN = 64;          // columns of one B box
constexpr int kABytes = kBM * kBK * 2;       // 16 KB
constexpr int kBBoxBytes = kBK * kBoxN * 2;  // 8 KB

enum class Major { K, MN };

template <int BN, int kStageCount>
struct Ring {
  static_assert(BN == 128 || BN == 192, "tiles of 128 (B, #4, #6) or 192 (A) columns");
  static constexpr int kStageBytes = kABytes + (BN / kBoxN) * kBBoxBytes;
  static constexpr int kStages = kStageCount;
  // 1 KB of slack: the stages are aligned to 1024 bytes (the swizzle's period)
  static constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// ---- host: TMA descriptors ----

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A descriptor of a row-major bf16 matrix (rows x cols, leading dimension
// ld elements) read in boxes of box_rows x 64 columns, 128-byte swizzled.
// Returns false if the encoding is refused (alignment, strides).
inline bool make_tmap_2d(CUtensorMap* map, const void* p, int rows, int cols, int ld,
                         int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: barriers, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// box (col, row) of the tensor behind map into shared memory at dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) += A (64 x 16) . B (16 x N), bf16 in. The trailing
// immediates: scale-a 1, scale-b 1, transpose-a TA, transpose-b TB (0: the
// operand is K-major in shared memory, 1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n192k16(float (&d)[96], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, Major kA, Major kB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  constexpr int ta = kA == Major::MN, tb = kB == Major::MN;
  if constexpr (BN == 128) mma_m64n128k16<ta, tb>(d, da, db);
  else mma_m64n192k16<ta, tb>(d, da, db);
}

// ---- the mainloop ----

// Shared memory of a block: kStages stages of [A box | B boxes], each
// aligned to 1024 bytes, then the full and empty barriers. Returns the
// aligned base; the caller may reuse the stages after the mainloop.
__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// Initialises the ring's barriers; every thread of the block calls it
// once, before the first run().
template <int BN, int kStageCount>
__device__ __forceinline__ void ring_init(unsigned char* base) {
  using R = Ring<BN, kStageCount>;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + R::kStages * R::kStageBytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[R::kStages + s], kConsumerWarps);  // the empty barriers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One product of a tile through the ring: acc = sum over k < nk of the
// stage pairs (A, B), 64 K values a stage, starting at K = 64 k0. Every
// thread of the block calls it; the consumers (threads below 256) return
// with their accumulators (row r of the tile for consumer warpgroup w is
// 64 w + r), the producer warp with acc untouched. a_off: the tile's first
// row of A (K-major) or first column of A^T (MN-major); b_off[j]: the
// first column (MN-major) or row (K-major) of B's box j. `it` counts the
// stages the ring has passed through, in every thread alike; the function
// ends with every stage of this product consumed and freed and no copy in
// flight, but without a block-wide barrier, so the next run() may follow
// at once.
template <int BN, int kStageCount, Major kA, Major kB>
__device__ __forceinline__ void run(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                    int a_off, const int (&b_off)[BN / kBoxN], int k0, int nk,
                                    unsigned char* base, float (&acc)[BN / 2], uint32_t& it) {
  using R = Ring<BN, kStageCount>;
  constexpr int kStages = R::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * R::kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const uint32_t it0 = it;
  it += nk;

  if (wgi == 2) {
    if (tid == 2 * 128) {  // producer: one thread issues every copy
      for (int k = 0; k < nk; ++k) {
        const uint32_t i = it0 + k;
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        unsigned char* st = base + s * R::kStageBytes;
        const int kc = (k0 + k) * kBK;  // first K value of the stage
        mbar_expect_tx(&full[s], R::kStageBytes);
        if constexpr (kA == Major::K) {
          tma_load(st, map_a, &full[s], kc, a_off);
        } else {
          tma_load(st, map_a, &full[s], a_off, kc);
          tma_load(st + kBBoxBytes, map_a, &full[s], a_off + kBoxN, kc);
        }
#pragma unroll
        for (int j = 0; j < BN / kBoxN; ++j) {
          unsigned char* dst = st + kABytes + j * kBBoxBytes;
          if constexpr (kB == Major::MN) tma_load(dst, map_b, &full[s], b_off[j], kc);
          else tma_load(dst, map_b, &full[s], kc, b_off[j]);
        }
      }
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const int lane = tid % 32;
  // A K-major: 8-row groups 1024 bytes apart, 16 K values = 32 bytes on;
  // A MN-major: this warpgroup's 64-column box, 8 K-row groups 1024 bytes
  // apart, 16 K rows = 2048 bytes on; B MN-major: 64-column boxes
  // kBBoxBytes apart, the same K steps; B K-major: BN rows of 128 bytes,
  // 8-row groups 1024 bytes apart, 16 K values = 32 bytes on
  constexpr uint32_t kStepA = kA == Major::K ? 32 : 2048;
  constexpr uint32_t kStepB = kB == Major::K ? 32 : 2048;
  constexpr uint32_t kLboA = kA == Major::K ? 16 : kBBoxBytes;
  constexpr uint32_t kLboB = kB == Major::K ? 16 : kBBoxBytes;
  for (int k = 0; k < nk; ++k) {
    const uint32_t i = it0 + k;
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* st = base + s * R::kStageBytes;
    const unsigned char* a = st + wgi * 64 * kBK * 2;  // this warpgroup's 64 rows
    const unsigned char* b = st + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma<BN, kA, kB>(acc, desc(a + kk * kStepA, kLboA, 1024),
                      desc(b + kk * kStepB, kLboB, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_acc(acc);
    if (k > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (nk > 0 && lane == 0) mbar_arrive(&empty[(it0 + nk - 1) % kStages]);
}

// The whole mainloop of one tile, A K-major and B MN-major (kernels A and
// B): the ring initialised, then one run() over K = 64 nk.
template <int BN, int kStageCount>
__device__ __forceinline__ void mainloop(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                         int a_row, const int (&b_col)[BN / kBoxN], int nk,
                                         unsigned char* base, float (&acc)[BN / 2]) {
  ring_init<BN, kStageCount>(base);
  uint32_t it = 0;
  run<BN, kStageCount, Major::K, Major::MN>(map_a, map_b, a_row, b_col, 0, nk, base, acc, it);
}

// Hands fn(row, col, v0, v1) every pair of neighbouring accumulators of a
// consumer thread: row within the tile (0..127), col (even) within the
// BN columns. wgmma's m64nN layout: warp w of the warpgroup holds rows
// 16w..16w+15; in each 8-column slice j, d[4j], d[4j+1] are row lane/4,
// columns 8j + 2 (lane % 4) + {0, 1}, and d[4j+2], d[4j+3] the row 8 below.
template <int BN, class Fn>
__device__ __forceinline__ void for_each_acc(const float (&acc)[BN / 2], Fn fn) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    fn(r0, c, acc[4 * j], acc[4 * j + 1]);
    fn(r0 + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace wg
}  // namespace orbit
