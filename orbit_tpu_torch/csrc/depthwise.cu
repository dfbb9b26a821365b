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
// What bounds it on the H100. Per output element (one channel of one
// pixel): bytes, 2 x sizeof(T) read and written once (0.28 clock of an
// SM's share of 3.35 TB/s in bf16, 0.55 in f32); K*K f32 FMAs (9 or 25:
// 0.07 or 0.20 clock at 128 a clock); the special-function unit: each SiLU
// is one MUFU.EX2 and one MUFU.RCP, so with act1 run once per input and
// act2 once per output, 4 MUFU operations an output, 0.25 clock at 16 a
// clock; and the issue slots, about 30 instructions an output at K = 3 and
// 50 at K = 5 (0.23 and 0.39 clock at 128 a clock). In f32 the bytes bound
// it; in bf16 the MUFU work, the bytes and the issue slots are within 40% of
// each other, and at K = 5 the issue slots come first. So the design runs
// act1 once per input element, with the fewest instructions a SiLU.
//
// Design: a block owns (a group of `images` images, a strip of at most 56
// output columns, a slice of 8-64 channels that divides C; the slices of a
// group and strip are neighbouring blocks) and walks down the image's rows
// in phases of kRows output rows. Its input rows go through shared memory
// twice:
//   - raw: kRows + 2 rows ahead of the compute, 16-byte cp.async copies
//     into a ring of raw rows in T (each thread waits only for its own
//     copies);
//   - activated: the thread that copied a 16-byte chunk applies the
//     pre-affine and SiLU, rounds to T and writes the f32 values into a ring
//     of K + 2 kRows - 1 activated rows (a phase's kRows + K - 1 and the
//     next phase's kRows); positions outside the image (the halo, a ragged
//     image group) are written as zeros there, after the activation.
// One barrier a phase. In a phase each thread computes its outputs from the
// ring's rows and, between the input rows, activates its copies of the next
// phase's rows into the slots of rows no later output reads, so its MUFU
// work interleaves with its FMAs. Each input element is copied from device
// memory and activated once per strip (a strip is the whole row up to 56
// columns: only the 112-wide tail has a 2-column seam), and the vertical
// halo costs K - 1 zero rows per image.
// A thread owns kCh channels of kOut = 7 neighbouring outputs (every width
// of a 224-pixel EfficientNet is a multiple of 7) in each of a phase's
// kRows rows and keeps its K*K taps and the post-affine in registers for
// the whole walk: for each input row it slides a window over the kOut + K -
// 1 inputs it needs, each loaded once from shared memory for all the
// outputs and rows that use it. Each output sums its K*K products in (row,
// column) order. launch_k picks kCh, kRows and the ring column (the
// slice's channels, at least 32: a constant stride, so the window's loads
// take immediate offsets) by shape; the host groups images (the 7 x 7 and
// 14 x 14 tails) until 256 threads or 40 KB of rings.
// MUFU operations an output: 2 (act2) + 2 x the inputs activated per
// output, which is 1 for every tail of a 224-pixel B0 or V2-S but the
// 112-wide one (58/56, and that tail has no act1).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kOut = 7;          // outputs a thread computes along its row
constexpr int kMaxThreads = 256;
constexpr int kStripMax = 56;    // widest strip of output columns
constexpr size_t kGroupSmem = 40 * 1024;  // rings of a block that groups images

// SiLU with two MUFU operations and three FP32 instructions: 2^(-v log2 e)
// and the reciprocal, both approximate with denormals flushed (a flushed
// exponential gives silu(v) = v, a flushed reciprocal 0, both right to f32
// rounding there); about 2 ulp of f32 in all.
__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}

// the rounding point of the activated input: kVec values through T and
// back (bf16 in pairs, on the FP32 pipe rather than the conversion unit)
template <typename T, int kVec>
__device__ __forceinline__ void round_vec(float* v) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < kVec; j += 2) {
      const float2 r = __bfloat1622float2(__floats2bfloat162_rn(v[j], v[j + 1]));
      v[j] = r.x;
      v[j + 1] = r.y;
    }
  }
}

// 16 bytes of T as floats: 4 floats or 8 bf16
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* o);

template <>
__device__ __forceinline__ void load16<float>(const float* p, float* o) {
  orbit::load_vec<float, 4>(p, o);
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float* o) {
  orbit::load_vec<__nv_bfloat16, 4>(p, o);
  orbit::load_vec<__nv_bfloat16, 4>(p + 4, o + 4);
}

// kCh consecutive channels: f32 from the ring, T to the output
template <int kCh>
__device__ __forceinline__ void load_ch(const float* p, float* o) {
  if constexpr (kCh == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

template <typename T, int kCh>
__device__ __forceinline__ void store_ch(T* p, const float* v) {
  if constexpr (kCh == 1) {
    *p = orbit::from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// The launch geometry of a variant with ch channels a thread, ring columns
// of pix elements and rows output rows a phase (mirrored by
// orbit_tpu_torch/kernels/plans.py::dw_plan)
struct Plan {
  int slice;    // channels a block: 64, 48, 32, 16 or 8, the first that divides C
  int strip;    // output columns a block
  int runs;     // runs of kOut outputs covering a strip row
  int images;   // images a block
  int strips, groups, slices, threads;
  size_t smem;
};

// channels a block: the widest of 64, 48, 32, 16, 8 that divides C
inline int slice_of(int C) {
  return C % 64 == 0 ? 64 : C % 48 == 0 ? 48 : C % 32 == 0 ? 32 : C % 16 == 0 ? 16 : 8;
}

// raw input rows in flight ahead of the compute
__host__ __device__ constexpr int depth_of(int rows) { return rows + 2; }

// one image's rings: K + 2 rows - 1 activated f32 rows and depth_of(rows)
// raw rows in T, of runs * kOut + K - 1 columns of pix elements
template <typename T, int K>
constexpr size_t ring_bytes(int runs, int pix, int rows) {
  return size_t(runs * kOut + K - 1) * pix *
         ((K + 2 * rows - 1) * sizeof(float) + depth_of(rows) * sizeof(T));
}

template <typename T, int K>
Plan make_plan(int N, int W, int C, int ch, int pix, int rows) {
  Plan p{};
  p.slice = slice_of(C);
  p.strips = (W + kStripMax - 1) / kStripMax;
  p.strip = (W + p.strips - 1) / p.strips;
  p.runs = (p.strip + kOut - 1) / kOut;
  const int image_threads = p.slice / ch * p.runs;
  const size_t image_bytes = ring_bytes<T, K>(p.runs, pix, rows);
  const long fit = std::min<long>(kMaxThreads / image_threads,
                                  static_cast<long>(kGroupSmem / image_bytes));
  p.images = static_cast<int>(std::max<long>(1, std::min<long>(N, fit)));
  p.groups = (N + p.images - 1) / p.images;
  p.slices = C / p.slice;
  p.threads = image_threads * p.images;
  p.smem = image_bytes * p.images;
  return p;
}

template <typename T, int K, int kCh, int kPix, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
fused_dw_rows_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const float* __restrict__ a1, const float* __restrict__ b1,
                     const float* __restrict__ a2, const float* __restrict__ b2,
                     T* __restrict__ out, int N, int H, int W, int C, int pad_top,
                     int pad_left, Plan p, bool act1, bool act2) {
  constexpr int kVec = 16 / sizeof(T);  // channels a 16-byte copy
  constexpr int kRing = K + 2 * kRows - 1;  // activated rows: a phase's and the next ones
  constexpr int kDepth = depth_of(kRows);
  const int S = p.slice, lanes = S / kCh, vecs = S / kVec;
  const int ring_w = p.runs * kOut + K - 1;   // columns of a ring row
  const int row_elems = p.images * ring_w * kPix;
  const int chunks = p.images * ring_w * vecs;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);                          // [kRing][row_elems]
  T* raw = reinterpret_cast<T*>(smem + sizeof(float) * kRing * row_elems);  // [kDepth][row_elems]

  // the slices of one image group and strip are neighbouring blocks, so
  // the blocks in flight read whole pixels of neighbouring images
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c0 = (blockIdx.x % p.slices) * S;
  const int b = blockIdx.x / p.slices;
  const int n0 = (b / p.strips) * p.images;
  const int x0 = (b % p.strips) * p.strip;
  const int i0 = -pad_top;       // first input row
  const int n_in = H + K - 1;    // input rows walked, the zero rows included

  // this thread's copies: positions q = tid, tid + nthreads, ... of a row;
  // nthreads is a multiple of vecs, so all of them hold the same channel
  // vector. Per copy: its ring offset, and its source offset in x less the
  // row (-1 outside the image or past the last image).
  constexpr int kMaxCopies = (2 * (kOut + K - 1) + kVec - 1) / kVec;
  const int cv = (tid % vecs) * kVec;
  int off[kMaxCopies];
  long long src[kMaxCopies];
#pragma unroll
  for (int k = 0; k < kMaxCopies; ++k) {
    const int q = tid + k * nthreads;
    const int col = (q / vecs) % ring_w, g = q / (vecs * ring_w);
    const int ix = x0 - pad_left + col;
    off[k] = q < chunks ? (g * ring_w + col) * kPix + cv : -1;
    src[k] = q < chunks && n0 + g < N && ix >= 0 && ix < W
                 ? (static_cast<long long>(n0 + g) * H * W + ix) * C + c0 + cv
                 : -1;
  }
  float s1[kVec], t1[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s1[j] = a1[c0 + cv + j];
    t1[j] = b1[c0 + cv + j];
  }
  // raw row t into raw slot t % kDepth; one commit a call, copies or not
  const auto issue = [&](int t) {
    const int iy = i0 + t;
    if (t < n_in && iy >= 0 && iy < H) {
      T* dst = raw + (t % kDepth) * row_elems;
      const long long row = static_cast<long long>(iy) * W * C;
#pragma unroll
      for (int k = 0; k < kMaxCopies; ++k)
        if (src[k] >= 0) __pipeline_memcpy_async(dst + off[k], x + src[k] + row, 16);
    }
    __pipeline_commit();
  };
  // this thread's copy k of raw row t -> ring slot t % kRing: the
  // pre-affine and SiLU in f32, rounded to T; zero outside the image
  const auto activate = [&](int t, int k) {
    if (off[k] < 0) return;
    const int iy = i0 + t;
    float v[kVec];
    if (iy >= 0 && iy < H && src[k] >= 0) {
      load16<T>(raw + (t % kDepth) * row_elems + off[k], v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[j] = fmaf(v[j], s1[j], t1[j]);
        if (act1) v[j] = silu(v[j]);
      }
      round_vec<T, kVec>(v);  // the rounding point
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = 0.0f;
    }
    float* dst = ring + (t % kRing) * row_elems + off[k];
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  };

  // this thread's outputs: channels c .. c + kCh - 1 of outputs run * kOut
  // .. run * kOut + kOut - 1 of the strip, image n0 + g (computed also past
  // the last image, from zeros, and not stored)
  const int lane = tid % lanes, run = (tid / lanes) % p.runs, g = tid / (lanes * p.runs);
  const int c = c0 + kCh * lane, n = n0 + g;
  float w[K * K][kCh], s2[kCh], t2[kCh];
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
#pragma unroll
    for (int i = 0; i < K * K; ++i) w[i][j] = taps[i * C + c + j];
    s2[j] = a2[c + j];
    t2[j] = b2[c + j];
  }
  const int ring_off = (g * ring_w + run * kOut) * kPix + kCh * lane;

  // the first phase's kRows + K - 1 input rows
#pragma unroll
  for (int t = 0; t < kDepth; ++t) issue(t);
  for (int t = 0; t < kRows + K - 1; ++t) {
    __pipeline_wait_prior(kDepth - 1);  // this thread's copies of row t landed
#pragma unroll
    for (int k = 0; k < kMaxCopies; ++k) activate(t, k);
    issue(t + kDepth);
  }
  constexpr int kIn = kRows + K - 1;  // input rows a phase reads
  for (int r = 0; r < H; r += kRows) {
    // rows r .. r + kIn - 1 are visible to every thread, and every thread
    // has finished the previous phase, the last to read rows r - kRows ..
    // r - 1, whose slots this phase's new rows take
    __syncthreads();
    const int t0 = r + kIn;  // the rows activated in this phase, between the tap rows
    __pipeline_wait_prior(kDepth - kRows);
    float acc[kRows][kOut][kCh];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int o = 0; o < kOut; ++o)
#pragma unroll
        for (int j = 0; j < kCh; ++j) acc[rr][o][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      const float* row = ring + ((r + i) % kRing) * row_elems + ring_off;
#pragma unroll
      for (int col = 0; col < kOut + K - 1; ++col) {
        float in[kCh];
        load_ch<kCh>(row + col * kPix, in);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int di = i - rr;  // the tap row this input meets for output row r + rr
          if (di < 0 || di >= K) continue;
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const int o = col - dj;  // the output this input meets at tap dj
            if (o < 0 || o >= kOut) continue;
#pragma unroll
            for (int j = 0; j < kCh; ++j)
              acc[rr][o][j] = fmaf(in[j], w[di * K + dj][j], acc[rr][o][j]);
          }
        }
      }
      // the next phase's rows, activated between the input rows: their
      // MUFU work overlaps this warp's FMAs
#pragma unroll
      for (int u = 0; u < kRows * kMaxCopies; ++u)
        if (u % kIn == i) activate(t0 + u / kMaxCopies, u % kMaxCopies);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) issue(t0 + u + kDepth);
    if (n >= N) continue;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r + rr >= H) break;
      T* orow = out + (static_cast<size_t>(n) * H + r + rr) * W * C + c;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int sx = run * kOut + o, ox = x0 + sx;
        if (sx >= p.strip || ox >= W) break;
        float y[kCh];
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          y[j] = fmaf(acc[rr][o][j], s2[j], t2[j]);
          if (act2) y[j] = silu(y[j]);
        }
        store_ch<T, kCh>(orow + static_cast<size_t>(ox) * C, y);
      }
    }
  }
}

template <typename T, int K, int kCh, int kPix, int kRows>
int launch_ch(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
              const void* b2, void* out, int N, int H, int W, int C, int pad_top,
              int pad_left, int act1, int act2, cudaStream_t stream) {
  // the most any plan asks for: one image of 8 runs, or a group of images
  constexpr size_t kMaxBytes =
      std::max(ring_bytes<T, K>(kStripMax / kOut, kPix, kRows), kGroupSmem);
  const auto kernel = fused_dw_rows_kernel<T, K, kCh, kPix, kRows>;
  static bool configured = false;
  if (const int e = orbit::set_smem(kernel, kMaxBytes, &configured)) return e;
  const Plan p = make_plan<T, K>(N, W, C, kCh, kPix, kRows);
  kernel<<<p.groups * p.strips * p.slices, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const float*>(a2),
      static_cast<const float*>(b2), static_cast<T*>(out), N, H, W, C, pad_top, pad_left, p,
      act1 != 0, act2 != 0);
  return static_cast<int>(cudaGetLastError());
}

// slices of kPix channels (48 or 64)
template <typename T, int K, int kPix>
int launch_pix(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
               const void* b2, void* out, int N, int H, int W, int C, int pad_top,
               int pad_left, int act1, int act2, cudaStream_t s, int runs) {
  if constexpr (K == 5) {
    if (kPix * runs <= kMaxThreads)
      return launch_ch<T, K, 1, kPix, 2>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top,
                                         pad_left, act1, act2, s);
    return launch_ch<T, K, 2, kPix, 2>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top,
                                       pad_left, act1, act2, s);
  }
  return launch_ch<T, K, 2, kPix, 1>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top,
                                     pad_left, act1, act2, s);
}

// The variant by shape (chosen on an H100 over the B0 and V2-S tails):
//   - slices of 32 channels or fewer: 32-element ring columns, one channel
//     and two output rows a thread;
//   - wider slices: ring columns of the slice's 48 or 64 channels (64 for
//     the 48-channel slices read 5% slower a bf16 B0 forward), and
//     - at K = 5 one channel a thread where an image's threads stay within
//       256 (more threads for the FMA-heavy taps), else two, and two output
//       rows a thread (each input column loaded once for both);
//     - at K = 3 two channels and one output row a thread (two rows cost
//       more registers than they save).
template <typename T, int K>
int launch_k(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
             const void* b2, void* out, int N, int H, int W, int C, int pad_top,
             int pad_left, int act1, int act2, cudaStream_t s) {
  const int strips = (W + kStripMax - 1) / kStripMax;
  const int runs = ((W + strips - 1) / strips + kOut - 1) / kOut;
  const int slice = slice_of(C);
  if (slice <= 32)
    return launch_ch<T, K, 1, 32, 2>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top,
                                     pad_left, act1, act2, s);
  if (slice == 48)
    return launch_pix<T, K, 48>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top, pad_left,
                                act1, act2, s, runs);
  return launch_pix<T, K, 64>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top, pad_left,
                              act1, act2, s, runs);
}

template <typename T>
int launch(const void* x, const void* taps, const void* a1, const void* b1, const void* a2,
           const void* b2, void* out, int N, int H, int W, int C, int K, int pad_top,
           int pad_left, int act1, int act2, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 8 || C % 8 ||
      static_cast<long long>(N) * ((W + kStripMax - 1) / kStripMax) * (C / 8) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {  // the depthwise kernel sizes of EfficientNet-B0 and V2-S
    case 3:
      return launch_k<T, 3>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top, pad_left,
                            act1, act2, s);
    case 5:
      return launch_k<T, 5>(x, taps, a1, b1, a2, b2, out, N, H, W, C, pad_top, pad_left,
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
