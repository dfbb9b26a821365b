// A plain product on wgmma.cuh's mainloop, for each operand layout and
// tile width the kernels instantiate, so that chip_smoke.py and the card's
// tests can hold every (A major, B major, BN) against torch.matmul on a
// ragged shape before a kernel relies on it. No op calls it.
//   C (M x N, f32) = A . B, A stored (M x K) if K-major or (K x M) if
//   MN-major, B stored (K x N) if MN-major or (N x K) if K-major, all bf16
//   row-major; M, N and K need not be multiples of the tiles (the ragged
//   edges read as TMA's zeros and are not stored), N even, K and the
//   MN-major extents multiples of 8 (TMA's 16-byte strides).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using orbit::wg::Major;
constexpr int kStages = 4;

template <int BN, Major kA, Major kB>
__global__ void __launch_bounds__(orbit::wg::kThreads, 1)
wgmma_check_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, float* __restrict__ c, int M,
                   int N, int nk) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base = orbit::wg::ring_base(wg_smem);
  const int m0 = blockIdx.y * orbit::wg::kBM, n0 = blockIdx.x * BN;
  int cols[BN / orbit::wg::kBoxN];
#pragma unroll
  for (int j = 0; j < BN / orbit::wg::kBoxN; ++j) cols[j] = n0 + j * orbit::wg::kBoxN;
  orbit::wg::ring_init<BN, kStages>(base);
  uint32_t it = 0;
  float acc[BN / 2];
  orbit::wg::run<BN, kStages, kA, kB>(&map_a, &map_b, m0, cols, 0, nk, base, acc, it);
  if (threadIdx.x >= 256) return;
  orbit::wg::for_each_acc<BN>(acc, [&](int r, int cc, float v0, float v1) {
    if (m0 + r < M && n0 + cc < N)
      *reinterpret_cast<float2*>(c + static_cast<size_t>(m0 + r) * N + n0 + cc) =
          make_float2(v0, v1);
  });
}

template <int BN, Major kA, Major kB>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  const bool ok =
      (kA == Major::K ? orbit::wg::make_tmap_2d(&map_a, a, M, K, K, orbit::wg::kBM)
                      : orbit::wg::make_tmap_2d(&map_a, a, K, M, M, orbit::wg::kBoxN)) &&
      (kB == Major::MN ? orbit::wg::make_tmap_2d(&map_b, b, K, N, N, orbit::wg::kBoxN)
                       : orbit::wg::make_tmap_2d(&map_b, b, N, K, K, orbit::wg::kBoxN));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  using R = orbit::wg::Ring<BN, kStages>;
  static bool configured = false;  // one flag per instantiation
  if (const int e = orbit::set_smem(wgmma_check_kernel<BN, kA, kB>, R::kSmemBytes, &configured))
    return e;
  const dim3 grid((N + BN - 1) / BN, (M + orbit::wg::kBM - 1) / orbit::wg::kBM);
  wgmma_check_kernel<BN, kA, kB><<<grid, orbit::wg::kThreads, R::kSmemBytes, s>>>(
      map_a, map_b, static_cast<float*>(c), M, N, (K + orbit::wg::kBK - 1) / orbit::wg::kBK);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bn(const void* a, const void* b, void* c, int M, int N, int K, int a_mn, int b_k,
              cudaStream_t s) {
  if (a_mn) {
    return b_k ? launch<BN, Major::MN, Major::K>(a, b, c, M, N, K, s)
               : launch<BN, Major::MN, Major::MN>(a, b, c, M, N, K, s);
  }
  return b_k ? launch<BN, Major::K, Major::K>(a, b, c, M, N, K, s)
             : launch<BN, Major::K, Major::MN>(a, b, c, M, N, K, s);
}

}  // namespace

// a_mn: A stored MN-major (K x M); b_k: B stored K-major (N x K); bn: 128
// or 192. Returns the launch's cudaError_t code.
extern "C" int orbit_wgmma_check(const void* a, const void* b, void* c, int M, int N, int K,
                                 int a_mn, int b_k, int bn, void* stream) {
  if (M < 1 || N < 2 || N % 2 || K < 1 || (bn != 128 && bn != 192))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 128 ? launch_bn<128>(a, b, c, M, N, K, a_mn, b_k, s)
                   : launch_bn<192>(a, b, c, M, N, K, a_mn, b_k, s);
}
