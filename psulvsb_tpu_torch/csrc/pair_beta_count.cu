// Number of active pairs i < j that pass the known-scale window
// | |s_j - s_i| - |d_j - d_i| | <= beta (registration.cc:753-767).
//
// Replaces psulvsb_tpu/ops/pallas_hist.py::_pair_beta_count_impl (the
// Pallas kernel _beta_count_kernel behind pair_beta_count), which gives the
// known-scale init beyond the dense window (init_mode "exact_beta") its
// exact reduced-set size.
//
// Numerics. As in pair_ratio_hist.cu: direct differences, squares summed
// x, y, z in round-to-nearest without contraction, IEEE sqrt, so each test
// is bit for bit the plain PyTorch version's (ops/hist.py) and the count
// equals it. The count is an exact integer: 32-bit per thread and per
// block, one 64-bit atomic per block into device memory. (The Pallas kernel
// sums in float32, exact only up to 2^24.)
//
// Design. The same sweep as pair_ratio_hist.cu: (column tile, row tile)
// blocks, tiles at or below the diagonal exit at once, kRows row points
// staged in shared memory, one column point per thread in registers. Each
// thread counts its passing pairs; the block sums them by warp shuffles and
// one pass over the warp sums, and adds the total with one atomic.
//
// What bounds it on the card. About 25 floating-point operations and two
// square roots per pair over C(C-1)/2 pairs; inputs stay in L2, so it is
// bound by arithmetic, not by memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx, float by,
                                       float bz) {
  const float ex = __fsub_rn(ax, bx);
  const float ey = __fsub_rn(ay, by);
  const float ez = __fsub_rn(az, bz);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
  return __fsqrt_rn(s);
}

__global__ void __launch_bounds__(kThreads)
    pair_beta_count_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                           const unsigned char* __restrict__ act, int c, float beta,
                           unsigned long long* __restrict__ count) {
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kThreads;
  if (row0 >= col0 + kThreads - 1) return;  // no pair i < j in this tile

  __shared__ float rs[3][kRows];
  __shared__ float rd[3][kRows];
  __shared__ unsigned char ra[kRows];
  __shared__ unsigned int warp_sums[kWarps];

  const int tid = threadIdx.x;
  if (tid < kRows) {
    const int i = row0 + tid;
    const bool in = i < c;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rs[d][tid] = in ? src[static_cast<size_t>(d) * c + i] : 0.0f;
      rd[d][tid] = in ? dst[static_cast<size_t>(d) * c + i] : 0.0f;
    }
    ra[tid] = in ? act[i] : 0;
  }
  __syncthreads();

  const int j = col0 + tid;
  unsigned int n = 0;
  if (j < c && act[j] != 0) {
    const float sx = src[j];
    const float sy = src[static_cast<size_t>(c) + j];
    const float sz = src[2 * static_cast<size_t>(c) + j];
    const float dx = dst[j];
    const float dy = dst[static_cast<size_t>(c) + j];
    const float dz = dst[2 * static_cast<size_t>(c) + j];
    const int r_end = min(kRows, j - row0);  // rows i < j only
    for (int r = 0; r < r_end; ++r) {
      const float v1 = dist3(sx, sy, sz, rs[0][r], rs[1][r], rs[2][r]);
      const float v2 = dist3(dx, dy, dz, rd[0][r], rd[1][r], rd[2][r]);
      n += (ra[r] != 0 && fabsf(__fsub_rn(v1, v2)) <= beta) ? 1u : 0u;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = n;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    if (total != 0) atomicAdd(count, total);
  }
}

}  // namespace

// Adds the number of active pairs i < j with | |s_j - s_i| - |d_j - d_i| |
// <= beta to `count` (one 64-bit integer the caller zeroed) on `stream`;
// returns cudaGetLastError() as an int (0 on success). src and dst are
// (3, c) contiguous float32 and act c bytes of 0/1, all device pointers.
extern "C" int pair_beta_count_launch(const float* src, const float* dst, const unsigned char* act,
                                      int c, float beta, unsigned long long* count, void* stream) {
  if (c < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (c < 2) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + kThreads - 1) / kThreads, (c + kRows - 1) / kRows);
  pair_beta_count_kernel<<<grid, kThreads, 0, st>>>(src, dst, act, c, beta, count);
  return static_cast<int>(cudaGetLastError());
}
