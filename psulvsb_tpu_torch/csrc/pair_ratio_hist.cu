// Windowed histogram of pair distance ratios over all active pairs i < j.
//
// Replaces psulvsb_tpu/ops/pallas_hist.py::_pair_ratio_histogram_impl (the
// Pallas kernel _hist_kernel behind pair_ratio_histogram, which
// exact_peak_bin calls twice). For each active pair i < j of a (3, C) cloud
// pair:
//   v1 = |s_j - s_i|, v2 = |d_j - d_i|, ratio = v2 / (v1 > 0 ? v1 : 1),
//   fine = max(floor(ratio * bins_per_unit), 0),
//   idx = floor((fine - lo) / stride)  (floor division),
// then idx is clamped into [0, num_bins) (coarse pass) or the pair is dropped
// when idx falls outside it (fine pass). (lo, stride) come from device
// memory, so the fine pass can take its window from the coarse pass without
// a host read.
//
// Numerics. Distances come from direct differences, the squares summed in
// the order x, y, z with round-to-nearest intrinsics (no contraction into
// FMAs), and sqrt and the division are IEEE, so every ratio is bit for bit
// what the plain PyTorch version (ops/hist.py) computes and the counts are
// equal, not close. The Pallas kernel's |a|^2 + |b|^2 - 2ab form is not
// used. Counts are exact integers: 32-bit in shared memory (a block sees at
// most kRows * kThreads pairs) and 64-bit in device memory (one bin can
// hold all C(C-1)/2 pairs, which overflows 32 bits beyond C of about 65k).
//
// Design. A 2-D grid of (column tile, row tile) blocks over the pair grid;
// tiles wholly at or below the diagonal exit at once. A block stages its
// kRows row points in shared memory; each of its kThreads threads owns one
// column point in registers and walks the rows, so a warp reads one row
// point at a time (a shared-memory broadcast). Each pair's bin goes to a
// shared-memory histogram of num_bins <= 512 counters; lanes of a warp that
// hit the same bin are merged first (__match_any_sync), so the one shared
// atomic per distinct bin absorbs the inlier spike where most pairs of a
// warp share a bin. At the end each block adds its nonzero bins to the
// 64-bit device counts with one atomic each.
//
// What bounds it on the card. C(C-1)/2 pairs (12.5M at C = 5000, 134M at
// C = 16384) of about 30 floating-point operations each, two square roots
// and one division; the inputs are 28 bytes a point and stay in L2. It is
// bound by arithmetic and by the shared atomics on a few hot bins, not by
// memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // columns per block, one per thread
constexpr int kRows = 128;     // rows per block
constexpr int kMaxBins = 512;
constexpr float kFineCap = 1073741824.0f;  // 2^30: any larger fine bin is out of every window

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx, float by,
                                       float bz) {
  const float ex = __fsub_rn(ax, bx);
  const float ey = __fsub_rn(ay, by);
  const float ez = __fsub_rn(az, bz);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
  return __fsqrt_rn(s);
}

template <bool kClamp>
__global__ void __launch_bounds__(kThreads)
    pair_ratio_hist_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                           const unsigned char* __restrict__ act, int c, float bins_per_unit,
                           const int* __restrict__ window, int num_bins,
                           unsigned long long* __restrict__ counts) {
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kThreads;
  // No pair i < j in this tile: every row is at or past every column.
  if (row0 >= col0 + kThreads - 1) return;

  __shared__ unsigned int hist[kMaxBins];
  __shared__ float rs[3][kRows];
  __shared__ float rd[3][kRows];
  __shared__ unsigned char ra[kRows];

  const int tid = threadIdx.x;
  for (int k = tid; k < num_bins; k += kThreads) hist[k] = 0u;
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

  const int lo = window[0];
  const int stride = window[1];
  const int j = col0 + tid;
  const bool col_in = j < c;
  const bool col_ok = col_in && act[j] != 0;
  float sx = 0.f, sy = 0.f, sz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (col_in) {
    sx = src[j];
    sy = src[static_cast<size_t>(c) + j];
    sz = src[2 * static_cast<size_t>(c) + j];
    dx = dst[j];
    dy = dst[static_cast<size_t>(c) + j];
    dz = dst[2 * static_cast<size_t>(c) + j];
  }
  const int lane = tid & 31;

  // Every lane of a warp runs every row, so the warp stays converged for
  // __match_any_sync; invalid pairs vote with key -1 and add nothing.
  for (int r = 0; r < kRows; ++r) {
    bool valid = col_ok && ra[r] != 0 && (row0 + r) < j;
    const float v1 = dist3(sx, sy, sz, rs[0][r], rs[1][r], rs[2][r]);
    const float v2 = dist3(dx, dy, dz, rd[0][r], rd[1][r], rd[2][r]);
    const float ratio = __fdiv_rn(v2, v1 > 0.0f ? v1 : 1.0f);
    float f = floorf(__fmul_rn(ratio, bins_per_unit));
    f = fminf(fmaxf(f, 0.0f), kFineCap);
    const int fine = static_cast<int>(f);
    const int d = fine - lo;
    int idx = d >= 0 ? d / stride : -((stride - 1 - d) / stride);
    if (kClamp) {
      idx = min(max(idx, 0), num_bins - 1);
    } else {
      valid = valid && idx >= 0 && idx < num_bins;
    }
    const int key = valid ? idx : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[key], __popc(peers));
  }
  __syncthreads();

  for (int k = tid; k < num_bins; k += kThreads) {
    const unsigned int h = hist[k];
    if (h != 0u) atomicAdd(&counts[k], static_cast<unsigned long long>(h));
  }
}

}  // namespace

// Adds the histogram of the active pairs i < j to `counts` (num_bins
// 64-bit integers the caller zeroed) on `stream`; returns
// cudaGetLastError() as an int (0 on success). src and dst are (3, c)
// contiguous float32, act c bytes of 0/1, window two int32 (lo, stride)
// with stride >= 1, all device pointers.
extern "C" int pair_ratio_hist_launch(const float* src, const float* dst, const unsigned char* act,
                                      int c, float bins_per_unit, const int* window, int num_bins,
                                      int clamp_overflow, unsigned long long* counts,
                                      void* stream) {
  if (c < 0 || num_bins < 1 || num_bins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c < 2) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + kThreads - 1) / kThreads, (c + kRows - 1) / kRows);
  const dim3 block(kThreads);
  if (clamp_overflow) {
    pair_ratio_hist_kernel<true><<<grid, block, 0, st>>>(src, dst, act, c, bins_per_unit, window,
                                                         num_bins, counts);
  } else {
    pair_ratio_hist_kernel<false><<<grid, block, 0, st>>>(src, dst, act, c, bins_per_unit, window,
                                                          num_bins, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
