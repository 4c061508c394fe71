// Degree of every correspondence in the length-consistency graph:
// deg[i] = #{j != i, both active : | |s_i - s_j| - |t_i - t_j| | < tau}.
//
// Replaces psulvsb_tpu/ops/pallas_pairs.py::_consistency_degree_impl (the
// Pallas kernel _degree_kernel behind consistency_degree), which GROR's
// node reliability calls once per solve (gror/gror.py).
//
// Numerics. Distances come from direct differences with the squares summed
// x, y, z in round-to-nearest without contraction and an IEEE square root,
// as in pair_ratio_hist.cu: each test is bit for bit the plain PyTorch
// version's (ops/pairs.py), so the degrees are equal as integers. (The
// Pallas kernel uses |a|^2 + |b|^2 - 2ab through a float32 dot product,
// which can move a pair at the edge of the window.) The comparison is the
// strict < of the reference; inactive rows give 0; the self pair is never
// counted; there is no padding, C is any size >= 1.
//
// Design. A full-row sweep, not the i < j triangle, so that every row's
// count is finished inside one block and nothing is added across blocks: no
// atomics and no (C, C) matrix. A block owns kRows = 32 rows, one row per
// lane; its kSplit warps hold the same 32 rows and share out the columns.
// The block stages column tiles of (s_j, t_j, active_j) in shared memory,
// one column per thread; each warp reads its slice of the tile as
// broadcasts. Each thread keeps its partial count in a register; at the end
// warp 0 sums the kSplit partials of its row in a fixed order and writes the
// degree once.
//
// What bounds it on the card. About 20 floating-point operations and two
// square roots per ordered pair over C^2 pairs; the inputs (25 bytes a
// point) stay in L1/L2, so it is bound by arithmetic, and at a few thousand
// points by the launch and the few blocks it has.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;
constexpr int kSplit = 8;
constexpr int kThreads = kRows * kSplit;
constexpr int kTile = kThreads;  // columns staged per pass

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx, float by,
                                       float bz) {
  const float ex = __fsub_rn(ax, bx);
  const float ey = __fsub_rn(ay, by);
  const float ez = __fsub_rn(az, bz);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
  return __fsqrt_rn(s);
}

__global__ void __launch_bounds__(kThreads)
    consistency_degree_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                              const unsigned char* __restrict__ act, int c, float tau,
                              int* __restrict__ deg) {
  __shared__ float cs[3][kTile];
  __shared__ float cd[3][kTile];
  __shared__ unsigned char ca[kTile];
  __shared__ int partial[kSplit][kRows];

  const int tid = threadIdx.x;
  const int lane = tid % kRows;
  const int warp = tid / kRows;
  const int i = blockIdx.x * kRows + lane;
  const bool row_on = i < c && act[i] != 0;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (row_on) {
    sx = src[i];
    sy = src[static_cast<size_t>(c) + i];
    sz = src[2 * static_cast<size_t>(c) + i];
    dx = dst[i];
    dy = dst[static_cast<size_t>(c) + i];
    dz = dst[2 * static_cast<size_t>(c) + i];
  }

  int n = 0;
  const int per_warp = kTile / kSplit;
  for (int col0 = 0; col0 < c; col0 += kTile) {
    const int jt = col0 + tid;
    const bool in = jt < c;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cs[d][tid] = in ? src[static_cast<size_t>(d) * c + jt] : 0.0f;
      cd[d][tid] = in ? dst[static_cast<size_t>(d) * c + jt] : 0.0f;
    }
    ca[tid] = in ? act[jt] : 0;
    __syncthreads();
    if (row_on) {
      const int k0 = warp * per_warp;
      for (int k = k0; k < k0 + per_warp; ++k) {
        const int j = col0 + k;
        const float v1 = dist3(sx, sy, sz, cs[0][k], cs[1][k], cs[2][k]);
        const float v2 = dist3(dx, dy, dz, cd[0][k], cd[1][k], cd[2][k]);
        n += (ca[k] != 0 && j != i && fabsf(__fsub_rn(v1, v2)) < tau) ? 1 : 0;
      }
    }
    __syncthreads();
  }
  partial[warp][lane] = n;
  __syncthreads();
  if (warp == 0 && i < c) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) total += partial[w][lane];
    deg[i] = row_on ? total : 0;
  }
}

}  // namespace

// Writes the (c,) int32 degrees into `deg` on `stream`; returns
// cudaGetLastError() as an int (0 on success). src and dst are (3, c)
// contiguous float32 and act c bytes of 0/1, all device pointers; c >= 1.
extern "C" int consistency_degree_launch(const float* src, const float* dst,
                                         const unsigned char* act, int c, float tau, int* deg,
                                         void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + kRows - 1) / kRows);
  consistency_degree_kernel<<<grid, kThreads, 0, st>>>(src, dst, act, c, tau, deg);
  return static_cast<int>(cudaGetLastError());
}
