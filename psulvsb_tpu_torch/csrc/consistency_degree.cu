// Degree of every correspondence in the length-consistency graph:
// deg[i] = #{j != i, both active : | |s_i - s_j| - |t_i - t_j| | < tau}.
//
// Replaces psulvsb_tpu/ops/pallas_pairs.py::_consistency_degree_impl (the
// Pallas kernel _degree_kernel behind consistency_degree), which GROR's
// node reliability calls once per solve (gror/gror.py).
//
// Numerics. Distances by pair_sweep.cuh's dist3 (direct differences, no
// contraction, IEEE square root): each test is bit for bit the plain
// PyTorch version's (ops/pairs.py), and the degrees are sums of integers,
// which commute, so they are equal as integers whatever the order of the
// atomics. (The Pallas kernel uses |a|^2 + |b|^2 - 2ab through a float32
// dot product, which can move a pair at the edge of the window.) The
// comparison is the strict < of the reference; inactive rows give 0; the
// self pair is never counted; C is any size from 1 to 2^20.
//
// What bounds it on the card. About 36 issued instructions a pair (two
// distances of 8 rounded operations and an 8-instruction IEEE root each)
// over C (C - 1) / 2 pairs: 1.8M pairs at C = 1889, a few microseconds of
// arithmetic on 132 SMs, so at the solve paths' sizes the launch, the
// staging and the flush set the time, and every SM must have work.
//
// Design. The test is symmetric, so the kernel sweeps the triangle i < j
// (pair_sweep.cuh: upper-triangle tiles sized from C, J columns a lane in
// registers, rows as broadcast 16-byte shared loads) and a passing pair
// adds one to both ends. The column end is counted in the lane's registers
// and added to a shared counter at the end of the tile; the row end is one
// warp-wide integer sum a row, stored by one lane (a row of a tile belongs
// to one warp). After the tile, the thread that staged a point flushes that
// point's nonzero counter into deg with one 32-bit atomicAdd and zeroes it.
// A counter holds at most a tile's 128 pairs a point and deg at most C - 1.
// deg is zeroed on the stream before the launch.
//
// Inactive points. An inactive row is skipped on its flag; an inactive
// column never counts, but its lane still runs beside its neighbours. A
// compaction of the active indices inside the launch was tried and is not
// kept. Every block counted the active points of 256 runs of the mask (a
// scan into shared memory), walked tiles over ranks, and staged the point
// of a rank by a binary search over the runs and a walk of one. With 80%
// of the points active a launch at C = 8192 took 60.1 us with it and 60.1
// us without, and with every point active 71.2 us against 63.8 us; at
// C = 1250 and 1889 it added 1.2 and 1.9 us to launches of 5.0 and 7.8 us
// (tools/kernel_phases.py on both trees in one call, H100 at 700 W). The
// same launch on the active points alone, the most any compaction could
// reach, took 3.4, 5.8 and 43.0 us at C = 1250, 1889 and 8192; the solve
// paths' mask is all ones unless the caller filtered correspondences out
// beforehand.
//
// A pair axis, the counterpart of jax.vmap over consistency_degree
// (pallas_call's batching rule adds a leading grid dimension): P cloud
// pairs, (P, 3, C) each cloud and (P, C) masks, in one launch whose grid's
// second dimension is the pair, as in pair_ratio_hist.cu. Each pair has its
// own clouds, mask and row of degrees, and one zero fill covers all P rows.
// The blocks of one pair are a P-th of the grid a single pair gets (at
// least one), so the launch keeps about kBlocksPerSM blocks an SM whatever P
// is.

#include "pair_sweep.cuh"

namespace {

using pair_sweep::kThreads;

// Tiles (and blocks of the grid) an SM before the tile grows: at 1, 2, 4 and
// 8 a launch took 14.2, 8.4, 8.8 and 7.8 us at C = 1889 and 149, 86, 62 and
// 61 us at C = 8192 on an H100 (700 W).
constexpr int kBlocksPerSM = 8;

template <int J>
__global__ void __launch_bounds__(kThreads)
    consistency_degree_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                              const unsigned char* __restrict__ act, int c, float tau,
                              int tiles_per_side, int* __restrict__ deg) {
  constexpr int kSize = pair_sweep::Tile<J>::kSize;
  __shared__ pair_sweep::Tile<J> tile;
  __shared__ unsigned int count[2 * kSize];  // by staged slot: rows, then columns

  // This block's pair: its clouds, mask and degrees.
  const int pair = blockIdx.y;
  src += 3LL * c * pair;
  dst += 3LL * c * pair;
  if (act != nullptr) act += static_cast<long long>(c) * pair;
  deg += static_cast<long long>(c) * pair;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < 2 * kSize) count[tid] = 0u;

  const long long tiles = pair_sweep::tile_count(tiles_per_side);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    int row0, col0;
    pair_sweep::tile_origin(t, kSize, row0, col0);
    pair_sweep::stage(tile, src, dst, act, c, row0, col0);
    __syncthreads();

    unsigned int n[J] = {};
    pair_sweep::sweep(tile, row0 == col0,
                      [&](int r, const float4& a, const float4& b,
                          const pair_sweep::Columns<J>& cols) {
      unsigned int row_n = 0u;
#pragma unroll
      for (int k = 0; k < J; ++k) {
        const float v1 = pair_sweep::dist3(cols.s[k], a);
        const float v2 = pair_sweep::dist3(cols.d[k], b);
        const unsigned int ok = (r < cols.limit[k] && fabsf(__fsub_rn(v1, v2)) < tau) ? 1u : 0u;
        n[k] += ok;
        row_n += ok;
      }
      row_n = __reduce_add_sync(0xffffffffu, row_n);
      if (lane == 0) count[r] = row_n;
    });
#pragma unroll
    for (int k = 0; k < J; ++k) {
      if (n[k] != 0u) atomicAdd(&count[kSize + lane + 32 * k], n[k]);
    }
    __syncthreads();

    // Thread t owns slot t from here to the next tile's first barrier: it
    // flushes and zeroes the counter, then stages the slot's next point.
    if (tid < 2 * kSize) {
      const unsigned int v = count[tid];
      if (v != 0u) {
        atomicAdd(deg + pair_sweep::Tile<J>::point(tid, row0, col0), static_cast<int>(v));
        count[tid] = 0u;
      }
    }
  }
}

}  // namespace

// Writes the (pairs, c) int32 degrees into `deg` on `stream`; returns the
// CUDA error as an int (0 on success). src and dst are (pairs, 3, c)
// contiguous float32 and act (pairs, c) bytes of 0/1 or null (all active),
// all device pointers; 1 <= c <= 2^20, 1 <= pairs <= 65535.
extern "C" int consistency_degree_launch(const float* src, const float* dst,
                                         const unsigned char* act, int c, int pairs, float tau,
                                         int* deg, void* stream) {
  if (c < 1 || c > pair_sweep::kMaxC || pairs < 1 || pairs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(deg, 0, sizeof(int) * static_cast<size_t>(c) * pairs, st);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const pair_sweep::Plan p = pair_sweep::plan(c, kBlocksPerSM, pairs);
  const dim3 grid(p.grid, pairs);
  switch (p.j) {
    case 4:
      consistency_degree_kernel<4><<<grid, kThreads, 0, st>>>(src, dst, act, c, tau, p.side, deg);
      break;
    case 2:
      consistency_degree_kernel<2><<<grid, kThreads, 0, st>>>(src, dst, act, c, tau, p.side, deg);
      break;
    default:
      consistency_degree_kernel<1><<<grid, kThreads, 0, st>>>(src, dst, act, c, tau, p.side, deg);
  }
  return static_cast<int>(cudaGetLastError());
}
