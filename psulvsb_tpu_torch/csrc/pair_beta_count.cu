// Number of active pairs i < j that pass the known-scale window
// | |s_j - s_i| - |d_j - d_i| | <= beta (registration.cc:753-767).
//
// Replaces psulvsb_tpu/ops/pallas_hist.py::_pair_beta_count_impl (the
// Pallas kernel _beta_count_kernel behind pair_beta_count), which gives the
// known-scale init beyond the dense window (init_mode "exact_beta") its
// exact reduced-set size.
//
// Numerics. The exact test is pair_sweep.cuh's: distances from direct
// differences without contraction and IEEE square roots, D = rn(v1 - v2),
// pass iff |D| <= beta, bit for bit the plain PyTorch version's
// (ops/hist.py). The count is an exact integer: 32-bit per thread, 64-bit
// per block, one 64-bit atomic per block into device memory. (The Pallas
// kernel sums in float32, exact only up to 2^24.)
//
// What bounds it on the card. Arithmetic: C (C - 1) / 2 pairs (72M at
// C = 12000) whose exact test issues about 36 instructions (two distances
// of 8 rounded operations, two IEEE roots of about 8 instructions each, the
// difference, the compare and the count) against 28 bytes a point that stay
// in L2.
//
// Design. pair_sweep.cuh's walk: only upper-triangle tiles are launched,
// sized from C, eight blocks of the grid an SM, J columns a lane in
// registers, rows as broadcast 16-byte shared loads. Most pairs are decided
// without the exact expression. With a, b the exact test's squared
// distances, the fast test takes a', b' from the same rounded differences
// with contraction (either sum of three rounded squares is within 3 * 2^-24
// of the true sum, so a' is within 6 * 2^-24 of a), u1 = sqrt.approx(a'),
// u2 = sqrt.approx(b') (relative error <= 2^-23 each, PTX ISA; the .ftz
// form returns 0 for a subnormal input, an absolute error <= 2^-63) and
// d = |rn(u1 - u2)|.
// Against the exact v1 = rn(sqrt a), v2 = rn(sqrt b) (relative error 2^-24
// each) and M = max(sqrt a, sqrt b):
//   |u - v| <= (1.5 + 1 + 0.5) * 2^-23 sqrt(.) = 3 * 2^-23 sqrt(.) a root,
//   the two roundings of the differences add at most 2^-23 M together,
// so | d - |D| | <= 7 * 2^-23 M + 2^-62. The guard is g = 16 * 2^-23
// max(u1, u2) + 2^-60, more than twice that: when |d - beta| > g, d and
// |D| lie strictly on the same side of beta and `d <= beta` is the exact
// answer. Otherwise (and for any NaN or infinity, whose compare with g
// fails) the lane recomputes its row's pairs with the exact expression.
// The guard is a band of 32 ulp of the larger distance around beta, so few
// pairs fall in it, and a warp branches to the exact path once a row, not
// once a pair.
//
// Each thread counts its passing pairs over all its tiles; a block sums
// them by warp shuffles and one pass over the warp sums, and adds the total
// with one atomic. Inactive points are treated as in consistency_degree.cu
// (rows skipped on their flag): the compaction tried there made this
// kernel slower, 74.8 -> 81.2 us at C = 12000 and 134.0 -> 180.5 us at
// C = 16384 with 80% of the points active (on the active points alone
// 55.0 and 99.5 us; tools/kernel_phases.py, H100 at 700 W).
//
// A pair axis, the counterpart of jax.vmap over pair_beta_count
// (pallas_call's batching rule adds a leading grid dimension): P cloud
// pairs, (P, 3, C) each cloud and (P, C) masks, in one launch whose grid's
// second dimension is the pair, as in pair_ratio_hist.cu. Each pair has its
// own clouds, mask and count, P counts the caller zeroed once; the blocks of
// one pair are a P-th of the grid a single pair gets (at least one).

#include "pair_sweep.cuh"

namespace {

using pair_sweep::kThreads;
using pair_sweep::kWarps;

constexpr int kBlocksPerSM = 8;  // tiles (and blocks of the grid) an SM before the tile grows
constexpr float kGuardRel = 0x1p-19f;  // 16 ulp of a distance
constexpr float kGuardAbs = 0x1p-60f;  // above the error of a flushed subnormal root

// (ex ex + ey ey) + ez ez of a - b, free to contract: the fast test only.
__device__ __forceinline__ float sq3_fast(const float4& a, const float4& b) {
  const float ex = a.x - b.x, ey = a.y - b.y, ez = a.z - b.z;
  return fmaf(ez, ez, fmaf(ey, ey, ex * ex));
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int J>
__global__ void __launch_bounds__(kThreads)
    pair_beta_count_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                           const unsigned char* __restrict__ act, int c, float beta,
                           int tiles_per_side, unsigned long long* __restrict__ count) {
  constexpr int kSize = pair_sweep::Tile<J>::kSize;
  __shared__ pair_sweep::Tile<J> tile;
  __shared__ unsigned int warp_sums[kWarps];

  // This block's pair: its clouds, mask and count.
  const int pair = blockIdx.y;
  src += 3LL * c * pair;
  dst += 3LL * c * pair;
  if (act != nullptr) act += static_cast<long long>(c) * pair;
  count += pair;

  const int tid = threadIdx.x;
  unsigned int n = 0u;
  const long long tiles = pair_sweep::tile_count(tiles_per_side);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    int row0, col0;
    pair_sweep::tile_origin(t, kSize, row0, col0);
    pair_sweep::stage(tile, src, dst, act, c, row0, col0);
    __syncthreads();
    pair_sweep::sweep(tile, row0 == col0,
                      [&](int r, const float4& a, const float4& b,
                          const pair_sweep::Columns<J>& cols) {
      bool pass[J];
      bool decided = true;
#ifndef BETA_EXACT_ONLY  // defined: the exact test on every pair, the fast test's yardstick
#pragma unroll
      for (int k = 0; k < J; ++k) {
        const float u1 = sqrt_approx(sq3_fast(cols.s[k], a));
        const float u2 = sqrt_approx(sq3_fast(cols.d[k], b));
        const float d = fabsf(u1 - u2);
        const float g = fmaf(fmaxf(u1, u2), kGuardRel, kGuardAbs);
        pass[k] = d <= beta;
        decided = decided && fabsf(d - beta) > g;
      }
      if (!decided)
#endif
      {
#pragma unroll
        for (int k = 0; k < J; ++k) {
          const float v1 = pair_sweep::dist3(cols.s[k], a);
          const float v2 = pair_sweep::dist3(cols.d[k], b);
          pass[k] = fabsf(__fsub_rn(v1, v2)) <= beta;
        }
      }
#pragma unroll
      for (int k = 0; k < J; ++k) n += (pass[k] && r < cols.limit[k]) ? 1u : 0u;
    });
    __syncthreads();  // the tile is read no more: the next one may be staged
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

// Adds, for each of `pairs` cloud pairs, the number of its active pairs
// i < j with | |s_j - s_i| - |d_j - d_i| | <= beta to count[pair] (64-bit
// integers the caller zeroed) on `stream`; returns cudaGetLastError() as an
// int (0 on success). src and dst are (pairs, 3, c) contiguous float32 and
// act (pairs, c) bytes of 0/1 or null (all active), all device pointers;
// 0 <= c <= 2^20, 1 <= pairs <= 65535.
extern "C" int pair_beta_count_launch(const float* src, const float* dst, const unsigned char* act,
                                      int c, int pairs, float beta, unsigned long long* count,
                                      void* stream) {
  if (c < 0 || c > pair_sweep::kMaxC || pairs < 1 || pairs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c < 2) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pair_sweep::Plan p = pair_sweep::plan(c, kBlocksPerSM, pairs);
  const dim3 grid(p.grid, pairs);
  switch (p.j) {
    case 4:
      pair_beta_count_kernel<4><<<grid, kThreads, 0, st>>>(src, dst, act, c, beta, p.side, count);
      break;
    case 2:
      pair_beta_count_kernel<2><<<grid, kThreads, 0, st>>>(src, dst, act, c, beta, p.side, count);
      break;
    default:
      pair_beta_count_kernel<1><<<grid, kThreads, 0, st>>>(src, dst, act, c, beta, p.side, count);
  }
  return static_cast<int>(cudaGetLastError());
}
