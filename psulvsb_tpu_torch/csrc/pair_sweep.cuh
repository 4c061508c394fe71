// The sweep over all pairs i < j of a (3, C) cloud pair that the three
// pair-grid kernels share (pair_ratio_hist.cu, pair_beta_count.cu,
// consistency_degree.cu): the distance arithmetic, the walk over
// upper-triangle tiles and the staging of a tile's points.
//
// Numerics. A distance is sqrt((ex ex + ey ey) + ez ez) of direct
// differences, every step rounded to nearest with no contraction into FMAs
// and the square root IEEE, which is bit for bit what the plain PyTorch
// versions compute (ops/hist.py, ops/pairs.py): a kernel built on dist3
// gives equal counts, not close ones.
//
// The walk. Square tiles of T = 32 J points a side (J = 1, 2 or 4), T the
// largest that still gives `blocks_per_sm` tiles per SM, and only tiles on
// or above the diagonal, numbered tile = tj (tj + 1) / 2 + ti for ti <= tj.
// A grid of at most blocks_per_sm blocks per SM walks the tiles (tile =
// blockIdx.x, then += gridDim.x).
//
// A tile. The block stages the tile's T row points and T column points in
// shared memory, packed as one float4 a point and cloud: x, y, z and the
// active flag as the fourth word (1 or 0; points past C are inactive, so
// padding never passes a test). After a barrier each lane takes J columns
// into registers (J independent pairs a row, for ILP over the square
// root's latency) and each warp walks every eighth row, one broadcast
// 16-byte load a cloud; an inactive row costs its flag's test and nothing
// more. The caller's functor gets the row, its two points and the lane's
// columns; pair (r, k) counts when r < limit[k], which folds the column's
// flag and, on a diagonal tile, i < j into one compare.

#pragma once

#include <cuda_runtime.h>

namespace pair_sweep {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJ = 4;        // columns a lane: tiles of at most 128 x 128 pairs
constexpr int kMaxC = 1 << 20;  // 3 C fits an int; a block's 32-bit counts cannot overflow

// (ex ex + ey ey) + ez ez of a - b, rounded to nearest at every step.
__device__ __forceinline__ float sq3(const float4& a, const float4& b) {
  const float ex = __fsub_rn(a.x, b.x);
  const float ey = __fsub_rn(a.y, b.y);
  const float ez = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

__device__ __forceinline__ float dist3(const float4& a, const float4& b) {
  return __fsqrt_rn(sq3(a, b));
}

// The tiling of a launch: J, tiles a side, blocks of the grid.
struct Plan {
  int j;
  int side;
  unsigned int grid;
};

// The largest tile that still gives blocks_per_sm tiles per SM; the grid is
// one block a tile up to that many. One block even with no pair (C < 2 has
// one or no tile), so that a kernel's epilogue always runs. With `clouds`
// cloud pairs in one launch (a grid dimension of their own), each gets a
// clouds-th of those blocks, and at least one.
inline Plan plan(int c, int blocks_per_sm, int clouds = 1) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long min_tiles = static_cast<long long>(blocks_per_sm) * sms / clouds;
  if (min_tiles < 1) min_tiles = 1;
  int j = kMaxJ;
  while (j > 1) {
    const long long side = (c + 32LL * j - 1) / (32LL * j);
    if (side * (side + 1) / 2 >= min_tiles) break;
    j /= 2;
  }
  const int side = c > 0 ? (c + 32 * j - 1) / (32 * j) : 0;
  const long long tiles = static_cast<long long>(side) * (side + 1) / 2;
  const long long grid = tiles < min_tiles ? (tiles > 0 ? tiles : 1) : min_tiles;
  return Plan{j, side, static_cast<unsigned int>(grid)};
}

__device__ __forceinline__ long long tile_count(int tiles_per_side) {
  return static_cast<long long>(tiles_per_side) * (tiles_per_side + 1) / 2;
}

// First row and first column of upper-triangle tile `tile` of tile_size points a side.
__device__ __forceinline__ void tile_origin(long long tile, int tile_size, int& row0, int& col0) {
  long long tj = static_cast<long long>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
  while (tj * (tj + 1) / 2 > tile) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= tile) ++tj;
  row0 = static_cast<int>(tile - tj * (tj + 1) / 2) * tile_size;
  col0 = static_cast<int>(tj) * tile_size;
}

// A tile's points in shared memory: slots [0, kSize) its rows, [kSize,
// 2 kSize) its columns.
template <int J>
struct Tile {
  static constexpr int kSize = 32 * J;
  float4 s[2 * kSize];
  float4 d[2 * kSize];

  // The point that slot `slot` holds.
  __device__ __forceinline__ static int point(int slot, int row0, int col0) {
    return slot < kSize ? row0 + slot : col0 + slot - kSize;
  }
};

// Thread t < 2 kSize stages slot t. act: C bytes of 0/1, or null (all
// active). Barriers are the caller's: one after staging, one after the sweep.
template <int J>
__device__ __forceinline__ void stage(Tile<J>& t, const float* __restrict__ src,
                                      const float* __restrict__ dst,
                                      const unsigned char* __restrict__ act, int c, int row0,
                                      int col0) {
  const int slot = threadIdx.x;
  if (slot >= 2 * Tile<J>::kSize) return;
  const int i = Tile<J>::point(slot, row0, col0);
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f), d = s;
  if (i < c && (act == nullptr || act[i] != 0)) {
    s = make_float4(src[i], src[c + i], src[2 * c + i], 1.0f);
    d = make_float4(dst[i], dst[c + i], dst[2 * c + i], 1.0f);
  }
  t.s[slot] = s;
  t.d[slot] = d;
}

// A lane's J columns of a tile.
template <int J>
struct Columns {
  float4 s[J], d[J];
  int limit[J];  // pair (row r, column k) counts when r < limit[k]
};

// Calls fn(r, row's source point, row's destination point, columns) for
// every active row r of the tile that this warp owns, all 32 lanes together.
template <int J, class RowFn>
__device__ __forceinline__ void sweep(const Tile<J>& t, bool diagonal, RowFn fn) {
  constexpr int kSize = Tile<J>::kSize;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Columns<J> cols;
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const int col = lane + 32 * k;
    cols.s[k] = t.s[kSize + col];
    cols.d[k] = t.d[kSize + col];
    cols.limit[k] = cols.s[k].w == 0.0f ? 0 : (diagonal ? col : kSize);
  }
  for (int r = warp; r < kSize; r += kWarps) {
    const float4 a = t.s[r];
    if (a.w == 0.0f) continue;  // uniform in the warp
    fn(r, a, t.d[r], cols);
  }
}

}  // namespace pair_sweep
