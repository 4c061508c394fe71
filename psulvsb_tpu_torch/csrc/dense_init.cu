// The dense init's reduced pool: every pair i < j of two active points that
// passes the reduced-set test, thinned to its top k by a hash priority and
// laid out in pool slots, with no (C, C) array in device memory.
//
// Replaces no Pallas kernel: it replaces the XLA dense init of the JAX
// package (psulvsb_tpu/solver/psulvsb.py:320, `_init_stage_dense`), which the
// port ran as plain PyTorch over the full (C, C) grid (two matrix products,
// about fifteen (C, C) passes in float32, bool and int64, and a top-k over
// all C^2 entries): about 420 bytes of device traffic a grid cell, 4.7 ms a
// pair at C = 6144 on an H100.
//
// Contract (ops/init.py, `dense_init`). A pair (i < j, keep == 1 at both
// ends) is a member when
//   known scale:     |v1 - v2| <= beta,
//   estimated scale: the ratio bin clip(floor(v2 / v1' * bins_per_unit), 0,
//                    num_bins - 1) lies within 1 of the pair's `peak`,
// v = sqrt(max(n_i + n_j - 2 <a_i, a_j>, 0)) in float32 (the JAX package's
// form; n the squared norms), v1' = v1 where v1 > 0 else 1. Its priority is
// float32(h) of the uint32 hash h of its flat position i C + j,
//   h = pos a' + b;  h ^= h >> 16;  h *= 0x45D9F3B;  h ^= h >> 16
// (a' = a | 1, all mod 2^32), and the pool is the top k = min(fill, C^2)
// members by (priority descending, position ascending), the order of
// lax.top_k, padded with zeros to pool_cap. red_count = min(members,
// reduced_cap), pool_count = min(members, k).
//
// What bounds it on the card. C (C - 1) / 2 pair tests (18.9M at C = 6144)
// of about 17 floating-point operations and two IEEE square roots each, and
// a hash of about 8 integer operations: arithmetic, 4.8 us of float32 at
// the card's peak for one pair at C = 6144. Its inputs (16 bytes a point and
// cloud) stay in L2; its output is the pool, 16 bytes a slot.
//
// Design. No (C, C) array exists: every pass recomputes the test from the
// points, over pair_sweep.cuh's upper-triangle tiles, the tile's points
// staged as (x, y, z, |p|^2) in shared memory (|p|^2 = -1 marks an inactive
// point or one past C), J columns a lane in registers. A tile whose rows or
// columns are all inactive is skipped whole, so padding at the end of the
// cloud costs nothing. h is a bijection of the position (odd multiplies
// and xorshifts), so members have distinct hashes, and the pool is the top
// k of the members whose hash reaches a threshold T low enough to hold them
// all and high enough to leave at most k + 2047 of them:
//   1. count: the full test; members counted (one atomic a block) and a
//      histogram of h >> 20 over members (shared, flushed once a block);
//   2. select: one block a pair finds the bin b1 that holds the k-th
//      largest hash. Members <= k: T = 0 (every member). Otherwise T =
//      b1 2^20 - 256 when that bin holds few enough members; else
//   3. refine: a histogram of (h >> 8) & 0xFFF inside b1, the hash first
//      and the test only for pairs whose hash lies in the bin (so the pass
//      costs about the hash alone), and a second select: T = the bin's
//      first hash - 256. The 256 below the bin's first hash hold every
//      member whose float32 equals the k-th largest's (a float32 above 2^31
//      covers at most 257 integers), so the pool's last run of equal
//      priorities is complete. Pairs that need no refine skip it;
//   4. emit: members with h >= T (the hash first, the test only there, or
//      the full test when T = 0) go to the candidates as their hash;
//   5. order: one block a pair ranks the candidates by (priority
//      descending, position ascending): a counting sort into 2048 buckets
//      of the priority's range, then within a bucket (about 8 candidates)
//      by comparison; each position comes from inverting the hash. A rank
//      under min(members, k) is a slot; the rest is padded. Slots are
//      decided by the ranks alone (no atomic decides a slot), so a replay
//      equals the eager run.
// The pair axis is the grid's second dimension (the order kernel's first),
// as in pair_ratio_hist.cu. The workspace (counters, histograms,
// candidates) is fixed per (P, k), zeroed once on the stream at the start
// of a launch; the op captures into a CUDA graph with no host read.
//
// Measured (H100 at 700 W, C = 6144 with 5000 points active, 3DMatch's
// beta, 118k members): 0.108 ms a launch for one pair and 0.49 ms for
// eight, against 5.7 and 44 ms for the plain version; for one pair the
// count and emit passes take about 33 and 31 us, the order block 35 us
// (one SM), the selects and the skipped refine a few us.
//
// Numerics. Squared norms from rounded squares and adds, the dot product as
// a chain of FMAs (as a float32 matrix product on the card), then
// (n_i + n_j) - 2 g, a max with 0 and an IEEE square root; the division of
// the estimated test is IEEE. The plain version takes its products from
// cuBLAS, which may sum in another order, so a pair at the edge of the
// window can fall the other way; the hash and its order are exact.

#include "pair_sweep.cuh"

namespace {

using pair_sweep::kThreads;
using pair_sweep::kWarps;

constexpr int kBlocksPerSM = 4;
constexpr int kTopBins = 1 << 12;   // h >> 20
constexpr int kMidBins = 1 << 12;   // (h >> 8) & 0xFFF
constexpr int kBand = 256;          // below a bin's first hash: the k-th's float32 run
constexpr int kSlack = 2048;        // candidates beyond k
constexpr int kMaxFill = 1 << 15;   // k + kSlack candidates fit one block's shared memory
constexpr int kOrderBucketBits = 11;
constexpr int kOrderBuckets = 1 << kOrderBucketBits;
constexpr int kOrderThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned int kMul = 0x45D9F3Bu;

// A pair's workspace, in 32-bit words.
enum : int {
  kMembers = 0,   // members of the reduced set
  kEmitted,       // candidates emitted
  kRefine,        // 1 when the refine pass runs
  kPrefix,        // the selected bin b1
  kRank,          // the k-th largest's rank inside b1 (1-based)
  kThreshold,     // T: members with h >= T are candidates
  kHeader = 8,
  kHist1 = kHeader,
  kHist2 = kHist1 + kTopBins,
  kCand = kHist2 + kMidBins,
};

enum Mode { kCount, kRefineMid, kEmit };

__host__ __device__ constexpr unsigned int inverse_odd(unsigned int a) {
  unsigned int x = a;  // right to 3 bits; each step doubles them
  for (int i = 0; i < 5; ++i) x *= 2u - a * x;
  return x;
}
constexpr unsigned int kMulInverse = inverse_odd(kMul);
static_assert(kMul * kMulInverse == 1u, "the hash's multiplier must be invertible mod 2^32");

__device__ __forceinline__ unsigned int pair_hash(unsigned int pos, unsigned int a,
                                                  unsigned int b) {
  unsigned int h = pos * a + b;
  h ^= h >> 16;
  h *= kMul;
  return h ^ (h >> 16);
}

// The position whose hash is h (x ^= x >> 16 is its own inverse on 32 bits).
__device__ __forceinline__ unsigned int pair_position(unsigned int h, unsigned int a_inverse,
                                                      unsigned int b) {
  h ^= h >> 16;
  h *= kMulInverse;
  h ^= h >> 16;
  return (h - b) * a_inverse;
}

// Distance of two staged points (x, y, z, |p|^2).
__device__ __forceinline__ float gram_dist(const float4& a, const float4& b) {
  const float g = __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, __fmul_rn(a.x, b.x)));
  const float sq = __fsub_rn(__fadd_rn(a.w, b.w), __fmul_rn(2.0f, g));
  return __fsqrt_rn(fmaxf(sq, 0.0f));
}

struct Args {
  const float* src;        // (pairs, 3, c)
  const float* dst;        // (pairs, 3, c)
  const long long* keep;   // (pairs, c)
  const long long* ab;     // (pairs, 2)
  const long long* peak;   // (pairs,), estimated scale only
  unsigned int* ws;        // (pairs, stride)
  long long stride;
  int c;
  unsigned int k;
  float beta;
  float bins_per_unit;
  int num_bins;
  int tiles_per_side;
};

template <bool kEstimate>
__device__ __forceinline__ bool is_member(const float4& rs, const float4& rd, const float4& cs,
                                          const float4& cd, const Args& args, long long peak) {
  const float v1 = gram_dist(rs, cs);
  const float v2 = gram_dist(rd, cd);
  if (kEstimate) {
    const float ratio = __fdiv_rn(v2, v1 > 0.0f ? v1 : 1.0f);
    const float f = fminf(fmaxf(floorf(__fmul_rn(ratio, args.bins_per_unit)), -1.0f),
                          static_cast<float>(args.num_bins));
    long long bin = static_cast<long long>(f);
    bin = bin < 0 ? 0 : (bin > args.num_bins - 1 ? args.num_bins - 1 : bin);
    const long long off = bin - peak;
    return off >= -1 && off <= 1;
  }
  return fabsf(__fsub_rn(v1, v2)) <= args.beta;
}

template <int J>
struct Tile {
  static constexpr int kSize = 32 * J;
  float4 s[2 * kSize];  // rows, then columns
  float4 d[2 * kSize];
};

template <int kMode>
struct HistBins {
  static constexpr int value = kMode == kCount ? kTopBins : (kMode == kRefineMid ? kMidBins : 1);
};

template <int J, bool kEstimate, int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) dense_sweep_kernel(Args args) {
  constexpr int kSize = Tile<J>::kSize;
  constexpr int kBins = HistBins<kMode>::value;
  constexpr int kQueue = 64;  // a warp's queued pairs of the emit pass
  __shared__ Tile<J> tile;
  __shared__ unsigned int hist[kBins];
  __shared__ unsigned int block_members;
  __shared__ unsigned int queue[kMode == kEmit ? kWarps * 2 * kQueue : 1];

  const int pair = blockIdx.y;
  const int c = args.c;
  const float* src = args.src + 3LL * c * pair;
  const float* dst = args.dst + 3LL * c * pair;
  const long long* keep = args.keep + static_cast<long long>(c) * pair;
  unsigned int* ws = args.ws + args.stride * pair;
  const long long peak = kEstimate ? args.peak[pair] : 0;
  const unsigned int a = static_cast<unsigned int>(args.ab[2 * pair]) | 1u;
  const unsigned int b = static_cast<unsigned int>(args.ab[2 * pair + 1]);

  // A pass after the count reads where the select left the pair.
  unsigned int prefix = 0u, threshold = 0u;
  if (kMode == kRefineMid) {
    if (ws[kRefine] == 0u) return;  // uniform in the block: nothing to refine
    prefix = ws[kPrefix];
  }
  if (kMode == kEmit) threshold = ws[kThreshold];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0u;
  if (tid == 0) block_members = 0u;
  unsigned int members = 0u;
  // The emit pass queues the pairs whose hash reaches T, a warp's 32 at a
  // time, and tests them together: tested where they arise, nearly every
  // warp would run the test for a few of its lanes.
  unsigned int* queued_at = queue + warp * 2 * kQueue;  // (row << 8) | column slot
  unsigned int* queued_hash = queued_at + kQueue;
  unsigned int queued = 0u;
  const unsigned int cap = args.k + kSlack;
  auto test_queued = [&](unsigned int i) {
    const unsigned int e = queued_at[i];
    const unsigned int r = e >> 8, slot = kSize + (e & 0xFFu);
    if (is_member<kEstimate>(tile.s[r], tile.d[r], tile.s[slot], tile.d[slot], args, peak)) {
      const unsigned int at = atomicAdd(&ws[kEmitted], 1u);
      if (at < cap) ws[kCand + at] = queued_hash[i];
    }
  };

  const long long tiles = pair_sweep::tile_count(args.tiles_per_side);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    int row0, col0;
    pair_sweep::tile_origin(t, kSize, row0, col0);
    bool on = false;
    if (tid < 2 * kSize) {
      const int i = tid < kSize ? row0 + tid : col0 + tid - kSize;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, -1.0f), d = s;
      if (i < c && keep[i] == 1) {
        const float sx = src[i], sy = src[c + i], sz = src[2 * c + i];
        const float dx = dst[i], dy = dst[c + i], dz = dst[2 * c + i];
        s = make_float4(sx, sy, sz,
                        __fadd_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
                                  __fmul_rn(sz, sz)));
        d = make_float4(dx, dy, dz,
                        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz)));
        on = true;
      }
      tile.s[tid] = s;
      tile.d[tid] = d;
    }
    const int rows_on = __syncthreads_or(on && tid < kSize);
    const int cols_on = __syncthreads_or(on && tid >= kSize);
    if (!rows_on || !cols_on) continue;  // uniform; nothing reads this tile

    const bool diagonal = row0 == col0;
    float4 cs[J], cd[J];
    int limit[J];
    unsigned int col[J];
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const int slot = lane + 32 * k;
      cs[k] = tile.s[kSize + slot];
      cd[k] = tile.d[kSize + slot];
      limit[k] = cs[k].w < 0.0f ? 0 : (diagonal ? slot : kSize);
      col[k] = static_cast<unsigned int>(col0 + slot);
    }
    for (int r = warp; r < kSize; r += kWarps) {
      const float4 rs = tile.s[r];
      if (rs.w < 0.0f) continue;  // uniform in the warp
      const float4 rd = tile.d[r];
      const unsigned int row_pos = static_cast<unsigned int>(row0 + r) * static_cast<unsigned int>(c);
#pragma unroll
      for (int k = 0; k < J; ++k) {
        if (kMode == kEmit) {
          const unsigned int h = pair_hash(row_pos + col[k], a, b);
          const bool want = r < limit[k] && h >= threshold;
          const unsigned int m = __ballot_sync(0xffffffffu, want);
          if (want) {
            const unsigned int at = queued + __popc(m & ((1u << lane) - 1u));
            queued_at[at] = (static_cast<unsigned int>(r) << 8) | (lane + 32 * k);
            queued_hash[at] = h;
          }
          queued += __popc(m);
          if (queued >= 32u) {
            __syncwarp();
            test_queued(lane);
            const unsigned int rest = queued - 32u;
            const bool moves = static_cast<unsigned int>(lane) < rest;
            const unsigned int e = moves ? queued_at[32 + lane] : 0u;
            const unsigned int eh = moves ? queued_hash[32 + lane] : 0u;
            __syncwarp();
            if (moves) {
              queued_at[lane] = e;
              queued_hash[lane] = eh;
            }
            __syncwarp();
            queued = rest;
          }
          continue;
        }
        if (r >= limit[k]) continue;
        const unsigned int pos = row_pos + col[k];
        if (kMode == kCount) {
          if (is_member<kEstimate>(rs, rd, cs[k], cd[k], args, peak)) {
            ++members;
            atomicAdd(&hist[pair_hash(pos, a, b) >> 20], 1u);
          }
        } else if (kMode == kRefineMid) {
          const unsigned int h = pair_hash(pos, a, b);
          if ((h >> 20) == prefix && is_member<kEstimate>(rs, rd, cs[k], cd[k], args, peak)) {
            atomicAdd(&hist[(h >> 8) & 0xFFFu], 1u);
          }
        }
      }
    }
    if (kMode == kEmit) {
      __syncwarp();
      if (static_cast<unsigned int>(lane) < queued) test_queued(lane);
      queued = 0u;
    }
    __syncthreads();  // the next tile's staging overwrites this one
  }

  if (kMode == kEmit) return;
  if (kMode == kCount) {
    members = __reduce_add_sync(0xffffffffu, members);
    if (lane == 0 && members != 0u) atomicAdd(&block_members, members);
  }
  __syncthreads();
  if (kMode == kCount && tid == 0 && block_members != 0u) atomicAdd(&ws[kMembers], block_members);
  unsigned int* out = ws + (kMode == kCount ? kHist1 : kHist2);
  for (int i = tid; i < kBins; i += kThreads) {
    const unsigned int v = hist[i];
    if (v != 0u) atomicAdd(out + i, v);
  }
}

// One block a pair: the bin of `hist` (nbins, counted from the top) that
// holds the rank-th largest member, and the members in the bins above it.
// Thread t sums the t-th run of nbins / kThreads bins from the top; a scan
// finds the run, and its thread walks it.
__device__ void select_bin(const unsigned int* hist, int nbins, unsigned int rank, int* bin_out,
                           unsigned int* above_out) {
  __shared__ unsigned int warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = nbins / kThreads;
  unsigned int local = 0u;
  for (int q = 0; q < per; ++q) local += hist[nbins - 1 - (tid * per + q)];
  unsigned int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned int before = 0u;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  incl += before;
  const unsigned int excl = incl - local;
  if (excl < rank && rank <= incl) {
    unsigned int acc = excl;
    for (int q = 0; q < per; ++q) {
      const int bin = nbins - 1 - (tid * per + q);
      const unsigned int v = hist[bin];
      if (acc + v >= rank) {
        *bin_out = bin;
        *above_out = acc;
        return;
      }
      acc += v;
    }
  }
}

// The emit threshold of a pair whose k-th largest hash lies in the bin that
// starts at `first`: 256 below it, and not below 0.
__device__ __forceinline__ unsigned int threshold_below(unsigned int first) {
  return first >= static_cast<unsigned int>(kBand) ? first - kBand : 0u;
}

// Level 0 after the count, level 1 after the refine (module comment).
template <int kLevel>
__global__ void __launch_bounds__(kThreads) dense_select_kernel(unsigned int* ws_all,
                                                                long long stride, unsigned int k) {
  __shared__ int bin;
  __shared__ unsigned int above;
  unsigned int* ws = ws_all + stride * blockIdx.x;
  unsigned int rank;
  const unsigned int* hist;
  if (kLevel == 0) {
    if (ws[kMembers] <= k) return;  // every member fits: T stays 0
    rank = k;
    hist = ws + kHist1;
  } else {
    if (ws[kRefine] == 0u) return;
    rank = ws[kRank];
    hist = ws + kHist2;
  }
  if (threadIdx.x == 0) bin = -1;
  __syncthreads();
  int found = -1;
  unsigned int found_above = 0u;
  select_bin(hist, kLevel == 0 ? kTopBins : kMidBins, rank, &found, &found_above);
  if (found >= 0) {
    bin = found;
    above = found_above;
  }
  __syncthreads();
  if (threadIdx.x != 0 || bin < 0) return;
  const unsigned int b = static_cast<unsigned int>(bin);
  if (kLevel == 1) {
    ws[kThreshold] = threshold_below(((ws[kPrefix] << 12) | b) << 8);
    return;
  }
  // At most k - 1 candidates above the bin, the bin's own and 256 below it.
  if (hist[b] + kBand <= static_cast<unsigned int>(kSlack)) {
    ws[kThreshold] = threshold_below(b << 20);
  } else {
    ws[kRefine] = 1u;
    ws[kPrefix] = b;
    ws[kRank] = rank - above;
  }
}

// One block a pair: each candidate's rank by (priority descending, position
// ascending), the first min(members, k) into their slots, then the padding
// and the two counts. Shared memory: the bucket counts and starts, then
// the candidates grouped by bucket.
__global__ void __launch_bounds__(kOrderThreads)
    dense_order_kernel(const unsigned int* ws_all, long long stride, const long long* ab_all, int c,
                       unsigned int k, int pool_cap, long long reduced_cap, long long* red_i_all,
                       long long* red_j_all, long long* red_count, long long* pool_count) {
  extern __shared__ unsigned int order_shared[];
  unsigned int* count = order_shared;                  // [kOrderBuckets]
  unsigned int* start = count + kOrderBuckets;         // [kOrderBuckets]
  unsigned int* grouped = start + kOrderBuckets;       // [k + kSlack]
  __shared__ unsigned int warp_sums[kOrderThreads / 32];

  const int pair = blockIdx.x;
  const unsigned int* ws = ws_all + stride * pair;
  long long* red_i = red_i_all + static_cast<long long>(pool_cap) * pair;
  long long* red_j = red_j_all + static_cast<long long>(pool_cap) * pair;
  const unsigned int a_inverse = inverse_odd(static_cast<unsigned int>(ab_all[2 * pair]) | 1u);
  const unsigned int b = static_cast<unsigned int>(ab_all[2 * pair + 1]);
  const unsigned int cu = static_cast<unsigned int>(c);
  const unsigned int members = ws[kMembers];
  const unsigned int n = min(ws[kEmitted], k + kSlack);
  const unsigned int filled = min(members, k);
  const unsigned int* cand = ws + kCand;
  // Buckets over the candidates' priorities, [T, 2^32], monotone in the
  // priority, so equal priorities share a bucket.
  // priority - T < 2^bits, shifted right to 11 bits (a shift, not a 64-bit division).
  const unsigned long long lo = ws[kThreshold];
  const int bits = 64 - __clzll((1ull << 32) - lo);
  const int shift = bits > kOrderBucketBits ? bits - kOrderBucketBits : 0;
  auto bucket = [&](unsigned int h) {
    const unsigned long long key = static_cast<unsigned long long>(__uint2float_rn(h));
    if (key <= lo) return 0u;
    const unsigned long long q = (key - lo) >> shift;
    return static_cast<unsigned int>(q < kOrderBuckets ? q : kOrderBuckets - 1);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kOrderBuckets; i += kOrderThreads) count[i] = 0u;
  __syncthreads();
  for (unsigned int i = tid; i < n; i += kOrderThreads) atomicAdd(&count[bucket(cand[i])], 1u);
  __syncthreads();
  // start[q] = the candidates in buckets above q: a scan from the top, two
  // buckets a thread.
  constexpr int kPer = kOrderBuckets / kOrderThreads;
  unsigned int local = 0u;
  for (int q = 0; q < kPer; ++q) local += count[kOrderBuckets - 1 - (tid * kPer + q)];
  unsigned int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned int acc = incl - local;
  for (int w = 0; w < warp; ++w) acc += warp_sums[w];
  for (int q = 0; q < kPer; ++q) {
    const int i = kOrderBuckets - 1 - (tid * kPer + q);
    start[i] = acc;
    acc += count[i];
  }
  __syncthreads();
  // Group the candidates by bucket; count[] becomes each bucket's cursor.
  for (unsigned int i = tid; i < n; i += kOrderThreads) {
    const unsigned int h = cand[i];
    const unsigned int q = bucket(h);
    grouped[start[q] + atomicSub(&count[q], 1u) - 1u] = h;
  }
  __syncthreads();
  for (unsigned int t = tid; t < n; t += kOrderThreads) {
    const unsigned int h = grouped[t];
    const float key = __uint2float_rn(h);
    const unsigned int pos = pair_position(h, a_inverse, b);
    const unsigned int q = bucket(h);
    unsigned int end = q == 0 ? n : start[q - 1];  // the bucket below starts where q ends
    unsigned int rank = start[q];
    for (unsigned int f = start[q]; f < end; ++f) {
      const float other = __uint2float_rn(grouped[f]);
      rank += (other > key || (other == key && f != t &&
                               pair_position(grouped[f], a_inverse, b) < pos)) ? 1u : 0u;
    }
    if (rank < filled) {
      red_i[rank] = pos / cu;
      red_j[rank] = pos % cu;
    }
  }
  for (int slot = static_cast<int>(filled) + tid; slot < pool_cap; slot += kOrderThreads) {
    red_i[slot] = 0;
    red_j[slot] = 0;
  }
  if (tid == 0) {
    red_count[pair] = members < reduced_cap ? static_cast<long long>(members) : reduced_cap;
    pool_count[pair] = filled;
  }
}

template <int J, bool kEstimate>
cudaError_t sweep_passes(const Args& args, dim3 grid, unsigned int pairs, cudaStream_t st) {
  dense_sweep_kernel<J, kEstimate, kCount><<<grid, kThreads, 0, st>>>(args);
  dense_select_kernel<0><<<pairs, kThreads, 0, st>>>(args.ws, args.stride, args.k);
  dense_sweep_kernel<J, kEstimate, kRefineMid><<<grid, kThreads, 0, st>>>(args);
  dense_select_kernel<1><<<pairs, kThreads, 0, st>>>(args.ws, args.stride, args.k);
  dense_sweep_kernel<J, kEstimate, kEmit><<<grid, kThreads, 0, st>>>(args);
  return cudaGetLastError();
}

template <bool kEstimate>
cudaError_t run_sweeps(const Args& args, int j, dim3 grid, unsigned int pairs, cudaStream_t st) {
  switch (j) {
    case 4: return sweep_passes<4, kEstimate>(args, grid, pairs, st);
    case 2: return sweep_passes<2, kEstimate>(args, grid, pairs, st);
    default: return sweep_passes<1, kEstimate>(args, grid, pairs, st);
  }
}

}  // namespace

// Words of workspace a pair needs for a pool of k members (k <= 32768).
extern "C" long long dense_init_workspace_words(int k) {
  return static_cast<long long>(kCand) + k + kSlack;
}

// Writes each pair's pool (red_i, red_j: (pairs, pool_cap) int64), red_count
// and pool_count ((pairs,) int64) on `stream`; returns the CUDA error as an
// int (0 on success). src and dst are (pairs, 3, c) contiguous float32, keep
// (pairs, c) int64, ab (pairs, 2) int64, peak (pairs,) int64 or null (known
// scale: the beta test), ws (pairs, stride) 32-bit words that the launch
// zeroes, all device pointers; 1 <= c <= 65536 (positions fit 32 bits),
// 1 <= k <= min(32768, pool_cap), 1 <= pairs <= 65535.
extern "C" int dense_init_launch(const float* src, const float* dst, const long long* keep,
                                 const long long* ab, const long long* peak, int c, int pairs,
                                 float beta, int bins_per_unit, int num_bins, int k, int pool_cap,
                                 long long reduced_cap, unsigned int* ws, long long stride,
                                 long long* red_i, long long* red_j, long long* red_count,
                                 long long* pool_count, void* stream) {
  if (c < 1 || c > 65536 || pairs < 1 || pairs > 65535 || k < 1 || k > kMaxFill ||
      k > pool_cap || stride < dense_init_workspace_words(k) || reduced_cap < 0 ||
      (peak != nullptr && num_bins < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ws, 0, sizeof(unsigned int) * stride * pairs, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const pair_sweep::Plan p = pair_sweep::plan(c, kBlocksPerSM, pairs);
  Args args{src, dst, keep, ab, peak, ws, stride, c, static_cast<unsigned int>(k), beta,
            static_cast<float>(bins_per_unit), num_bins, p.side};
  const dim3 grid(p.grid, pairs);
  err = peak != nullptr ? run_sweeps<true>(args, p.j, grid, pairs, st)
                        : run_sweeps<false>(args, p.j, grid, pairs, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t shared = sizeof(unsigned int) * (2 * kOrderBuckets + k + kSlack);
  // The attribute is the device's: set once a device, to the largest asked.
  static size_t shared_set[kMaxDevices] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (shared > shared_set[device]) {
    err = cudaFuncSetAttribute(dense_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    shared_set[device] = shared;
  }
  dense_order_kernel<<<pairs, kOrderThreads, shared, st>>>(ws, stride, ab, c,
                                                           static_cast<unsigned int>(k), pool_cap,
                                                           reduced_cap, red_i, red_j, red_count,
                                                           pool_count);
  return static_cast<int>(cudaGetLastError());
}
