// Windowed histogram of pair distance ratios over all active pairs i < j,
// and the exact histogram peak of exact_peak_bin in the same launch.
//
// Replaces psulvsb_tpu/ops/pallas_hist.py::_pair_ratio_histogram_impl (the
// Pallas kernel _hist_kernel behind pair_ratio_histogram) and the two
// passes exact_peak_bin makes over it. For each active pair i < j of a
// (3, C) cloud pair:
//   v1 = |s_j - s_i|, v2 = |d_j - d_i|, ratio = v2 / (v1 > 0 ? v1 : 1),
//   fine = max(floor(ratio * bins_per_unit), 0),
//   idx = floor((fine - lo) / stride)  (floor division),
// then idx is clamped into [0, num_bins) (clamp_overflow) or the pair is
// dropped when idx falls outside it. lo comes from device memory or from
// the call.
//
// exact_peak_bin in one pass. Its coarse pass (nc bins of `cs` fine bins,
// the tail clamped) and its fine pass (3 cs fine bins from the coarse
// argmax - 1) both read off one full-resolution pass with lo = 0, stride 1,
// the tail clamped, and (nc + 1) cs + 1 bins (2065 at the defaults): coarse
// bin k < nc - 1 is the sum of full bins [k cs, (k + 1) cs), coarse bin
// nc - 1 the sum of [(nc - 1) cs, end), and the fine window ends at most at
// (nc + 1) cs, below the clamp bin. When asked, the last block to finish
// (a device counter after __threadfence) derives (peak, count, certified)
// with the two-pass rule (pallas_hist.py:317-344), first maximum winning
// every argmax, so the result is the two passes' bit for bit, with no
// second launch and no host read.
//
// A pair axis, the counterpart of jax.vmap over pair_ratio_histogram and
// exact_peak_bin (pallas_call's batching rule adds a leading grid
// dimension): P cloud pairs, (P, 3, C) each cloud, in one launch whose
// grid's second dimension is the pair. Each pair has its own counts, block
// counter and peak, P rows of one buffer the caller zeroed once, and its own
// last block derives its peak; a window's lo is one for all the pairs or
// one a pair (a vmapped lo), read by each pair's blocks. The blocks of
// one pair are a P-th of the grid a single pair gets (at least one), so
// the launch keeps about four blocks per SM whatever P is.
//
// Numerics. Distances by pair_sweep.cuh's dist3 (direct differences, no
// contraction into FMAs, IEEE square root) and an IEEE division, so every
// ratio is bit for bit what the plain PyTorch version (ops/hist.py)
// computes and the counts are equal, not close. Counts are exact integers:
// 32-bit in shared memory (a block sees at most ~2e9 pairs below C = 2^20)
// and 64-bit in device memory (one bin can hold all C(C-1)/2 pairs).
//
// What bounds it on the card. C(C-1)/2 pairs (0.78M at C = 1250, 12.5M at
// C = 5000, 72M at C = 12000) of about 30 floating-point operations each,
// two square roots and one division, over inputs of 28 bytes a point that
// stay in L2: arithmetic, and the shared atomics of hot bins. At the
// front end's C the old fixed 256 x 128 tiles filled 30 of 132 SMs.
//
// Design. pair_sweep.cuh's walk: upper-triangle tiles of T = 32 J points a
// side, T the largest that still gives four tiles per SM, a grid of four
// blocks per SM, a tile's points staged packed in shared memory, J columns
// a lane in registers and rows as broadcast 16-byte loads. Each block keeps
// one shared histogram of up to 4096 32-bit counters for all its tiles, and
// flushes only its nonzero bins, with one 64-bit atomic each, once. A pair
// adds one to its bin with one shared atomic (merging the lanes of a warp
// that share a bin first, with __match_any_sync, was slower on the card at
// every C measured: the peak bins are not hot enough to pay for it).

#include "pair_sweep.cuh"

namespace {

using pair_sweep::kThreads;

constexpr int kBlocksPerSM = 4;  // blocks of the grid, each with its own histogram
constexpr int kMaxBins = 4096;
constexpr int kMaxCoarse = kMaxBins / 2;   // coarse u64 counts reuse the histogram
constexpr float kFineCap = 1073741824.0f;  // 2^30: any larger fine bin is out of every window
constexpr long long kLoLimit = 1LL << 30;  // |lo| beyond 2^30 windows nothing more

struct Peak {
  unsigned int* done;             // block counter, zeroed by the caller; null: no peak
  int coarse_bins, coarse_stride;  // exact_peak_bin's num_bins and stride
  long long* peak;                // peak fine bin
  long long* count;               // its count
  unsigned char* certified;

  // This pair's counter (in its row of counts, rows `row` 64-bit words
  // apart), peak, count and certificate.
  __device__ __forceinline__ Peak of_pair(int pair, long long row) const {
    Peak p = *this;
    p.done = reinterpret_cast<unsigned int*>(reinterpret_cast<long long*>(done) + pair * row);
    p.peak = peak + pair;
    p.count = count + pair;
    p.certified = certified + pair;
    return p;
  }
};

// First maximum over the lanes of a warp: (value, index), lower index on ties.
__device__ __forceinline__ void warp_argmax(unsigned long long& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// exact_peak_bin's rule over the full-resolution counts, by the last block.
__device__ void derive_peak(const unsigned long long* counts, int num_bins, const Peak& p,
                            unsigned long long* coarse) {
  const int nc = p.coarse_bins, cs = p.coarse_stride;
  for (int k = threadIdx.x; k < nc; k += kThreads) {
    const int end = k < nc - 1 ? (k + 1) * cs : num_bins;
    unsigned long long sum = 0;
    for (int f = k * cs; f < end; ++f) sum += __ldcg(counts + f);
    coarse[k] = sum;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  // Coarse argmax.
  unsigned long long best = 0;
  int cpeak = kMaxBins;
  for (int k = lane; k < nc; k += 32) {
    if (cpeak == kMaxBins || coarse[k] > best) {
      best = coarse[k];
      cpeak = k;
    }
  }
  warp_argmax(best, cpeak);
  // Fine argmax over the 3 cs full bins from the coarse argmax - 1.
  const int lo = (cpeak > 0 ? cpeak - 1 : 0) * cs;
  unsigned long long fbest = 0;
  int fpeak = kMaxBins;
  for (int f = lane; f < 3 * cs; f += 32) {
    const unsigned long long v = __ldcg(counts + lo + f);
    if (fpeak == kMaxBins || v > fbest) {
      fbest = v;
      fpeak = f;
    }
  }
  warp_argmax(fbest, fpeak);
  // Certificate: no coarse bin outside the window (the clamp bin is never
  // inside it) holds as much as the fine peak, and the peak is not on the
  // clamp bin.
  unsigned long long outside = 0;
  for (int k = lane; k < nc; k += 32) {
    const bool in_window = (k - cpeak <= 1 && cpeak - k <= 1) && k < nc - 1;
    if (!in_window && coarse[k] > outside) outside = coarse[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, outside, off);
    outside = o > outside ? o : outside;
  }
  if (lane == 0) {
    *p.peak = lo + fpeak;
    *p.count = static_cast<long long>(fbest);
    *p.certified = (outside < (fbest > 0 ? fbest : 1ull)) && cpeak < nc - 1;
  }
}

template <int J, bool kClamp>
__global__ void __launch_bounds__(kThreads)
    pair_ratio_hist_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                           const unsigned char* __restrict__ act, int c, float bins_per_unit,
                           const long long* __restrict__ lo_ptr, long long lo_imm, int lo_step,
                           int stride, int num_bins, int tiles_per_side, long long row,
                           unsigned long long* __restrict__ counts, const Peak all_peaks) {
  constexpr int kSize = pair_sweep::Tile<J>::kSize;
  __shared__ __align__(8) unsigned int hist[kMaxBins];
  __shared__ pair_sweep::Tile<J> points;
  __shared__ bool is_last;

  // This block's pair: its clouds, mask, counts and peak.
  const int pair = blockIdx.y;
  src += 3LL * c * pair;
  dst += 3LL * c * pair;
  if (act != nullptr) act += static_cast<long long>(c) * pair;
  counts += row * pair;
  const Peak peak = all_peaks.done == nullptr ? all_peaks : all_peaks.of_pair(pair, row);

  const int tid = threadIdx.x;
  for (int k = tid; k < num_bins; k += kThreads) hist[k] = 0u;
  long long lo64 = lo_ptr != nullptr ? lo_ptr[static_cast<long long>(pair) * lo_step] : lo_imm;
  lo64 = lo64 < -(kLoLimit - 1) ? -(kLoLimit - 1) : (lo64 > kLoLimit + 1 ? kLoLimit + 1 : lo64);
  const int lo = static_cast<int>(lo64);  // fine - lo stays inside int32
  __syncthreads();

  const long long tiles = pair_sweep::tile_count(tiles_per_side);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int row0, col0;
    pair_sweep::tile_origin(tile, kSize, row0, col0);
    pair_sweep::stage(points, src, dst, act, c, row0, col0);
    __syncthreads();
    pair_sweep::sweep(points, row0 == col0,
                      [&](int r, const float4& a, const float4& b,
                          const pair_sweep::Columns<J>& cols) {
#pragma unroll
      for (int k = 0; k < J; ++k) {
        const float v1 = pair_sweep::dist3(cols.s[k], a);
        const float v2 = pair_sweep::dist3(cols.d[k], b);
        const float ratio = __fdiv_rn(v2, v1 > 0.0f ? v1 : 1.0f);
        float f = floorf(__fmul_rn(ratio, bins_per_unit));
        f = fminf(fmaxf(f, 0.0f), kFineCap);
        const int d = static_cast<int>(f) - lo;
        int idx = d;
        if (stride != 1) {  // floor division
          idx = d / stride;
          if (d % stride != 0 && d < 0) --idx;
        }
        bool valid = r < cols.limit[k];
        if (kClamp) {
          idx = min(max(idx, 0), num_bins - 1);
        } else {
          valid = valid && idx >= 0 && idx < num_bins;
        }
        if (valid) atomicAdd(&hist[idx], 1u);
      }
    });
    __syncthreads();  // the tile is read no more: the next one may be staged
  }

  for (int k = tid; k < num_bins; k += kThreads) {
    const unsigned int h = hist[k];
    if (h != 0u) atomicAdd(&counts[k], static_cast<unsigned long long>(h));
  }
  if (peak.done == nullptr) return;  // uniform: no peak asked for

  // The last block to finish derives the peak from every block's counts.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(peak.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  derive_peak(counts, num_bins, peak, reinterpret_cast<unsigned long long*>(hist));
}

template <int J>
void launch(bool clamp, dim3 grid, cudaStream_t st, const float* src, const float* dst,
            const unsigned char* act, int c, float bins_per_unit, const long long* lo_ptr,
            long long lo_imm, int lo_step, int stride, int num_bins, int tiles_per_side,
            long long row, unsigned long long* counts, const Peak& peak) {
  if (clamp) {
    pair_ratio_hist_kernel<J, true><<<grid, kThreads, 0, st>>>(
        src, dst, act, c, bins_per_unit, lo_ptr, lo_imm, lo_step, stride, num_bins,
        tiles_per_side, row, counts, peak);
  } else {
    pair_ratio_hist_kernel<J, false><<<grid, kThreads, 0, st>>>(
        src, dst, act, c, bins_per_unit, lo_ptr, lo_imm, lo_step, stride, num_bins,
        tiles_per_side, row, counts, peak);
  }
}

}  // namespace

// Adds the histogram of the active pairs i < j of each of `pairs` cloud
// pairs to its row of `counts` (rows of num_bins 64-bit integers, `row`
// apart, that the caller zeroed) on `stream`; returns cudaGetLastError() as
// an int (0 on success). src and dst are (pairs, 3, c) contiguous float32,
// act (pairs, c) bytes of 0/1 or null (all active); the window starts at
// lo_ptr[pair * lo_step] (int64 on the device: lo_step 0 shares one lo, 1
// reads a lo a pair) or, when lo_ptr is null, at lo_imm, with stride >= 1.
// With done non-null (a zeroed uint32 on the device in each row's slot), the
// window must be exact_peak_bin's full pass (lo 0, stride 1, clamped,
// num_bins = (coarse_bins + 1) coarse_stride + 1), and each pair's last block
// writes its peak fine bin to peak_out[pair], its count to count_out[pair]
// and its certificate to certified[pair].
extern "C" int pair_ratio_hist_launch(const float* src, const float* dst, const unsigned char* act,
                                      int c, float bins_per_unit, const long long* lo_ptr,
                                      long long lo_imm, int lo_step, int stride, int num_bins,
                                      int clamp_overflow, int pairs, long long row,
                                      unsigned long long* counts, unsigned int* done,
                                      int coarse_bins, int coarse_stride, long long* peak_out,
                                      long long* count_out, unsigned char* certified,
                                      void* stream) {
  if (c < 0 || c > pair_sweep::kMaxC || num_bins < 1 || num_bins > kMaxBins || stride < 1 ||
      pairs < 1 || pairs > 65535 || (pairs > 1 && row < num_bins)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (done != nullptr &&
      (coarse_bins < 2 || coarse_bins > kMaxCoarse || coarse_stride < 1 ||
       (coarse_bins + 1) * coarse_stride + 1 != num_bins || !clamp_overflow || stride != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pair_sweep::Plan p = pair_sweep::plan(c, kBlocksPerSM, pairs);
  const dim3 grid(p.grid, pairs);
  const int j = p.j, side = p.side;
  const Peak peak{done, coarse_bins, coarse_stride, peak_out, count_out, certified};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool clamp = clamp_overflow != 0;
  switch (j) {
    case 4:
      launch<4>(clamp, grid, st, src, dst, act, c, bins_per_unit, lo_ptr, lo_imm, lo_step,
                stride, num_bins, side, row, counts, peak);
      break;
    case 2:
      launch<2>(clamp, grid, st, src, dst, act, c, bins_per_unit, lo_ptr, lo_imm, lo_step,
                stride, num_bins, side, row, counts, peak);
      break;
    default:
      launch<1>(clamp, grid, st, src, dst, act, c, bins_per_unit, lo_ptr, lo_imm, lo_step,
                stride, num_bins, side, row, counts, peak);
  }
  return static_cast<int>(cudaGetLastError());
}
