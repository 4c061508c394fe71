// The local batch around the rotation estimator: the basic sets' pick before
// it and the acceptance after it, as two kernels of one library.
//
// Replaces no Pallas kernel. In the JAX package (psulvsb_tpu/solver/
// psulvsb.py:815 `_local_stage`: `eval_batch_pallas` :959 and `batch_body`
// :1064, XLA around the Pallas GNC kernel) and in the port before this file
// (solver/psulvsb.py `_local_round`), a local batch on the endpoint route
// is about 260 small XLA / PyTorch operations around the one GNC kernel:
// the Gumbel top-k of each hypothesis' basic set and its gathers, the TIMs
// and the known-scale test, the dedup sort of the endpoints, two stable
// sorts and three cumsums of `max_stabbing`, the scoring of the batch and
// of the warm baseline, the similarity test and the serial acceptance
// replayed by cummax and selects. Each of those is a launch of 2-5 us on an
// H100 for microseconds of work; a batch costs about 0.54 ms. Here a batch
// is three launches: `local_pick_kernel`, the rotation estimator (gnc_batch,
// or the "eigh" / FGR loops), `local_accept_kernel`.
//
// Contract (ops/local.py, `local_pick` and `local_accept`, whose plain
// versions are the solver's own code).
//
// local_pick_kernel, a block a hypothesis (blockIdx.x) and pair
// (blockIdx.y): the hypothesis' keys over the S sampled slots (float32
// Gumbel keys, or int64 draws d taken as -log(-log(max(u, tiny))) with
// u = (d >> 38) 2^-24, the float32 ops of the plain version), -inf where
// the slot is not valid; the top bcap slots by (key descending, slot
// ascending), the order torch.topk(sorted=True) gives on the card; rank r
// is selected when r < min(clamp(floor(f32(count) * b_rate), 1, bcap),
// n_valid); b_i, b_j the selected slots' endpoints (0 elsewhere); the TIMs
// src[:, b_j] - src[:, b_i] and dst's likewise; at known scale the test
// |‖src_t‖ - ‖dst_t‖| <= beta on the selected columns and the GNC noise
// bounds 2 nb. It also writes use_warm = !first_time and zeroes the
// accept kernel's ticket.
//
// local_accept_kernel, a block a hypothesis and pair, and the last block of
// a pair to finish replays the batch:
//   1. translation over the deduplicated endpoints of the hypothesis'
//      rotation inliers (robust/translation.py `solve_translation_endpoints`):
//      per axis, the max interval stabbing of x = dst - s R src over
//      [x - beta, x + beta] with the warm slot, the first strict maximum of
//      the events sorted by (value, starts before ends, position), the
//      estimate the mean of the stabbed values; inliers within beta on all
//      three axes; the translation t / s;
//   2. the score ‖dst - s (R src + t)‖² <= thr² over the sampled points, of
//      the hypothesis and (block 0) of the warm state;
//   3. the similarity test against the warm state;
//   4. in the pair's last block: the serial acceptance of `step` (the
//      running best, pro_t, the early accept, the stop by confidence or
//      stagnation, the winner, the local_r bump, pro_local, escalate, done)
//      and the new state; with the stage masks tracked, the winner's.
// The blocks of a pair meet through a ticket: each adds one after its
// results are fenced; the block that takes the last ticket reads the
// others' results and puts the ticket back to 0. No host read and no
// allocation, so both kernels capture into a CUDA graph.
//
// What bounds them on the card. Pick: S keys and a bitonic sort of S_pad
// keys a hypothesis (S = 2048: 66 stages of 1024 compare-swaps), bcap
// gathers of 6 floats. Accept: a bitmap over C, at most 2 bcap + 1 values
// a hypothesis and axis in a bitonic sort, C scored points a hypothesis
// and the baseline. The bytes are the points (24 a point, in L2), the
// basic sets (about 30 bytes a TIM) and the masks; the work is microseconds
// of a few SMs; the bound is launch and synchronisation latency (each
// bitonic stage is a block barrier), not bandwidth or arithmetic.
//
// Shared memory: the pick's sort takes 8 S_pad bytes, the accept block a
// bitmap of C bits, the endpoint list and its values (16 bytes an entry)
// and the sort of up to three axes at once (8 bytes an entry and axis).
// Where a size passes the card's shared memory a block, the same arrays
// lie in a global workspace a block (the front doors ask
// `local_*_global_bytes`), so no setting is refused; only speed differs.
//
// Numerics. The keys, the top-k order, the basic sets, the TIMs and the
// known-scale test are bit for bit the plain version's (IEEE float32 ops in
// its order, no contraction). The stabbing sums its values in a tree
// rather than the plain version's cumsum, and the products R p in FMA
// chains rather than cuBLAS's order, so a translation differs in its last
// bits and a point within float32 rounding of a threshold may fall the
// other way; the acceptance itself is integer logic and the plain
// version's float32 expressions.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr unsigned int kUnitShift = 38;  // an int64 draw's top 24 of 62 bits
constexpr unsigned int kWarmPos = 0xFFFFFFFFu;  // the warm slot sorts after every point
constexpr int kCache = 64;  // hypotheses whose results the replay reads from shared memory

__device__ __forceinline__ unsigned int ordered(float f) {
  f = __fadd_rn(f, 0.0f);  // -0 -> +0: equal values order by position
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ float gumbel_of_draw(long long d) {
  float u = __fmul_rn(static_cast<float>(static_cast<unsigned long long>(d) >> kUnitShift),
                      5.9604644775390625e-08f);
  u = fmaxf(u, 1.17549435e-38f);
  return -logf(-logf(u));
}

// Squared norm as the plain version sums it: rounded squares, added in order.
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// One stage (level k, distance j) of an ascending bitonic sort of `segs`
// segments of n keys, through shared (or global) memory, then a barrier.
__device__ void bitonic_stage(u64* a, int n, int segs, int k, int j) {
  const int half = n >> 1;
  const int hshift = __ffs(half) - 1;
  for (int t = threadIdx.x; t < half * segs; t += kThreads) {
    const int seg = t >> hshift;
    const int i = t & (half - 1);
    const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
    u64* s = a + static_cast<size_t>(seg) * n;
    const u64 x = s[lo], y = s[lo + j];
    if ((x > y) == ((lo & k) == 0)) {
      s[lo] = y;
      s[lo + j] = x;
    }
  }
  __syncthreads();
}

// The stages of distance 32 down to 1 of level k (all levels up to 64 when
// k == 0) on each 64-key chunk, a warp a chunk, in registers: a lane holds
// keys lane and lane + 32 of its chunk and meets its partners by shuffles,
// so these stages need no block barrier. n (a power of two, >= 64) is the
// segment length, which sets each key's direction.
__device__ void bitonic_warp(u64* a, int n, int total, int k) {
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < total / 64; c += kWarps) {
    const int e0 = c * 64 + lane;
    u64 x[2] = {a[e0], a[e0 + 32]};
    for (int kk = k == 0 ? 2 : k; kk <= (k == 0 ? 64 : k); kk <<= 1) {
      // A key's direction: its level-kk block's bit of its place in its segment.
      const bool up[2] = {((e0 & (n - 1)) & kk) == 0, (((e0 + 32) & (n - 1)) & kk) == 0};
      for (int j = kk >= 64 ? 32 : kk >> 1; j > 0; j >>= 1) {
        if (j == 32) {  // kk >= 64: both keys of the lane go the same way
          const u64 lo = x[0] < x[1] ? x[0] : x[1], hi = x[0] < x[1] ? x[1] : x[0];
          x[0] = up[0] ? lo : hi;
          x[1] = up[0] ? hi : lo;
          continue;
        }
        for (int q = 0; q < 2; ++q) {
          const u64 y = __shfl_xor_sync(0xFFFFFFFFu, x[q], j);
          const bool keep_min = ((lane & j) == 0) == up[q];
          x[q] = keep_min ? (x[q] < y ? x[q] : y) : (x[q] < y ? y : x[q]);
        }
      }
    }
    a[e0] = x[0];
    a[e0 + 32] = x[1];
  }
  __syncthreads();
}

// Ascending bitonic sort of `segs` segments of n (a power of two) keys each:
// the stages of distance 64 and more through memory with a block barrier
// each, those below in registers a warp a chunk.
__device__ void bitonic_sort(u64* a, int n, int segs) {
  if (n < 64) {
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) bitonic_stage(a, n, segs, k, j);
    }
    return;
  }
  bitonic_warp(a, n, n * segs, 0);
  for (int k = 128; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) bitonic_stage(a, n, segs, k, j);
    bitonic_warp(a, n, n * segs, k);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_down_sync(0xFFFFFFFFu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Block-wide sums and maxima through `scratch` (kWarps words); every thread
// gets the result.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = lane < kWarps ? scratch[lane] : T(0);
  r = warp_sum(r);
  r = __shfl_sync(0xFFFFFFFFu, r, 0);
  return r;
}

__device__ u64 block_max(u64 v, u64* scratch) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  u64 r = lane < kWarps ? scratch[lane] : 0ull;
  r = warp_max(r);
  return __shfl_sync(0xFFFFFFFFu, r, 0);
}

// Exclusive prefix of v over the block; `total` gets the sum.
__device__ int block_exclusive(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int w = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += w;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? scratch[lane] : 0;
    int si = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int w = __shfl_up_sync(0xFFFFFFFFu, si, o);
      if (lane >= o) si += w;
    }
    if (lane < kWarps) scratch[lane] = si - s;
    if (lane == 31) scratch[kWarps] = si;
  }
  __syncthreads();
  *total = scratch[kWarps];
  return scratch[warp] + inc - v;
}

__host__ __device__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int shared_limit(int device) {
  static int limit[kMaxDevices] = {};
  if (limit[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
      return 48 * 1024;
    limit[device] = v - 2048;  // the kernels' static shared arrays
  }
  return limit[device];
}

cudaError_t allow_shared(const void* fn, size_t bytes, size_t* set) {
  if (bytes <= 48 * 1024 || bytes <= *set) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *set = bytes;
  return err;
}

// ---- pick -------------------------------------------------------------------

struct PickArgs {
  const float* keys_f;      // (P, B, S) Gumbel keys, or null
  const long long* keys_d;  // (P, B, S) int64 draws, or null
  const long long* s_i;     // (P, S)
  const long long* s_j;
  const bool* s_ok;
  const long long* s_count;  // (P,)
  const float* b_rate;       // (P,)
  const float* src;          // (P, 3, C)
  const float* dst;
  const bool* first_time;  // (P,)
  int batch, s, s_pad, bcap, c, known;
  float beta, noise2;
  long long* b_i;  // (P, B, bcap)
  long long* b_j;
  bool* sel_ok;
  float* src_t;  // (P, B, 3, bcap)
  float* dst_t;
  bool* sc_inl;     // (P, B, bcap), known scale
  float* noise;     // (P, B), known scale
  float* scale;     // (P, B), known scale: 1
  bool* use_warm;   // (P,)
  int* ticket;      // (P,)
  u64* global_buf;  // (P B, s_pad), or null: shared memory
};

__global__ void __launch_bounds__(kThreads) local_pick_kernel(PickArgs a) {
  extern __shared__ u64 dyn[];
  __shared__ int red[kWarps + 1];
  const int h = blockIdx.x, p = blockIdx.y, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(p) * a.batch + h;
  u64* buf = a.global_buf != nullptr ? a.global_buf + row * a.s_pad : dyn;
  const size_t kbase = row * a.s;
  const size_t sbase = static_cast<size_t>(p) * a.s;

  int finite = 0;
  for (int i = tid; i < a.s_pad; i += kThreads) {
    u64 v = ~0ull;
    if (i < a.s) {
      float key = -INFINITY;
      if (a.s_ok[sbase + i]) {
        key = a.keys_f != nullptr ? a.keys_f[kbase + i] : gumbel_of_draw(a.keys_d[kbase + i]);
      }
      finite += key > -INFINITY;
      v = (static_cast<u64>(~ordered(key)) << 32) | static_cast<unsigned int>(i);
    }
    buf[i] = v;
  }
  const int n_finite = block_sum(finite, red);
  __syncthreads();
  bitonic_sort(buf, a.s_pad, 1);

  const long long count = a.s_count[p];
  long long choose = static_cast<long long>(floorf(__fmul_rn(static_cast<float>(count), a.b_rate[p])));
  choose = choose < 1 ? 1 : (choose > a.bcap ? a.bcap : choose);
  const long long n_valid = n_finite < a.bcap ? n_finite : a.bcap;
  choose = choose < n_valid ? choose : n_valid;

  const float* src = a.src + static_cast<size_t>(p) * 3 * a.c;
  const float* dst = a.dst + static_cast<size_t>(p) * 3 * a.c;
  for (int r = tid; r < a.bcap; r += kThreads) {
    const unsigned int slot = static_cast<unsigned int>(buf[r] & 0xFFFFFFFFull);
    const bool sel = r < choose;
    const long long bi = sel ? a.s_i[sbase + slot] : 0;
    const long long bj = sel ? a.s_j[sbase + slot] : 0;
    const size_t o = row * a.bcap + r;
    a.b_i[o] = bi;
    a.b_j[o] = bj;
    a.sel_ok[o] = sel;
    float sv[3], dv[3];
    for (int ax = 0; ax < 3; ++ax) {
      sv[ax] = __fsub_rn(src[ax * a.c + bj], src[ax * a.c + bi]);
      dv[ax] = __fsub_rn(dst[ax * a.c + bj], dst[ax * a.c + bi]);
      a.src_t[(row * 3 + ax) * a.bcap + r] = sv[ax];
      a.dst_t[(row * 3 + ax) * a.bcap + r] = dv[ax];
    }
    if (a.known) {
      const float v1 = __fsqrt_rn(sq3(sv[0], sv[1], sv[2]));
      const float v2 = __fsqrt_rn(sq3(dv[0], dv[1], dv[2]));
      a.sc_inl[o] = sel && fabsf(__fsub_rn(v1, v2)) <= a.beta;
    }
  }
  if (tid == 0) {
    if (a.known) {
      a.noise[row] = a.noise2;
      a.scale[row] = 1.0f;
    }
    if (h == 0) {
      a.use_warm[p] = !a.first_time[p];
      a.ticket[p] = 0;
    }
  }
}

// ---- accept -----------------------------------------------------------------

struct AcceptArgs {
  const float* src;  // (P, 3, C)
  const float* dst;
  const bool* s_pts;        // (P, C)
  const long long* b_i;     // (P, B, bcap)
  const long long* b_j;
  const bool* rot_inl;      // (P, B, bcap)
  const float* rots;        // (P, B, 3, 3)
  const float* scale;       // (P, B), or null: 1
  const float* warm_scale;  // (P,)
  const float* warm_rot;    // (P, 3, 3)
  const float* warm_trans;  // (P, 3)
  const bool* first_time;   // (P,)
  const long long* best_count;  // (P,) each
  const long long* local_r;
  const long long* hypotheses;
  const bool* escalate;
  const bool* extras_valid;
  const long long* host_r;
  const float* thr;
  // The stage masks (null: not tracked): the batch's scale inliers (P, B,
  // bcap) and the state's b_i, b_j, scale and rotation inliers (P, bcap),
  // translation inliers and points (P, C).
  const bool* sc_inl;
  const long long* ex_b_i;
  const long long* ex_b_j;
  const bool* ex_sc;
  const bool* ex_rot;
  const bool* ex_tinl;
  const bool* ex_tpts;
  int batch, bcap, c, npad_max, keys_cap;
  float beta, scale_noise, trans_noise, rot_similar, stagn_min, local_conf;
  long long local_max_iter;
  int* ticket;  // (P,), 0 at the launch
  // The blocks' results: count, similar, translation; the baseline a pair;
  // the masks a hypothesis when tracked.
  long long* ws_count;
  int* ws_sim;
  float* ws_trans;
  long long* ws_base;
  bool* ws_tinl;
  bool* ws_tpts;
  unsigned char* global_scratch;  // null: shared memory
  long long scratch_stride;
  // The new state (P,) each, and the tracked masks.
  float* o_scale;
  float* o_rot;
  float* o_trans;
  long long* o_best_count;
  long long* o_local_r;
  float* o_pro_local;
  long long* o_hypotheses;
  bool* o_escalate;
  bool* o_done;
  bool* o_extras_valid;
  long long* o_b_i;
  long long* o_b_j;
  bool* o_sc;
  bool* o_rot_inl;
  bool* o_tinl;
  bool* o_tpts;
};

// Bytes a block's scratch takes: the sort keys, the values of the three
// axes and the positions of the endpoint list, the bitmap.
size_t accept_scratch_bytes(int bcap, int c, int* npad_max, int* keys_cap, int shared) {
  const int nmax = 2 * bcap + 1;
  *npad_max = next_pow2(nmax);
  const size_t rest = static_cast<size_t>(nmax) * 16 + static_cast<size_t>((c + 31) / 32) * 4;
  const size_t three = static_cast<size_t>(3) * *npad_max * 8 + rest;
  if (three <= static_cast<size_t>(shared)) {
    *keys_cap = 3 * *npad_max;
    return three;
  }
  *keys_cap = *npad_max;
  return static_cast<size_t>(*npad_max) * 8 + rest;
}

// The score of s (R p + t) over the sampled points.
__device__ int score_points(const float* src, const float* dst, const bool* pts, int c,
                            float s, const float* R, const float* t, float thr2) {
  int n = 0;
  for (int q = threadIdx.x; q < c; q += kThreads) {
    if (!pts[q]) continue;
    const float x = src[q], y = src[c + q], z = src[2 * c + q];
    float d[3];
    for (int ax = 0; ax < 3; ++ax) {
      const float rp = fmaf(R[3 * ax + 2], z, fmaf(R[3 * ax + 1], y, __fmul_rn(R[3 * ax], x)));
      d[ax] = __fsub_rn(dst[ax * c + q], __fmul_rn(s, __fadd_rn(rp, t[ax])));
    }
    n += sq3(d[0], d[1], d[2]) <= thr2;
  }
  return n;
}

__global__ void __launch_bounds__(kThreads) local_accept_kernel(AcceptArgs a) {
  extern __shared__ u64 dyn[];
  __shared__ u64 red64[kWarps];
  __shared__ int red32[kWarps + 1];
  __shared__ float redf[kWarps];
  __shared__ float est[3];
  __shared__ float Rs[9];
  __shared__ int last;
  const int h = blockIdx.x, p = blockIdx.y, tid = threadIdx.x;
  const int B = a.batch, L = a.bcap, C = a.c;
  const size_t row = static_cast<size_t>(p) * B + h;
  const int nmax = 2 * L + 1;
  const int words = (C + 31) / 32;

  unsigned char* base = a.global_scratch != nullptr
                            ? a.global_scratch + row * a.scratch_stride
                            : reinterpret_cast<unsigned char*>(dyn);
  u64* keys = reinterpret_cast<u64*>(base);
  float* xv = reinterpret_cast<float*>(keys + a.keys_cap);  // (3, nmax)
  unsigned int* pos = reinterpret_cast<unsigned int*>(xv + 3 * nmax);
  unsigned int* bits = pos + nmax;

  const float* src = a.src + static_cast<size_t>(p) * 3 * C;
  const float* dst = a.dst + static_cast<size_t>(p) * 3 * C;
  const bool* pts = a.s_pts + static_cast<size_t>(p) * C;
  const float s = a.scale != nullptr ? a.scale[row] : 1.0f;
  if (tid < 9) Rs[tid] = a.rots[row * 9 + tid];
  const bool ft = a.first_time[p];
  const bool use_warm = !ft;

  // 1. The endpoints of the rotation inliers, deduplicated, ascending.
  for (int w = tid; w < words; w += kThreads) bits[w] = 0u;
  __syncthreads();
  for (int l = tid; l < L; l += kThreads) {
    if (!a.rot_inl[row * L + l]) continue;
    const long long i = a.b_i[row * L + l], j = a.b_j[row * L + l];
    atomicOr(&bits[i >> 5], 1u << (i & 31));
    atomicOr(&bits[j >> 5], 1u << (j & 31));
  }
  __syncthreads();
  int n = 0;
  for (int w0 = 0; w0 < words; w0 += kThreads) {
    const int w = w0 + tid;
    unsigned int word = w < words ? bits[w] : 0u;
    int chunk = 0;
    const int off = block_exclusive(__popc(word), red32, &chunk) + n;
    for (int k = 0; word != 0u; ++k) {
      const int b = __ffs(word) - 1;
      word &= word - 1u;
      pos[off + k] = static_cast<unsigned int>(w * 32 + b);
    }
    n += chunk;
  }
  __syncthreads();

  // 2. x = dst - s R src at each endpoint, and the warm slot.
  for (int k = tid; k < n; k += kThreads) {
    const unsigned int q = pos[k];
    const float x = src[q], y = src[C + q], z = src[2 * C + q];
    for (int ax = 0; ax < 3; ++ax) {
      const float rp = fmaf(Rs[3 * ax + 2], z, fmaf(Rs[3 * ax + 1], y, __fmul_rn(Rs[3 * ax], x)));
      xv[ax * nmax + k] = __fsub_rn(dst[ax * C + q], __fmul_rn(s, rp));
    }
  }
  const int nn = n + (use_warm ? 1 : 0);
  if (use_warm && tid < 3) {
    xv[tid * nmax + n] = a.warm_trans[static_cast<size_t>(p) * 3 + tid];
    if (tid == 0) pos[n] = kWarmPos;
  }
  __syncthreads();

  // 3. Per axis, the max interval stabbing.
  if (nn == 0) {
    // No active value: the plain version's first sorted slot, point 0.
    if (tid < 3) {
      const float rp = fmaf(Rs[3 * tid + 2], src[2 * C],
                            fmaf(Rs[3 * tid + 1], src[C], __fmul_rn(Rs[3 * tid], src[0])));
      est[tid] = __fsub_rn(dst[tid * C], __fmul_rn(s, rp));
    }
  } else {
    const int npad = next_pow2(nn);
    const int conc = a.keys_cap / npad >= 3 ? 3 : 1;
    for (int a0 = 0; a0 < 3; a0 += conc) {
      const int na = 3 - a0 < conc ? 3 - a0 : conc;
      for (int t = tid; t < na * npad; t += kThreads) {
        const int seg = t / npad, i = t - seg * npad;
        keys[t] = i < nn ? (static_cast<u64>(ordered(xv[(a0 + seg) * nmax + i])) << 32) | pos[i]
                         : ~0ull;
      }
      __syncthreads();
      bitonic_sort(keys, npad, na);
      for (int seg = 0; seg < na; ++seg) {
        const u64* sk = keys + static_cast<size_t>(seg) * npad;
        u64 best = 0ull;
        for (int r = tid; r < nn; r += kThreads) {
          const float e = __fadd_rn(unordered(static_cast<unsigned int>(sk[r] >> 32)), a.beta);
          int lo = r + 1, hi = nn;  // the starts at or below e: [0, ub)
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__fsub_rn(unordered(static_cast<unsigned int>(sk[mid] >> 32)), a.beta) <= e) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          const u64 cand = (static_cast<u64>(lo - r) << 32) | (0xFFFFFFFFu - static_cast<unsigned int>(r));
          best = cand > best ? cand : best;
        }
        best = block_max(best, red64);
        const int count = static_cast<int>(best >> 32);
        const int r0 = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(best & 0xFFFFFFFFull));
        float part = 0.0f;
        for (int r = r0 + tid; r < r0 + count; r += kThreads) {
          part = __fadd_rn(part, unordered(static_cast<unsigned int>(sk[r] >> 32)));
        }
        const float sum = block_sum(part, redf);
        if (tid == 0) est[a0 + seg] = __fdiv_rn(sum, static_cast<float>(count));
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // 4. Translation inliers, the translation, the score and the similarity.
  bool* tinl = a.ws_tinl != nullptr ? a.ws_tinl + row * C : nullptr;
  bool* tpts = a.ws_tpts != nullptr ? a.ws_tpts + row * C : nullptr;
  if (tinl != nullptr) {
    for (int q = tid; q < C; q += kThreads) {
      tpts[q] = (bits[q >> 5] >> (q & 31)) & 1u;
      tinl[q] = false;
    }
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) {
      bool in = true;
      for (int ax = 0; ax < 3; ++ax) {
        in = in && fabsf(__fsub_rn(xv[ax * nmax + k], est[ax])) <= a.beta;
      }
      if (in) tinl[pos[k]] = true;
    }
  }
  const float inv_s = __fdiv_rn(1.0f, fmaxf(s, 1e-30f));
  float trans[3];
  for (int ax = 0; ax < 3; ++ax) trans[ax] = __fmul_rn(est[ax], inv_s);
  const float thr = *a.thr;
  const float thr2 = __fmul_rn(thr, thr);
  const int count = block_sum(score_points(src, dst, pts, C, s, Rs, trans, thr2), red32);
  if (h == 0) {
    long long base_count = -1;
    if (!ft) {
      const float* wr = a.warm_rot + static_cast<size_t>(p) * 9;
      const float* wt = a.warm_trans + static_cast<size_t>(p) * 3;
      base_count = block_sum(score_points(src, dst, pts, C, a.warm_scale[p], wr, wt, thr2), red32);
    }
    if (tid == 0) a.ws_base[p] = base_count;
  }
  if (tid == 0) {
    const float* wr = a.warm_rot + static_cast<size_t>(p) * 9;
    const float* wt = a.warm_trans + static_cast<size_t>(p) * 3;
    float tr = 0.0f;
    for (int k = 0; k < 9; ++k) tr = fmaf(wr[k], Rs[k], tr);
    const float cosv = fminf(fmaxf(__fdiv_rn(__fsub_rn(tr, 1.0f), 2.0f), -1.0f), 1.0f);
    float dt2 = 0.0f;
    for (int ax = 0; ax < 3; ++ax) {
      const float d = __fsub_rn(wt[ax], trans[ax]);
      dt2 = __fadd_rn(dt2, __fmul_rn(d, d));
    }
    const bool sim = fabsf(__fsub_rn(a.warm_scale[p], s)) <= a.scale_noise &&
                     fabsf(acosf(cosv)) <= a.rot_similar && __fsqrt_rn(dt2) <= a.trans_noise;
    a.ws_count[row] = count;
    a.ws_sim[row] = sim;
    for (int ax = 0; ax < 3; ++ax) a.ws_trans[row * 3 + ax] = trans[ax];
  }

  // 5. The pair's last block replays the batch.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.ticket[p], 1) == B - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The blocks' counts and flags, read once in parallel (the first kCache).
  __shared__ long long cached_count[kCache];
  __shared__ int cached_sim[kCache];
  const size_t r0 = static_cast<size_t>(p) * B;
  if (tid < B && tid < kCache) {
    cached_count[tid] = __ldcg(&a.ws_count[r0 + tid]);
    cached_sim[tid] = __ldcg(&a.ws_sim[r0 + tid]);
  }
  int sampled = 0;
  for (int q = tid; q < C; q += kThreads) sampled += pts[q];
  sampled = block_sum(sampled, red32);
  __shared__ int sel_idx;
  __shared__ bool keep_new;
  if (tid == 0) {
    const auto count_of = [&](int t) {
      return t < kCache ? cached_count[t] : __ldcg(&a.ws_count[r0 + t]);
    };
    const auto sim_of = [&](int t) {
      return t < kCache ? cached_sim[t] : __ldcg(&a.ws_sim[r0 + t]);
    };
    const long long baseline = ft ? -1 : __ldcg(&a.ws_base[p]);
    const float nsp = static_cast<float>(sampled > 1 ? sampled : 1);
    const long long lr0 = a.local_r[p];
    long long run = LLONG_MIN;
    int stop_t = -1, sim_t = -1;
    float pro = 0.0f, pro_stop = 0.0f;
    bool conf = false, stagn = false, conf_stop = false, stagn_stop = false;
    for (int t = 0; t < B; ++t) {
      const long long ct = count_of(t);
      const long long m = ct > baseline ? ct : baseline;
      run = m > run ? m : run;
      const long long lr = lr0 + t + 1;
      const float w = __fdiv_rn(static_cast<float>(run), nsp);
      pro = __fsub_rn(1.0f, powf(__fsub_rn(1.0f, w), static_cast<float>(lr)));
      stagn = lr >= a.local_max_iter && pro <= a.stagn_min;
      conf = pro > a.local_conf;
      if (stop_t < 0 && (conf || stagn)) {
        stop_t = t;
        pro_stop = pro;
        conf_stop = conf;
        stagn_stop = stagn;
      }
      if (sim_t < 0 && !ft && sim_of(t)) sim_t = t;
    }
    const bool stop_any = stop_t >= 0;
    if (!stop_any) {
      stop_t = B - 1;
      pro_stop = pro;
      conf_stop = conf;
      stagn_stop = stagn;
    }
    const bool sim_any = sim_t >= 0;
    if (!sim_any) sim_t = 0;
    const bool cut_sim = sim_any && sim_t <= stop_t;
    const int cut = cut_sim ? sim_t : stop_t;
    int best_h = 0;
    long long best = count_of(0);
    for (int t = 1; t <= cut; ++t) {
      const long long ct = count_of(t);
      if (ct > best) {
        best = ct;
        best_h = t;
      }
    }
    const bool take = best > baseline || ft;
    const int from = cut_sim ? sim_t : (take ? best_h : -1);
    if (from < 0) {
      a.o_scale[p] = a.warm_scale[p];
      for (int k = 0; k < 9; ++k) a.o_rot[p * 9 + k] = a.warm_rot[p * 9 + k];
      for (int ax = 0; ax < 3; ++ax) a.o_trans[p * 3 + ax] = a.warm_trans[p * 3 + ax];
    } else {
      a.o_scale[p] = a.scale != nullptr ? a.scale[r0 + from] : 1.0f;
      for (int k = 0; k < 9; ++k) a.o_rot[p * 9 + k] = a.rots[(r0 + from) * 9 + k];
      for (int ax = 0; ax < 3; ++ax) a.o_trans[p * 3 + ax] = __ldcg(&a.ws_trans[(r0 + from) * 3 + ax]);
    }
    const long long consumed = cut + 1;
    const long long bump =
        (a.hypotheses[p] == 0 && cut_sim && sim_t == 0) ? a.host_r[p] + 1 : consumed;
    a.o_local_r[p] = lr0 + (cut_sim ? bump : consumed);
    const float pro_after = (cut_sim || stop_any) ? 1.0f : pro;
    a.o_pro_local[p] = (stop_any && !cut_sim && conf_stop) ? pro_stop : pro_after;
    a.o_escalate[p] = a.escalate[p] || (stop_any && !cut_sim && stagn_stop && !conf_stop);
    a.o_best_count[p] = cut_sim ? a.best_count[p] : (best > baseline ? best : baseline);
    a.o_hypotheses[p] = a.hypotheses[p] + consumed;
    a.o_done[p] = cut_sim || stop_any;
    keep_new = cut_sim || take;
    a.o_extras_valid[p] = a.extras_valid[p] || keep_new;
    sel_idx = cut_sim ? sim_t : best_h;
    a.ticket[p] = 0;
  }
  if (a.ex_b_i == nullptr) return;
  __syncthreads();
  const size_t win = static_cast<size_t>(p) * B + sel_idx;
  for (int r = tid; r < L; r += kThreads) {
    const size_t o = static_cast<size_t>(p) * L + r, w = win * L + r;
    a.o_b_i[o] = keep_new ? a.b_i[w] : a.ex_b_i[o];
    a.o_b_j[o] = keep_new ? a.b_j[w] : a.ex_b_j[o];
    a.o_sc[o] = keep_new ? a.sc_inl[w] : a.ex_sc[o];
    a.o_rot_inl[o] = keep_new ? a.rot_inl[w] : a.ex_rot[o];
  }
  for (int q = tid; q < C; q += kThreads) {
    const size_t o = static_cast<size_t>(p) * C + q;
    a.o_tinl[o] = keep_new ? static_cast<bool>(__ldcg(reinterpret_cast<const unsigned char*>(
                                 a.ws_tinl + win * C + q)))
                           : a.ex_tinl[o];
    a.o_tpts[o] = keep_new ? static_cast<bool>(__ldcg(reinterpret_cast<const unsigned char*>(
                                 a.ws_tpts + win * C + q)))
                           : a.ex_tpts[o];
  }
}

}  // namespace

// Bytes of global workspace a launch of the pick needs a hypothesis (its
// sort of S keys), 0 where the sort fits in shared memory.
extern "C" long long local_pick_global_bytes(int s) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return -1;
  const long long bytes = 8LL * next_pow2(s);
  return bytes <= shared_limit(device) ? 0 : bytes;
}

// Bytes of global workspace the accept needs a hypothesis, 0 where its
// scratch fits in shared memory.
extern "C" long long local_accept_global_bytes(int bcap, int c) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return -1;
  int npad = 0, cap = 0;
  const int shared = shared_limit(device);
  const size_t bytes = accept_scratch_bytes(bcap, c, &npad, &cap, shared);
  return bytes <= static_cast<size_t>(shared) ? 0 : static_cast<long long>((bytes + 15) / 16 * 16);
}

// One launch of the pick for P pairs of B hypotheses on `stream`; returns
// the CUDA error as an int (0 on success). keys_f or keys_d (the other
// null) is (P, B, S); s_i, s_j, s_ok (P, S); s_count, b_rate, first_time
// (P,); src, dst (P, 3, C); all contiguous device arrays. known: write the
// scale test (beta), the GNC noise bounds (noise2) and the scales (1). ws: (P B,
// local_pick_global_bytes(S)) bytes when that is not 0, else null.
extern "C" int local_pick_launch(const float* keys_f, const long long* keys_d,
                                 const long long* s_i, const long long* s_j, const bool* s_ok,
                                 const long long* s_count, const float* b_rate, const float* src,
                                 const float* dst, const bool* first_time, int pairs, int batch,
                                 int s, int bcap, int c, int known, float beta, float noise2,
                                 long long* b_i, long long* b_j, bool* sel_ok, float* src_t,
                                 float* dst_t, bool* sc_inl, float* noise, float* scale,
                                 bool* use_warm, int* ticket, void* ws, void* stream) {
  if (pairs < 1 || pairs > 65535 || batch < 1 || s < 1 || bcap < 1 || bcap > s || c < 1 ||
      (keys_f == nullptr) == (keys_d == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int s_pad = next_pow2(s);
  const bool global = 8LL * s_pad > shared_limit(device);
  if (global && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  PickArgs a{keys_f, keys_d, s_i, s_j, s_ok, s_count, b_rate, src, dst, first_time,
             batch, s, s_pad, bcap, c, known, beta, noise2, b_i, b_j, sel_ok, src_t, dst_t,
             sc_inl, noise, scale, use_warm, ticket, global ? static_cast<u64*>(ws) : nullptr};
  const size_t shared = global ? 0 : 8 * static_cast<size_t>(s_pad);
  static size_t shared_set[kMaxDevices] = {};
  err = allow_shared(reinterpret_cast<const void*>(local_pick_kernel), shared, &shared_set[device]);
  if (err != cudaSuccess) return static_cast<int>(err);
  local_pick_kernel<<<dim3(batch, pairs), kThreads, shared, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the accept for P pairs of B hypotheses on `stream`; returns
// the CUDA error as an int. Shapes as AcceptArgs gives them, contiguous;
// scale null at known scale; sc_inl and the ex_* and o_ (mask) arrays null
// where the stage masks are not tracked. ws_*: the blocks' results (P B
// counts, flags and translations, P baselines, and where tracked P B C
// bools twice); scratch: (P B, local_accept_global_bytes(bcap, C)) bytes
// when that is not 0, else null. ticket (P,) must be 0, as the pick leaves
// it; the launch leaves it 0.
extern "C" int local_accept_launch(
    const float* src, const float* dst, const bool* s_pts, const long long* b_i,
    const long long* b_j, const bool* rot_inl, const float* rots, const float* scale,
    const float* warm_scale, const float* warm_rot, const float* warm_trans,
    const bool* first_time, const long long* best_count, const long long* local_r,
    const long long* hypotheses, const bool* escalate, const bool* extras_valid,
    const long long* host_r, const float* thr, const bool* sc_inl, const long long* ex_b_i,
    const long long* ex_b_j, const bool* ex_sc, const bool* ex_rot, const bool* ex_tinl,
    const bool* ex_tpts, int pairs, int batch, int bcap, int c, float beta, float scale_noise,
    float trans_noise, float rot_similar, float stagn_min, float local_conf,
    long long local_max_iter, int* ticket, long long* ws_count, int* ws_sim, float* ws_trans,
    long long* ws_base, bool* ws_tinl, bool* ws_tpts, void* scratch, float* o_scale,
    float* o_rot, float* o_trans, long long* o_best_count, long long* o_local_r,
    float* o_pro_local, long long* o_hypotheses, bool* o_escalate, bool* o_done,
    bool* o_extras_valid, long long* o_b_i, long long* o_b_j, bool* o_sc, bool* o_rot_inl,
    bool* o_tinl, bool* o_tpts, void* stream) {
  const bool track = ex_b_i != nullptr;
  if (pairs < 1 || pairs > 65535 || batch < 1 || bcap < 1 || c < 1 ||
      (track && (sc_inl == nullptr || ws_tinl == nullptr || ws_tpts == nullptr ||
                 o_b_i == nullptr || o_tinl == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int limit = shared_limit(device);
  int npad = 0, cap = 0;
  const size_t bytes = accept_scratch_bytes(bcap, c, &npad, &cap, limit);
  const bool global = bytes > static_cast<size_t>(limit);
  if (global && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  AcceptArgs a{src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm_scale, warm_rot,
               warm_trans, first_time, best_count, local_r, hypotheses, escalate, extras_valid,
               host_r, thr, sc_inl, ex_b_i, ex_b_j, ex_sc, ex_rot, ex_tinl, ex_tpts,
               batch, bcap, c, npad, cap, beta, scale_noise, trans_noise, rot_similar,
               stagn_min, local_conf, local_max_iter, ticket, ws_count, ws_sim, ws_trans,
               ws_base, track ? ws_tinl : nullptr, track ? ws_tpts : nullptr,
               global ? static_cast<unsigned char*>(scratch) : nullptr,
               static_cast<long long>((bytes + 15) / 16 * 16), o_scale, o_rot, o_trans,
               o_best_count, o_local_r, o_pro_local, o_hypotheses, o_escalate, o_done,
               o_extras_valid, o_b_i, o_b_j, o_sc, o_rot_inl, o_tinl, o_tpts};
  const size_t shared = global ? 0 : bytes;
  static size_t shared_set[kMaxDevices] = {};
  err = allow_shared(reinterpret_cast<const void*>(local_accept_kernel), shared,
                     &shared_set[device]);
  if (err != cudaSuccess) return static_cast<int>(err);
  local_accept_kernel<<<dim3(batch, pairs), kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
