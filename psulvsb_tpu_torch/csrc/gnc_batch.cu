// GNC-TLS rotation loop for a batch of hypotheses, one launch for all, with
// the front door's rules (noise floor, inlier cut, fail-safe) inside.
//
// Replaces psulvsb_tpu/ops/pallas_gnc.py::gnc_batch_pallas (the Pallas
// kernel built by _make_kernel) and the rules its front door gnc_batch
// applies around it. For each hypothesis:
//   0. nb_sq = noise_bound^2, floored to 1e-2 below 1e-16;
// then each iteration:
//   1. weighted 3x3 correlation H = sum_i w_i act_i s_i d_i^T (9 sums);
//   2. rotation from H by shifted power iteration on the 4x4 Davenport
//      matrix K + (2|H| + 1e-12) I: 5 squarings, then the largest-norm
//      column (the first maximum wins); the warm rotation replaces this
//      solve on iteration 0 when the device flag use_warm is set;
//   3. squared residuals r2_i = |d_i - R s_i|^2;
//   4. on iteration 0, mu = 1 / (2 max_active(r2) / nb_sq - 1), and a
//      degenerate mu (<= 0) stops the hypothesis with its old weights;
//   5. cost = sum w_i r2_i act_i with the PREVIOUS weights;
//   6. TLS weights between th1 = (mu+1)/mu nb_sq and th2 = mu/(mu+1) nb_sq,
//      w_mid = sqrt(nb_sq mu (mu+1) / max(r2, 1e-30)) - mu clipped to [0, 1];
//      then mu *= gnc_factor;
//   7. stop when |cost - prev_cost| < cost_threshold;
// and after the loop the inliers w >= 0.5 of the active columns, or all
// active columns when at most 10 survive (registration.cc:1685-1690).
//
// What bounds it on the card. Not bytes and not arithmetic: a hypothesis
// is a chain of dependent steps, at most 100 iterations of a 9-sum
// reduction, a 4x4 power iteration and a max/sum reduction, over a few KB
// of data that sits in registers after the first read. Latency decides the
// time: how long one iteration's chain is, and how many barriers and
// serial steps it holds.
//
// Design.
//   * One block a hypothesis, its columns in registers, COLS a thread: 4
//     warps (one on each sub-partition of an SM, 1-2 columns a thread) up
//     to N = 256, the anchor's and the front end's basic cap; 8 warps (2-8
//     columns) up to 2048. A reduction is a xor butterfly in each warp and
//     one barrier over a double-buffered scratch, so no second barrier
//     guards its reuse; the warps' partials are read back as float4s.
//   * One reduction an iteration. For i >= 1 mu is known before the cost
//     is, so the next weights, and from them the next correlation, are
//     formed before the stop test; the cost of iteration i and the 9 sums
//     of iteration i + 1 go through one 10-value reduction. Iteration 0
//     keeps its own max/cost reduction (mu comes from the max).
//   * The 4x4 solve runs in every thread on the reduced sums, so no thread
//     waits for another and no shared memory carries R. It is cheap: K is
//     symmetric and stays so, so a squaring is 10 entries of 4 products;
//     and the matrix is scaled once by 1 / (2 shift) instead of after every
//     squaring. The eigenvalues of K + shift I lie in [0, 2 shift] and the
//     largest is at least shift (K is traceless, |K|_F = 2 |H|_F), so the
//     scaled top eigenvalue lies in [1/2, 1] and its 32nd power cannot
//     underflow; the direction is that of the reference up to rounding.
//   * Every per-hypothesis scalar is bitwise uniform across the threads
//     that branch on it: a xor butterfly gives the same sum on every lane
//     (a + b == b + a), the cross-warp pass is read by every thread in the
//     same order, and the solve is the same instructions on the same
//     values. So every branch on mu, the costs and the stop flags is
//     uniform, and a hypothesis stops on its own.
//   * The TLS weight update has no branch, so the columns' square roots
//     overlap (branches per column serialised them).
//   * Inputs are read through their strides (unit column stride), the mask
//     as the bool tensor's bytes; outputs are the caller's (B, 3, 3) float32
//     and (B, N) bool tensors.
//   * A pair axis, the counterpart of jax.vmap over gnc_batch (pallas_call's
//     batching rule adds a leading grid dimension): the B hypotheses of one
//     launch are P pairs' hypotheses in pair order, and each reads its own
//     pair's warm rotation and flag, so a batched solve of P pairs makes one
//     launch where P solves alone make P. P = 1 is the single solve's call.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 2048;
constexpr int kSmallN = 256;     // up to here a hypothesis takes kSmallWarps warps
constexpr int kSmallWarps = 4;   // one warp on each sub-partition of an SM
constexpr int kBlockWarps = 8;   // warps a hypothesis beyond kSmallN
constexpr int kRed = 10;         // values a reduction carries at most

struct Inputs {
  const float* src;   // (B, 3, N) at strides (src_b, src_k, 1)
  const float* dst;   // (B, 3, N) at strides (dst_b, dst_k, 1)
  const unsigned char* act;  // (B, N) bool bytes at stride (act_b, 1)
  const float* nb;    // (B,) noise bound at stride nb_s
  const float* warm;  // (P, 3, 3) at strides (warm_p, warm_0, warm_1)
  const unsigned char* use_warm;  // (P,) bool bytes on the device: take `warm` on iteration 0
  long long src_b, src_k, dst_b, dst_k, act_b, nb_s, warm_p, warm_0, warm_1;
  int b, n, max_iterations;
  int per_pair;  // hypotheses of one pair: hypothesis h belongs to pair h / per_pair
  float gnc_factor, cost_threshold;
  float* rot_out;           // (B, 3, 3) contiguous
  unsigned char* inl_out;   // (B, N) contiguous bool
};

// Sums v[0..K) over the WARPS warps of a hypothesis (v[0] takes the max
// instead when MAX0); every thread gets totals bitwise equal to every
// other's. A xor butterfly in each warp; then lane 0 of each warp writes
// its K totals to scratch[buf][k * WARPS + warp], one __syncthreads, and
// every thread reads each k's WARPS partials as vectors and sums them in
// the same order.
template <int WARPS, int K, bool MAX0>
__device__ __forceinline__ void reduce(float (&v)[K], float (*scratch)[kBlockWarps * kRed],
                                       int& buf) {
  static_assert(WARPS % 4 == 0, "partials are read four at a time");
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = (MAX0 && k == 0) ? fmaxf(v[k], o) : v[k] + o;
    }
  }
  float* sc = scratch[buf];
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sc[k * WARPS + (threadIdx.x >> 5)] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float p[WARPS];
#pragma unroll
    for (int q = 0; q < WARPS; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sc + k * WARPS + q);
      p[q] = x.x, p[q + 1] = x.y, p[q + 2] = x.z, p[q + 3] = x.w;
    }
    float acc = p[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) acc = (MAX0 && k == 0) ? fmaxf(acc, p[w]) : acc + p[w];
    v[k] = acc;
  }
  buf ^= 1;  // the next reduction writes the other buffer
}

// Proper rotation (row-major, 9 entries) from the correlation h (row-major
// S_ab) by shifted matrix-squaring power iteration on the Davenport matrix
// (pallas_gnc.py::_rot_from_h9, core/linalg.py rot_from_correlation
// "power"), on the 10 entries of the symmetric matrix, scaled once.
__device__ __forceinline__ void rot_from_h9(const float* h, float (&r)[9]) {
  const float sxx = h[0], sxy = h[1], sxz = h[2];
  const float syx = h[3], syy = h[4], syz = h[5];
  const float szx = h[6], szy = h[7], szz = h[8];
  const float h_sq = ((sxx * sxx + sxy * sxy) + (sxz * sxz + syx * syx)) +
                     ((syy * syy + syz * syz) + (szx * szx + szy * szy)) + szz * szz;
  const float shift = 2.0f * sqrtf(h_sq) + 1e-12f;
  const float sc = __fdividef(0.5f, shift);  // any scale near 1 / (2 shift) will do
  float a00 = (sxx + syy + szz + shift) * sc, a01 = (syz - szy) * sc;
  float a02 = (szx - sxz) * sc, a03 = (sxy - syx) * sc;
  float a11 = (sxx - syy - szz + shift) * sc, a12 = (sxy + syx) * sc;
  float a13 = (szx + sxz) * sc, a22 = (-sxx + syy - szz + shift) * sc;
  float a23 = (syz + szy) * sc, a33 = (-sxx - syy + szz + shift) * sc;
#pragma unroll
  for (int it = 0; it < 5; ++it) {
    const float b00 = a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03;
    const float b01 = a00 * a01 + a01 * a11 + a02 * a12 + a03 * a13;
    const float b02 = a00 * a02 + a01 * a12 + a02 * a22 + a03 * a23;
    const float b03 = a00 * a03 + a01 * a13 + a02 * a23 + a03 * a33;
    const float b11 = a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13;
    const float b12 = a01 * a02 + a11 * a12 + a12 * a22 + a13 * a23;
    const float b13 = a01 * a03 + a11 * a13 + a12 * a23 + a13 * a33;
    const float b22 = a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23;
    const float b23 = a02 * a03 + a12 * a13 + a22 * a23 + a23 * a33;
    const float b33 = a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33;
    a00 = b00, a01 = b01, a02 = b02, a03 = b03, a11 = b11;
    a12 = b12, a13 = b13, a22 = b22, a23 = b23, a33 = b33;
  }
  // Column c of the symmetric matrix is its row c.
  const float n0 = a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03;
  const float n1 = a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13;
  const float n2 = a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23;
  const float n3 = a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33;
  float w = a00, x = a01, y = a02, z = a03, best = n0;
  if (n1 > best) { w = a01; x = a11; y = a12; z = a13; best = n1; }
  if (n2 > best) { w = a02; x = a12; y = a22; z = a23; best = n2; }
  if (n3 > best) { w = a03; x = a13; y = a23; z = a33; }
  // The column is a power of at least 2^-32 of a unit eigenvector: its
  // norm is far from 0, and 1e-30 would change nothing.
  const float inv = rsqrtf(w * w + x * x + y * y + z * z);
  w *= inv;
  x *= inv;
  y *= inv;
  z *= inv;
  r[0] = 1 - 2 * (y * y + z * z);
  r[1] = 2 * (x * y - w * z);
  r[2] = 2 * (x * z + w * y);
  r[3] = 2 * (x * y + w * z);
  r[4] = 1 - 2 * (x * x + z * z);
  r[5] = 2 * (y * z - w * x);
  r[6] = 2 * (x * z - w * y);
  r[7] = 2 * (y * z + w * x);
  r[8] = 1 - 2 * (x * x + y * y);
}

// One hypothesis on WARPS warps; `t` is the thread's index among its
// hypothesis' 32 * WARPS threads.
template <int WARPS, int COLS>
__device__ __forceinline__ void gnc_hypothesis(const Inputs& in, int b, int t,
                                               float (*scratch)[kBlockWarps * kRed]) {
  constexpr int kStride = 32 * WARPS;
  const int n = in.n;
  const float* s = in.src + b * in.src_b;
  const float* d = in.dst + b * in.dst_b;
  const unsigned char* a = in.act + b * in.act_b;

  float sx[COLS], sy[COLS], sz[COLS], dx[COLS], dy[COLS], dz[COLS];
  float ac[COLS], w[COLS], r2[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int c = t + k * kStride;
    const bool ok = c < n;
    sx[k] = ok ? s[c] : 0.0f;
    sy[k] = ok ? s[in.src_k + c] : 0.0f;
    sz[k] = ok ? s[2 * in.src_k + c] : 0.0f;
    dx[k] = ok ? d[c] : 0.0f;
    dy[k] = ok ? d[in.dst_k + c] : 0.0f;
    dz[k] = ok ? d[2 * in.dst_k + c] : 0.0f;
    ac[k] = (ok && a[c] != 0) ? 1.0f : 0.0f;  // padding columns are inactive
    w[k] = ac[k];
  }
  static_assert(WARPS >= 2 && WARPS <= kBlockWarps && 32 * WARPS * COLS <= kMaxN);
  const float nb = in.nb[b * in.nb_s];
  float nbsq = nb * nb;
  if (nbsq < 1e-16f) nbsq = 1e-2f;  // registration.cc:1592-1595

  int buf = 0;
  float red[kRed];
  float r[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};

  // Weighted correlation partials of the current weights into red[1..9];
  // red[0] is the cost slot, 0 unless the caller sets it.
  auto correlation = [&]() {
#pragma unroll
    for (int k = 0; k < kRed; ++k) red[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const float wa = w[k] * ac[k];
      const float w0 = wa * sx[k], w1 = wa * sy[k], w2 = wa * sz[k];
      red[1] += w0 * dx[k];
      red[2] += w0 * dy[k];
      red[3] += w0 * dz[k];
      red[4] += w1 * dx[k];
      red[5] += w1 * dy[k];
      red[6] += w1 * dz[k];
      red[7] += w2 * dx[k];
      red[8] += w2 * dy[k];
      red[9] += w2 * dz[k];
    }
  };
  auto residuals = [&]() {
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const float e0 = dx[k] - (r[0] * sx[k] + r[1] * sy[k] + r[2] * sz[k]);
      const float e1 = dy[k] - (r[3] * sx[k] + r[4] * sy[k] + r[5] * sz[k]);
      const float e2 = dz[k] - (r[6] * sx[k] + r[7] * sy[k] + r[8] * sz[k]);
      r2[k] = e0 * e0 + e1 * e1 + e2 * e2;
    }
  };
  auto cost_partial = [&]() {
    float cost = 0.0f;
#pragma unroll
    for (int k = 0; k < COLS; ++k) cost += w[k] * r2[k] * ac[k];
    return cost;
  };
  // Branch-free, so the columns' square roots overlap: w_mid as
  // sqrt(nb_sq mu (mu+1)) / sqrt(max(r2, 1e-30)) - mu, within a few ulps of
  // the plain version's sqrt of the quotient.
  auto tls_weights = [&](float mu) {
    const float th1 = (mu + 1.0f) / mu * nbsq;
    const float th2 = mu / (mu + 1.0f) * nbsq;
    const float root = sqrtf(nbsq * mu * (mu + 1.0f));
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      float mid = root * rsqrtf(fmaxf(r2[k], 1e-30f)) - mu;
      mid = mid < 0.0f ? 0.0f : (mid > 1.0f ? 1.0f : mid);  // NaN passes, as torch.clamp
      const float wn = r2[k] >= th1 ? 0.0f : (r2[k] <= th2 ? 1.0f : mid);
      w[k] = wn * ac[k];
    }
  };

  if (in.max_iterations > 0) {
    // Iteration 0: the warm rotation or the solve, then mu from the max.
    const int pair = b / in.per_pair;
    if (in.use_warm[pair] != 0) {  // the same byte for every thread: a uniform branch
      const float* warm = in.warm + pair * in.warm_p;
#pragma unroll
      for (int k = 0; k < 9; ++k) r[k] = warm[(k / 3) * in.warm_0 + (k % 3) * in.warm_1];
    } else {
      correlation();
      reduce<WARPS, kRed, false>(red, scratch, buf);
      rot_from_h9(red + 1, r);
    }
    residuals();
    float mc[2] = {-CUDART_INF_F, cost_partial()};
#pragma unroll
    for (int k = 0; k < COLS; ++k) mc[0] = fmaxf(mc[0], ac[k] != 0.0f ? r2[k] : -CUDART_INF_F);
    reduce<WARPS, 2, true>(mc, scratch, buf);
    const float mu0 = 1.0f / (2.0f * mc[0] / nbsq - 1.0f);
    if (!(mu0 <= 0.0f)) {  // not degenerate
      tls_weights(mu0);
      float mu = mu0 * in.gnc_factor;
      float prev_cost = mc[1];
      // The previous cost starts at +inf, as in the plain loop.
      const bool converged0 = fabsf(mc[1] - CUDART_INF_F) < in.cost_threshold;
      if (in.max_iterations > 1 && !converged0) {
        correlation();
        reduce<WARPS, kRed, false>(red, scratch, buf);
        rot_from_h9(red + 1, r);
        for (int i = 1;; ++i) {
          residuals();
          const float cost = cost_partial();  // with the weights of iteration i
          tls_weights(mu);
          correlation();  // of iteration i + 1's weights
          red[0] = cost;
          reduce<WARPS, kRed, false>(red, scratch, buf);
          const bool converged = fabsf(red[0] - prev_cost) < in.cost_threshold;
          prev_cost = red[0];
          mu *= in.gnc_factor;
          if (converged || i + 1 >= in.max_iterations) break;
          rot_from_h9(red + 1, r);
        }
      }
    }
  }

  // Inliers: w >= 0.5 on active columns; at most 10 of them -> all active.
  float cnt[1] = {0.0f};
#pragma unroll
  for (int k = 0; k < COLS; ++k) cnt[0] += (ac[k] != 0.0f && w[k] >= 0.5f) ? 1.0f : 0.0f;
  reduce<WARPS, 1, false>(cnt, scratch, buf);
  const bool few = cnt[0] <= 10.0f;
  unsigned char* out = in.inl_out + static_cast<long long>(b) * n;
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int c = t + k * kStride;
    if (c < n) out[c] = (ac[k] != 0.0f && (few || w[k] >= 0.5f)) ? 1 : 0;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (t == k) in.rot_out[b * 9 + k] = r[k];
  }
}

// One block of WARPS warps a hypothesis, COLS columns a thread.
template <int WARPS, int COLS>
__global__ void __launch_bounds__(32 * WARPS) gnc_batch_kernel(const Inputs in) {
  __shared__ __align__(16) float scratch[2][kBlockWarps * kRed];
  gnc_hypothesis<WARPS, COLS>(in, blockIdx.x, threadIdx.x, scratch);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success). Pointers are device pointers: src/dst float32 (B, 3, N)
// at element strides (*_b, *_k, 1), act the bytes of a (B, N) bool tensor
// at (act_b, 1), nb float32 (B,) at nb_s, warm float32 (P, 3, 3) at
// (warm_p, warm_0, warm_1), use_warm the P bytes of a bool tensor (read by
// the kernel, so a captured launch follows the flags' values at each
// replay); the B hypotheses are P pairs' per_pair each, in pair order, and
// hypothesis h takes pair h / per_pair's warm rotation and flag (P = 1,
// per_pair = B: one warm rotation for the batch);
// rot_out a contiguous float32 (B, 3, 3), inl_out a
// contiguous (B, N) bool tensor.
extern "C" int gnc_batch_launch(const float* src, long long src_b, long long src_k,
                                const float* dst, long long dst_b, long long dst_k,
                                const unsigned char* act, long long act_b, const float* nb,
                                long long nb_s, const float* warm, long long warm_p,
                                long long warm_0, long long warm_1,
                                const unsigned char* use_warm, int per_pair, int b, int n,
                                int max_iterations, float gnc_factor, float cost_threshold,
                                float* rot_out, unsigned char* inl_out, void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxN || per_pair <= 0 || b % per_pair != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{src, dst, act, nb, warm, use_warm, src_b, src_k, dst_b, dst_k, act_b, nb_s,
                  warm_p, warm_0, warm_1, b, n, max_iterations, per_pair, gnc_factor,
                  cost_threshold, rot_out, inl_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32 * kSmallWarps) {
    gnc_batch_kernel<kSmallWarps, 1><<<b, 32 * kSmallWarps, 0, st>>>(in);
  } else if (n <= kSmallN) {
    gnc_batch_kernel<kSmallWarps, 2><<<b, 32 * kSmallWarps, 0, st>>>(in);
  } else if (n <= 2 * 32 * kBlockWarps) {
    gnc_batch_kernel<kBlockWarps, 2><<<b, 32 * kBlockWarps, 0, st>>>(in);
  } else if (n <= 4 * 32 * kBlockWarps) {
    gnc_batch_kernel<kBlockWarps, 4><<<b, 32 * kBlockWarps, 0, st>>>(in);
  } else {
    gnc_batch_kernel<kBlockWarps, 8><<<b, 32 * kBlockWarps, 0, st>>>(in);
  }
  return static_cast<int>(cudaGetLastError());
}
