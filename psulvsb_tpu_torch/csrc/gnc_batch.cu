// GNC-TLS rotation loop for a batch of hypotheses, one launch for all.
//
// Replaces psulvsb_tpu/ops/pallas_gnc.py::gnc_batch_pallas (the Pallas
// kernel built by _make_kernel). Each iteration of a hypothesis:
//   1. weighted 3x3 correlation H = sum_i w_i act_i s_i d_i^T (9 sums);
//   2. rotation from H by shifted power iteration on the 4x4 Davenport
//      matrix: K + (2|H| + 1e-12) I, 5 squarings each normalized by
//      |Ks| + 1e-30, then the largest-norm column (the first maximum wins);
//      the warm rotation replaces this solve on iteration 0 when asked;
//   3. squared residuals r2_i = |d_i - R s_i|^2;
//   4. on iteration 0, mu = 1 / (2 max_active(r2) / nb_sq - 1), and a
//      degenerate mu (<= 0) stops the hypothesis with its old weights;
//   5. cost = sum w_i r2_i act_i with the PREVIOUS weights;
//   6. TLS weights between th1 = (mu+1)/mu nb_sq and th2 = mu/(mu+1) nb_sq,
//      w_mid = sqrt(nb_sq mu (mu+1) / max(r2, 1e-30)) - mu clipped to [0, 1];
//      then mu *= gnc_factor;
//   7. stop when |cost - prev_cost| < cost_threshold.
// The numerics follow the Pallas kernel step for step; only the order of
// the sums differs.
//
// Design. One thread block per hypothesis (grid = B), 256 threads; each
// thread owns columns tid, tid + 256, ... and keeps their TIM coordinates,
// active flag, weight and r2 in registers (COLS columns per thread, a
// template parameter picked from N; N <= 2048). Per-hypothesis scalars (mu,
// prev_cost, the stop flags) are block-uniform: every thread computes them
// from the same reduced values, so every branch on them is uniform. Each
// iteration does 11 block reductions (the 9 correlation sums in one pass,
// then the max residual and the cost in another), by warp shuffles and one
// shared-memory pass that every thread reads in the same order. One thread
// solves the 4x4 and writes R to shared memory. A block stops on its own
// when its hypothesis is done: the Pallas kernel freezes a finished
// hypothesis, so no result depends on the others.
//
// What bounds it on the card. It is latency- and launch-bound: at the bench
// anchor (B = 4, N = 256) four blocks occupy four of 132 SMs, each iteration
// is a chain of dependent reductions and a serial 4x4 solve, and a
// hypothesis holds about 1 KB of TIM data per coordinate set, read once into
// registers. Later work can raise occupancy by packing the hypotheses of
// several pairs into one launch (once register_batch is ported), or cut the
// launch and host cost around it with CUDA graphs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 2048;
constexpr float kBig = 3.0e38f;

// Sums the 9 per-thread partials over the block; every thread gets the
// totals, bitwise identical across threads.
__device__ __forceinline__ void block_sum9(float (&v)[9], float (*scratch)[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) scratch[warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float acc = scratch[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += scratch[w][k];
    v[k] = acc;
  }
  __syncthreads();  // scratch is reused by the next reduction
}

// Max of `mx` and sum of `sm` over the block, in one pass.
__device__ __forceinline__ void block_max_sum(float& mx, float& sm, float (*scratch)[9]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    sm += __shfl_xor_sync(0xffffffffu, sm, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp][0] = mx;
    scratch[warp][1] = sm;
  }
  __syncthreads();
  mx = scratch[0][0];
  sm = scratch[0][1];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    mx = fmaxf(mx, scratch[w][0]);
    sm += scratch[w][1];
  }
  __syncthreads();
}

// Proper rotation (row-major, 9 entries) from the correlation h (row-major
// S_ab) by shifted matrix-squaring power iteration on the Davenport matrix
// (pallas_gnc.py::_rot_from_h9, core/linalg.py rot_from_correlation "power").
__device__ void rot_from_h9(const float (&h)[9], float (&r)[9]) {
  const float sxx = h[0], sxy = h[1], sxz = h[2];
  const float syx = h[3], syy = h[4], syz = h[5];
  const float szx = h[6], szy = h[7], szz = h[8];
  float ks[16] = {
      sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
      syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
      szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy,
      sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz,
  };
  float h_sq = h[0] * h[0];
  for (int k = 1; k < 9; ++k) h_sq = h_sq + h[k] * h[k];
  const float shift = 2.0f * sqrtf(h_sq) + 1e-12f;
  for (int k = 0; k < 16; k += 5) ks[k] = ks[k] + shift;
  for (int it = 0; it < 5; ++it) {
    float sq[16];
    for (int i = 0; i < 4; ++i) {
      for (int j = 0; j < 4; ++j) {
        float acc = ks[4 * i] * ks[j];
        for (int m = 1; m < 4; ++m) acc = acc + ks[4 * i + m] * ks[4 * m + j];
        sq[4 * i + j] = acc;
      }
    }
    float nrm = sq[0] * sq[0];
    for (int k = 1; k < 16; ++k) nrm = nrm + sq[k] * sq[k];
    const float inv = 1.0f / (sqrtf(nrm) + 1e-30f);
    for (int k = 0; k < 16; ++k) ks[k] = sq[k] * inv;
  }
  int best = 0;
  float best_n = ks[0] * ks[0] + ks[4] * ks[4] + ks[8] * ks[8] + ks[12] * ks[12];
  for (int c = 1; c < 4; ++c) {
    const float n = ks[c] * ks[c] + ks[4 + c] * ks[4 + c] + ks[8 + c] * ks[8 + c] +
                    ks[12 + c] * ks[12 + c];
    if (n > best_n) {
      best_n = n;
      best = c;
    }
  }
  float w = ks[best], x = ks[4 + best], y = ks[8 + best], z = ks[12 + best];
  const float inv = 1.0f / (sqrtf(w * w + x * x + y * y + z * z) + 1e-30f);
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

template <int COLS>
__global__ void __launch_bounds__(kThreads) gnc_batch_kernel(
    const float* __restrict__ src,    // (B, 3, N)
    const float* __restrict__ dst,    // (B, 3, N)
    const float* __restrict__ act,    // (B, N) in {0, 1}
    const float* __restrict__ nb_sq,  // (B,) floored noise bound squared
    const float* __restrict__ warm9,  // (9,) row-major warm rotation
    int use_warm, int n, int max_iterations, float gnc_factor,
    float cost_threshold,
    float* __restrict__ rot_out,  // (B, 9)
    float* __restrict__ w_out) {  // (B, N)
  __shared__ float scratch[kWarps][9];
  __shared__ float rot_sh[9];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* s = src + static_cast<size_t>(b) * 3 * n;
  const float* d = dst + static_cast<size_t>(b) * 3 * n;
  const float* a = act + static_cast<size_t>(b) * n;

  float sx[COLS], sy[COLS], sz[COLS], dx[COLS], dy[COLS], dz[COLS];
  float ac[COLS], w[COLS], r2[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int c = tid + k * kThreads;
    const bool in = c < n;
    sx[k] = in ? s[c] : 0.0f;
    sy[k] = in ? s[n + c] : 0.0f;
    sz[k] = in ? s[2 * n + c] : 0.0f;
    dx[k] = in ? d[c] : 0.0f;
    dy[k] = in ? d[n + c] : 0.0f;
    dz[k] = in ? d[2 * n + c] : 0.0f;
    ac[k] = in ? a[c] : 0.0f;  // padding columns are inactive
    w[k] = ac[k];
    r2[k] = 0.0f;
  }
  if (tid < 9) rot_sh[tid] = (tid % 4 == 0) ? 1.0f : 0.0f;
  __syncthreads();

  const float nbsq = nb_sq[b];
  float mu = 1.0f;
  float prev_cost = kBig;

  for (int i = 0; i < max_iterations; ++i) {
    if (i == 0 && use_warm) {
      if (tid < 9) rot_sh[tid] = warm9[tid];
    } else {
      float h[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) h[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const float wa = w[k] * ac[k];
        const float ws[3] = {wa * sx[k], wa * sy[k], wa * sz[k]};
        h[0] += ws[0] * dx[k];
        h[1] += ws[0] * dy[k];
        h[2] += ws[0] * dz[k];
        h[3] += ws[1] * dx[k];
        h[4] += ws[1] * dy[k];
        h[5] += ws[1] * dz[k];
        h[6] += ws[2] * dx[k];
        h[7] += ws[2] * dy[k];
        h[8] += ws[2] * dz[k];
      }
      block_sum9(h, scratch);
      if (tid == 0) {
        float r[9];
        rot_from_h9(h, r);
#pragma unroll
        for (int k = 0; k < 9; ++k) rot_sh[k] = r[k];
      }
    }
    __syncthreads();
    float r[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) r[k] = rot_sh[k];

    float mx = -kBig;
    float cost = 0.0f;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const float e0 = dx[k] - (r[0] * sx[k] + r[1] * sy[k] + r[2] * sz[k]);
      const float e1 = dy[k] - (r[3] * sx[k] + r[4] * sy[k] + r[5] * sz[k]);
      const float e2 = dz[k] - (r[6] * sx[k] + r[7] * sy[k] + r[8] * sz[k]);
      r2[k] = e0 * e0 + e1 * e1 + e2 * e2;
      mx = fmaxf(mx, r2[k] * ac[k] - kBig * (1.0f - ac[k]));
      cost += w[k] * r2[k] * ac[k];
    }
    block_max_sum(mx, cost, scratch);

    const float mu_new = (i == 0) ? 1.0f / (2.0f * mx / nbsq - 1.0f) : mu;
    const bool degenerate = (i == 0) && (mu_new <= 0.0f);
    const bool converged = fabsf(cost - prev_cost) < cost_threshold;
    if (!degenerate) {
      const float th1 = (mu_new + 1.0f) / mu_new * nbsq;
      const float th2 = mu_new / (mu_new + 1.0f) * nbsq;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        float wn;
        if (r2[k] >= th1) {
          wn = 0.0f;
        } else if (r2[k] <= th2) {
          wn = 1.0f;
        } else {
          wn = sqrtf(nbsq * mu_new * (mu_new + 1.0f) / fmaxf(r2[k], 1e-30f)) - mu_new;
          wn = wn < 0.0f ? 0.0f : (wn > 1.0f ? 1.0f : wn);  // NaN passes, as jnp.clip
        }
        w[k] = wn * ac[k];
      }
    }
    mu = mu_new * gnc_factor;
    prev_cost = cost;
    if (degenerate || converged) break;
  }

  if (tid < 9) rot_out[b * 9 + tid] = rot_sh[tid];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int c = tid + k * kThreads;
    if (c < n) w_out[static_cast<size_t>(b) * n + c] = w[k];
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success). All pointers are device pointers to contiguous float32.
extern "C" int gnc_batch_launch(const float* src, const float* dst, const float* act,
                                const float* nb_sq, const float* warm9, int use_warm,
                                int b, int n, int max_iterations, float gnc_factor,
                                float cost_threshold, float* rot_out, float* w_out,
                                void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(b);
  const dim3 block(kThreads);
  if (n <= kThreads) {
    gnc_batch_kernel<1><<<grid, block, 0, st>>>(src, dst, act, nb_sq, warm9, use_warm, n,
                                                 max_iterations, gnc_factor, cost_threshold,
                                                 rot_out, w_out);
  } else if (n <= 2 * kThreads) {
    gnc_batch_kernel<2><<<grid, block, 0, st>>>(src, dst, act, nb_sq, warm9, use_warm, n,
                                                 max_iterations, gnc_factor, cost_threshold,
                                                 rot_out, w_out);
  } else if (n <= 4 * kThreads) {
    gnc_batch_kernel<4><<<grid, block, 0, st>>>(src, dst, act, nb_sq, warm9, use_warm, n,
                                                 max_iterations, gnc_factor, cost_threshold,
                                                 rot_out, w_out);
  } else {
    gnc_batch_kernel<8><<<grid, block, 0, st>>>(src, dst, act, nb_sq, warm9, use_warm, n,
                                                 max_iterations, gnc_factor, cost_threshold,
                                                 rot_out, w_out);
  }
  return static_cast<int>(cudaGetLastError());
}
