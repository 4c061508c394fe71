// The finalize of a solve in one launch: the weighted refit of the sampled
// best, its RMSE gate and the consensus of the pose it returns.
//
// Replaces no Pallas kernel. In the JAX package (psulvsb_tpu/solver/
// psulvsb.py:1433 `_finalize_stage`, XLA) and in the port's plain chain
// (ops/finalize.py `finalize_fit_reference`, the body of solver/psulvsb.py
// `_finalize_counted` without the translation rescue), the finalize is about
// 510 small operations on a card: the weighted centroids and correlation,
// the Davenport matrix, 18 plane rotations of the 4x4 Jacobi solve (440
// operations: stacks, 4x4 float64 products, atan2, cos, sin), the
// composition, two masked RMSEs and the consensus count. Each is a launch
// of 1-2 us for nanoseconds of work; the stage cost ~0.76 ms a solve.
//
// Contract (ops/finalize.py `finalize_fit`), a block a pair (blockIdx.y):
//   1. w = inlier_counter; s = s_b > 0 ? s_b : 1 (the sampled best's scale);
//   2. moved = s (R_b p + t_b) from the sampled best (R_b, t_b);
//   3. the weighted centroids c_m, c_d of moved and dst (sum w + 1e-30),
//      then H = sum w (moved - c_m)(dst - c_d)^T over the centred columns
//      (two passes, as core/linalg.py `weighted_procrustes_srt`);
//   4. the Davenport matrix K of H (float32), its top eigenvector by cyclic
//      Jacobi in float64 (6 sweeps of the rounds (0,1)(2,3), (0,2)(1,3),
//      (0,3)(1,2); theta = atan2(2 a_pq, a_qq - a_pp) / 2; the largest
//      diagonal, first on ties), the quaternion normalised and made R_fit
//      in float32, t_fit = c_d - R_fit c_m;
//   5. R_adj = R_fit R_b, t_adj = R_fit t_b + t_fit / s;
//   6. the squared errors of s (R_adj p + t_adj) and s (R_b p + t_b)
//      against dst over final_inliers == 1 (+inf RMSE on an empty mask);
//   7. refined = rmse_adj < rmse_b picks (R_adj, t_adj), else the host
//      best's pose;
//   8. the consensus of (R_adj, t_adj) under the host best's scale:
//      #{keep > -2 and |dst - s_h (R p + t)| <= thr}, in the pass of 6;
//   9. count = refined ? consensus : best_count.
// Nothing is read on the host and nothing allocated, so the launch captures
// into a CUDA graph.
//
// What bounds it on the card. Three passes over C columns of 24 bytes of
// points and 8 of each int64 mask (about 0.4 MB at C = 8192, 0.12 us of HBM
// at 3.35 TB/s, and in L2 after the first pass), a few tens of operations
// a column, and one thread's 18 float64 plane rotations of a 4x4 matrix
// (two square roots, two divisions and 48 products each). The work is
// microseconds on one SM; the bound is latency: three block-wide reductions
// and the dependent float64 chain of the eigen-solve. One block of 512 threads a pair; a
// pass keeps each thread's sums in registers, reduces them by warp
// shuffles and one shared-memory step, and every thread reads the result.
//
// Numerics. Column arithmetic is the plain version's float32 expressions
// (FMA chains where cuBLAS orders its products its own way); every sum over
// the columns is taken in float64, in a fixed order (deterministic run to
// run), where the plain version sums in float32. The eigen-solve is the
// plain version's in float64 with the same rotations; a rotation is applied
// to its two rows and columns, which are the only non-zero terms of the
// plain version's 4x4 products. So the pose agrees with the plain version
// to float32 rounding; `refined` may differ only where the two RMSEs agree
// to rounding, and the count only by a column whose residual is within
// rounding of thr.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSweeps = 6;  // core/linalg.py _JACOBI_SWEEPS

struct Args {
  const float* src;           // (P, 3, C)
  const float* dst;           // (P, 3, C)
  const long long* counter;   // (P, C) inlier_counter, the fit's weights
  const long long* final_in;  // (P, C) final_inliers, 1 where in the RMSE mask
  const long long* keep;      // (P, C) keep_mask, > -2 on the real columns
  const float* s_scale;       // (P,) the sampled best
  const float* s_rot;         // (P, 3, 3)
  const float* s_trans;       // (P, 3)
  const float* b_scale;       // (P,) the host best
  const float* b_rot;         // (P, 3, 3)
  const float* b_trans;       // (P, 3)
  const long long* b_count;   // (P,)
  const float* thr;           // (P,)
  int c;
  float* o_rot;               // (P, 3, 3)
  float* o_trans;             // (P, 3)
  long long* o_count;         // (P,)
  bool* o_refined;            // (P,)
};

// The block's sum of each v[k]; every thread gets the sums. `red` is
// shared memory of kWarps * N doubles, free again on return.
template <int N>
__device__ void block_sum(double (&v)[N], double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xFFFFFFFFu, v[k], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      double x = lane < kWarps ? red[lane * N + k] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, o);
      v[k] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = red[k];
  __syncthreads();
}

// s (R p + t) for the point p, in float32.
__device__ __forceinline__ void transform(const float* r, const float* t, float s, float p0,
                                         float p1, float p2, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = s * (fmaf(r[3 * i + 2], p2, fmaf(r[3 * i + 1], p1, r[3 * i] * p0)) + t[i]);
  }
}

__device__ __forceinline__ float sq_dist(const float* a, float d0, float d1, float d2) {
  const float x = a[0] - d0, y = a[1] - d1, z = a[2] - d2;
  return x * x + y * y + z * z;
}

// cos and sin of theta = atan2(y, x) / 2 in (-pi/2, pi/2], by the
// half-angle identities (cos 2 theta = x / r, sin 2 theta = y / r, cos theta
// >= 0, sin theta of the sign of y), each from the larger of the two so
// that neither loses digits; atan2(0, 0) = 0 gives c = 1, s = 0. The plain
// version's atan2, cos and sin give the same values to float64 rounding at
// a fraction of the dependent float64 work.
__device__ __forceinline__ void half_angle(double y, double x, double* c, double* s) {
  const double r = sqrt(x * x + y * y);
  if (r == 0.0) {
    *c = 1.0;
    *s = 0.0;
  } else if (x >= 0.0) {
    *c = sqrt(0.5 * (1.0 + x / r));
    *s = y / (2.0 * r * *c);
  } else {
    *s = copysign(sqrt(0.5 * (1.0 - x / r)), y);
    *c = fabs(y) / (2.0 * r * fabs(*s));
  }
}

// One round of the cyclic Jacobi solve: the two disjoint plane rotations
// (P0, Q0) and (P1, Q1) from the same a, theta = atan2(2 a_pq, a_qq - a_pp)
// / 2 each, then a = G^T a G (rows, then columns) and v = v G, G[p][p] =
// G[q][q] = c, G[p][q] = s, G[q][p] = -s.
template <int P0, int Q0, int P1, int Q1>
__device__ __forceinline__ void jacobi_round(double (&a)[4][4], double (&v)[4][4]) {
  double c0, s0, c1, s1;
  half_angle(2.0 * a[P0][Q0], a[Q0][Q0] - a[P0][P0], &c0, &s0);
  half_angle(2.0 * a[P1][Q1], a[Q1][Q1] - a[P1][P1], &c1, &s1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double p0 = a[P0][j], q0 = a[Q0][j], p1 = a[P1][j], q1 = a[Q1][j];
    a[P0][j] = c0 * p0 - s0 * q0;
    a[Q0][j] = s0 * p0 + c0 * q0;
    a[P1][j] = c1 * p1 - s1 * q1;
    a[Q1][j] = s1 * p1 + c1 * q1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double p0 = a[i][P0], q0 = a[i][Q0], p1 = a[i][P1], q1 = a[i][Q1];
    a[i][P0] = p0 * c0 - q0 * s0;
    a[i][Q0] = p0 * s0 + q0 * c0;
    a[i][P1] = p1 * c1 - q1 * s1;
    a[i][Q1] = p1 * s1 + q1 * c1;
    const double vp0 = v[i][P0], vq0 = v[i][Q0], vp1 = v[i][P1], vq1 = v[i][Q1];
    v[i][P0] = vp0 * c0 - vq0 * s0;
    v[i][Q0] = vp0 * s0 + vq0 * c0;
    v[i][P1] = vp1 * c1 - vq1 * s1;
    v[i][Q1] = vp1 * s1 + vq1 * c1;
  }
}

// R_fit (row-major 3x3) of the correlation h: the Davenport matrix's top
// eigenvector as a unit quaternion (w, x, y, z), core/linalg.py
// `rot_from_correlation(h, "jacobi")`.
__device__ void rotation_of(const float* h, float* r) {
  const float sxx = h[0], sxy = h[1], sxz = h[2];
  const float syx = h[3], syy = h[4], syz = h[5];
  const float szx = h[6], szy = h[7], szz = h[8];
  const float k[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz},
  };
  double a[4][4], v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[i][j] = k[i][j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_round<0, 1, 2, 3>(a, v);
    jacobi_round<0, 2, 1, 3>(a, v);
    jacobi_round<0, 3, 1, 2>(a, v);
  }
  int top = 0;
  double best = a[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (a[i][i] > best) {
      best = a[i][i];
      top = i;
    }
  }
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = static_cast<float>(top == 0 ? v[i][0] : top == 1 ? v[i][1] : top == 2 ? v[i][2]
                                                                               : v[i][3]);
  }
  const float norm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-30f;
  const float w = q[0] / norm, x = q[1] / norm, y = q[2] / norm, z = q[3] / norm;
  r[0] = 1.0f - 2.0f * (y * y + z * z);
  r[1] = 2.0f * (x * y - w * z);
  r[2] = 2.0f * (x * z + w * y);
  r[3] = 2.0f * (x * y + w * z);
  r[4] = 1.0f - 2.0f * (x * x + z * z);
  r[5] = 2.0f * (y * z - w * x);
  r[6] = 2.0f * (x * z - w * y);
  r[7] = 2.0f * (y * z + w * x);
  r[8] = 1.0f - 2.0f * (x * x + y * y);
}

__global__ void __launch_bounds__(kThreads) finalize_fit_kernel(Args a) {
  __shared__ double red[kWarps * 9];
  // The pose the passes read: [0, 9) R_b, [9, 12) t_b, [12, 21) R_adj,
  // [21, 24) t_adj, [24] s.
  __shared__ float pose[25];

  const int pair = blockIdx.y;
  const int c = a.c;
  const int tid = threadIdx.x;
  const float* src = a.src + 3LL * c * pair;
  const float* dst = a.dst + 3LL * c * pair;
  const long long* counter = a.counter + static_cast<long long>(c) * pair;
  const long long* final_in = a.final_in + static_cast<long long>(c) * pair;
  const long long* keep = a.keep + static_cast<long long>(c) * pair;

  if (tid < 9) pose[tid] = a.s_rot[9 * pair + tid];
  if (tid < 3) pose[9 + tid] = a.s_trans[3 * pair + tid];
  if (tid == 0) {
    const float s = a.s_scale[pair];
    pose[24] = s > 0.0f ? s : 1.0f;
  }
  __syncthreads();
  const float s = pose[24];
  float rb[9], tb[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) rb[i] = pose[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) tb[i] = pose[9 + i];

  // Pass 1: sum w, sum w moved, sum w dst.
  double sums[7] = {};
#pragma unroll 4
  for (int j = tid; j < c; j += kThreads) {
    const float w = static_cast<float>(counter[j]);
    float m[3];
    transform(rb, tb, s, src[j], src[c + j], src[2 * c + j], m);
    sums[0] += w;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sums[1 + i] += static_cast<double>(m[i] * w);
      sums[4 + i] += static_cast<double>(dst[i * c + j] * w);
    }
  }
  block_sum(sums, red);
  const float total = static_cast<float>(sums[0]) + 1e-30f;
  float cm[3], cd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cm[i] = static_cast<float>(sums[1 + i]) / total;
    cd[i] = static_cast<float>(sums[4 + i]) / total;
  }

  // Pass 2: H = sum w (moved - c_m)(dst - c_d)^T.
  double h[9] = {};
#pragma unroll 4
  for (int j = tid; j < c; j += kThreads) {
    const float w = static_cast<float>(counter[j]);
    float m[3];
    transform(rb, tb, s, src[j], src[c + j], src[2 * c + j], m);
    float xw[3], y[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      xw[i] = (m[i] - cm[i]) * w;
      y[i] = dst[i * c + j] - cd[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) h[3 * i + k] += static_cast<double>(xw[i]) * y[k];
    }
  }
  block_sum(h, red);

  // One thread: the rotation, the composition.
  if (tid == 0) {
    float hf[9], rf[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) hf[i] = static_cast<float>(h[i]);
    rotation_of(hf, rf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float tf = cd[i] - fmaf(rf[3 * i + 2], cm[2], fmaf(rf[3 * i + 1], cm[1],
                                                              rf[3 * i] * cm[0]));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pose[12 + 3 * i + k] = fmaf(rf[3 * i + 2], rb[6 + k],
                                    fmaf(rf[3 * i + 1], rb[3 + k], rf[3 * i] * rb[k]));
      }
      pose[21 + i] = fmaf(rf[3 * i + 2], tb[2], fmaf(rf[3 * i + 1], tb[1], rf[3 * i] * tb[0])) +
                     tf / s;
    }
  }
  __syncthreads();
  float ra[9], ta[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) ra[i] = pose[12 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) ta[i] = pose[21 + i];

  // Pass 3: both squared errors over final_inliers == 1, and the refit's
  // consensus under the host best's scale, which the count takes where the
  // refit is kept (known before the gate, so no fourth pass).
  const float sh = a.b_scale[pair];
  const float thr = a.thr[pair];
  double acc[4] = {};  // error of the refit, of the sampled best; mask size; consensus
#pragma unroll 4
  for (int j = tid; j < c; j += kThreads) {
    const bool in_mask = final_in[j] == 1;
    const bool real = keep[j] > -2;
    if (!in_mask && !real) continue;
    const float p0 = src[j], p1 = src[c + j], p2 = src[2 * c + j];
    const float d0 = dst[j], d1 = dst[c + j], d2 = dst[2 * c + j];
    float m[3];
    if (in_mask) {
      transform(ra, ta, s, p0, p1, p2, m);
      acc[0] += sq_dist(m, d0, d1, d2);
      transform(rb, tb, s, p0, p1, p2, m);
      acc[1] += sq_dist(m, d0, d1, d2);
      acc[2] += 1.0;
    }
    if (real) {
      transform(ra, ta, sh, p0, p1, p2, m);
      acc[3] += sqrtf(sq_dist(m, d0, d1, d2)) <= thr ? 1.0 : 0.0;
    }
  }
  block_sum(acc, red);
  const bool refined = acc[2] > 0.0 && sqrt(acc[0] / acc[2]) < sqrt(acc[1] / acc[2]);
  if (tid < 9) a.o_rot[9 * pair + tid] = refined ? pose[12 + tid] : a.b_rot[9 * pair + tid];
  if (tid < 3) a.o_trans[3 * pair + tid] = refined ? pose[21 + tid] : a.b_trans[3 * pair + tid];
  if (tid == 0) {
    a.o_count[pair] = refined ? static_cast<long long>(acc[3]) : a.b_count[pair];
    a.o_refined[pair] = refined;
  }
}

}  // namespace

// One launch of the finalize for P pairs on `stream`; returns the CUDA
// error as an int (0 on success). Contiguous device arrays: src, dst
// (P, 3, C) float32; counter, final_in, keep (P, C) int64; the sampled and
// host bests' scale (P,), rotation (P, 3, 3), translation (P, 3) float32;
// b_count (P,) int64; thr (P,) float32. Writes o_rot (P, 3, 3), o_trans
// (P, 3), o_count (P,) int64 and o_refined (P,) bool. 1 <= C < 2^31,
// 1 <= P <= 65535.
extern "C" int finalize_fit_launch(const float* src, const float* dst, const long long* counter,
                                   const long long* final_in, const long long* keep,
                                   const float* s_scale, const float* s_rot, const float* s_trans,
                                   const float* b_scale, const float* b_rot, const float* b_trans,
                                   const long long* b_count, const float* thr, int pairs, int c,
                                   float* o_rot, float* o_trans, long long* o_count,
                                   bool* o_refined, void* stream) {
  if (pairs < 1 || pairs > 65535 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{src,    dst,    counter, final_in, keep,    s_scale, s_rot, s_trans, b_scale, b_rot,
         b_trans, b_count, thr,    c,        o_rot,   o_trans, o_count, o_refined};
  finalize_fit_kernel<<<dim3(1, pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
