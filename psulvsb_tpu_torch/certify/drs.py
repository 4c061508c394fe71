"""Douglas-Rachford-splitting rotation certifier (port of
psulvsb_tpu/certify/drs.py; teaser::DRSCertifier, certification.cc:22-671).

Given a rotation estimate R, TIMs (src, dst) and the TLS inlier signs theta,
it verifies the global optimality of R for the QUASAR lifted-quaternion SDP
by searching for a dual certificate with DRS iterations:

  M_PSD   = Pi_PSD(M)                      (eigenvalue clamp)
  W_dual  = Pi_dual(2 M_PSD - M - M_init)  (structure projection)
  M_aff   = M_init + W_dual
  gap     = -lambda_min(M_aff) (N+1) / mu
  M      += gamma_tau (M_aff - M_PSD)

The matrices are dense: (4N+4)^2 as flat matrices for the two
eigen-decompositions of an iteration and as (N+1, N+1, 4, 4) block tensors
for the structure projection, whose sparse linear inverse map is the JAX
package's closed form (`apply_a_inv`). The building blocks run where their
tensors lie, in their dtype. `DRSCertifier.certify` chooses: float64 on the
card by default (an H100 computes in float64, which a TPU cannot, so the
JAX package certifies on the host), float64 on the host with device="cpu",
float32 with dtype=torch.float32. The eigen-decompositions are
torch.linalg.eigh / eigvalsh, as they are XLA's eigh in the JAX package;
no kernel of this package is involved.

The DRS loop reads its stop flag on the host once an iteration (JAX's
while_loop reads it on the device); an iteration holds two eigen-solves,
which check their status on the host anyway.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.core.linalg import hatmap, nearest_psd, svd_rot
from psulvsb_tpu_torch.utils.precision import mm, pin_float32


def _quat_to_rot_xyzw(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@functools.lru_cache(maxsize=1)
def _p_matrix() -> np.ndarray:
    """vec_colmajor(R) = P @ vec_colmajor(q q^T) with q = (x, y, z, w): the
    QUASAR P (certification.cc:241-251), derived by exact least squares over
    the 10 symmetric monomials q_i q_j from 40 random unit quaternions, the
    off-diagonal coefficients split evenly between (i, j) and (j, i)."""
    rng = np.random.default_rng(0)
    pairs = [(i, j) for i in range(4) for j in range(i, 4)]
    n_s = 40
    lhs = np.zeros((n_s, 10))
    rhs = np.zeros((n_s, 9))
    for s in range(n_s):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        lhs[s] = [q[i] * q[j] for (i, j) in pairs]
        rhs[s] = _quat_to_rot_xyzw(q).reshape(-1, order="F")
    coef, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)  # (10, 9)
    p = np.zeros((9, 16))
    for m, (i, j) in enumerate(pairs):
        if i == j:
            p[:, 4 * j + i] = coef[m]
        else:
            p[:, 4 * j + i] += coef[m] / 2
            p[:, 4 * i + j] += coef[m] / 2
    return np.round(p, 9)


class CertificationResult(NamedTuple):
    """Parity with teaser::CertificationResult (certification.h:30-35)."""

    is_optimal: torch.Tensor  # () bool
    best_suboptimality: torch.Tensor  # ()
    suboptimality_traj: torch.Tensor  # (max_iterations,), inf-padded


def blocks_to_dense(b: torch.Tensor) -> torch.Tensor:
    """(K, K, 4, 4) block tensor -> (4K, 4K)."""
    k = b.shape[0]
    return b.permute(0, 2, 1, 3).reshape(4 * k, 4 * k)


def dense_to_blocks(m: torch.Tensor) -> torch.Tensor:
    """(4K, 4K) -> (K, K, 4, 4)."""
    k = m.shape[0] // 4
    return m.reshape(k, 4, k, 4).permute(0, 2, 1, 3)


def get_q_cost(v1: torch.Tensor, v2: torch.Tensor, noise_bound: float,
               cbar2: float) -> torch.Tensor:
    """QUASAR data matrix Q (certification.cc:233-298) of (3, N) TIMs ->
    (4N+4, 4N+4)."""
    n = v1.shape[1]
    dtype, device = v1.dtype, v1.device
    nbs = cbar2 * noise_bound * noise_bound
    p = torch.as_tensor(_p_matrix(), dtype=dtype, device=device)
    # P_k = reshape_F(P^T vec_F(v2_k v1_k^T)) for all k: (N, 4, 4).
    outer = v2.T[:, :, None] * v1.T[:, None, :]  # [k, r, c]
    vec_f = outer.transpose(1, 2).reshape(n, 9)  # column-major vec
    p_k = mm(vec_f, p).reshape(n, 4, 4).transpose(1, 2)
    sq = (v1 * v1).sum(0) + (v2 * v2).sum(0)
    ck1 = 0.5 * (sq - nbs)
    ck2 = 0.5 * (sq + nbs)
    eye = torch.eye(4, dtype=dtype, device=device)
    q = torch.zeros((n + 1, n + 1, 4, 4), dtype=dtype, device=device)
    row0 = -0.5 * p_k + 0.5 * ck1[:, None, None] * eye  # blocks (0, k+1) and (k+1, 0)
    q[0, 1:] = row0
    q[1:, 0] = row0
    d = torch.arange(1, n + 1, device=device)
    q[d, d] = -p_k + ck2[:, None, None] * eye
    return blocks_to_dense(q)


def rotation_to_quat_xyzw(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w) with w >= 0: the
    leading eigenvector of the symmetric 4x4 matrix built from R."""
    m = r
    t = m[0, 0] + m[1, 1] + m[2, 2]
    rows = [
        [m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0], m[0, 2] + m[2, 0], m[2, 1] - m[1, 2]],
        [m[0, 1] + m[1, 0], m[1, 1] - m[0, 0] - m[2, 2], m[1, 2] + m[2, 1], m[0, 2] - m[2, 0]],
        [m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], m[2, 2] - m[0, 0] - m[1, 1], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1], t],
    ]
    k4 = torch.stack([torch.stack(row) for row in rows]) / 3.0
    _, vecs = torch.linalg.eigh(k4)
    q = vecs[:, -1]
    q = q * torch.sign(q[3] + 1e-30)
    return q / torch.linalg.vector_norm(q)


def get_omega1(q_xyzw: torch.Tensor) -> torch.Tensor:
    """Left quaternion product matrix Omega_1(q) (certification.cc:301-310)."""
    x, y, z, w = q_xyzw[0], q_xyzw[1], q_xyzw[2], q_xyzw[3]
    rows = [[w, -z, y, x], [z, w, -x, y], [-y, x, w, z], [-x, -y, -z, w]]
    return torch.stack([torch.stack(row) for row in rows])


def apply_a_inv(b_grid: torch.Tensor, theta_p: torch.Tensor) -> torch.Tensor:
    """Closed-form A_inv matvec (the JAX module's docstring derives it):
    (x + 2y) B + y (theta R^T - R theta^T) with R_a = sum_k theta_k B[a, k],
    y = 1/(2 N0 + 6) and x + 2y = 1/2.

    b_grid: (K, K, d), the pair values in the upper triangle (i < j; the
    rest is ignored); theta_p: (K,) in {+1, -1} (theta with 1 prepended).
    Returns (K, K, d) with out(i, j) in the upper triangle."""
    k = b_grid.shape[0]
    iu = torch.ones((k, k), dtype=torch.bool, device=b_grid.device).triu(1)[:, :, None]
    b_anti = torch.where(iu, b_grid, 0.0)
    b_anti = b_anti - b_anti.transpose(0, 1)  # antisymmetric B[a, b]
    y = 1.0 / (2.0 * (k - 1) + 6.0)
    rsum = torch.einsum("k,akd->ad", theta_p, b_anti)
    out = 0.5 * b_anti + y * (
        theta_p[:, None, None] * rsum[None, :, :] - theta_p[None, :, None] * rsum[:, None, :]
    )
    return torch.where(iu, out, 0.0)


def dual_projection(w: torch.Tensor, theta_p: torch.Tensor) -> torch.Tensor:
    """getOptimalDualProjection (certification.cc:323-452) in block form.
    w: (4K, 4K); theta_p: (K,). Returns W_dual, (4K, 4K)."""
    k = theta_p.shape[0]
    d = torch.arange(k, device=w.device)
    wb = dense_to_blocks(w)
    iu = torch.ones((k, k), dtype=torch.bool, device=w.device).triu(1)
    tij = (theta_p[:, None] * theta_p[None, :])[:, :, None]

    # b_W(i,j) = -t_ij W[ii][3,:3] + W[ji][3,:3] - W[ij][3,:3] + t_ij W[jj][3,:3]
    # (certification.cc:336-379)
    d_ii = wb[d, d][:, 3, 0:3]
    b_w = (-tij * d_ii[:, None, :] + wb.transpose(0, 1)[:, :, 3, 0:3] - wb[:, :, 3, 0:3]
           + tij * d_ii[None, :, :])
    y_dual = apply_a_inv(b_w, theta_p)

    # Off-diagonal blocks: (W_ij - W_ij^T)/2 with the last column and row
    # replaced, then the block transpose added below the diagonal.
    off = (wb - wb.transpose(2, 3)) / 2.0
    off[:, :, 0:3, 3] = y_dual
    off[:, :, 3, 0:3] = -y_dual
    off = torch.where(iu[:, :, None, None], off, 0.0)
    wd = off + off.permute(1, 0, 3, 2)

    # Diagonal blocks (certification.cc:424-440): the theta-weighted row sum
    # of the last columns as the last column and row (complementary
    # slackness), then the mean top-left 3x3 over the diagonal subtracted.
    row_sum = torch.einsum("j,ija->ia", theta_p, wd[:, :, :, 3])
    w_ii = wb[d, d]  # from W, not W_dual (a copy)
    last = -theta_p[:, None] * row_sum
    w_ii[:, :, 3] = last
    w_ii[:, 3, :] = last
    w_ii[:, 0:3, 0:3] -= w_ii[:, 0:3, 0:3].mean(0)[None]
    wd[d, d] = w_ii
    return blocks_to_dense(wd)


def get_lambda_guess(
    r: torch.Tensor,
    theta: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: float,
    cbar2: float,
) -> torch.Tensor:
    """KKT-slackness initial dual guess (certification.cc:454-536).
    theta: (N,) in {+1, -1}. Returns (4N+4, 4N+4)."""
    n = src.shape[1]
    dtype, device = src.dtype, src.device
    nbs = cbar2 * noise_bound * noise_bound
    xi = mm(r.T, dst - mm(r, src))  # (3, N)
    src_hat = hatmap(src.T)  # (N, 3, 3)
    xi_hat = hatmap(xi.T)
    eye3 = torch.eye(3, dtype=dtype, device=device)

    xi_sq = (xi * xi).sum(0)
    dot_sx = (src * xi).sum(0)
    outer_xs = xi.T[:, :, None] * src.T[:, None, :]
    hh = torch.einsum("nab,nbc->nac", src_hat, src_hat)
    xh = torch.einsum("nab,nbc->nac", xi_hat, src_hat)
    xs_vec = torch.einsum("nab,bn->na", xi_hat, src)

    # The inlier and outlier branches differ only in the 0.75/0.25
    # coefficients (certification.cc:484-509).
    pos = theta > 0
    c44 = torch.where(pos, -0.75 * xi_sq - 0.25 * nbs, -0.25 * xi_sq - 0.75 * nbs)
    c_res = (0.25 + 0.5 * pos.to(dtype))[:, None, None]
    top33 = (
        hh
        - 0.5 * dot_sx[:, None, None] * eye3
        + 0.5 * xh
        + 0.5 * outer_xs
        - c_res * xi_sq[:, None, None] * eye3
        - 0.25 * nbs * eye3
    )
    vec = torch.where(pos[:, None], -1.5 * xs_vec, -0.5 * xs_vec)

    block = torch.zeros((n, 4, 4), dtype=dtype, device=device)
    block[:, 0:3, 0:3] = top33
    block[:, 3, 3] = c44
    block[:, 0:3, 3] = vec
    block[:, 3, 0:3] = vec
    lam = torch.zeros((n + 1, n + 1, 4, 4), dtype=dtype, device=device)
    d = torch.arange(1, n + 1, device=device)
    lam[d, d] = -block
    lam[0, 0] = block.sum(0)
    return blocks_to_dense(lam)


def _min_eig(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.eigvalsh((m + m.T) / 2)[0]


def certify_rotation(
    r_solution: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    theta: torch.Tensor,
    noise_bound: float = 0.01,
    cbar2: float = 1.0,
    max_iterations: int = 200,
    gamma_tau: float = 1.999999,
    sub_optimality: float = 1e-3,
) -> CertificationResult:
    """DRS certification (certify, certification.cc:39-190) on the device
    and in the dtype of `src`. theta: (N,) in {+1, -1}, or bool (True is
    +1). Defaults mirror DRSCertifier::Params (certification.h:74-101)."""
    dtype, device = src.dtype, src.device
    if theta.dtype == torch.bool:
        theta = torch.where(theta, 1.0, -1.0)
    theta = theta.to(dtype)
    n = src.shape[1]
    theta_p = torch.cat([torch.ones(1, dtype=dtype, device=device), theta])

    q_cost = get_q_cost(src, dst, noise_bound, cbar2)
    q_vec = rotation_to_quat_xyzw(r_solution)
    # x = kron(theta_prepended, q), the would-be rank-1 SDP solution
    # (certification.cc:74-75): x[4i + r] = theta_p[i] q[r].
    x = (theta_p[:, None] * q_vec[None, :]).reshape(-1)
    d_omega = torch.kron(torch.eye(n + 1, dtype=dtype, device=device), get_omega1(q_vec))
    q_bar = mm(d_omega.T, mm(q_cost, d_omega))
    mu = x @ mm(q_cost, x)
    j_bar = torch.zeros_like(q_cost)
    j_bar[0:4, 0:4] = torch.eye(4, dtype=dtype, device=device)
    m_init = q_bar - mu * j_bar - get_lambda_guess(r_solution, theta, src, dst, noise_bound,
                                                   cbar2)

    m = m_init
    best = torch.full((), torch.inf, dtype=dtype, device=device)
    traj = torch.full((max_iterations,), torch.inf, dtype=dtype, device=device)
    for it in range(max_iterations):
        m_psd = nearest_psd(m)
        m_affine = m_init + dual_projection(2.0 * m_psd - m - m_init, theta_p)
        min_eig = _min_eig(m_affine)
        gap = torch.where(min_eig > 0, 0.0, (-min_eig * (n + 1)) / mu)
        best = torch.minimum(best, gap)
        traj[it] = gap
        m = m + gamma_tau * (m_affine - m_psd)
        if bool(gap < sub_optimality):
            break
    return CertificationResult(
        is_optimal=best < sub_optimality,
        best_suboptimality=best,
        suboptimality_traj=traj,
    )


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    return t.to(device=device, dtype=dtype)


class DRSCertifier:
    """Class facade mirroring teaser::DRSCertifier (certification.h:53-238)."""

    def __init__(
        self,
        noise_bound: float = 0.01,
        cbar2: float = 1.0,
        max_iterations: int = 200,
        gamma_tau: float = 1.999999,
        sub_optimality: float = 1e-3,
    ):
        self.noise_bound = float(noise_bound)
        self.cbar2 = float(cbar2)
        self.max_iterations = int(max_iterations)
        self.gamma_tau = float(gamma_tau)
        self.sub_optimality = float(sub_optimality)

    def certify(
        self,
        r_solution,
        src,
        dst,
        theta,
        polish: bool = False,
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ) -> CertificationResult:
        """Certify `r_solution` for the TIMs (src, dst) and signs `theta`
        (numpy arrays or tensors), on `device` in `dtype`: float64 on the
        card unless the caller asks otherwise. Without a card device="cuda"
        raises; device="cpu" is the host's float64, the JAX package's
        accurate path. The gap divides -lambda_min by mu ~ noise^2, so it
        needs about 1e-8 eigenvalue resolution; float32 (the JAX package's
        on-device mode) agrees on `is_optimal` and within 2e-2 on the gap on
        the reference's fixtures, and is kept for parity, not as a faster
        path.

        A bool theta means TLS signs (True +1, False -1), the reference's
        primary overload (certification.cc:23): a plain float cast would
        give {1, 0} and certify another problem.

        polish=True certifies the local optimum of one weighted Procrustes
        on the theta-positive set, in `dtype`, instead of `r_solution`: a
        float32 solve carries ~1e-7 of orientation error, which the gap
        amplifies by 1/mu past the 1e-3 threshold. The certificate then
        speaks for the polished rotation."""
        from psulvsb_tpu_torch.solver.fused import resolve_device

        device = resolve_device(device)
        pin_float32()
        theta_t = _as_tensor(theta, device)
        if theta_t.dtype == torch.bool:
            theta_t = torch.where(theta_t, 1.0, -1.0)
        theta_t = theta_t.to(dtype)
        src_t = _as_tensor(src, device, dtype)
        dst_t = _as_tensor(dst, device, dtype)
        r = _as_tensor(r_solution, device, dtype)
        if polish:
            r = svd_rot(src_t, dst_t, (theta_t > 0).to(dtype))
        return certify_rotation(
            r, src_t, dst_t, theta_t,
            noise_bound=self.noise_bound,
            cbar2=self.cbar2,
            max_iterations=self.max_iterations,
            gamma_tau=self.gamma_tau,
            sub_optimality=self.sub_optimality,
        )
