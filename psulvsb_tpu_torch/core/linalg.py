"""Rotation from a weighted correlation, and weighted rigid fits.

Point-set convention: (3, N) matrices, points as columns, as in the JAX
package. Every function here also takes leading batch dimensions:
(..., 3, N) point sets and (..., 3, 3) correlations.

Functional equivalents of teaser::utils::svdRot (utils.h:121-136), the
core of weightedSVD (registration.cc:526-569) and the small helpers of
teaser/linalg.h (hatmap, vectorKron, getNearestPSD). The rotation is the leading
eigenvector of the 4x4 Davenport matrix (Horn 1987), which gives the
Kabsch rotation with the reflection fix and no sign branch.
"""

from __future__ import annotations

import numpy as np
import torch

from psulvsb_tpu_torch.utils.precision import mm


def hatmap(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (hat) map of 3-vectors: (..., 3) -> (..., 3, 3)
    (linalg.h:24-32)."""
    z = torch.zeros_like(v[..., 0])
    rows = [
        [z, -v[..., 2], v[..., 1]],
        [v[..., 2], z, -v[..., 0]],
        [-v[..., 1], v[..., 0], z],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def vector_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column-wise Kronecker product of (d1, N) and (d2, N) -> (d1*d2, N)
    (linalg.h:43-72)."""
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"vector_kron: {a.shape[1]} != {b.shape[1]} columns")
    return (a[:, None, :] * b[None, :, :]).reshape(a.shape[0] * b.shape[0], a.shape[1])


def nearest_psd(a: torch.Tensor) -> torch.Tensor:
    """Projection of a symmetric matrix onto the PSD cone by clamping its
    eigenvalues at 0 (linalg.h:84-99)."""
    w, v = torch.linalg.eigh((a + a.T) / 2)
    return mm(v * torch.clamp(w, min=0)[None, :], v.T)


# torch.linalg.eigh takes cuSOLVER's batched solver (cusolverDnXsyevBatched)
# for a batch of small matrices on the card, and that solver refuses a large
# batch of 3x3 matrices with CUSOLVER_STATUS_INVALID_VALUE (seen on the H100
# at the 44027 covariances of the KITTI example's voxel grid). The front end
# solves one 3x3 covariance a point, so it goes through `batched_eigh` in
# chunks of EIGH_BATCH, which chip_smoke.py holds to the host's solve.
EIGH_BATCH = 16384


def batched_eigh(a: torch.Tensor, vectors: bool = True):
    """torch.linalg.eigh (vectors=True) or eigvalsh of a (B, n, n) batch of
    symmetric matrices, EIGH_BATCH matrices a call. Each matrix is solved
    alone either way, so the chunks change no result."""
    fn = torch.linalg.eigh if vectors else torch.linalg.eigvalsh
    if a.shape[0] <= EIGH_BATCH:
        return fn(a)
    parts = [fn(a[i:i + EIGH_BATCH]) for i in range(0, a.shape[0], EIGH_BATCH)]
    if not vectors:
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _davenport_matrix(s: torch.Tensor) -> torch.Tensor:
    """Davenport K (..., 4, 4) from the correlation S = sum_i w_i x_i y_i^T
    (..., 3, 3); rows/cols in quaternion (w, x, y, z) order."""
    sxx, sxy, sxz = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    syx, syy, syz = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    szx, szy, szz = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    rows = [
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) in (w, x, y, z) order -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


# Cyclic Jacobi on a 4x4 matrix: the three rounds of two disjoint plane
# rotations that cover all six off-diagonal pairs.
_JACOBI_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))
_JACOBI_SWEEPS = 6  # off-diagonal mass falls quadratically; 4x4 needs 4-5


def _jacobi_top_eigenvector(k: torch.Tensor) -> torch.Tensor:
    """Eigenvector (..., 4) of the largest eigenvalue of the symmetric
    (..., 4, 4) matrix k by cyclic Jacobi sweeps in float64, as elementwise
    and matmul operations of fixed count: nothing is read on the host, so it
    can run inside a CUDA graph, which torch.linalg.eigh cannot (it checks
    its status on the host)."""
    a = k.to(torch.float64)
    eye = torch.eye(4, dtype=torch.float64, device=k.device)
    v = eye.expand(a.shape).clone()
    for _ in range(_JACOBI_SWEEPS):
        for pairs in _JACOBI_ROUNDS:
            app = torch.stack([a[..., p, p] for p, _ in pairs], -1)
            aqq = torch.stack([a[..., q, q] for _, q in pairs], -1)
            apq = torch.stack([a[..., p, q] for p, q in pairs], -1)
            # G^T A G with G[p,p] = G[q,q] = c, G[p,q] = s, G[q,p] = -s
            # zeroes a_pq when tan(2 theta) = 2 a_pq / (a_qq - a_pp).
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c, s = torch.cos(theta), torch.sin(theta)
            zero = torch.zeros_like(c[..., 0])
            rows = [[zero] * 4 for _ in range(4)]
            for n, (p, q) in enumerate(pairs):
                rows[p][p] = rows[q][q] = c[..., n]
                rows[p][q] = s[..., n]
                rows[q][p] = -s[..., n]
            g = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
            a = g.transpose(-1, -2) @ a @ g
            v = v @ g
    top = torch.argmax(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
    q = torch.gather(v, -1, top[..., None, None].expand(*v.shape[:-1], 1))[..., 0]
    return q.to(k.dtype)


def rot_from_correlation(h: torch.Tensor, method: str = "eigh") -> torch.Tensor:
    """Proper rotation R maximizing tr(R^T H) for H = sum_i w_i x_i y_i^T.

    method:
      "eigh"  — torch.linalg.eigh on the 4x4 Davenport matrix;
      "jacobi" — the same eigenvector by Jacobi sweeps in float64 with no
                host read (`_jacobi_top_eigenvector`);
      "power" — shifted power iteration: 5 squarings of K + shift*I, each
                normalized, then the largest-norm column (the first maximum
                wins), which is a scaled dominant eigenvector whatever its
                orientation.
    """
    k = _davenport_matrix(h)
    if method == "eigh":
        _, vecs = torch.linalg.eigh(k)
        q = vecs[..., :, -1]
    elif method == "jacobi":
        q = _jacobi_top_eigenvector(k)
    elif method == "power":
        shift = 2.0 * torch.sqrt((h * h).sum(dim=(-2, -1))) + 1e-12
        eye = torch.eye(4, dtype=k.dtype, device=k.device)
        ks = k + shift[..., None, None] * eye
        for _ in range(5):
            ks = mm(ks, ks)
            ks = ks / (torch.sqrt((ks * ks).sum(dim=(-2, -1)))[..., None, None] + 1e-30)
        col = torch.argmax((ks * ks).sum(dim=-2), dim=-1)  # (...,)
        q = torch.gather(ks, -1, col[..., None, None].expand(*ks.shape[:-1], 1))[..., 0]
    else:
        raise ValueError(f"unknown method {method!r}")
    return _quat_to_rot(q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-30))


def svd_rot(
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor | None = None,
    method: str = "eigh",
) -> torch.Tensor:
    """Weighted Procrustes: rotation R with y ≈ R x (both (..., 3, N));
    inactive columns carry zero weight (utils.h:121-136)."""
    if w is None:
        w = torch.ones(x.shape[:-2] + x.shape[-1:], dtype=x.dtype, device=x.device)
    h = mm(x * w[..., None, :], y.transpose(-1, -2))  # S_ab = sum_i w_i x_a y_b
    return rot_from_correlation(h, method=method)


def weighted_procrustes_srt(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    method: str = "eigh",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid fit (R, t) minimizing sum_i w_i ||R src_i + t - dst_i||^2
    over (3, N) point sets (registration.cc:526-569 without the transform
    composition, which the caller does)."""
    total = w.sum() + 1e-30
    c_src = mm(src, w) / total
    c_dst = mm(dst, w) / total
    xs = src - c_src[:, None]
    ys = dst - c_dst[:, None]
    h = mm(xs * w[None, :], ys.T)
    r = rot_from_correlation(h, method=method)
    t = c_dst - mm(r, c_src)
    return r, t


# --- small teaser::utils parity helpers (utils.h:31-171) ---------------------


def random_sample(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct indices from [0, n) on the generator's device —
    utils::randomSample (utils.h:31-56; the reference's rejection loop
    becomes a permutation slice)."""
    return torch.randperm(n, generator=generator, device=generator.device)[:k]


def mask_vector(mask, elements) -> list:
    """utils::maskVector (utils.h:144-157): the elements where mask is True.
    Host-side helper (the output's size depends on the data)."""
    mask = np.asarray(_host(mask), bool)
    return [e for e, m in zip(elements, mask) if m]


def find_nonzero(mask) -> list[int]:
    """utils::findNonzero (utils.h:164-171). Host-side helper."""
    return [int(i) for i in np.nonzero(np.asarray(_host(mask)))[0]]


def remove_columns(arr, cols) -> np.ndarray:
    """utils::removeColumn generalization (utils.h:58-105): `arr` without
    the columns `cols`, as a numpy array. Host-side."""
    arr = np.asarray(_host(arr))
    keep = np.ones(arr.shape[1], bool)
    keep[list(cols)] = False
    return arr[:, keep]


def _host(x):
    """A tensor as a numpy array on the host; anything else as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
