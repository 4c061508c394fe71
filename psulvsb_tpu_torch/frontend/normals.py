"""Surface normals by neighbourhood PCA (counterpart of
psulvsb_tpu/frontend/normals.py; the reference programs' PCL normal estimation,
PSULVSB.cc:35-85): brute-force kNN, one batched 3x3 eigen-decomposition, the
eigenvector of the smallest eigenvalue, flipped towards the viewpoint as PCL
flips it (the origin by default).
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.core.linalg import batched_eigh
from psulvsb_tpu_torch.frontend.knn import knn


def neighbourhood_normals(
    points: torch.Tensor,
    k: int = 20,
    active: torch.Tensor | None = None,
    radius: float | None = None,
    solve_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Unoriented unit normals (3, N): the smallest-eigenvalue eigenvector
    of each point's neighbourhood covariance. Its sign is the eigen-solver's
    choice; `estimate_normals` fixes it.

    solve_dtype: the dtype of the neighbour distances (knn's dist_dtype),
    the covariance and its eigen-decomposition (the points' by default, as
    in the JAX package); the normal is returned in the points' dtype. The
    FPFH front end asks for float64: a float32 solve differs between LAPACK
    and the card's solver by ~1e-6, and FPFH's source/target swap rule
    (|n1.d| < |n2.d|, both near 0 on a plane) turns that into other
    histogram bins, while in float64 both devices give the same float32
    normals."""
    solve_dtype = solve_dtype or points.dtype
    idx, d2 = knn(points, points, k, point_active=active, dist_dtype=solve_dtype)
    k = idx.shape[1]
    neigh = points[:, idx].to(solve_dtype)  # (3, N, k)
    if radius is not None:
        # The radius search of the reference (setRadiusSearch, fpfh.cc:30),
        # bounded by the k nearest; the self-neighbour keeps the count >= 1.
        w = (d2 <= float(radius) ** 2).to(solve_dtype)
        cnt = w.sum(1)[:, None]  # (N, 1)
        mean = (neigh * w[None]).sum(2, keepdim=True) / cnt[None]
        centered = (neigh - mean) * w[None]
        cov = torch.einsum("ink,jnk->nij", centered, centered) / cnt[:, :, None]
    else:
        centered = neigh - neigh.mean(2, keepdim=True)
        cov = torch.einsum("ink,jnk->nij", centered, centered) / k
    _, vecs = batched_eigh(cov)  # ascending eigenvalues
    return vecs[:, :, 0].T.to(points.dtype)


def estimate_normals(
    points: torch.Tensor,
    k: int = 20,
    active: torch.Tensor | None = None,
    viewpoint: torch.Tensor | None = None,
    radius: float | None = None,
    solve_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Normals of a (3, N) cloud, oriented towards `viewpoint` (PCL's
    flipNormalTowardsViewpoint). Returns (3, N) unit columns.

    radius: when given, neighbours beyond it are left out of the covariance;
    without it, plain kNN (the KSearch(20) form of PSULVSB.cc:52)."""
    normal = neighbourhood_normals(points, k, active, radius, solve_dtype)
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=points.dtype, device=points.device)
    to_vp = viewpoint.to(points)[:, None] - points
    flip = (normal * to_vp).sum(0) < 0
    normal = torch.where(flip[None, :], -normal, normal)
    norm = torch.sqrt((normal * normal).sum(0, keepdim=True))
    return normal / torch.clamp(norm, min=1e-30)
