"""Surface normals by neighbourhood PCA (counterpart of
psulvsb_tpu/frontend/normals.py; the reference programs' PCL normal estimation,
PSULVSB.cc:35-85): brute-force kNN, one batched 3x3 eigen-decomposition, the
eigenvector of the smallest eigenvalue, flipped towards the viewpoint as PCL
flips it (the origin by default).
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.frontend.knn import knn


def neighbourhood_normals(
    points: torch.Tensor,
    k: int = 20,
    active: torch.Tensor | None = None,
    radius: float | None = None,
) -> torch.Tensor:
    """Unoriented unit normals (3, N): the smallest-eigenvalue eigenvector
    of each point's neighbourhood covariance. Its sign is the eigen-solver's
    choice; `estimate_normals` fixes it."""
    idx, d2 = knn(points, points, k, point_active=active)  # (N, k) incl. self
    k = idx.shape[1]
    neigh = points[:, idx]  # (3, N, k)
    if radius is not None:
        # The radius search of the reference (setRadiusSearch, fpfh.cc:30),
        # bounded by the k nearest; the self-neighbour keeps the count >= 1.
        w = (d2 <= float(radius) ** 2).to(points.dtype)
        cnt = w.sum(1)[:, None]  # (N, 1)
        mean = (neigh * w[None]).sum(2, keepdim=True) / cnt[None]
        centered = (neigh - mean) * w[None]
        cov = torch.einsum("ink,jnk->nij", centered, centered) / cnt[:, :, None]
    else:
        centered = neigh - neigh.mean(2, keepdim=True)
        cov = torch.einsum("ink,jnk->nij", centered, centered) / k
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    return vecs[:, :, 0].T


def estimate_normals(
    points: torch.Tensor,
    k: int = 20,
    active: torch.Tensor | None = None,
    viewpoint: torch.Tensor | None = None,
    radius: float | None = None,
) -> torch.Tensor:
    """Normals of a (3, N) cloud, oriented towards `viewpoint` (PCL's
    flipNormalTowardsViewpoint). Returns (3, N) unit columns.

    radius: when given, neighbours beyond it are left out of the covariance;
    without it, plain kNN (the KSearch(20) form of PSULVSB.cc:52)."""
    normal = neighbourhood_normals(points, k, active, radius)
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=points.dtype, device=points.device)
    to_vp = viewpoint.to(points)[:, None] - points
    flip = (normal * to_vp).sum(0) < 0
    normal = torch.where(flip[None, :], -normal, normal)
    norm = torch.sqrt((normal * normal).sum(0, keepdim=True))
    return normal / torch.clamp(norm, min=1e-30)
