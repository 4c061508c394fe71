"""ISS (Intrinsic Shape Signature) keypoints (port of
psulvsb_tpu/frontend/iss.py; PCL's ISSKeypoint3D stage of the correspondence
generator, teaser_cpp_ply.cc:113-139: salient radius 6r, non-max radius 4r,
gamma_21 = gamma_32 = 0.975, min_neighbors = 5).

kNN neighbourhoods with radius masks, a batched 3x3 eigvalsh, the gamma
tests and non-maximum suppression on the smallest eigenvalue; library calls
on the device of the input.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.core.linalg import batched_eigh
from psulvsb_tpu_torch.frontend.knn import knn


def iss_keypoints(
    points: torch.Tensor,
    salient_radius: float,
    non_max_radius: float,
    gamma_21: float = 0.975,
    gamma_32: float = 0.975,
    min_neighbors: int = 5,
    k: int = 64,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N,) bool keypoint mask of a (3, N) cloud."""
    n = points.shape[1]
    dtype, device = points.dtype, points.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=device)

    def squared(r):  # in the points' dtype, as the JAX package squares its traced radius
        return (torch.as_tensor(r, dtype=dtype) ** 2).to(device)

    idx, sqd = knn(points, points, k=min(k, n), point_active=active, dist_dtype=torch.float64)
    in_salient = (sqd <= squared(salient_radius)) & active[idx]

    # Plain scatter covariance of the salient neighbourhood (PCL weights by
    # inverse local density; the JAX package takes the plain form too), and
    # its eigenvalues, in float64: the gamma tests and the suppression then
    # decide alike on the card and on the host (frontend/normals.py says why).
    neigh = points.T[idx].to(torch.float64)  # (N, K, 3)
    w = in_salient.to(torch.float64)
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = torch.einsum("nk,nkd->nd", w, neigh) / cnt[:, None]
    cen = (neigh - mean[:, None, :]) * w[:, :, None]
    cov = torch.einsum("nkd,nke->nde", cen, cen) / cnt[:, None, None]
    evals = batched_eigh(cov, vectors=False)  # ascending: l3, l2, l1
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]

    ok = (
        (l2 / torch.clamp(l1, min=1e-30) < gamma_21)
        & (l3 / torch.clamp(l2, min=1e-30) < gamma_32)
        & (in_salient.sum(1) >= min_neighbors)
        & (l3 > 0)
        & active
    )

    # Non-maximum suppression on l3 within non_max_radius.
    in_nms = (sqd <= squared(non_max_radius)) & active[idx]
    sal = torch.where(ok, l3, -torch.inf)
    neigh_sal = torch.where(in_nms, sal[idx], -torch.inf)
    return ok & (sal >= neigh_sal.max(1).values)
