"""Brute-force blocked k-nearest-neighbours (counterpart of
psulvsb_tpu/frontend/knn.py).

For each block of queries one (block, N) tile of squared distances from
||q - p||^2 = ||q||^2 + ||p||^2 - 2 q.p (one float32 matmul, TF32 off) and
one torch.topk. The JAX package computes this outside any Pallas kernel, so
the port keeps it in library calls.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.utils.precision import mm


def pairwise_sq_dists(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances between (d, M) queries and (d, N) points -> (M, N)."""
    qn = (q * q).sum(0)[:, None]
    pn = (p * p).sum(0)[None, :]
    return torch.clamp(qn + pn - 2.0 * mm(q.T, p), min=0.0)


def knn(
    query: torch.Tensor,
    points: torch.Tensor,
    k: int,
    point_active: torch.Tensor | None = None,
    block: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query column among the point columns.

    query: (d, M), points: (d, N), on one device. Returns (indices (M, k)
    int64, squared distances (M, k)), ascending. Inactive points get +inf
    distance (never selected while k active points exist). There is no query
    mask: inactive queries return ordinary results that callers mask."""
    m = query.shape[1]
    n = points.shape[1]
    k = min(k, n)
    # Bound the live (block, N) distance tile to ~256M elements (1 GiB of
    # float32) so clouds of ~1e5 points do not exhaust device memory.
    block = int(min(block, max(128, (1 << 28) // max(n, 1))))
    idxs, dists = [], []
    for q0 in range(0, m, block):
        dist = pairwise_sq_dists(query[:, q0:q0 + block], points)
        if point_active is not None:
            dist = torch.where(point_active[None, :], dist, torch.inf)
        near, idx = torch.topk(dist, k, dim=1, largest=False, sorted=True)
        idxs.append(idx)
        dists.append(near)
    if not idxs:
        empty = torch.zeros((0, k), device=query.device)
        return empty.to(torch.int64), empty.to(query.dtype)
    return torch.cat(idxs), torch.cat(dists)
