"""Brute-force blocked k-nearest-neighbours (counterpart of
psulvsb_tpu/frontend/knn.py).

For each block of queries one (block, N) tile of squared distances from
||q - p||^2 = ||q||^2 + ||p||^2 - 2 q.p and one torch.topk (the smallest,
first of ties, where k = 1). The JAX package computes this outside any
Pallas kernel, so the port keeps it in library calls.

dist_dtype=torch.float64 expands float32 inputs in float64 and rounds the
distances to float32 once. At coordinates of ~20 the float32 expansion is
off by up to ~2e-4 and its rounding depends on the BLAS, so a neighbour can
cross a radius test on the card and not on the host; expanded in float64,
both devices give the same float32 distances (but for a tie at a rounding
boundary). The FPFH front end asks for it; the default is float32, the
JAX package's form.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.utils.precision import mm


def pairwise_sq_dists(q: torch.Tensor, p: torch.Tensor,
                      dist_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Squared distances between (d, M) queries and (d, N) points -> (M, N)
    in the inputs' dtype, expanded in `dist_dtype` (theirs by default)."""
    dtype = q.dtype
    if dist_dtype is None or dist_dtype == dtype:
        qn = (q * q).sum(0)[:, None]
        pn = (p * p).sum(0)[None, :]
        return torch.clamp(qn + pn - 2.0 * mm(q.T, p), min=0.0)
    q, p = q.to(dist_dtype), p.to(dist_dtype)
    d = torch.addmm((p * p).sum(0)[None, :], q.T, p, alpha=-2.0)  # in place from here
    return d.add_((q * q).sum(0)[:, None]).clamp_(min=0.0).to(dtype)


def knn(
    query: torch.Tensor,
    points: torch.Tensor,
    k: int,
    point_active: torch.Tensor | None = None,
    block: int = 2048,
    dist_dtype: torch.dtype | None = None,
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
        dist = pairwise_sq_dists(query[:, q0:q0 + block], points, dist_dtype)
        if point_active is not None:
            dist = torch.where(point_active[None, :], dist, torch.inf)
        if k == 1:  # the first of tied minima, as XLA's top_k gives it
            near, idx = dist.min(dim=1, keepdim=True)
        else:
            near, idx = torch.topk(dist, k, dim=1, largest=False, sorted=True)
        idxs.append(idx)
        dists.append(near)
    if not idxs:
        empty = torch.zeros((0, k), device=query.device)
        return empty.to(torch.int64), empty.to(query.dtype)
    return torch.cat(idxs), torch.cat(dists)
