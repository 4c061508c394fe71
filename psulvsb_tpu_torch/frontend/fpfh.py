"""FPFH-33 descriptors on fixed-K neighbourhoods (port of
psulvsb_tpu/frontend/fpfh.py; teaser::FPFHEstimation, fpfh.cc:15-43, a PCL
wrapper: radius search -> SPFH pair-feature histograms -> distance-weighted
neighbour pooling).

- neighbourhoods: the k + 1 nearest by frontend/knn.py with the self
  column dropped and a radius mask (PCL searches the radius alone; a cap of
  k keeps the shapes fixed),
- Darboux pair features (f1 = atan2(w.n_t, n_s.n_t), f2 = v.n_t,
  f3 = n_s.d/|d|) for every (point, neighbour) lane at once,
- SPFH: three 11-bin histograms a point by scatter-add, each neighbour
  adding 100 / n_neighbours (PCL's hist_incr),
- FPFH(p) = SPFH(p) + (1/K) sum_k (1/d_k^2) SPFH(q_k), then each 11-bin
  block renormalized to sum 100.

The JAX package computes all of it outside any Pallas kernel; here it is
library calls on the device of the input tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from psulvsb_tpu_torch.frontend.knn import knn
from psulvsb_tpu_torch.frontend.normals import estimate_normals
from psulvsb_tpu_torch.utils.precision import pin_float32


# Dot and cross products of (..., 3) vectors written as one elementwise
# operation each, every one rounded on its own: a fused kernel (a reduction,
# linalg.cross) may contract a*b + c into one rounding on the card and not on
# the host, and the swap rule below decides on differences of that size.
def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def pair_features(p1: torch.Tensor, n1: torch.Tensor, p2: torch.Tensor, n2: torch.Tensor):
    """Darboux-frame pair features over (..., 3) points and normals.
    Returns (f1, f2, f3, dist, valid) under PCL's source/target swap rule:
    the point whose normal is better aligned with the connecting line is
    the source."""
    d = p2 - p1
    dist = torch.sqrt(_dot3(d, d))
    safe = torch.clamp(dist, min=1e-20)
    a1 = _dot3(n1, d) / safe
    a2 = _dot3(n2, d) / safe
    swap = torch.abs(a1) < torch.abs(a2)  # acos(|a1|) > acos(|a2|)

    ns = torch.where(swap[..., None], n2, n1)
    nt = torch.where(swap[..., None], n1, n2)
    ds = torch.where(swap[..., None], -d, d)
    f3 = torch.where(swap, -a2, a1)

    v = _cross3(ds, ns)
    v_norm = torch.sqrt(_dot3(v, v))
    valid = (dist > 1e-12) & (v_norm > 1e-12)
    v = v / torch.clamp(v_norm, min=1e-20)[..., None]
    w = _cross3(ns, v)
    f2 = _dot3(v, nt)
    f1 = torch.atan2(_dot3(w, nt), _dot3(ns, nt))
    return f1, f2, f3, dist, valid


def _bin11(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(torch.floor(11.0 * (f - lo) / (hi - lo)).to(torch.int64), 0, 10)


def compute_fpfh(
    points: torch.Tensor,
    normals: torch.Tensor,
    radius: float,
    k: int = 64,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """FPFH-33 features (N, 33) of a (3, N) cloud with (3, N) normals, on
    their device. Neighbours are the k nearest within `radius` (PCL's
    setRadiusSearch); inactive points get zero rows and are nobody's
    neighbour."""
    n = points.shape[1]
    dtype = points.dtype
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=points.device)
    idx, sqd = knn(points, points, k=min(k + 1, n), point_active=active,
                   dist_dtype=torch.float64)
    idx, sqd = idx[:, 1:], sqd[:, 1:]  # drop self
    r2 = torch.as_tensor(radius, dtype=dtype) ** 2  # squared in the points' dtype, as JAX
    nb_ok = (sqd <= r2.to(points.device)) & active[idx] & active[:, None]

    pts, nrm = points.T, normals.T
    p2, n2 = pts[idx], nrm[idx]  # (N, K, 3)
    f1, f2, f3, _, valid = pair_features(pts[:, None, :].expand_as(p2),
                                         nrm[:, None, :].expand_as(n2), p2, n2)
    ok = nb_ok & valid

    n_nb = torch.clamp(ok.sum(1), min=1).to(dtype)
    incr = (100.0 / n_nb)[:, None] * ok.to(dtype)  # (N, K)

    def hist(bins):
        return torch.zeros((n, 11), dtype=dtype, device=points.device).scatter_add_(1, bins, incr)

    spfh = torch.cat([hist(_bin11(f1, -math.pi, math.pi)), hist(_bin11(f2, -1.0, 1.0)),
                      hist(_bin11(f3, -1.0, 1.0))], dim=1)  # (N, 33)

    # Distance-weighted neighbour pooling.
    w = torch.where(ok, 1.0 / torch.clamp(sqd, min=1e-12), 0.0)
    neighbour_sum = torch.einsum("nk,nkf->nf", w, spfh[idx])
    fpfh = spfh + neighbour_sum / n_nb[:, None]

    blocks = fpfh.reshape(n, 3, 11)
    sums = torch.clamp(blocks.sum(2, keepdim=True), min=1e-12)
    out = (blocks / sums * 100.0).reshape(n, 33)
    return torch.where(active[:, None], out, 0.0)


class FPFHEstimation:
    """Class facade mirroring teaser::FPFHEstimation (fpfh.h:22-83)."""

    def __init__(self, normal_k: int = 20, neighbor_cap: int = 64):
        self.normal_k = normal_k
        self.neighbor_cap = neighbor_cap

    def computeFPFHFeatures(self, points, normal_search_radius: float,
                            fpfh_search_radius: float, device="cuda") -> torch.Tensor:
        """computeFPFHFeatures(cloud, normal_radius, fpfh_radius)
        (fpfh.cc:15-43) of (3, N) points, numpy or a tensor, on `device`:
        the card unless the caller asks for the CPU. Returns (N, 33)
        features there. Normals are radius-bounded like the reference's
        setRadiusSearch (fpfh.cc:30), normal_k capping the neighbourhood."""
        from psulvsb_tpu_torch.solver.fused import resolve_device

        device = resolve_device(device)
        pin_float32()
        pts = points if isinstance(points, torch.Tensor) else torch.as_tensor(np.asarray(points))
        pts = pts.to(device=device, dtype=torch.float32)
        normals = estimate_normals(pts, k=self.normal_k, radius=float(normal_search_radius),
                                   solve_dtype=torch.float64)
        return compute_fpfh(pts, normals, fpfh_search_radius, k=self.neighbor_cap)
