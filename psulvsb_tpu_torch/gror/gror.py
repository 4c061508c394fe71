"""GROR — Graph Reliability Outlier Removal initial alignment, on PyTorch.

Port of psulvsb_tpu/gror/gror.py, the vendored GRORInitialAlignment
(ia_gror.hpp, used by registration_artificial.cc:571-576 with resolution =
voxel size and n_optimal = 800):

1. **Node reliability** (ia_gror.hpp:125-193): each correspondence's degree
   in the length-consistency graph (| |e_s| - |e_t| | < 2 resolution), from
   the kernel `ops.pairs.consistency_degree`; the K most reliable are kept.
2. **Edge reliability** (ia_gror.hpp:199-259): every kept node proposes the
   edge to its best consistent partner; all K edges are evaluated at once as
   (K, 3, K) tensors: the exact two-pair alignment, the relaxed constraint
   count (RCFS) and the 1-D angular interval stab about the edge axis
   (TCFS). The first largest TCFS count wins.
3. **Refinement** (ia_gror.hpp:259-379): inliers within 2 resolution under
   the winning transform, then a weighted Procrustes fit.

Ties are broken as the JAX package breaks them: the top-K selection runs on
the unique key degree * C + (C - 1 - index), so equal degrees keep the lower
index first as XLA's top_k does, and every argmax takes the first maximum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.core.linalg import weighted_procrustes_srt
from psulvsb_tpu_torch.ops.pairs import consistency_degree
from psulvsb_tpu_torch.utils.precision import mm, pin_float32
from psulvsb_tpu_torch.utils.scalars import pick as _pick

_TWOPI = 2.0 * math.pi
_EPS = 1e-7
_F32 = torch.float32


class GRORResult(NamedTuple):
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    best_count: torch.Tensor  # () int64 — TCFS consensus of the winning edge
    inliers: torch.Tensor  # (C,) bool over input correspondences


def _norm(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Euclidean norm as sqrt(sum(v * v)), the form jnp.linalg.norm takes."""
    return torch.sqrt((v * v).sum(dim))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    rows = [
        [z, -v[..., 2], v[..., 1]],
        [v[..., 2], z, -v[..., 0]],
        [-v[..., 1], v[..., 0], z],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _two_vectors_align(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation taking unit vector a to unit vector b (ia_gror.hpp:443-458),
    batched over leading dims; near antiparallel (c < -0.999) a 180-degree
    flip about an axis orthogonal to a."""
    v = torch.linalg.cross(a, b, dim=-1)
    c = (a * b).sum(-1)
    vx = _skew(v)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    r = eye + vx + mm(vx, vx) * (1.0 / torch.clamp(1.0 + c, min=1e-6))[..., None, None]
    # The unit vectors are rows of `eye`: made on the device, no host copy.
    ortho = torch.where((torch.abs(a[..., 0]) < 0.9)[..., None], eye[0], eye[1])
    axis = torch.linalg.cross(a, ortho, dim=-1)
    axis = axis / torch.clamp(_norm(axis, -1), min=1e-20)[..., None]
    flip = 2.0 * axis[..., :, None] * axis[..., None, :] - eye
    return torch.where((c < -0.999)[..., None, None], flip, r)


def _axis_angle_rotation(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about `axis` (..., 3) by `angle` (...)."""
    axis = axis / torch.clamp(_norm(axis, -1), min=1e-20)[..., None]
    vx = _skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return (
        eye
        + torch.sin(angle)[..., None, None] * vx
        + (1.0 - torch.cos(angle))[..., None, None] * mm(vx, vx)
    )


def _interval_stab_one_to_one(
    beg: torch.Tensor, end: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max stabbing over [begin, end] angle intervals (the one_to_one branch
    of intervalStab, ia_gror.hpp:592-616), batched over leading dims: count
    = #starts <= x minus #ends < x, maximized over start locations.

    The JAX lexsort((-deltas, locs)) is two stable sorts, the secondary key
    first, so starts come before ends on equal angles. Returns (angle (...),
    count (...) int64)."""
    big = torch.full_like(beg, 1e9)
    locs = torch.cat([torch.where(valid, beg, big), torch.where(valid, end, big)], dim=-1)
    one = torch.ones_like(beg)
    zero = torch.zeros_like(beg)
    deltas = torch.cat([torch.where(valid, one, zero), torch.where(valid, -one, zero)], dim=-1)
    order = torch.sort(-deltas, dim=-1, stable=True).indices
    locs1 = torch.gather(locs, -1, order)
    order2 = torch.sort(locs1, dim=-1, stable=True).indices
    order = torch.gather(order, -1, order2)
    d_s = torch.gather(deltas, -1, order)
    l_s = torch.gather(locs, -1, order)
    cnt = torch.cumsum(d_s, dim=-1)
    score = torch.where(d_s > 0, cnt, -torch.ones_like(cnt))
    best = torch.argmax(score, dim=-1, keepdim=True)
    return (
        torch.gather(l_s, -1, best)[..., 0],
        torch.gather(score, -1, best)[..., 0].to(torch.int64),
    )


def _fmod_positive(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m in [0, m) for m > 0, computed as jnp.mod does: the truncated
    remainder, moved up by m where it is negative."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def _evaluate_edges(
    e_i: torch.Tensor,
    e_j: torch.Tensor,
    src_k: torch.Tensor,
    dst_k: torch.Tensor,
    corr_active: torch.Tensor,
    resolution: float,
):
    """Every candidate edge (e_i[e], e_j[e]) at once: two-pair align + RCFS
    + TCFS over the K selected points src_k/dst_k (3, K). Returns per edge
    (rcfs count (E,), tcfs count (E,), angle (E,), r0 (E, 3, 3), t0 (E, 3),
    axis (E, 3), origin (E, 3))."""
    thr = 2.0 * resolution
    dtype, dev = src_k.dtype, src_k.device
    pts_s = src_k.T  # (K, 3)
    pts_t = dst_k.T
    s1, t1 = pts_s[e_i], pts_t[e_i]  # (E, 3)
    s2, t2 = pts_s[e_j], pts_t[e_j]

    def unit(v):
        return v / torch.clamp(_norm(v, -1), min=1e-20)[:, None]

    vec_s = unit(s1 - s2)
    axis_t = unit(t1 - t2)
    r0 = _two_vectors_align(vec_s, axis_t)  # (E, 3, 3)
    t0 = 0.5 * ((t1 - mm(r0, s1[:, :, None])[..., 0]) + (t2 - mm(r0, s2[:, :, None])[..., 0]))
    origin = t1

    # --- RCFS (ia_gror.hpp:474-521) ----------------------------------------
    diff_s = src_k[None] - s1[:, :, None]  # (E, 3, K)
    diff_t = dst_k[None] - t1[:, :, None]
    dist_s = _norm(diff_s, 1)
    dist_t = _norm(diff_t, 1)
    axis_s = mm(r0.transpose(-1, -2), axis_t[:, :, None])[..., 0]
    proj = torch.abs(
        (diff_t * axis_t[:, :, None]).sum(1) - (diff_s * axis_s[:, :, None]).sum(1)
    )
    rcfs = (torch.abs(dist_t - dist_s) < thr) & (proj < thr) & corr_active[None]
    rcfs_count = rcfs.sum(1)

    # --- TCFS (ia_gror.hpp:619-748) -----------------------------------------
    # Local frame: origin -> 0, axis -> z; the source pre-moved by the
    # two-pair transform.
    e_z = torch.eye(3, dtype=dtype, device=dev)[2].expand_as(axis_t)
    r_loc = _two_vectors_align(axis_t, e_z)
    t_loc = dst_k[None] - origin[:, :, None]
    s_loc = mm(r_loc, mm(r0, src_k) + t0[:, :, None] - origin[:, :, None])
    t_loc = mm(r_loc, t_loc)

    m_len = torch.sqrt(s_loc[:, 0] ** 2 + s_loc[:, 1] ** 2)
    b_len = torch.sqrt(t_loc[:, 0] ** 2 + t_loc[:, 1] ** 2)
    m_azi = torch.atan2(s_loc[:, 1], s_loc[:, 0])
    b_azi = torch.atan2(t_loc[:, 1], t_loc[:, 0])
    dz = t_loc[:, 2] - s_loc[:, 2]
    d_len = b_len - m_len

    th_mz = thr * thr - dz * dz
    feasible = (d_len * d_len <= th_mz) & corr_active[None] & (th_mz > 0)
    rth = torch.sqrt(torch.clamp(th_mz, min=0.0))

    # circleIntersection(R = m_len, d = b_len, r = rth) (ia_gror.hpp:538-571).
    x = (b_len * b_len - rth * rth + m_len * m_len) / torch.clamp(2.0 * b_len, min=1e-20)
    rat = x / torch.clamp(m_len, min=1e-20)
    pi = torch.full_like(rat, math.pi)
    dev_ang = torch.where(
        (b_len <= _EPS) | (rat <= -1.0), pi, torch.arccos(torch.clamp(rat, -1.0, 1.0))
    )
    full = (m_len <= _EPS) | (torch.abs(dev_ang - pi) <= _EPS)

    beg = _fmod_positive(b_azi - dev_ang - m_azi, _TWOPI)
    end = _fmod_positive(b_azi + dev_ang - m_azi, _TWOPI)
    # Wrap-around split: [beg, 2pi] + [0, end] when end < beg; a full circle
    # becomes [0, 2pi]. Two interval slots per correspondence.
    wrap = (end < beg) & ~full
    zero = torch.zeros_like(beg)
    twopi = torch.full_like(beg, _TWOPI)
    beg1 = torch.where(full, zero, beg)
    end1 = torch.where(full | wrap, twopi, end)
    end2 = torch.where(wrap, end, zero)
    angle, tcfs_count = _interval_stab_one_to_one(
        torch.cat([beg1, zero], dim=-1),
        torch.cat([end1, end2], dim=-1),
        torch.cat([feasible, feasible & wrap], dim=-1),
    )
    return rcfs_count, tcfs_count, angle, r0, t0, axis_t, origin


def _top_k_lower_index_first(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest int values, ties by lower index first (the
    order of XLA's top_k), from a top-k over the unique key
    value * C + (C - 1 - index)."""
    c = values.shape[0]
    idx = torch.arange(c, device=values.device)
    key = values.to(torch.int64) * c + (c - 1 - idx)
    return torch.topk(key, k, sorted=True).indices


def _gror_core(
    src: torch.Tensor,
    dst: torch.Tensor,
    corr_active: torch.Tensor,
    resolution: float,
    k_optimal: int,
    min_edge_support: int = 10,
    rot_method: str = "eigh",
) -> GRORResult:
    """GROR on (3, C) float32 tensors of one device. Nothing here is read on
    the host but the refinement's eigen-solver, which `rot_method` names
    (core.linalg.rot_from_correlation; "jacobi" reads nothing)."""
    c = src.shape[1]
    thr = 2.0 * resolution

    # --- node reliability + top-K selection ---------------------------------
    degree = consistency_degree(src, dst, thr, active=corr_active)
    k = min(k_optimal, c)
    deg_masked = torch.where(corr_active, degree.to(torch.int64), -1)
    top = _top_k_lower_index_first(deg_masked, k)
    sel_active = deg_masked[top] >= 0

    src_k = src[:, top]
    dst_k = dst[:, top]
    ds_k = _norm(src_k[:, :, None] - src_k[:, None, :], 0)
    dt_k = _norm(dst_k[:, :, None] - dst_k[:, None, :], 0)
    eye = torch.eye(k, dtype=torch.bool, device=src.device)
    cons_k = (torch.abs(ds_k - dt_k) < thr) & sel_active[:, None] & sel_active[None, :] & ~eye

    # --- candidate edges: (node, its highest-degree consistent partner) -----
    deg_k = cons_k.sum(1)
    partner_score = torch.where(cons_k, deg_k[None, :], -1)
    partner = torch.argmax(partner_score, dim=1)
    has_partner = partner_score.amax(1) >= 0
    edge_ok = sel_active & has_partner & (deg_k >= min_edge_support)

    e_i = torch.arange(k, device=src.device)
    _, tcfs, angles, r0s, t0s, axes, origins = _evaluate_edges(
        e_i, partner, src_k, dst_k, sel_active, resolution
    )
    tcfs = torch.where(edge_ok, tcfs, -1)
    best = torch.argmax(tcfs)

    # --- compose the transform (ia_gror.hpp:405-414) ------------------------
    # T = T(origin) * R(angle) * T(-origin) * [r0 | t0]
    rot = _axis_angle_rotation(_pick(axes, best), _pick(angles, best))
    origin = _pick(origins, best)
    r_final = mm(rot, _pick(r0s, best))
    t_final = mm(rot, _pick(t0s, best) - origin) + origin

    # --- inliers + weighted Procrustes refinement (ia_gror.hpp:259-379) -----
    moved = mm(r_final, src) + t_final[:, None]
    dist = _norm(moved - dst, 0)
    inliers = (dist < thr) & corr_active
    w = inliers.to(src.dtype)
    r_ref, t_ref = weighted_procrustes_srt(src, dst, w, method=rot_method)
    ok = w.sum() >= 3
    return GRORResult(
        rotation=torch.where(ok, r_ref, r_final),
        translation=torch.where(ok, t_ref, t_final),
        best_count=_pick(tcfs, best),
        inliers=inliers,
    )


def gror_align(
    src,
    dst,
    resolution: float,
    k_optimal: int = 800,
    corr_active=None,
    device="cuda",
) -> GRORResult:
    """GROR initial alignment of matched correspondences.

    src/dst: (3, C) matched points, numpy or tensors; they are moved to
    `device` (the card unless the caller asks for the CPU; no fallback).
    resolution: cloud resolution (the voxel leaf); every consistency
    threshold is 2 resolution. k_optimal: nodes kept by reliability
    (registration_artificial.cc:536 uses 800). corr_active: optional (C,)
    bool mask of the correspondences that take part.
    """
    pin_float32()
    device = torch.device(device)
    src = torch.as_tensor(src).to(device=device, dtype=_F32)
    dst = torch.as_tensor(dst).to(device=device, dtype=_F32)
    if corr_active is None:
        corr_active = torch.ones(src.shape[1], dtype=torch.bool, device=device)
    corr_active = torch.as_tensor(corr_active).to(device=device, dtype=torch.bool)
    return _gror_core(src, dst, corr_active, float(resolution), int(k_optimal))


class GRORInitialAlignment:
    """Class facade mirroring pcl::registration::GRORInitialAlignment
    (ia_gror.h:26-260) at the setter-API level. `device` is where `align`
    runs: the card unless the caller asks for the CPU."""

    def __init__(self, device="cuda"):
        self.device = device
        self._source = None
        self._target = None
        self._corr = None
        self.resolution = 0.1
        self.k_optimal = 800

    def setInputSource(self, pts):
        self._source = np.asarray(pts)

    def setInputTarget(self, pts):
        self._target = np.asarray(pts)

    def setResolution(self, r: float):
        self.resolution = float(r)

    def setOptimalSelectionNumber(self, k: int):
        self.k_optimal = int(k)

    def setNumberOfThreads(self, n: int):
        pass  # parallelism is the batch width on the card

    def setInputCorrespondences(self, corr):
        self._corr = np.asarray(corr, np.int64)

    def align(self) -> GRORResult:
        src = self._source[:, self._corr[:, 0]]
        dst = self._target[:, self._corr[:, 1]]
        return gror_align(src, dst, self.resolution, self.k_optimal, device=self.device)
