"""Synthetic experiment protocol of the published PSULVSB example program
(examples/teaser_cpp_ply/PSULVSB.cc), in numpy so that a pair is made the
same way on any machine and fed to either package:

- random SE(3): uniform axis, angle in [0, pi), ||t|| <= 3 (PSULVSB.cc:256-278)
- per-coordinate uniform noise in [-noise_bound, +noise_bound]
  (PSULVSB.cc:190-194)
- outliers: a fraction of target points displaced per axis by a uniform
  draw from ±[5, 10] (PSULVSB.cc:196-221), or matched to another random
  point of the cloud ("mismatch", like wrong descriptor matches on scans)
- an optional test scale that stretches the target, the reference's
  unknownScale mode (teaser_cpp_ply_main.cc:319)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.core.se3 import SE3, random_se3


def synthetic_cloud(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Deterministic blobby closed surface: unit sphere modulated by a few
    random spherical harmonics (coords ~ ±1). Returns (3, n)."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(1 - 2 * rng.uniform(size=n))
    phi = rng.uniform(0, 2 * np.pi, size=n)
    r = 1.0
    for k in range(3, 7):
        a = rng.normal() * 0.08
        b = rng.normal() * 0.08
        r = r + a * np.cos(k * theta) + b * np.sin(k * phi) * np.sin(theta)
    pts = np.stack(
        [
            r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta),
        ]
    )
    return pts.astype(dtype)


def structured_scene(
    n: int, seed: int = 0, extent: float = 40.0, dtype=np.float32
) -> np.ndarray:
    """Urban-style structured scene: ground plane, box buildings, and
    vertical poles — the planar/corner/edge structure FPFH keys on (the
    blobby `synthetic_cloud` has none at outdoor scale, which is why the
    KITTI-scale example's match quality on it only lower-bounds real
    scans). Point density is surface-area weighted; every surface carries
    mild jitter so normals are estimable but not degenerate. Returns
    (3, n), coordinates spanning roughly ±extent/2 in x/y."""
    rng = np.random.default_rng(seed)
    half = extent / 2.0
    chunks: list[np.ndarray] = []

    def sample_rect(origin, u, v, m):
        """m points on the parallelogram origin + a*u + b*v, a,b ~ U[0,1]."""
        a = rng.uniform(size=m)[:, None]
        b = rng.uniform(size=m)[:, None]
        return (np.asarray(origin)[None, :] + a * np.asarray(u)[None, :]
                + b * np.asarray(v)[None, :])

    # Ground plane: 30% of points.
    n_ground = int(n * 0.30)
    chunks.append(sample_rect(
        (-half, -half, 0.0), (extent, 0, 0), (0, extent, 0), n_ground
    ))

    # Buildings: 60% of points over ~8 boxes; walls + roof sampled
    # area-weighted, so corners and wall/roof edges appear at natural
    # density.
    n_build = int(n * 0.60)
    boxes = []
    for _ in range(8):
        w, d = rng.uniform(4.0, 10.0, size=2)
        h = rng.uniform(5.0, 15.0)
        x0 = rng.uniform(-half + 2, half - 12)
        y0 = rng.uniform(-half + 2, half - 12)
        boxes.append((x0, y0, w, d, h))
    areas = np.array([2 * (w + d) * h + w * d for (_, _, w, d, h) in boxes])
    per_box = (areas / areas.sum() * n_build).astype(int)
    for (x0, y0, w, d, h), m in zip(boxes, per_box):
        faces = [
            ((x0, y0, 0), (w, 0, 0), (0, 0, h), w * h),          # south wall
            ((x0, y0 + d, 0), (w, 0, 0), (0, 0, h), w * h),      # north wall
            ((x0, y0, 0), (0, d, 0), (0, 0, h), d * h),          # west wall
            ((x0 + w, y0, 0), (0, d, 0), (0, 0, h), d * h),      # east wall
            ((x0, y0, h), (w, 0, 0), (0, d, 0), w * d),          # roof
        ]
        fa = np.array([f[3] for f in faces])
        per_face = rng.multinomial(m, fa / fa.sum())
        for (origin, u, v, _a), fm in zip(faces, per_face):
            if fm:
                chunks.append(sample_rect(origin, u, v, fm))

    # Poles: the remainder, as thin vertical cylinders (edge-like features).
    n_pole = n - sum(c.shape[0] for c in chunks)
    if n_pole > 0:
        k = max(n_pole // 200, 4)
        centers = rng.uniform(-half + 1, half - 1, size=(k, 2))
        which = rng.integers(0, k, size=n_pole)
        ang = rng.uniform(0, 2 * np.pi, size=n_pole)
        z = rng.uniform(0, 6.0, size=n_pole)
        r = 0.15
        chunks.append(np.stack([
            centers[which, 0] + r * np.cos(ang),
            centers[which, 1] + r * np.sin(ang),
            z,
        ], axis=1))

    pts = np.concatenate(chunks, axis=0)[:n]
    pts = pts + rng.normal(size=pts.shape) * 0.01  # sensor-like jitter
    return np.ascontiguousarray(pts.T.astype(dtype))


class SyntheticPair(NamedTuple):
    src: np.ndarray  # (3, N)
    dst: np.ndarray  # (3, N)
    transform: SE3  # ground truth, numpy fields; scale = the test scale
    outlier_mask: np.ndarray  # (N,) bool — True where dst was corrupted


def _clustered_outliers(rng, src, dst, gt, out_idx, noise_bound, max_translation):
    """dst with the outliers `out_idx` in colluding groups, as the JAX
    package's "clustered" mode makes them (psulvsb_tpu/eval/synthetic.py:
    184-229): each center claims its `cap` nearest unassigned outliers, cap
    = max(8, 0.6 of the inlier count), so the true consensus stays the
    largest; a group's points go to T_g(T_gt(src)) + noise under a decoy
    motion T_g of its own, the way matching two identical chairs does."""
    src64 = np.asarray(src, np.float64)
    n_out = out_idx.size
    cap = max(8, int(0.6 * (src.shape[1] - n_out)))
    n_groups = max(1, -(-n_out // cap))
    centers = src64[:, rng.choice(out_idx, size=n_groups, replace=False)]
    d2 = np.sum((src64[:, out_idx, None] - centers[:, None, :]) ** 2, axis=0)  # (n_out, groups)
    group_of = np.full(n_out, -1)
    taken = np.zeros(n_out, bool)
    for g in range(n_groups):
        order = np.argsort(np.where(taken, np.inf, d2[:, g]))
        pick = order[: min(cap, n_out - int(taken.sum()))]
        group_of[pick] = g
        taken[pick] = True
    noise = rng.uniform(-noise_bound, noise_bound, size=(3, n_out))
    out = np.array(dst, np.float64)
    gt_r = np.asarray(gt.rotation, np.float64)
    gt_t = np.asarray(gt.translation, np.float64)
    for g in range(n_groups):
        members = out_idx[group_of == g]
        if members.size == 0:
            continue
        decoy = random_se3(rng, max_translation=max_translation, dtype=np.float64)
        base = gt_r @ src64[:, members] + gt_t[:, None]
        out[:, members] = np.asarray(decoy.rotation) @ base + np.asarray(decoy.translation)[:, None]
    out[:, out_idx] += noise
    return out


def make_synthetic_pair(
    rng: np.random.Generator,
    src: np.ndarray,
    noise_bound: float = 0.05,
    outlier_rate: float = 0.9,
    max_translation: float = 3.0,
    outlier_mode: str = "displace",
    test_scale: float = 1.0,
) -> SyntheticPair:
    """dst = T(src) + uniform noise, then `outlier_rate` of the points are
    corrupted, then dst is multiplied by `test_scale`.

    outlier_mode: "displace" moves each outlier per axis by a magnitude
    uniform in [5, 10] with a random sign (the published protocol);
    "mismatch" gives each outlier the (transformed, noisy) target of
    another random point (the JAX package's eval/synthetic.py mode, used by
    the correspondence-benchmark fixtures); "clustered" makes colluding
    wrong matches, spatial groups of outliers each rigidly consistent with
    a decoy motion of its own (`_clustered_outliers`).

    The test scale follows the batch harness's unknown-scale protocol
    (psulvsb_tpu/eval/batch_harness.py:285-303): the returned transform
    carries scale = test_scale, so dst ≈ s (R src + t) in the solver's
    convention."""
    src = np.asarray(src)
    dtype = src.dtype
    n = src.shape[1]
    gt = random_se3(rng, max_translation=max_translation, dtype=dtype)
    dst = gt.scale * (gt.rotation @ src + gt.translation[:, None])
    dst = dst + rng.uniform(-noise_bound, noise_bound, size=dst.shape)

    n_out = int(round(n * outlier_rate))
    outlier_mask = np.zeros(n, bool)
    outlier_mask[rng.permutation(n)[:n_out]] = True
    if outlier_mode == "displace":
        mag = rng.uniform(5.0, 10.0, size=(3, n))
        sign = np.where(rng.uniform(size=(3, n)) <= 0.5, -1.0, 1.0)
        dst = np.where(outlier_mask[None, :], dst + sign * mag, dst)
    elif outlier_mode == "mismatch":
        wrong = rng.permutation(n)
        dst = np.where(outlier_mask[None, :], dst[:, wrong], dst)
    elif outlier_mode == "clustered":
        dst = _clustered_outliers(rng, src, dst, gt, np.where(outlier_mask)[0], noise_bound,
                                  max_translation)
    else:
        raise ValueError(
            f"outlier_mode must be 'displace', 'mismatch' or 'clustered', got {outlier_mode!r}"
        )
    gt = gt._replace(scale=np.asarray(test_scale, dtype))
    return SyntheticPair(
        src=src, dst=(dst * test_scale).astype(dtype), transform=gt, outlier_mask=outlier_mask
    )


def registration_errors(
    pair: SyntheticPair, scale, rotation, translation
) -> tuple[float, float, float]:
    """(rotation error in degrees, translation error, scale error) of a
    solution s (R p + t) against the pair's truth, as the batch harness
    scores them (psulvsb_tpu/eval/batch_harness.py:386-402): the
    translation error compares t s / test_scale with the true t."""
    gt = pair.transform
    s = float(np.asarray(scale))
    test_scale = float(gt.scale)
    re = angular_error_deg_np(gt.rotation, np.asarray(rotation, np.float64))
    te = float(np.linalg.norm(np.asarray(translation, np.float64) * s / test_scale - gt.translation))
    return re, te, abs(s - test_scale)
