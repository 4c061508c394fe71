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


class SyntheticPair(NamedTuple):
    src: np.ndarray  # (3, N)
    dst: np.ndarray  # (3, N)
    transform: SE3  # ground truth, numpy fields; scale = the test scale
    outlier_mask: np.ndarray  # (N,) bool — True where dst was corrupted


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
    the correspondence-benchmark fixtures).

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
    else:
        raise ValueError(f"outlier_mode must be 'displace' or 'mismatch', got {outlier_mode!r}")
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
