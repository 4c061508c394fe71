"""The benchmark's pair generator: a copy, in numpy alone, of the synthetic
protocol that the port's `eval/synthetic.py` and `eval/make_dataset.py` follow
(the reference's PSULVSB.cc:190-278 and its dataset regimes,
teaser_cpp_ply_main.cc:244-424 and :700-720), kept here so that no change to
the program can change the yardstick.

- `synthetic_cloud`: a blobby closed surface, the unit sphere modulated by a
  few random spherical harmonics, (3, n);
- `random_se3`: a uniform random axis, an angle uniform in [0, pi), a
  translation of uniform direction with norm uniform in [0, max_translation);
- `make_synthetic_pair`: dst = R src + t plus uniform noise in
  [-noise_bound, noise_bound] per coordinate, then a share of dst replaced
  by wrong matches ("mismatch": the target of another random point) or
  moved by 5-10 per axis ("displace");
- `vehicle_pose`: a ground vehicle's move between two scans (a
  configuration's `pose` of kind "vehicle"): a yaw on fixed strata, a small
  roll and pitch, a step of some metres along the mean heading;
- `make_pool`: the pairs one run draws from, made from the run's seed, the
  rotation angles (or yaws) on fixed strata so that every seed gives the
  same work; for a configuration with a `test_scale`, each pair's dst
  stretched by its own test scale (the unknown-scale protocol,
  teaser_cpp_ply_main.cc:319), on fixed strata too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SEED_SPACE = 1 << 64  # --seed may be any whole number; SeedSequence wants one >= 0


class Pair(NamedTuple):
    src: np.ndarray  # (3, n) float32
    dst: np.ndarray  # (3, n) float32
    rotation: np.ndarray  # (3, 3) float32, the truth
    translation: np.ndarray  # (3,) float32
    outlier_mask: np.ndarray  # (n,) bool, True where dst was corrupted
    scale: float = 1.0  # the test scale that stretched dst: dst ~ scale (R src + t)


def synthetic_cloud(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    theta = np.arccos(1 - 2 * rng.uniform(size=n))
    phi = rng.uniform(0, 2 * np.pi, size=n)
    r = 1.0
    for k in range(3, 7):
        a = rng.normal() * 0.08
        b = rng.normal() * 0.08
        r = r + a * np.cos(k * theta) + b * np.sin(k * phi) * np.sin(theta)
    pts = np.stack([
        r * np.sin(theta) * np.cos(phi),
        r * np.sin(theta) * np.sin(phi),
        r * np.cos(theta),
    ])
    return pts.astype(dtype)


def rodrigues(axis: np.ndarray, angle: float) -> np.ndarray:
    """Axis-angle to a float64 rotation matrix."""
    axis = np.asarray(axis, np.float64)
    axis = axis / (np.linalg.norm(axis) + 1e-30)
    k = np.array([[0.0, -axis[2], axis[1]],
                  [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def random_se3(rng: np.random.Generator, max_translation: float, dtype=np.float32,
               angle: float | None = None):
    """(rotation, translation) in `dtype`, drawn in the protocol's order; a
    given `angle` replaces the drawn one (the draw is made all the same)."""
    axis = rng.uniform(-1.0, 1.0, size=3)
    drawn = rng.uniform(0.0, np.pi)
    r = rodrigues(axis, drawn if angle is None else angle)
    t_dir = rng.uniform(-0.5, 0.5, size=3)
    t_dir = t_dir / (np.linalg.norm(t_dir) + 1e-30)
    t_norm = max_translation * rng.uniform()
    return r.astype(dtype), (t_norm * t_dir).astype(dtype)


def make_synthetic_pair(rng: np.random.Generator, src: np.ndarray, noise_bound: float,
                        outlier_rate: float, max_translation: float,
                        outlier_mode: str = "mismatch", angle: float | None = None,
                        pose: tuple | None = None) -> Pair:
    """A given `pose` (rotation, translation) replaces the protocol's draw
    of one (and no draw is made for it)."""
    src = np.asarray(src)
    dtype = src.dtype
    n = src.shape[1]
    if pose is None:
        rot, trans = random_se3(rng, max_translation, dtype, angle)
    else:
        rot, trans = (np.asarray(a, np.float64).astype(dtype) for a in pose)
    dst = np.ones((), dtype) * (rot @ src + trans[:, None])
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
    return Pair(src, dst.astype(dtype), rot, trans, outlier_mask)


def stratum(j: int, per_size: int, first: int = 7) -> float:
    """Pair j's point in [0, 1): the midpoints of per_size equal strata,
    dealt out by a stride coprime to per_size (the first from `first` on)
    so that each outlier rate of the cycle meets points from across the
    range."""
    stride = next(s for s in range(first, first + per_size) if np.gcd(s, per_size) == 1)
    return ((j * stride) % per_size + 0.5) / per_size


def pool_angle(j: int, per_size: int) -> float:
    """Pair j's rotation angle, on fixed strata of [0, pi)."""
    return stratum(j, per_size) * np.pi


def pool_scale(j: int, per_size: int, spec: dict) -> float:
    """Pair j's test scale, on fixed strata of [spec["low"], spec["high"]),
    dealt by a stride of its own (29 and on: the angles' stride is 7), so
    that the scale follows neither the angle nor the outlier rate (at 48
    pairs a size their correlations are 0.06 and -0.02)."""
    return spec["low"] + (spec["high"] - spec["low"]) * stratum(j, per_size, first=29)


def _axis_rotation(axis: int, angle: float) -> np.ndarray:
    return rodrigues(np.eye(3)[axis], angle)


def vehicle_pose(rng: np.random.Generator, spec: dict, j: int, per_size: int):
    """A ground vehicle's move between two scans, in the scanner's frame (x
    ahead, z up): the yaw on fixed strata of [-yaw_deg, yaw_deg], roll and
    pitch uniform in [-tilt_deg, tilt_deg], a step of uniform length in
    step_m along the mean heading (half the yaw), and a climb uniform in
    [-climb_m, climb_m]. Float64 (rotation, translation)."""
    yaw = np.radians(spec["yaw_deg"]) * (2.0 * stratum(j, per_size) - 1.0)
    roll, pitch = np.radians(spec["tilt_deg"]) * rng.uniform(-1.0, 1.0, size=2)
    step = rng.uniform(*spec["step_m"])
    climb = spec["climb_m"] * rng.uniform(-1.0, 1.0)
    rot = _axis_rotation(2, yaw) @ _axis_rotation(1, pitch) @ _axis_rotation(0, roll)
    trans = np.array([step * np.cos(yaw / 2), step * np.sin(yaw / 2), climb])
    return rot, trans


def make_pool(config: dict, seed: int, sizes: list[int], per_size: int) -> dict[int, list[Pair]]:
    """`per_size` pairs of each size, all from `seed`: one base cloud a size
    (scaled to the configuration's scene), the outlier rates cycling through
    the configuration's list and the rotation angles on fixed strata
    (`pool_angle`; the yaws, for a configuration whose `pose` is a
    vehicle's), so every seed makes the same sizes, rates and angles; the
    seed draws the clouds, axes, translations, noise and wrong matches.
    (Drawn angles made the pre-filter's losses, and with them a run's work,
    follow the seed.) With the configuration's `test_scale` ({"low",
    "high"}), each pair's dst is then stretched by its scale (`pool_scale`)
    as the port stretches it (eval/realdata.py: the float32 dst times the
    scale, kept in float32), after the noise and the wrong matches; without
    it nothing is drawn or stretched."""
    root = int(seed) % SEED_SPACE
    rates = config["outlier_rates"]
    stretch = config.get("test_scale")
    spec = config.get("pose")
    if spec is not None and spec["kind"] != "vehicle":
        raise ValueError(f"pose kind must be 'vehicle', got {spec['kind']!r}")
    pool = {}
    for k, n in enumerate(sizes):
        rng = np.random.default_rng([root, k])
        cloud = synthetic_cloud(n, seed=int(rng.integers(1 << 31))) * np.float32(config["scene_scale"])
        pool[n] = []
        for j in range(per_size):
            rng = np.random.default_rng([root, k, j])
            pose = None if spec is None else vehicle_pose(rng, spec, j, per_size)
            pair = make_synthetic_pair(
                rng, cloud, config["noise_bound"], rates[j % len(rates)],
                config.get("max_translation", 0.0), config["outlier_mode"],
                angle=pool_angle(j, per_size), pose=pose)
            if stretch is not None:
                sigma = pool_scale(j, per_size, stretch)
                pair = pair._replace(dst=np.asarray(pair.dst * sigma, np.float32), scale=sigma)
            pool[n].append(pair)
    return pool
