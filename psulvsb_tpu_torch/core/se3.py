"""Similarity transforms p -> s * (R p + t), the PSULVSB convention (the
solver divides t by s, registration.cc:1250, and scores with s*(R p + t))."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.utils.precision import mm


class SE3(NamedTuple):
    """Similarity transform: p -> scale * (rotation @ p + translation).
    Fields are tensors, or numpy arrays where `random_se3` made them."""

    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)


def transform_points(t: SE3, pts: torch.Tensor) -> torch.Tensor:
    """Apply p -> s * (R p + t) to a (3, N) point matrix."""
    return t.scale * (mm(t.rotation, pts) + t.translation[:, None])


def _rodrigues_np(axis: np.ndarray, angle: float) -> np.ndarray:
    """Axis-angle -> rotation matrix (PSULVSB.cc:259-271)."""
    axis = axis / (np.linalg.norm(axis) + 1e-30)
    k = np.array(
        [
            [0.0, -axis[2], axis[1]],
            [axis[2], 0.0, -axis[0]],
            [-axis[1], axis[0], 0.0],
        ]
    )
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def random_se3(
    rng: np.random.Generator, max_translation: float = 3.0, dtype=np.float32
) -> SE3:
    """Random transform of the synthetic protocol (PSULVSB.cc:256-278), as
    numpy arrays: uniform random axis, angle uniform in [0, pi), translation
    of uniform random direction with norm uniform in [0, max_translation)."""
    axis = rng.uniform(-1.0, 1.0, size=3)
    angle = rng.uniform(0.0, np.pi)
    r = _rodrigues_np(axis, angle)
    t_dir = rng.uniform(-0.5, 0.5, size=3)
    t_dir = t_dir / (np.linalg.norm(t_dir) + 1e-30)
    t_norm = max_translation * rng.uniform()
    return SE3(
        scale=np.ones((), dtype),
        rotation=r.astype(dtype),
        translation=(t_norm * t_dir).astype(dtype),
    )
