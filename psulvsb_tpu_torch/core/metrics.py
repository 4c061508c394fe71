"""Metric functions shared by the solver and the checks.

Equivalents of getAngularError (PSULVSB.cc:30-33), calculateRMSE
(registration.cc:571-602) and computeInlierProbability
(registration.cc:611-619).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from psulvsb_tpu_torch.utils.precision import mm


def angular_error_rad(r_exp: torch.Tensor, r_est: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error |acos((tr(Ra^T Rb) - 1)/2)| in radians, over
    leading batch dims."""
    prod = mm(r_exp.transpose(-1, -2), r_est)
    c = (prod.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.abs(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def angular_error_deg(r_exp: torch.Tensor, r_est: torch.Tensor) -> torch.Tensor:
    return angular_error_rad(r_exp, r_est) * (180.0 / math.pi)


def angular_error_deg_np(r_exp, r_est) -> float:
    """Host-side (numpy, float64) geodesic rotation error in degrees."""
    a = np.asarray(r_exp, np.float64)
    b = np.asarray(r_est, np.float64)
    c = (np.trace(a.T @ b) - 1.0) / 2.0
    return float(abs(np.arccos(min(1.0, max(-1.0, c)))) * (180.0 / np.pi))


def masked_rmse(
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    scale: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """RMSE of s*(R src + t) vs dst over mask==True columns; +inf when the
    mask is empty (the reference throws there)."""
    m = mask.to(src.dtype)
    diff = scale * (mm(rotation, src) + translation[:, None]) - dst
    sq = (diff * diff).sum(0)
    count = m.sum()
    mse = (sq * m).sum() / torch.clamp(count, min=1.0)
    return torch.where(count > 0, torch.sqrt(mse), torch.full_like(mse, math.inf))


def inlier_probability(
    residual: torch.Tensor, sigma: torch.Tensor | float
) -> torch.Tensor:
    """P(inlier) = 1 - P(3/2, r^2 / (2 sigma^2)): the chi(3) survival
    function through the regularized lower incomplete gamma function."""
    z = (residual * residual) / (2.0 * sigma * sigma)
    return 1.0 - torch.special.gammainc(torch.full_like(z, 1.5), z)
