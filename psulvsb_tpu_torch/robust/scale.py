"""Known-scale inlier test over line-vector (TIM) sets
(ScaleInliersSelector::solveForScale, registration.cc:418-434)."""

from __future__ import annotations

import torch


def tim_norms(tims: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """Column norms of a (..., 3, L) TIM matrix; inactive columns get 0."""
    n = torch.sqrt((tims * tims).sum(-2))
    if active is not None:
        n = torch.where(active, n, torch.zeros_like(n))
    return n


def select_scale_inliers(
    src_tims: torch.Tensor,
    dst_tims: torch.Tensor,
    noise_bound: torch.Tensor | float,
    cbar2: torch.Tensor | float,
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Known-scale (s = 1) test |‖src_tim‖ - ‖dst_tim‖| <= beta with
    beta = 2 * noise_bound * sqrt(cbar2), over (..., 3, L) TIMs.

    Returns (scale = 1 per batch entry, inlier mask (..., L), beta)."""
    if active is None:
        active = torch.ones(
            src_tims.shape[:-2] + src_tims.shape[-1:], dtype=torch.bool,
            device=src_tims.device,
        )
    dtype, dev = src_tims.dtype, src_tims.device
    v1 = tim_norms(src_tims)
    v2 = tim_norms(dst_tims)
    beta = 2.0 * torch.as_tensor(noise_bound, dtype=dtype, device=dev) * torch.sqrt(
        torch.as_tensor(cbar2, dtype=dtype, device=dev)
    )
    inliers = (torch.abs(v1 - v2) <= beta) & active
    return torch.ones(src_tims.shape[:-2], dtype=dtype, device=dev), inliers, beta
