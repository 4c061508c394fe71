"""Pieces of the decoupled scale -> rotation -> translation basic step
(registration.cc:937-1256) that the PSULVSB loop shares: the warm-start
carry, the TIM endpoint mask and transform scoring."""

from __future__ import annotations

from typing import NamedTuple

import torch

from psulvsb_tpu_torch.robust.translation import scatter_or
from psulvsb_tpu_torch.utils.precision import mm


class WarmState(NamedTuple):
    """Explicit carry for the reference's warm-start globals
    (registration.cc:42-47). `first_time` is known on the host at every
    step of the solve, so it is a Python bool."""

    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    first_time: bool  # True until the first scoring pass

    @staticmethod
    def initial(device=None, dtype=torch.float32) -> "WarmState":
        return WarmState(
            scale=torch.ones((), dtype=dtype, device=device),
            rotation=torch.eye(3, dtype=dtype, device=device),
            translation=torch.zeros(3, dtype=dtype, device=device),
            first_time=True,
        )


def endpoint_mask(
    idx_i: torch.Tensor, idx_j: torch.Tensor, tim_mask: torch.Tensor, num_points: int
) -> torch.Tensor:
    """Scatter-or TIM endpoints into a (..., C) point mask (the `dub[]`
    dedup, registration.cc:1114-1154)."""
    return scatter_or(
        num_points,
        torch.cat([idx_i, idx_j], dim=-1),
        torch.cat([tim_mask, tim_mask], dim=-1),
    )


def score_transform(
    src: torch.Tensor,
    dst: torch.Tensor,
    point_mask: torch.Tensor,
    scale: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    threshold: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Count points with ||dst - s*(R src + t)|| <= threshold among
    point_mask (registration.cc:1317-1346, :1417-1444). src/dst (3, C);
    scale (...), rotation (..., 3, 3), translation (..., 3) for a batch of
    transforms. Returns (count (...) int64, per-point inlier (..., C))."""
    moved = scale[..., None, None] * (mm(rotation, src) + translation[..., :, None])
    res_sq = ((dst - moved) ** 2).sum(-2)
    ok = (res_sq <= torch.as_tensor(threshold) ** 2) & point_mask
    return ok.sum(-1), ok
