"""Scale solvers over line-vector (TIM) sets: the unknown-scale estimate
(TLSScaleSolver::solveForScale, registration.cc:397-415) and the known-scale
inlier test (ScaleInliersSelector::solveForScale, registration.cc:418-434),
batched over leading dims."""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.robust.scalar_tls import scale_consensus_1pt, tls_vote
from psulvsb_tpu_torch.utils.scalars import as_float32, as_generator, as_scalar


def tim_norms(tims: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """Column norms of a (..., 3, L) TIM matrix; inactive columns get 0."""
    n = torch.sqrt((tims * tims).sum(-2))
    if active is not None:
        n = torch.where(active, n, torch.zeros_like(n))
    return n


def _beta(noise_bound, cbar2, like: torch.Tensor) -> torch.Tensor:
    """beta = 2 * noise_bound * sqrt(cbar2) in the TIMs' dtype."""
    dtype, dev = like.dtype, like.device
    return 2.0 * as_scalar(noise_bound, dtype, dev) * torch.sqrt(as_scalar(cbar2, dtype, dev))


def solve_scale_tls(
    src_tims: torch.Tensor,
    dst_tims: torch.Tensor,
    noise_bound: torch.Tensor | float,
    cbar2: torch.Tensor | float,
    active: torch.Tensor | None = None,
    warm_scale: torch.Tensor | None = None,
    use_warm: bool = False,
    max_draws: int = 256,
    estimator: str = "ransac1pt",
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unknown-scale estimate from TIM norm ratios over (..., 3, L) TIMs
    (registration.cc:397-415): raw scales |dst_tim| / |src_tim| with
    ranges beta / |src_tim|, beta = 2 noise_bound sqrt(cbar2); zero-length
    source TIMs never vote.

    estimator: "ransac1pt", the PSULVSB fork's 1-point consensus
    (registration.cc:67-119; `u`, optional (..., max_draws) uniforms, picks
    its draws), or "vote", upstream TEASER's adaptive voting
    (registration.cc:206-320). Returns (scale (...), inliers (..., L),
    beta)."""
    v1 = tim_norms(src_tims)
    v2 = tim_norms(dst_tims)
    if active is None:
        active = torch.ones_like(v1, dtype=torch.bool)
    safe_v1 = torch.where(v1 > 0, v1, torch.ones_like(v1))
    raw_scales = v2 / safe_v1
    beta = _beta(noise_bound, cbar2, v1)
    alphas = beta / safe_v1
    valid = active & (v1 > 0)
    if estimator == "vote":
        scale, inliers = tls_vote(raw_scales, alphas, active=valid)
    elif estimator == "ransac1pt":
        scale, inliers = scale_consensus_1pt(
            raw_scales, alphas, active=valid, warm_value=warm_scale, use_warm=use_warm,
            max_draws=max_draws, u=u, generator=generator,
        )
    else:
        raise ValueError(f"scale estimator must be 'ransac1pt' or 'vote', got {estimator!r}")
    return scale, inliers, beta


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
    beta = _beta(noise_bound, cbar2, v1)
    inliers = (torch.abs(v1 - v2) <= beta) & active
    return torch.ones(src_tims.shape[:-2], dtype=dtype, device=dev), inliers, beta


class TLSScaleSolver:
    """Facade of teaser::TLSScaleSolver (registration.h:138-166): the
    unknown-scale estimate of `solve_scale_tls` on float32 TIMs moved to
    `device` (the card unless the caller asks for the CPU). Each solve
    draws from `seed` (an int, or a torch.Generator on `device`), or from
    the uniforms `u` it is given."""

    def __init__(self, noise_bound: float, cbar2: float, seed=0, device="cuda"):
        self.noise_bound = noise_bound
        self.cbar2 = cbar2
        self.device = torch.device(device)
        self._gen = as_generator(seed, self.device)

    def solveForScale(self, src_tims, dst_tims, u=None):
        """Returns (scale, inlier mask over the TIM columns)."""
        scale, inliers, _ = solve_scale_tls(
            as_float32(src_tims, self.device), as_float32(dst_tims, self.device),
            self.noise_bound, self.cbar2, u=u, generator=self._gen,
        )
        return scale, inliers


class ScaleInliersSelector:
    """Facade of teaser::ScaleInliersSelector (registration.h:168-189): the
    known-scale inlier test of `select_scale_inliers` on float32 TIMs moved
    to `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, noise_bound: float, cbar2: float, device="cuda"):
        self.noise_bound = noise_bound
        self.cbar2 = cbar2
        self.device = torch.device(device)

    def solveForScale(self, src_tims, dst_tims):
        """Returns (scale = 1, inlier mask over the TIM columns)."""
        scale, inliers, _ = select_scale_inliers(
            as_float32(src_tims, self.device), as_float32(dst_tims, self.device),
            self.noise_bound, self.cbar2,
        )
        return scale, inliers
