"""Fast Global Registration rotation-only solver (port of
psulvsb_tpu/rotation/fgr.py).

Equivalent of FastGlobalRegistrationSolver::solveForRotation
(registration.cc:322-394), stock TEASER, kept for API parity: Geman-McClure
line processes l_pq, weighted Procrustes, mu /= gnc_factor per iteration,
stop when cost < cost_threshold or mu < 1.

`fgr_batched` runs B problems side by side; a problem that has stopped is
frozen while the others go on, so each result is the one the single-problem
loop gives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from psulvsb_tpu_torch.core.linalg import svd_rot
from psulvsb_tpu_torch.core.metrics import calculate_diameter
from psulvsb_tpu_torch.utils.precision import mm
from psulvsb_tpu_torch.utils.scalars import as_float32, as_scalar


class FGRResult(NamedTuple):
    rotation: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    weights: torch.Tensor  # (N,)
    cost: torch.Tensor  # ()
    iterations: torch.Tensor  # ()


def fgr_batched(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor,
    noise_bound: torch.Tensor,
    max_iterations: int = 100,
    gnc_factor: float = 1.4,
    cost_threshold: float = 1e-6,
    rot_method: str = "eigh",
    early_exit: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FGR loop over B problems. src/dst (B, 3, N), active (B, N) bool,
    noise_bound (B,). With `early_exit` the host reads once an iteration
    whether every problem has stopped; without it all `max_iterations` run
    masked and nothing is read, as a captured CUDA graph needs it.

    Returns (rotations (B, 3, 3), weights l_pq (B, N), cost (B,),
    iterations (B,))."""
    b = src.shape[0]
    dtype, dev = src.dtype, src.device
    act_f = active.to(dtype)
    nb_sq = noise_bound.to(dtype) ** 2
    # mu starts from the larger point-set diameter (registration.cc:339-344).
    global_scale = torch.maximum(
        calculate_diameter(src, active), calculate_diameter(dst, active)
    ) / nb_sq
    mu = global_scale**2 / nb_sq
    rot = torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3).clone()
    l_pq = act_f.clone()
    cost = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    iters = torch.zeros(b, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        scaled_mu = (mu * nb_sq)[:, None]
        diff = dst - mm(rot, src)
        r_sq = (diff * diff).sum(1)
        new_l = (scaled_mu / (scaled_mu + r_sq)) ** 2 * act_f
        rotation = svd_rot(src, dst, new_l, method=rot_method)
        diff2 = dst - mm(rotation, src)
        d_sq = (diff2 * diff2).sum(1)
        cost_i = ((scaled_mu * d_sq) / (scaled_mu + d_sq) * act_f).sum(1)
        stop = (cost_i < cost_threshold) | (mu < 1.0)
        live = ~done
        rot = torch.where(live[:, None, None], rotation, rot)
        l_pq = torch.where(live[:, None], new_l, l_pq)
        cost = torch.where(live, cost_i, cost)
        mu = torch.where(live & ~stop, mu / gnc_factor, mu)
        iters = iters + live.to(torch.int64)
        done = done | stop
        if early_exit and bool(done.all()):
            break
    return rot, l_pq, cost, iters


def fgr_rotation(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: torch.Tensor | float,
    active: torch.Tensor | None = None,
    max_iterations: int = 100,
    gnc_factor: float = 1.4,
    cost_threshold: float = 1e-6,
    rot_method: str = "eigh",
) -> FGRResult:
    """FGR rotation of (3, N) TIM sets; a single problem stops as soon as
    its cost or its mu says so."""
    n = src.shape[1]
    dtype, dev = src.dtype, src.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    rot, l_pq, cost, iters = fgr_batched(
        src[None], dst[None], active[None], as_scalar(noise_bound, dtype, dev).reshape(1),
        max_iterations, gnc_factor, cost_threshold, rot_method,
    )
    # The reference casts l_pq to bool for the inlier mask (registration.cc:391-393).
    return FGRResult(
        rotation=rot[0], inliers=(l_pq[0] > 0) & active, weights=l_pq[0], cost=cost[0],
        iterations=iters[0],
    )


class FastGlobalRegistrationSolver:
    """Facade of teaser::FastGlobalRegistrationSolver (registration.h:222-265).
    The inputs are moved to `device`: the card unless the caller asks for
    the CPU."""

    def __init__(self, noise_bound: float = 0.01, cost_threshold: float = 1e-6,
                 gnc_factor: float = 1.4, max_iterations: int = 100, device="cuda"):
        self.noise_bound = noise_bound
        self.cost_threshold = cost_threshold
        self.gnc_factor = gnc_factor
        self.max_iterations = max_iterations
        self.device = torch.device(device)

    def solveForRotation(self, src, dst):
        res = fgr_rotation(
            as_float32(src, self.device), as_float32(dst, self.device), self.noise_bound,
            max_iterations=self.max_iterations, gnc_factor=self.gnc_factor,
            cost_threshold=self.cost_threshold,
        )
        return res.rotation, res.inliers
