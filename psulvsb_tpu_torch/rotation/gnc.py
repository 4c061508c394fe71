"""GNC-TLS rotation solver in plain PyTorch.

Equivalent of GNCTLSRotationSolver::solveForRotation (registration.cc:
1563-1692) with the PSULVSB changes: a warm rotation replaces the solve on
iteration 0 when requested (registration.cc:1617-1621), and weight >= 0.5
marks inliers, with an all-active fail-safe when at most 10 survive
(registration.cc:1676-1691).

`gnc_tls_batched` runs B problems side by side; a problem that has
converged is frozen while the others go on, so each result is the one the
single-problem loop gives. It is the plain version of the CUDA kernel in
`ops/gnc.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from psulvsb_tpu_torch.core.linalg import svd_rot
from psulvsb_tpu_torch.rotation.fgr import masked_loop
from psulvsb_tpu_torch.utils.precision import mm
from psulvsb_tpu_torch.utils.scalars import as_float32


class GNCResult(NamedTuple):
    rotation: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    weights: torch.Tensor  # (N,)
    cost: torch.Tensor  # ()
    iterations: torch.Tensor  # ()


def floor_noise_sq(noise_bound: torch.Tensor) -> torch.Tensor:
    """noise_bound^2, floored to 1e-2 below 1e-16 (registration.cc:1592-1595)."""
    nb_sq = noise_bound * noise_bound
    return torch.where(nb_sq < 1e-16, torch.full_like(nb_sq, 1e-2), nb_sq)


def tls_inliers(weights: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """weight >= 0.5 over active columns; a problem keeping at most 10
    inliers takes all its active columns instead (registration.cc:1685-1690)."""
    inliers = (weights >= 0.5) & active
    few = inliers.sum(-1, keepdim=True) <= 10
    return torch.where(few, active, inliers)


def gnc_tls_batched(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor,
    nb_sq: torch.Tensor,
    warm_rotation: torch.Tensor,
    use_warm,
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
    rot_method: str,
    early_exit: bool = True,
    repeat=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """GNC-TLS loop over B problems. src/dst (B, 3, N), active (B, N) bool,
    nb_sq (B,) already floored, warm_rotation (3, 3) shared by the batch.
    use_warm: a bool, or a 0-d bool tensor; the tensor selects iteration 0's
    rotation on the device (the solve runs either way). With `early_exit`
    the host reads once an iteration whether every problem is done; without
    it all `max_iterations` run masked and nothing is read. With `repeat`
    (`GraphControl.repeat` of solver/conditional.py) the iterations after
    the first run masked, in chunks, while a problem is left, decided on the
    device (`rotation.fgr.masked_loop`); the three forms give the same
    results.

    Returns (rotations (B, 3, 3), weights (B, N), cost (B,), iterations (B,)).
    """
    b, _, n = src.shape
    dtype, dev = src.dtype, src.device
    act_f = active.to(dtype)
    rot = torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3).clone()
    w = act_f.clone()
    mu = torch.ones(b, dtype=dtype, device=dev)
    prev_cost = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    cost = prev_cost.clone()
    iters = torch.zeros(b, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    neg_inf = torch.full((b, n), -float("inf"), dtype=dtype, device=dev)

    def iteration(state, first=False, in_range=None):
        rot, w, mu, prev_cost, cost, iters, done = state
        if first and isinstance(use_warm, torch.Tensor):
            rotation = torch.where(
                use_warm, warm_rotation.to(dtype).expand(b, 3, 3),
                svd_rot(src, dst, w * act_f, method=rot_method),
            )
        elif first and use_warm:
            rotation = warm_rotation.to(dtype).expand(b, 3, 3)
        else:
            rotation = svd_rot(src, dst, w * act_f, method=rot_method)
        diff = dst - mm(rotation, src)
        r_sq = (diff * diff).sum(1)  # (B, N)

        # mu initialization on the first iteration (registration.cc:1628-1638).
        if first:
            max_res = torch.where(active, r_sq, neg_inf).amax(1)
            mu_i = 1.0 / (2.0 * max_res / nb_sq - 1.0)
            degenerate = mu_i <= 0
        else:
            mu_i = mu
            degenerate = torch.zeros_like(done)
        mu_c = mu_i[:, None]
        th1 = (mu_c + 1.0) / mu_c * nb_sq[:, None]
        th2 = mu_c / (mu_c + 1.0) * nb_sq[:, None]
        # Cost uses the PREVIOUS weights (registration.cc:1645-1648).
        cost_i = (w * r_sq * act_f).sum(1)
        w_mid = torch.sqrt(
            nb_sq[:, None] * mu_c * (mu_c + 1.0) / torch.clamp(r_sq, min=1e-30)
        ) - mu_c
        new_w = torch.where(
            r_sq >= th1,
            torch.zeros_like(r_sq),
            torch.where(r_sq <= th2, torch.ones_like(r_sq), torch.clamp(w_mid, 0.0, 1.0)),
        ) * act_f
        converged = torch.abs(cost_i - prev_cost) < cost_threshold

        # The degenerate break exits before updating weights and cost.
        new_w = torch.where(degenerate[:, None], w, new_w)
        cost_i = torch.where(degenerate, cost, cost_i)
        live = ~done if in_range is None else ~done & in_range
        stopped = degenerate | converged
        return (
            torch.where(live[:, None, None], rotation, rot),
            torch.where(live[:, None], new_w, w),
            torch.where(live, mu_i * gnc_factor, mu),
            torch.where(live & ~degenerate, cost_i, prev_cost),
            torch.where(live, cost_i, cost),
            iters + live.to(torch.int64),
            done | stopped if in_range is None else done | (stopped & live),
        )

    state = (rot, w, mu, prev_cost, cost, iters, done)
    if max_iterations > 0:
        state = iteration(state, first=True)
    if repeat is not None:
        state = masked_loop(lambda s, in_range: iteration(s, in_range=in_range), state,
                            max_iterations - 1, repeat)
    else:
        for _ in range(1, max_iterations):
            if early_exit and bool(state[-1].all()):
                break
            state = iteration(state)
    rot, w, _, _, cost, iters, _ = state
    return rot, w, cost, iters


def gnc_tls_rotation(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: torch.Tensor | float,
    active: torch.Tensor | None = None,
    max_iterations: int = 100,
    gnc_factor: float = 1.4,
    cost_threshold: float = 1e-6,
    warm_rotation: torch.Tensor | None = None,
    use_warm: bool = False,
    rot_method: str = "eigh",
) -> GNCResult:
    """Graduated non-convexity TLS rotation estimation on (3, N) TIMs:
    iterate {weighted Procrustes; closed-form TLS weight update;
    mu *= gnc_factor} until |cost - prev_cost| < cost_threshold, the
    degenerate-mu break, or max_iterations."""
    n = src.shape[1]
    dtype, dev = src.dtype, src.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if warm_rotation is None:
        warm_rotation = torch.eye(3, dtype=dtype, device=dev)
    nb_sq = floor_noise_sq(torch.as_tensor(noise_bound, dtype=dtype, device=dev).reshape(1))
    rot, w, cost, iters = gnc_tls_batched(
        src[None], dst[None], active[None], nb_sq, warm_rotation, use_warm,
        max_iterations, gnc_factor, cost_threshold, rot_method,
    )
    return GNCResult(
        rotation=rot[0],
        inliers=tls_inliers(w, active[None])[0],
        weights=w[0],
        cost=cost[0],
        iterations=iters[0],
    )


class GNCTLSRotationSolver:
    """Facade of teaser::GNCTLSRotationSolver (registration.h:267-295): the
    single-problem `gnc_tls_rotation` on float32 TIMs moved to `device` (the
    card unless the caller asks for the CPU), as the JAX facade runs it."""

    def __init__(self, noise_bound: float = 0.01, cost_threshold: float = 1e-6,
                 gnc_factor: float = 1.4, max_iterations: int = 100, device="cuda"):
        self.noise_bound = noise_bound
        self.cost_threshold = cost_threshold
        self.gnc_factor = gnc_factor
        self.max_iterations = max_iterations
        self.device = torch.device(device)

    def solveForRotation(self, src, dst, warm_rotation=None):
        """Returns (rotation (3, 3), inlier mask over the TIM columns); a warm
        rotation replaces the solve of iteration 0 (registration.cc:1617-1621)."""
        warm = None if warm_rotation is None else as_float32(warm_rotation, self.device)
        res = gnc_tls_rotation(
            as_float32(src, self.device), as_float32(dst, self.device), self.noise_bound,
            max_iterations=self.max_iterations, gnc_factor=self.gnc_factor,
            cost_threshold=self.cost_threshold, warm_rotation=warm, use_warm=warm is not None,
        )
        return res.rotation, res.inliers
