"""The decoupled scale -> rotation -> translation basic step
(registration.cc:937-1256) and the pieces the PSULVSB loop shares with it:
the warm-start carry, the TIM endpoint mask and transform scoring."""

from __future__ import annotations

from typing import NamedTuple

import torch

from psulvsb_tpu_torch.ops.gnc import gnc_batch, gnc_batch_reference
from psulvsb_tpu_torch.robust.scale import select_scale_inliers, solve_scale_tls
from psulvsb_tpu_torch.robust.translation import scatter_or, solve_translation
from psulvsb_tpu_torch.rotation.fgr import fgr_batched
from psulvsb_tpu_torch.solver.config import RotationEstimationAlgorithm, SolverParams
from psulvsb_tpu_torch.utils.precision import mm
from psulvsb_tpu_torch.utils.scalars import device_flag

# Calls of `rotation_batch` that ran the plain GNC loop because the caller set
# gnc_rot_method="eigh"; none of them launches the GNC kernel.
PLAIN_ROUTE_CALLS = 0


class WarmState(NamedTuple):
    """Explicit carry for the reference's warm-start globals
    (registration.cc:42-47). `first_time` is a () bool tensor, as in the JAX
    package: the stages select on it, so none of them asks the host which
    way to go (a Python bool is accepted and read through `device_flag`)."""

    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    first_time: torch.Tensor  # () bool, True until the first scoring pass

    @staticmethod
    def initial(device=None, dtype=torch.float32) -> "WarmState":
        return WarmState(
            scale=torch.ones((), dtype=dtype, device=device),
            rotation=torch.eye(3, dtype=dtype, device=device),
            translation=torch.zeros(3, dtype=dtype, device=device),
            first_time=torch.ones((), dtype=torch.bool, device=device),
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


def rotation_batch(
    src_tims_b: torch.Tensor,  # (B, 3, N)
    dst_tims_b: torch.Tensor,  # (B, 3, N), de-scaled
    active_b: torch.Tensor,  # (B, N) bool
    noise_bound_b: torch.Tensor,  # (B,)
    warm_rotation: torch.Tensor,  # (3, 3)
    use_warm,
    params: SolverParams,
    sync_free: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation stage of a batch of basic iterations with the PSULVSB
    inner-loop constants. This function owns the choice of the estimator, by
    the caller's settings and by nothing else:

    - GNC-TLS at the default `gnc_rot_method="power"`: `ops.gnc.gnc_batch`,
      which on the card launches the GNC kernel or raises;
    - GNC-TLS at `gnc_rot_method="eigh"`: the kernel computes its rotations
      by power iteration only, so this setting runs the plain batched loop
      with the exact 4x4 eigenvector on whatever device the tensors lie, and
      the call is counted in `PLAIN_ROUTE_CALLS`;
    - FGR: its batched loop, which takes no warm start
      (registration.cc:322-394).

    `sync_free`: nothing is read on the host (a captured segment); the plain
    loops then run every iteration masked and take the Jacobi form of the
    eigenvector, since torch.linalg.eigh cannot be captured into a CUDA graph.

    Returns (rotations (B, 3, 3), inliers (B, N) bool)."""
    global PLAIN_ROUTE_CALLS
    loop = dict(
        max_iterations=params.inner_rotation_max_iterations,
        gnc_factor=params.inner_rotation_gnc_factor,
        cost_threshold=params.inner_rotation_cost_threshold,
    )
    plain = dict(rot_method="jacobi" if sync_free else "eigh", early_exit=not sync_free)
    if params.rotation_estimation_algorithm != RotationEstimationAlgorithm.GNC_TLS:
        rots, l_pq, _, _ = fgr_batched(
            src_tims_b, dst_tims_b, active_b, noise_bound_b, **loop, **plain
        )
        return rots, (l_pq > 0) & active_b
    if params.gnc_rot_method == "power":
        return gnc_batch(
            src_tims_b, dst_tims_b, active_b, noise_bound_b, warm_rotation, use_warm, **loop
        )
    if params.gnc_rot_method != "eigh":
        raise ValueError(
            f"gnc_rot_method must be 'power' or 'eigh', got {params.gnc_rot_method!r}"
        )
    PLAIN_ROUTE_CALLS += 1
    return gnc_batch_reference(
        src_tims_b, dst_tims_b, active_b, noise_bound_b, warm_rotation, use_warm,
        **loop, **plain,
    )


class BasicResult(NamedTuple):
    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    scale_inliers: torch.Tensor  # (L,) bool over the TIM set
    rotation_inliers: torch.Tensor  # (L,) bool
    translation_point_inliers: torch.Tensor  # (C,) bool
    translation_points: torch.Tensor  # (C,) bool — points fed to translation


def basic_step(
    src: torch.Tensor,
    dst: torch.Tensor,
    idx_i: torch.Tensor,
    idx_j: torch.Tensor,
    tim_active: torch.Tensor,
    params: SolverParams,
    warm: WarmState,
    generator: torch.Generator | None = None,
    scale_u: torch.Tensor | None = None,
    sync_free: bool = False,
) -> BasicResult:
    """One decoupled solve over the TIMs (src[:, idx_j] - src[:, idx_i]) with
    the PSULVSB inner-loop noise bound (registration.cc:938-939). The
    rotation goes through `rotation_batch` as a batch of one, so at the
    default GNC-TLS setting it launches the GNC kernel on the card. At
    estimated scale `scale_u` (optional (scale_max_draws,) uniforms) picks
    the 1-point consensus's draws, as `_local_stage` takes them."""
    dtype, dev = src.dtype, src.device
    c = src.shape[1]
    nb = torch.full((), params.inner_noise_bound, dtype=dtype, device=dev)
    cb2 = torch.full((), params.inner_cbar2, dtype=dtype, device=dev)
    src_tims = src[:, idx_j] - src[:, idx_i]
    dst_tims = dst[:, idx_j] - dst[:, idx_i]
    use_warm = ~device_flag(warm.first_time, dev)
    if params.estimate_scaling:
        scale, scale_inliers, _ = solve_scale_tls(
            src_tims, dst_tims, nb, cb2, active=tim_active, warm_scale=warm.scale,
            use_warm=use_warm, max_draws=params.scale_max_draws,
            estimator=params.scale_estimator, u=scale_u, generator=generator,
        )
        rot_mask = scale_inliers
    else:
        scale, scale_inliers, _ = select_scale_inliers(src_tims, dst_tims, nb, cb2, tim_active)
        rot_mask = tim_active  # known scale: rotation on all TIMs (registration.cc:984-991)
    # De-scale the dst TIMs and widen the noise bound (registration.cc:1102-1107).
    inv_s = 1.0 / torch.clamp(scale, min=1e-30)
    rots, rot_inl = rotation_batch(
        src_tims[None], (dst_tims * inv_s)[None], rot_mask[None], (nb * 2.0 * inv_s)[None],
        warm.rotation, use_warm, params, sync_free,
    )
    rotation, rotation_inliers = rots[0], rot_inl[0]
    trans_points = endpoint_mask(idx_i, idx_j, rotation_inliers, c)
    # solveForTranslation(s R src, dst), then t /= s (registration.cc:1248-1250).
    t_s, t_inl, _ = solve_translation(
        scale * mm(rotation, src), dst, nb, cb2, active=trans_points,
        warm_translation=warm.translation, use_warm=use_warm,
    )
    return BasicResult(
        scale, rotation, t_s * inv_s, scale_inliers, rotation_inliers, t_inl, trans_points
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
