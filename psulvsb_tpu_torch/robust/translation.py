"""Component-wise robust translation solver (TLSTranslationSolver::
solveForTranslation, registration.cc:436-463): per-axis max-interval
stabbing on dst - src with noise beta = noise_bound * sqrt(cbar2); a point
is an inlier iff all three axes agree. Batched over leading dims."""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.robust.scalar_tls import max_stabbing
from psulvsb_tpu_torch.utils.precision import mm
from psulvsb_tpu_torch.utils.scalars import as_float32, as_scalar


def scatter_or(num_points: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., num_points) bool with True at idx where mask (the reference's
    `dub[]` dedup). Masked-out entries write into a sentinel slot that is
    sliced off, so no write ever clears a True."""
    batch = idx.shape[:-1]
    out = torch.zeros(batch + (num_points + 1,), dtype=torch.bool, device=idx.device)
    target = torch.where(mask, idx, torch.full_like(idx, num_points))
    out.scatter_(-1, target, True)
    return out[..., :num_points]


def solve_translation(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: torch.Tensor | float,
    cbar2: torch.Tensor | float,
    active: torch.Tensor | None = None,
    warm_translation: torch.Tensor | None = None,
    use_warm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (translation (..., 3), inlier mask (..., N), beta).

    src/dst: (..., 3, N), already rotated and scaled by the caller
    (registration.cc:1248)."""
    dtype, dev = src.dtype, src.device
    if active is None:
        active = torch.ones(src.shape[:-2] + src.shape[-1:], dtype=torch.bool, device=dev)
    beta = as_scalar(noise_bound, dtype, dev) * torch.sqrt(as_scalar(cbar2, dtype, dev))
    raw = dst - src  # (..., 3, N)
    if warm_translation is None:
        warm_translation = torch.zeros(3, dtype=dtype, device=dev)
    warm = warm_translation.expand(src.shape[:-1])
    act = active[..., None, :].expand(raw.shape)
    est, inl = max_stabbing(raw, beta, active=act, warm_value=warm, use_warm=use_warm)
    inliers = inl.all(dim=-2) & active
    return est, inliers, beta


def solve_translation_endpoints(
    src: torch.Tensor,
    dst: torch.Tensor,
    rotation: torch.Tensor,
    scale: torch.Tensor,
    b_i: torch.Tensor,
    b_j: torch.Tensor,
    tim_mask: torch.Tensor,
    noise_bound: torch.Tensor | float,
    cbar2: torch.Tensor | float,
    warm_translation: torch.Tensor | None = None,
    use_warm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Translation solve over the deduplicated endpoints of the active basic
    TIMs only: the same estimate as masking the full (3, C) arrays, with
    sorts sized 2L instead of C.

    src/dst: (3, C) point sets; rotation (..., 3, 3), scale (...), b_i/b_j/
    tim_mask (..., L). Returns (translation_scaled (..., 3), point inliers
    (..., C), points fed (..., C), beta); the caller divides by scale
    (registration.cc:1248-1250)."""
    c = src.shape[1]
    idx = torch.cat([b_i, b_j], dim=-1)  # (..., 2L)
    okm = torch.cat([tim_mask, tim_mask], dim=-1)
    si = torch.sort(torch.where(okm, idx, torch.full_like(idx, c)), dim=-1).values
    first = torch.ones_like(okm)
    first[..., 1:] = si[..., 1:] != si[..., :-1]
    first = first & (si < c)
    gi = torch.where(si < c, si, torch.zeros_like(si))
    src_g = src[:, gi].movedim(0, -2)  # (..., 3, 2L)
    dst_g = dst[:, gi].movedim(0, -2)
    moved = scale[..., None, None] * mm(rotation, src_g)
    t_s, inl, beta = solve_translation(
        moved, dst_g, noise_bound, cbar2, active=first,
        warm_translation=warm_translation, use_warm=use_warm,
    )
    points_c = scatter_or(c, gi, first)
    inliers_c = scatter_or(c, gi, inl & first)
    return t_s, inliers_c, points_c, beta


def global_translation_vote(
    src: torch.Tensor,
    dst: torch.Tensor,
    rotation: torch.Tensor,
    scale: torch.Tensor,
    real: torch.Tensor,
    noise_bound: float,
    cbar2: float,
    current_translation: torch.Tensor,
    chunk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint 1-point translation consensus over all real correspondences,
    the repeated-geometry aliasing rescue (psulvsb_tpu/robust/translation.py
    ::global_translation_vote).

    Every correspondence proposes t_i = dst_i - s R src_i and votes for every
    proposal within the per-axis noise box (AND over axes) in (chunk, C)
    sweeps; the first proposal with the most votes wins and its box members
    are averaged. Returns (t_new (3,) divided by the scale, support_new ()
    int64, support_cur () int64 — the box count at `current_translation`);
    the caller adopts t_new only on a strict support gain."""
    c = src.shape[1]
    dtype, dev = src.dtype, src.device
    beta = as_scalar(noise_bound, dtype, dev) * torch.sqrt(as_scalar(cbar2, dtype, dev))
    d = (dst - scale * mm(rotation, src)).T  # (C, 3) proposals, s-scaled
    votes = torch.cat([
        ((torch.abs(d[r0:r0 + chunk, None, :] - d[None, :, :]) <= beta).all(-1) & real[None]).sum(1)
        for r0 in range(0, c, chunk)
    ])
    votes = torch.where(real, votes, -1)
    i = torch.argmax(votes)
    # index_select, not d[i]: indexing by a 0-d tensor reads it on the host.
    member = (torch.abs(d - d.index_select(0, i.reshape(1))) <= beta).all(-1) & real
    denom = torch.clamp(member.sum().to(dtype), min=1.0)
    center = torch.where(member[:, None], d, torch.zeros_like(d)).sum(0) / denom
    s_safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    cur_box = (torch.abs(d - scale * current_translation) <= beta).all(-1) & real
    return center / s_safe, member.sum(), cur_box.sum()


class TLSTranslationSolver:
    """Facade of teaser::TLSTranslationSolver (registration.h:194-217): the
    component-wise translation of `solve_translation` on float32 points
    moved to `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, noise_bound: float, cbar2: float, device="cuda"):
        self.noise_bound = noise_bound
        self.cbar2 = cbar2
        self.device = torch.device(device)

    def solveForTranslation(self, src, dst):
        """Returns (translation (3,), inlier mask over the points)."""
        t, inliers, _ = solve_translation(
            as_float32(src, self.device), as_float32(dst, self.device), self.noise_bound,
            self.cbar2,
        )
        return t, inliers
