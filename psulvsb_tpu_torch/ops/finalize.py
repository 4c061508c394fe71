"""The finalize of a solve: the CUDA kernel of `csrc/finalize_fit.cu` and
its plain PyTorch version.

The finalize (solver/psulvsb.py `_finalize_counted`; in the JAX package
psulvsb_tpu/solver/psulvsb.py:1433 `_finalize_stage`) refits the sampled
best by a weighted Procrustes over every point, weighted by its host-inlier
hits, in the s (R p + t) model with the sampled best's scale; keeps the fit
when its RMSE over the final inliers beats the sampled best's
(registration.cc:1502-1525), else the host best's pose; and counts, where
the fit was kept, the consensus of the pose it returns (registration.cc:669,
:1417-1444), else the host best's count stands.

`refit_reference` and `pose_consensus` are the solver's code for it, moved
here; `finalize_fit_reference` composes them as `_finalize_counted` does
without the translation rescue, the rotation by the Jacobi eigen-solve that
a CUDA graph can hold. On a card that chain is about 510 launches; the
kernel makes it one.

A pair axis, as the other kernels have one: (P, 3, C) clouds, (P, C)
weights and masks, (P,) states give P pairs' finalizes in one launch. The
front door calls a PyTorch custom operator whose vmap rule moves the
vmapped axis into that pair axis (ops/_axis.py), so `torch.func.vmap` over
a solve (solver/fused.py's batched plan) makes one launch for all its
pairs.

Which version runs is decided by where the tensors lie: CPU tensors take
the plain version; CUDA tensors launch the kernel (`ops._build.launch`) or
raise.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import NamedTuple

import torch

from psulvsb_tpu_torch.core.linalg import weighted_procrustes_srt
from psulvsb_tpu_torch.core.metrics import masked_rmse
from psulvsb_tpu_torch.ops._axis import check_input, over_pairs, register_pair_vmap
from psulvsb_tpu_torch.ops._build import launch
from psulvsb_tpu_torch.solver.basic import WarmState
from psulvsb_tpu_torch.utils.precision import mm

_F32 = torch.float32
_I64 = torch.int64
# finalize_fit_launch: src, dst, counter, final_inliers, keep, the sampled
# best's scale, rotation, translation, the host best's and its count, thr;
# P, C; the four outputs; stream.
_ARGTYPES = [c_void_p] * 13 + [c_int] * 2 + [c_void_p] * 5


class Finalized(NamedTuple):
    """A finalize's result: the pose returned (rotation (3, 3), translation
    (3,)), its count, and whether the refit was kept."""

    rotation: torch.Tensor
    translation: torch.Tensor
    count: torch.Tensor
    refined: torch.Tensor


def pose_consensus(src, dst, keep_mask, scale, rotation, translation, thr):
    """The consensus of the pose s (R p + t): the real columns (keep_mask
    > -2) whose residual lies within `thr`, counted as the solver's host
    stage counts the host best's."""
    moved = scale * (mm(rotation, src) + translation[:, None])
    res = torch.sqrt(((dst - moved) ** 2).sum(0))
    return ((res <= thr) & (keep_mask > -2)).sum()


def refit_reference(src, dst, inlier_counter, final_inliers, sampled: WarmState,
                    best: WarmState, method: str = "eigh"):
    """The weighted refit of the sampled best and its RMSE gate (module
    docstring) of one (3, C) pair; `method` names the eigen-solver of the
    fit's rotation (core.linalg.rot_from_correlation). Returns (rotation,
    translation, better () bool): the fit where better, else the host
    best's pose."""
    s = sampled.scale
    s_safe = torch.where(s > 0, s, torch.ones_like(s))
    w = inlier_counter.to(src.dtype)
    moved = s_safe * (mm(sampled.rotation, src) + sampled.translation[:, None])
    r_fit, t_fit = weighted_procrustes_srt(moved, dst, w, method=method)
    # combined = final * initial (registration.cc:566) in s*(R p + t) form.
    r_adj = mm(r_fit, sampled.rotation)
    t_adj = mm(r_fit, sampled.translation) + t_fit / s_safe

    mask = final_inliers == 1
    rmse_adj = masked_rmse(src, dst, mask, r_adj, t_adj, scale=s_safe)
    rmse_ori = masked_rmse(src, dst, mask, sampled.rotation, sampled.translation, scale=s_safe)
    better = rmse_adj < rmse_ori
    rotation = torch.where(better, r_adj, best.rotation)
    translation = torch.where(better, t_adj, best.translation)
    return rotation, translation, better


def finalize_fit_reference(src, dst, inlier_counter, final_inliers, keep_mask,
                           sampled: WarmState, best: WarmState, best_count, thr,
                           method: str = "jacobi") -> Finalized:
    """Plain version of `finalize_fit` for one (3, C) pair: `refit_reference`,
    then the returned pose's consensus under the host best's scale where
    the refit was kept, else `best_count`."""
    rotation, translation, refined = refit_reference(src, dst, inlier_counter, final_inliers,
                                                     sampled, best, method)
    moved = pose_consensus(src, dst, keep_mask, best.scale, rotation, translation, thr)
    return Finalized(rotation, translation, torch.where(refined, moved, best_count), refined)


def finalize_fit(src, dst, inlier_counter, final_inliers, keep_mask, sampled: WarmState,
                 best: WarmState, best_count, thr) -> Finalized:
    """The finalize of a solve (module docstring): clouds (3, C), the host
    stage's inlier_counter, final_inliers and keep_mask (C,) int64, the
    sampled best and the host best (scale (), rotation (3, 3), translation
    (3,)), the host best's count () int64 and thr (). CPU tensors run the
    plain version (the Jacobi eigen-solve); CUDA tensors the kernel (no
    fallback).

    A pair axis: (P, 3, C) clouds, (P, C) masks and (P,) scalars give P
    pairs' results from one launch (`torch.func.vmap` over the single form
    comes here too)."""
    single = src.dim() == 2
    lead = src.shape[:-2]
    c = src.shape[-1]
    dev = src.device
    want = [("dst", dst, tuple(src.shape)), ("inlier_counter", inlier_counter, lead + (c,)),
            ("final_inliers", final_inliers, lead + (c,)), ("keep_mask", keep_mask, lead + (c,)),
            ("best_count", best_count, lead), ("thr", thr, lead)]
    for prefix, state in (("sampled", sampled), ("best", best)):
        want += [(f"{prefix}.scale", state.scale, lead),
                 (f"{prefix}.rotation", state.rotation, lead + (3, 3)),
                 (f"{prefix}.translation", state.translation, lead + (3,))]
    if src.dim() not in (2, 3) or src.shape[-2] != 3:
        raise ValueError(f"src must be (3, C) or (P, 3, C), got {tuple(src.shape)}")
    for name, t, shape in want:
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name} must be {tuple(shape)} on {dev}, got {tuple(t.shape)} on "
                             f"{t.device}")
    args = [src, dst, inlier_counter, final_inliers, keep_mask, sampled.scale, sampled.rotation,
            sampled.translation, best.scale, best.rotation, best.translation, best_count, thr]
    if single:
        args = [t[None] for t in args]
    out = torch.ops.psulvsb_tpu_torch.finalize_fit(*args)
    if single:
        out = tuple(t[0] for t in out)
    return Finalized(*out)


@torch.library.custom_op("psulvsb_tpu_torch::finalize_fit", mutates_args=())
def _finalize_fit_pairs(
    src: torch.Tensor, dst: torch.Tensor, inlier_counter: torch.Tensor,
    final_inliers: torch.Tensor, keep_mask: torch.Tensor, s_scale: torch.Tensor,
    s_rot: torch.Tensor, s_trans: torch.Tensor, b_scale: torch.Tensor, b_rot: torch.Tensor,
    b_trans: torch.Tensor, best_count: torch.Tensor, thr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`finalize_fit` over P pairs: the plain version on the CPU, one
    launch on a card. Outputs rotation (P, 3, 3), translation (P, 3), count
    (P,) int64, refined (P,) bool."""
    p, _, c = src.shape
    if not src.is_cuda:
        def one(sr, ds, cnt, fin, kp, ss, sr_, st, bs, br, bt, bc, th):
            false = torch.zeros((), dtype=torch.bool, device=sr.device)
            return tuple(finalize_fit_reference(sr, ds, cnt, fin, kp, WarmState(ss, sr_, st, false),
                                                WarmState(bs, br, bt, false), bc, th))

        return over_pairs(one, p, src, dst, inlier_counter, final_inliers, keep_mask, s_scale,
                          s_rot, s_trans, b_scale, b_rot, b_trans, best_count, thr)
    dev = src.device
    ins = [("src", src, _F32), ("dst", dst, _F32), ("inlier_counter", inlier_counter, _I64),
           ("final_inliers", final_inliers, _I64), ("keep_mask", keep_mask, _I64),
           ("sampled.scale", s_scale, _F32), ("sampled.rotation", s_rot, _F32),
           ("sampled.translation", s_trans, _F32), ("best.scale", b_scale, _F32),
           ("best.rotation", b_rot, _F32), ("best.translation", b_trans, _F32),
           ("best_count", best_count, _I64), ("thr", thr, _F32)]
    ins = [check_input(n, t, dt, dev).contiguous() for n, t, dt in ins]
    rotation = torch.empty((p, 3, 3), dtype=_F32, device=dev)
    translation = torch.empty((p, 3), dtype=_F32, device=dev)
    count = torch.empty(p, dtype=_I64, device=dev)
    refined = torch.empty(p, dtype=torch.bool, device=dev)
    launch("finalize_fit", _ARGTYPES, dev, *(t.data_ptr() for t in ins), p, c,
           rotation.data_ptr(), translation.data_ptr(), count.data_ptr(), refined.data_ptr())
    return rotation, translation, count, refined


register_pair_vmap(_finalize_fit_pairs, 13, contiguous=True)
