"""The local batch around the rotation estimator: the CUDA kernels of
`csrc/local_batch.cu` and their plain PyTorch versions.

A local batch of the solver (solver/psulvsb.py `_local_round`; in the JAX
package psulvsb_tpu/solver/psulvsb.py:815 `_local_stage`, its
`eval_batch_pallas` and `batch_body`) on the endpoint
route, the route of every batch but the b_rate == 1.0 clique round's and
those of a sampled set too small for the endpoint sorts (2 bcap >= C), is
three steps:

- `local_pick`: each hypothesis' basic set, the top bcap of its Gumbel keys
  over the valid sampled slots (the first `basic_choose` of them selected),
  its TIMs, and at known scale their scale test and the GNC noise bounds;
- the rotation estimator (`solver.basic.rotation_batch`), and before it at
  estimated scale the 1-point scale consensus, in PyTorch;
- `local_accept`: the translation over each hypothesis' deduplicated
  endpoints, the score of the batch and of the warm state over the sampled
  points, the similarity test, and the serial acceptance of the batch
  (registration.cc:1256-1398) replayed over it: the new `LocalState`.

The plain versions are the solver's code as it was written around the GNC
kernel, moved here unchanged, about 260 operations a batch on a card. The
kernels make the same batch two launches beside the estimator's; on the
card a batch runs nothing else.

Keys: float32 Gumbel keys (the staged solver's), or the int64 draws of a
`DrawLayout` place, whose Gumbel keys the kernel computes as `gumbel_of(
uniform_of(draws))` does (the one-launch solve's, which then stage no
conversion).

A pair axis, as the other kernels have one: (P, B, S) keys, (P, S) sampled
slots, (P, 3, C) clouds and a (P,) state give P pairs' batches from one
launch each. The front doors call PyTorch custom operators whose vmap rules
move the vmapped axis into that pair axis (ops/_axis.py), so
`torch.func.vmap` over a solve (solver/fused.py's batched plan) makes one
launch for all its pairs.

Which version runs is decided by where the tensors lie: CPU tensors take
the plain version; CUDA tensors launch the kernel (`ops._build.launch`) or
raise.
"""

from __future__ import annotations

import functools
import math
from ctypes import c_float, c_int, c_longlong, c_void_p
from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.core.metrics import angular_error_rad
from psulvsb_tpu_torch.ops._axis import check_input, over_pairs, register_pair_vmap
from psulvsb_tpu_torch.ops._build import launch, load_library
from psulvsb_tpu_torch.robust.scale import select_scale_inliers
from psulvsb_tpu_torch.robust.translation import solve_translation_endpoints
from psulvsb_tpu_torch.solver.basic import WarmState, score_transform
from psulvsb_tpu_torch.utils.scalars import as_scalar, device_flag
from psulvsb_tpu_torch.utils.scalars import pick as _pick

_F32 = torch.float32
_I64 = torch.int64
UNIT_SHIFT = 62 - 24  # a draw's top 24 of its 62 bits give a float32 uniform in [0, 1)
# local_pick_launch: keys_f, keys_d, s_i, s_j, s_ok, s_count, b_rate, src,
# dst, first_time; P, B, S, bcap, C, known; beta, noise2; b_i, b_j, sel_ok,
# src_t, dst_t, sc_inl, noise, scale, use_warm, ticket, ws, stream.
_PICK_ARGTYPES = [c_void_p] * 10 + [c_int] * 6 + [c_float] * 2 + [c_void_p] * 12
# local_accept_launch: 26 inputs; P, B, bcap, C; beta, scale_noise,
# trans_noise, rotation_similar, stagnation_min, local_confidence;
# local_max_iter; ticket, 6 result arrays, scratch; 16 outputs; stream.
_ACCEPT_ARGTYPES = ([c_void_p] * 26 + [c_int] * 4 + [c_float] * 6 + [c_longlong]
                    + [c_void_p] * 8 + [c_void_p] * 16 + [c_void_p])


def gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel keys -log(-log(u)) from uniforms u, clamped to
    [tiny, 1)."""
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(_F32).tiny)))


def uniform_of(draws: torch.Tensor) -> torch.Tensor:
    """int64 draws in [0, 2^62) as float32 uniforms in [0, 1) with 24
    random bits, as torch.rand makes them."""
    return (draws >> UNIT_SHIFT).to(_F32) * (2.0 ** -24)


def keys_of(keys: torch.Tensor) -> torch.Tensor:
    """Gumbel keys as given, or those of int64 draws."""
    return keys if keys.is_floating_point() else gumbel_of(uniform_of(keys))


class AcceptRule(NamedTuple):
    """The constants of a batch's translation, similarity test and
    acceptance (registration.cc:938-939, 1261-1264, 1356-1366)."""

    noise_bound: float
    cbar2: float
    scale_noise: float
    trans_noise: float
    rotation_similar: float
    local_max_iter: int
    stagnation_min_pro_local: float
    local_confidence: float

    @staticmethod
    def of(params) -> "AcceptRule":
        nb, cb2 = params.inner_noise_bound, params.inner_cbar2
        return AcceptRule(nb, cb2, 2.0 * nb * math.sqrt(cb2), nb * math.sqrt(cb2),
                          params.rotation_similar, params.local_max_iter,
                          params.stagnation_min_pro_local, params.local_confidence)


class Pick(NamedTuple):
    """A batch's basic sets: (B, bcap) endpoints and selection, (B, 3, bcap)
    TIMs; at known scale (else None) the scales (ones), the scale inliers
    and the GNC noise bounds (B,); use_warm (the warm state is not the
    first); the accept kernel's meeting count, 0 (None from
    `local_pick_reference`)."""

    b_i: torch.Tensor
    b_j: torch.Tensor
    sel_ok: torch.Tensor
    src_t: torch.Tensor
    dst_t: torch.Tensor
    scale: torch.Tensor | None
    sc_inl: torch.Tensor | None
    noise: torch.Tensor | None
    use_warm: torch.Tensor
    ticket: torch.Tensor | None


class Accepted(NamedTuple):
    """The state after a batch (solver.psulvsb.LocalState's fields that a
    batch writes); `extras`, the stage masks of the winner, where tracked."""

    best: WarmState
    best_count: torch.Tensor
    local_r: torch.Tensor
    pro_local: torch.Tensor
    hypotheses: torch.Tensor
    escalate: torch.Tensor
    done: torch.Tensor
    extras_valid: torch.Tensor
    extras: tuple | None


def basic_choose_of(sampled_count: torch.Tensor, b_rate, bcap: int,
                    b_rate_is_one: bool) -> torch.Tensor:
    """How many of a hypothesis' top slots its basic set takes: the sampled
    set (capped) at b_rate == 1.0, else clamp(floor(count b_rate), 1, bcap)."""
    if b_rate_is_one:
        return torch.clamp(sampled_count, max=bcap)
    rate = as_scalar(b_rate, _F32, sampled_count.device)
    return torch.clamp(torch.floor(sampled_count.to(_F32) * rate).to(_I64), 1, bcap)


# ---- the plain versions -------------------------------------------------------


def local_pick_reference(keys, s_i, s_j, s_ok, basic_choose, src, dst, bcap: int, first_time,
                         noise_bound: float, cbar2: float, known_scale: bool) -> Pick:
    """Plain version of `local_pick` for one pair: keys (B, S), slots (S,),
    basic_choose (), clouds (3, C)."""
    dev = src.device
    score = torch.where(s_ok, keys_of(keys), -math.inf)  # (batch, S)
    vals, top = torch.topk(score, bcap, dim=1, sorted=True)
    n_valid = (vals > -math.inf).sum(1)
    sel_ok = torch.arange(bcap, device=dev) < torch.minimum(basic_choose, n_valid)[:, None]
    zero = torch.zeros_like(top)
    b_i = torch.where(sel_ok, s_i[top], zero)
    b_j = torch.where(sel_ok, s_j[top], zero)
    src_t = (src[:, b_j] - src[:, b_i]).movedim(0, 1)  # (batch, 3, bcap)
    dst_t = (dst[:, b_j] - dst[:, b_i]).movedim(0, 1)
    use_warm = ~device_flag(first_time, dev)
    if not known_scale:
        return Pick(b_i, b_j, sel_ok, src_t, dst_t, None, None, None, use_warm, None)
    nb = torch.full((), noise_bound, dtype=_F32, device=dev)
    cb2 = torch.full((), cbar2, dtype=_F32, device=dev)
    scale, sc_inl, _ = select_scale_inliers(src_t, dst_t, nb, cb2, sel_ok)
    # The GNC noise bounds at s = 1, as the estimated scale widens them
    # (registration.cc:1102-1107).
    noise = nb * 2.0 * (1.0 / torch.clamp(scale, min=1e-30))
    return Pick(b_i, b_j, sel_ok, src_t, dst_t, scale, sc_inl, noise, use_warm, None)


def similar(sol_scale, sol_rot, sol_trans, warm: WarmState, rule: AcceptRule):
    """Early-accept similarity test (registration.cc:1261-1264), batched
    over hypotheses, with the inner-loop noise constants."""
    return (
        (torch.abs(warm.scale - sol_scale) <= rule.scale_noise)
        & (angular_error_rad(warm.rotation, sol_rot) <= rule.rotation_similar)
        & (torch.linalg.vector_norm(warm.translation - sol_trans, dim=-1) <= rule.trans_noise)
    )


def accept_replay(src, dst, s_pts, counts, sims, scales, rots, transs, warm: WarmState, st,
                  host_r, thr, rule: AcceptRule, b_rate_is_one: bool,
                  extras_b: tuple | None = None) -> Accepted:
    """The serial acceptance of one batch (registration.cc:1256-1398)
    replayed over its B hypotheses, given their counts and similarity
    flags: `st` the state before the batch (its best_count, local_r,
    hypotheses, escalate, extras_valid and, with `extras_b`, the stage masks
    `extras`)."""
    dev = src.device
    batch = counts.shape[0]
    t_idx = torch.arange(batch, device=dev)
    n_sampled_pts = torch.clamp(s_pts.sum(), min=1).to(_F32)
    first_time = device_flag(warm.first_time, dev)
    sims = sims & ~first_time  # early-accept only after first scoring

    # Baseline: the serial loop re-baselines to warm's own sampled count
    # (registration.cc:1289-1315) except before the first scoring and at
    # the escalated b_rate == 1.0 round.
    if b_rate_is_one:
        baseline = torch.full((), -1, dtype=_I64, device=dev)
    else:
        baseline, _ = score_transform(
            src, dst, s_pts, warm.scale, warm.rotation, warm.translation, thr,
        )
        baseline = torch.where(first_time, -1, baseline)
    run_best = torch.cummax(torch.maximum(counts, baseline), dim=0).values
    local_r_t = st.local_r + t_idx + 1
    w_t = run_best.to(_F32) / n_sampled_pts
    pro_t = 1.0 - torch.pow(1.0 - w_t, local_r_t.to(_F32))

    # Early-accept: the first similar hypothesis ends the local loop with
    # pro_local = 1 (registration.cc:1261-1282).
    sim_any = sims.any()
    sim_t = torch.argmax(sims.to(_I64))
    stagn_t = (local_r_t >= rule.local_max_iter) & (pro_t <= rule.stagnation_min_pro_local)
    if b_rate_is_one:
        stagn_t = torch.ones_like(stagn_t)  # registration.cc:1361
    conf_t = pro_t > rule.local_confidence
    stop_mask = conf_t | stagn_t
    stop_any = stop_mask.any()
    stop_t = torch.where(stop_any, torch.argmax(stop_mask.to(_I64)), batch - 1)

    # The effective cut: earliest of early-accept and stop.
    is_sim_cut = sim_any & (sim_t <= stop_t)
    cut = torch.where(is_sim_cut, sim_t, stop_t)

    # Winner among hypotheses [0..cut]: first max of counts vs baseline.
    cmask = torch.where(t_idx <= cut, counts, torch.iinfo(_I64).min)
    best_h = torch.argmax(cmask)
    batch_best_count = _pick(cmask, best_h)
    take_batch = (batch_best_count > baseline) | first_time

    def choose(stack, keep):
        win = torch.where(take_batch, _pick(stack, best_h), keep)
        # Early-accept overrides the winner (registration.cc:1278-1281).
        return torch.where(is_sim_cut, _pick(stack, sim_t), win)

    new_scale = choose(scales, warm.scale)
    new_rot = choose(rots, warm.rotation)
    new_trans = choose(transs, warm.translation)
    new_best_count = torch.maximum(batch_best_count, baseline)

    consumed = cut + 1
    # The host_r + 1 bump applies only when the round's literal first
    # hypothesis is the similar one (registration.cc:1270-1276).
    sim_bump = torch.where(
        (st.hypotheses == 0) & is_sim_cut & (sim_t == 0), host_r + 1, consumed
    )
    local_r = st.local_r + torch.where(is_sim_cut, sim_bump, consumed)

    one = torch.ones((), dtype=_F32, device=dev)
    pro_after = torch.where(is_sim_cut | stop_any, one, pro_t[batch - 1])
    conf_at_stop = _pick(conf_t, stop_t)
    pro_local = torch.where(
        stop_any & ~is_sim_cut & conf_at_stop, _pick(pro_t, stop_t), pro_after
    )
    escalate = st.escalate | (
        stop_any & ~is_sim_cut & _pick(stagn_t, stop_t) & ~conf_at_stop
    )

    # Stage masks follow the same winner selection.
    sel_idx = torch.where(is_sim_cut, sim_t, best_h)
    keep_new = is_sim_cut | take_batch
    extras = None
    if extras_b is not None:
        extras = tuple(torch.where(keep_new, _pick(new, sel_idx), old)
                       for new, old in zip(extras_b, st.extras))
    return Accepted(
        best=WarmState(new_scale, new_rot, new_trans, first_time=device_flag(False, dev)),
        best_count=torch.where(is_sim_cut, st.best_count, new_best_count),
        local_r=local_r,
        pro_local=pro_local,
        hypotheses=st.hypotheses + consumed,
        escalate=escalate,
        done=is_sim_cut | stop_any,
        extras_valid=st.extras_valid | keep_new,
        extras=extras,
    )


def local_accept_reference(src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm: WarmState, st,
                           host_r, thr, rule: AcceptRule, sc_inl=None,
                           track: bool = False) -> Accepted:
    """Plain version of `local_accept` for one pair: the endpoint
    translation (registration.cc:1108-1250), the scores on the sampled
    points and the similarity test, then `accept_replay`."""
    dev = src.device
    nb = torch.full((), rule.noise_bound, dtype=_F32, device=dev)
    cb2 = torch.full((), rule.cbar2, dtype=_F32, device=dev)
    t_s, t_inl, t_pts, _ = solve_translation_endpoints(
        src, dst, rots, scale, b_i, b_j, rot_inl, nb, cb2,
        warm_translation=warm.translation, use_warm=~device_flag(warm.first_time, dev),
    )
    trans = t_s * (1.0 / torch.clamp(scale, min=1e-30))[:, None]
    counts, _ = score_transform(src, dst, s_pts, scale, rots, trans, thr)
    sims = similar(scale, rots, trans, warm, rule)
    extras_b = (b_i, b_j, sc_inl, rot_inl, t_inl, t_pts) if track else None
    return accept_replay(src, dst, s_pts, counts, sims, scale, rots, trans, warm, st, host_r,
                         thr, rule, False, extras_b)


# ---- the front doors -----------------------------------------------------------


def _lead(t: torch.Tensor, single: bool) -> torch.Tensor:
    return t[None] if single else t


def local_pick(keys, s_i, s_j, s_ok, sampled_count, b_rate, src, dst, bcap: int, first_time,
               noise_bound: float, cbar2: float, known_scale: bool) -> Pick:
    """A batch's basic sets (module docstring): keys (B, S) float32 Gumbel
    keys or int64 draws, the sampled slots s_i, s_j, s_ok (S,) and their
    count (), b_rate a float or a float32 (), clouds (3, C), the warm
    state's first_time (). CPU tensors run the plain version; CUDA tensors
    the kernel (no fallback).

    A pair axis: (P, B, S) keys, (P, S) slots, (P,) counts, rates and
    flags, (P, 3, C) clouds give P pairs' picks in one launch
    (`torch.func.vmap` over the single form comes here too)."""
    single = src.dim() == 2
    dev = src.device
    lead = () if single else (src.shape[0],)
    s = s_i.shape[-1]
    if keys.dim() != len(lead) + 2 or keys.shape[-1] != s or tuple(keys.shape[:-2]) != lead:
        raise ValueError(f"keys must be {lead + ('B', s)}, got {tuple(keys.shape)}")
    for name, t, shape in (("s_j", s_j, lead + (s,)), ("s_ok", s_ok, lead + (s,)),
                           ("dst", dst, tuple(src.shape))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
    if src.shape[-2] != 3 or tuple(s_i.shape) != lead + (s,) or keys.device != dev:
        raise ValueError(f"src must be (..., 3, C) and s_i {lead + (s,)} on one device, got "
                         f"{tuple(src.shape)} and {tuple(s_i.shape)}")
    if not 1 <= bcap <= s:
        raise ValueError(f"bcap must lie in [1, S = {s}], got {bcap}")
    if s_ok.dtype != torch.bool or keys.dtype not in (_F32, _I64):
        raise ValueError(f"s_ok must be bool and keys float32 or int64, got {s_ok.dtype} and "
                         f"{keys.dtype}")
    rate = as_scalar(b_rate, _F32, dev)
    flag = device_flag(first_time, dev) if single else first_time.to(dev, torch.bool)
    count = sampled_count.to(dev, _I64)
    if not single:
        rate = rate.expand(lead)
    args = [_lead(t, single) for t in (keys, s_i, s_j, s_ok, count, rate, src, dst, flag)]
    out = torch.ops.psulvsb_tpu_torch.local_pick(*args, int(bcap), float(noise_bound),
                                                 float(cbar2), bool(known_scale))
    if single:
        out = tuple(t[0] for t in out)
    b_i, b_j, sel_ok, src_t, dst_t, scale, sc_inl, noise, use_warm, ticket = out
    if not known_scale:
        scale = sc_inl = noise = None
    return Pick(b_i, b_j, sel_ok, src_t, dst_t, scale, sc_inl, noise, use_warm, ticket)


def local_accept(src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm: WarmState, st, host_r,
                 thr, rule: AcceptRule, sc_inl=None, track: bool = False,
                 ticket: torch.Tensor | None = None) -> Accepted:
    """A batch's acceptance (module docstring): clouds (3, C), the sampled
    points s_pts (C,), the basic sets b_i, b_j (B, bcap), the rotation
    inliers (B, bcap) and rotations (B, 3, 3), the scales (B,), the warm
    state, `st` the state before the batch (its best_count, local_r,
    hypotheses, escalate, extras_valid and, with `track`, the stage masks
    `extras`), host_r (), thr (); with `track` also the batch's scale
    inliers `sc_inl`. `ticket`: the pick's (the kernel's meeting count, 0);
    None makes one. CPU tensors run the plain version; CUDA tensors the
    kernel (no fallback). A pair axis as `local_pick` takes it."""
    single = src.dim() == 2
    dev = src.device
    lead = () if single else (src.shape[0],)
    bshape = tuple(b_i.shape)
    if len(bshape) != len(lead) + 2 or bshape[:-2] != lead:
        raise ValueError(f"b_i must be {lead + ('B', 'bcap')}, got {bshape}")
    bb = bshape[:-1]
    for name, t, shape in (("b_j", b_j, bshape), ("rot_inl", rot_inl, bshape),
                           ("rots", rots, bb + (3, 3)), ("scale", scale, bb),
                           ("s_pts", s_pts, lead + (src.shape[-1],)),
                           ("dst", dst, tuple(src.shape))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
    if track and (sc_inl is None or st.extras is None or tuple(sc_inl.shape) != bshape):
        raise ValueError("tracking the stage masks needs the batch's scale inliers "
                         f"{bshape} and the state's masks")
    if rot_inl.dtype != torch.bool or s_pts.dtype != torch.bool:
        raise ValueError(f"rot_inl and s_pts must be bool, got {rot_inl.dtype}, {s_pts.dtype}")
    flag = device_flag(warm.first_time, dev) if single else warm.first_time.to(dev, torch.bool)
    if ticket is None:
        ticket = torch.zeros(lead or (1,), dtype=torch.int32, device=dev)
    ex = tuple(st.extras) if track else (None,) * 6
    args = [src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm.scale, warm.rotation,
            warm.translation, flag, st.best_count, st.local_r, st.hypotheses, st.escalate,
            st.extras_valid, host_r, thr]
    args = [_lead(torch.as_tensor(t, device=dev), single) for t in args]
    ticket = ticket.reshape(1) if single else ticket
    opt = [None if t is None else _lead(t, single) for t in (sc_inl, *ex)]
    out = torch.ops.psulvsb_tpu_torch.local_accept(*args, ticket, *opt, *map(float, rule[:5]),
                                                   int(rule.local_max_iter),
                                                   float(rule.stagnation_min_pro_local),
                                                   float(rule.local_confidence))
    if single:
        out = tuple(t[0] for t in out)
    return Accepted(WarmState(out[0], out[1], out[2], device_flag(False, dev)), *out[3:10],
                    tuple(out[10:]) if track else None)


# ---- the operators ---------------------------------------------------------------


class _State(NamedTuple):
    """A pair's `st` as the plain version reads it."""

    best_count: torch.Tensor
    local_r: torch.Tensor
    hypotheses: torch.Tensor
    escalate: torch.Tensor
    extras_valid: torch.Tensor
    extras: tuple | None


@torch.library.custom_op("psulvsb_tpu_torch::local_pick", mutates_args=())
def _local_pick_pairs(
    keys: torch.Tensor, s_i: torch.Tensor, s_j: torch.Tensor, s_ok: torch.Tensor,
    sampled_count: torch.Tensor, b_rate: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    first_time: torch.Tensor, bcap: int, noise_bound: float, cbar2: float, known_scale: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`local_pick` over P pairs: the plain version on the CPU, one launch
    on a card. Outputs b_i, b_j, sel_ok, src_t, dst_t, scale, sc_inl, noise,
    use_warm, ticket; the scale's three are unset at estimated scale."""
    p, b = keys.shape[:2]
    if not src.is_cuda:
        def one(k, si, sj, ok, cnt, rate, sr, ds, ft):
            choose = basic_choose_of(cnt, rate, bcap, False)
            out = local_pick_reference(k, si, sj, ok, choose, sr, ds, bcap, ft, noise_bound,
                                       cbar2, known_scale)
            if not known_scale:
                out = out._replace(scale=torch.zeros((b, 0), device=sr.device),
                                   sc_inl=torch.zeros((b, 0), dtype=torch.bool, device=sr.device),
                                   noise=torch.zeros((b, 0), device=sr.device))
            return tuple(out[:9]) + (torch.zeros((), dtype=torch.int32, device=sr.device),)

        return over_pairs(one, p, keys, s_i, s_j, s_ok, sampled_count, b_rate, src, dst,
                          first_time)
    return _launch_pick(keys, s_i, s_j, s_ok, sampled_count, b_rate, src, dst, first_time, bcap,
                        noise_bound, cbar2, known_scale)


register_pair_vmap(_local_pick_pairs, 9)


@torch.library.custom_op("psulvsb_tpu_torch::local_accept", mutates_args=())
def _local_accept_pairs(
    src: torch.Tensor, dst: torch.Tensor, s_pts: torch.Tensor, b_i: torch.Tensor,
    b_j: torch.Tensor, rot_inl: torch.Tensor, rots: torch.Tensor, scale: torch.Tensor,
    warm_scale: torch.Tensor, warm_rot: torch.Tensor, warm_trans: torch.Tensor,
    first_time: torch.Tensor, best_count: torch.Tensor, local_r: torch.Tensor,
    hypotheses: torch.Tensor, escalate: torch.Tensor, extras_valid: torch.Tensor,
    host_r: torch.Tensor, thr: torch.Tensor, ticket: torch.Tensor,
    sc_inl: torch.Tensor | None, ex_b_i: torch.Tensor | None, ex_b_j: torch.Tensor | None,
    ex_sc: torch.Tensor | None, ex_rot: torch.Tensor | None, ex_tinl: torch.Tensor | None,
    ex_tpts: torch.Tensor | None, noise_bound: float, cbar2: float, scale_noise: float,
    trans_noise: float, rotation_similar: float, local_max_iter: int,
    stagnation_min_pro_local: float, local_confidence: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`local_accept` over P pairs: the plain version on the CPU, one
    launch on a card. Outputs the new warm scale, rotation, translation,
    best_count, local_r, pro_local, hypotheses, escalate, done,
    extras_valid, and the six stage masks (empty where not tracked)."""
    rule = AcceptRule(noise_bound, cbar2, scale_noise, trans_noise, rotation_similar,
                      local_max_iter, stagnation_min_pro_local, local_confidence)
    track = ex_b_i is not None
    p = src.shape[0]
    if not src.is_cuda:
        def one(sr, ds, pts, bi, bj, ri, R, s, ws, wr, wt, ft, bc, lr, hyp, esc, ev, hr, th,
                sc, *ex):
            st = _State(bc, lr, hyp, esc, ev, ex if track else None)
            got = local_accept_reference(sr, ds, pts, bi, bj, ri, R, s, WarmState(ws, wr, wt, ft),
                                         st, hr, th, rule, sc, track)
            extras = got.extras if track else tuple(torch.zeros(0, device=sr.device)
                                                    for _ in range(6))
            return (*got.best[:3], *got[1:8], *extras)

        return over_pairs(one, p, src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm_scale,
                          warm_rot, warm_trans, first_time, best_count, local_r, hypotheses,
                          escalate, extras_valid, host_r, thr, sc_inl, ex_b_i, ex_b_j, ex_sc,
                          ex_rot, ex_tinl, ex_tpts)
    return _launch_accept(src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm_scale, warm_rot,
                          warm_trans, first_time, best_count, local_r, hypotheses, escalate,
                          extras_valid, host_r, thr, ticket,
                          (sc_inl, ex_b_i, ex_b_j, ex_sc, ex_rot, ex_tinl, ex_tpts), rule)


register_pair_vmap(_local_accept_pairs, 27, contiguous=True)


# ---- the launches ------------------------------------------------------------------


@functools.cache
def _global_bytes(name: str, *sizes: int) -> int:
    fn = getattr(load_library("local_batch"), f"{name}_global_bytes")
    fn.restype = c_longlong
    fn.argtypes = [c_int] * len(sizes)
    got = int(fn(*sizes))
    if got < 0:
        raise RuntimeError(f"{name}_global_bytes failed: no CUDA device is current")
    return got


def _beta(noise_bound: float, cbar2: float, factor: float) -> float:
    """factor nb sqrt(cb2) in float32, as the plain version computes it from
    float32 scalars (a float32 product is exact in float64, then rounded)."""
    nb, cb2 = np.float32(noise_bound), np.float32(cbar2)
    return float(np.float32(np.float32(factor) * nb) * np.sqrt(cb2))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _contiguous(name: str, t: torch.Tensor, dtype, dev) -> torch.Tensor:
    return check_input(name, t, dtype, dev).contiguous()


def _launch_pick(keys, s_i, s_j, s_ok, sampled_count, b_rate, src, dst, first_time, bcap,
                 noise_bound, cbar2, known_scale):
    p, b, s = keys.shape
    c = src.shape[-1]
    dev = src.device
    f32, i64 = _F32, _I64
    keys = keys.contiguous()
    s_i, s_j = (_contiguous(n, t, i64, dev) for n, t in (("s_i", s_i), ("s_j", s_j)))
    s_ok = _contiguous("s_ok", s_ok, torch.bool, dev)
    count = _contiguous("sampled_count", sampled_count, i64, dev)
    rate = _contiguous("b_rate", b_rate, f32, dev)
    src, dst = (_contiguous(n, t, f32, dev) for n, t in (("src", src), ("dst", dst)))
    flag = _contiguous("first_time", first_time, torch.bool, dev)
    b_i = torch.empty((p, b, bcap), dtype=i64, device=dev)
    b_j = torch.empty_like(b_i)
    sel_ok = torch.empty((p, b, bcap), dtype=torch.bool, device=dev)
    src_t = torch.empty((p, b, 3, bcap), dtype=f32, device=dev)
    dst_t = torch.empty_like(src_t)
    sc_inl = torch.empty((p, b, bcap if known_scale else 0), dtype=torch.bool, device=dev)
    noise = torch.empty((p, b if known_scale else 0), dtype=f32, device=dev)
    scale = torch.empty_like(noise)
    use_warm = torch.empty(p, dtype=torch.bool, device=dev)
    ticket = torch.empty(p, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        per = _global_bytes("local_pick", s)
        ws = torch.empty(p * b * per, dtype=torch.uint8, device=dev) if per else None
    launch(
        "local_pick", _PICK_ARGTYPES, dev,
        _ptr(keys) if keys.dtype == f32 else None, _ptr(keys) if keys.dtype == i64 else None,
        s_i.data_ptr(), s_j.data_ptr(), s_ok.data_ptr(), count.data_ptr(), rate.data_ptr(),
        src.data_ptr(), dst.data_ptr(), flag.data_ptr(), p, b, s, int(bcap), c,
        int(known_scale), _beta(noise_bound, cbar2, 2.0), float(np.float32(noise_bound) * 2),
        b_i.data_ptr(), b_j.data_ptr(), sel_ok.data_ptr(), src_t.data_ptr(), dst_t.data_ptr(),
        _ptr(sc_inl) if known_scale else None, _ptr(noise) if known_scale else None,
        _ptr(scale) if known_scale else None, use_warm.data_ptr(), ticket.data_ptr(), _ptr(ws),
    )
    return b_i, b_j, sel_ok, src_t, dst_t, scale, sc_inl, noise, use_warm, ticket


def _launch_accept(src, dst, s_pts, b_i, b_j, rot_inl, rots, scale, warm_scale, warm_rot,
                   warm_trans, first_time, best_count, local_r, hypotheses, escalate,
                   extras_valid, host_r, thr, ticket, masks, rule: AcceptRule):
    p, b, bcap = b_i.shape
    c = src.shape[-1]
    dev = src.device
    f32, i64, bl = _F32, _I64, torch.bool
    track = masks[1] is not None
    ins = [
        ("src", src, f32), ("dst", dst, f32), ("s_pts", s_pts, bl), ("b_i", b_i, i64),
        ("b_j", b_j, i64), ("rot_inl", rot_inl, bl), ("rots", rots, f32), ("scale", scale, f32),
        ("warm_scale", warm_scale, f32), ("warm_rot", warm_rot, f32),
        ("warm_trans", warm_trans, f32), ("first_time", first_time, bl),
        ("best_count", best_count, i64), ("local_r", local_r, i64),
        ("hypotheses", hypotheses, i64), ("escalate", escalate, bl),
        ("extras_valid", extras_valid, bl), ("host_r", host_r, i64), ("thr", thr, f32),
    ]
    ins = [_contiguous(n, t, dt, dev) for n, t, dt in ins]
    ticket = _contiguous("ticket", ticket, torch.int32, dev)
    mask_types = (bl, i64, i64, bl, bl, bl, bl)
    masks = [None if not track else _contiguous("stage mask", t, dt, dev)
             for t, dt in zip(masks, mask_types)]
    outs = [torch.empty(p, dtype=f32, device=dev), torch.empty((p, 3, 3), dtype=f32, device=dev),
            torch.empty((p, 3), dtype=f32, device=dev)]
    outs += [torch.empty(p, dtype=dt, device=dev) for dt in (i64, i64, f32, i64, bl, bl, bl)]
    lc = (bcap, c) if track else (0, 0)
    outs += [torch.empty((p, lc[0]), dtype=dt, device=dev) for dt in (i64, i64, bl, bl)]
    outs += [torch.empty((p, lc[1]), dtype=bl, device=dev) for _ in range(2)]
    ws_count = torch.empty(p * b, dtype=i64, device=dev)
    ws_sim = torch.empty(p * b, dtype=torch.int32, device=dev)
    ws_trans = torch.empty(p * b * 3, dtype=f32, device=dev)
    ws_base = torch.empty(p, dtype=i64, device=dev)
    ws_masks = [torch.empty(p * b * c, dtype=bl, device=dev) if track else None for _ in range(2)]
    with torch.cuda.device(dev):
        per = _global_bytes("local_accept", bcap, c)
        scratch = torch.empty(p * b * per, dtype=torch.uint8, device=dev) if per else None
    launch(
        "local_accept", _ACCEPT_ARGTYPES, dev,
        *(t.data_ptr() for t in ins), *(_ptr(t) for t in masks), p, b, bcap, c,
        _beta(rule.noise_bound, rule.cbar2, 1.0), rule.scale_noise, rule.trans_noise,
        rule.rotation_similar, rule.stagnation_min_pro_local, rule.local_confidence,
        int(rule.local_max_iter), ticket.data_ptr(), ws_count.data_ptr(), ws_sim.data_ptr(),
        ws_trans.data_ptr(), ws_base.data_ptr(), *(_ptr(t) for t in ws_masks), _ptr(scratch),
        *((t.data_ptr() if t.numel() else None) for t in outs),
    )
    return tuple(outs)
