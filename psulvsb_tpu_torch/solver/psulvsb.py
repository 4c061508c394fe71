"""PSULVSB two-level probabilistic RANSAC on PyTorch tensors.

Port of psulvsb_tpu/solver/psulvsb.py (registration.cc:622-1535), at known
or estimated scale:

- `_init_stage` builds the reduced line-vector set: exactly over the dense
  (C, C) pair grid up to dense_init_max_c (the scale peak from the
  histogram kernel, ops.hist.exact_peak_bin), beyond it by rejection fill
  with the exact peak or the exact count from the pair-grid kernels
  (ops.hist), or by the gather-based sweep or pure sampling on request;
- optional seeds of the warm state: GROR's alignment (gror.gror_align,
  with the consistency-degree kernel) and the clique seed
  (`_clique_seed_stage`: greedy clique over the consistency graph, then
  one basic step over the clique's chain TIMs), before round 0 ("eager")
  or on the first escalation ("auto");
- each host round runs `_sample_stage` (Gumbel top-k), `_local_stage`
  (batched hypotheses: basic set -> scale (known-scale test or 1-point
  consensus) -> rotation (GNC-TLS in ops.gnc.gnc_batch, or FGR) ->
  endpoint translation, or at the b_rate == 1.0 round the clique's points
  (the greedy on the device, or with exact_clique_callback the native
  exact search on the host) -> sampled scoring, with the serial acceptance
  rule replayed over the batch), `_host_stage` (scoring on every point, the chi(3) self-update)
  and `_self_update_pairs`;
- `_finalize_stage` runs a weighted Procrustes kept only if an RMSE gate
  passes (ops.finalize.refit_reference), then the optional global
  translation rescue; the solve's final_inlier_count is the consensus of
  the pose it returns (`_finalize_counted`; on a card without the rescue
  the one-launch solve takes the kernel ops.finalize.finalize_fit,
  `_finalize_pose`).

Every stage that draws random numbers takes them as an optional argument
(hash constants, pair draws, sort keys, Gumbel keys, uniforms) and
otherwise draws them from the `torch.Generator` it is given, so a test can
feed the JAX package's own draws to both sides. A whole solve takes its
draws from one buffer filled before it starts (`DrawLayout`): each draw has
a place named by its kind, round and batch, as the JAX package derives a
round's and a batch's keys from (key, round, batch), so a batch that does
not run shifts no later draw, and `psulvsb_solve` and the one-launch solve
(solver/fused.py) see the same draws for one seed. Tensors stay on the device of the inputs; the
host reads a value only where control flow needs it, and `psulvsb_solve`
counts those reads in info["host_syncs"].
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.clique.kcore import greedy_clique, triangle_scores
from psulvsb_tpu_torch.core.metrics import inlier_probability
from psulvsb_tpu_torch.gror.gror import gror_align
from psulvsb_tpu_torch.ops.finalize import finalize_fit, pose_consensus, refit_reference
from psulvsb_tpu_torch.ops.hist import exact_peak_bin, pair_beta_count, pair_ratio_histogram
from psulvsb_tpu_torch.ops.init import dense_init, float_bins, pdist
from psulvsb_tpu_torch.ops.local import (
    AcceptRule,
    Pick,
    accept_replay,
    basic_choose_of,
    gumbel_of,
    local_accept,
    local_pick,
    local_pick_reference,
    similar,
    uniform_of,
)
from psulvsb_tpu_torch.pairs.tims import (
    _KEY_SPAN,
    compute_tims,
    gather_tims,
    masked_random_compact,
    random_sort_keys,
    ratio_bin_indices,
    sort_peak_bin,
)
from psulvsb_tpu_torch.robust.scale import select_scale_inliers, solve_scale_tls
from psulvsb_tpu_torch.robust.translation import global_translation_vote, solve_translation
from psulvsb_tpu_torch.solver.basic import (
    WarmState,
    basic_step,
    endpoint_mask,
    rotation_batch,
    score_transform,
)
from psulvsb_tpu_torch.solver.config import (
    DENSE_INIT_MAX_C,
    RATE_SCHEDULE,
    InlierSelectionMode,
    SolverParams,
)
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils import timing
from psulvsb_tpu_torch.utils.precision import mm, pin_float32
from psulvsb_tpu_torch.utils.scalars import as_scalar, device_flag, pick as _pick

_F32 = torch.float32
_I64 = torch.int64


def _gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws from `generator`."""
    return gumbel_of(torch.rand(shape, generator=generator, device=device, dtype=_F32))


# =============================================================================
# Stage 1: initial reduced set
# =============================================================================


def _pool_caps(params: SolverParams) -> tuple[int, int]:
    """(pool slot capacity, init fill target) for the materialized reduced
    pool. The fill stays below capacity so self-update appends always have
    reserve slots (config.pool_cap / pool_reserve)."""
    return min(params.pool_cap, params.reduced_cap), params.pool_fill


def _pad_pool(red_i: torch.Tensor, red_j: torch.Tensor, pool: int):
    """Zero-pad compacted index arrays up to the pool capacity (padding
    slots are never valid, consumers gate on slot < pool count, but they
    hold safe gather indices)."""
    extra = pool - red_i.shape[0]
    if extra <= 0:
        return red_i, red_j
    return F.pad(red_i, (0, extra)), F.pad(red_j, (0, extra))


def _pair_window_test(ori_src, ori_dst, pi, pj, params: SolverParams, peak_bin):
    """Reduced-set membership of explicit pairs (pi, pj): histogram peak ±1
    bins when the scale is estimated, else the known-scale beta test
    (registration.cc:744-767)."""
    st = ori_src[:, pj] - ori_src[:, pi]
    dt = ori_dst[:, pj] - ori_dst[:, pi]
    v1 = torch.sqrt((st * st).sum(0))
    v2 = torch.sqrt((dt * dt).sum(0))
    if params.estimate_scaling:
        num_bins = int(params.hist_max_scale) * params.hist_bins_per_unit
        ratios = v2 / torch.where(v1 > 0, v1, torch.ones_like(v1))
        b = float_bins(ratios / params.hist_max_scale * num_bins, num_bins)
        return torch.abs(b - peak_bin) <= 1
    beta = 2.0 * params.noise_bound * math.sqrt(params.cbar2)
    return torch.abs(v1 - v2) <= beta


def _draw_pairs(a: torch.Tensor, b: torch.Tensor):
    """Unordered pairs (i < j, i != j) from uniform draws a in [0, C) and
    b in [0, C - 1): b skips a, so every pair is equally likely."""
    b = torch.where(b >= a, b + 1, b)
    return torch.minimum(a, b), torch.maximum(a, b)


def _random_pairs(budget: int, c: int, generator: torch.Generator | None, device):
    """`budget` uniform random pairs over [0, C) (with replacement)."""
    a = torch.randint(0, c, (budget,), generator=generator, device=device)
    b = torch.randint(0, max(c - 1, 1), (budget,), generator=generator, device=device)
    return _draw_pairs(a, b)


def _subsample_peak(ori_src, ori_dst, active, params: SolverParams, pairs):
    """Histogram peak-bin estimate from the random pairs `pairs` (pi, pj),
    init_peak_sample of them; inactive pairs do not vote."""
    pi, pj = pairs
    ok = active[pi] & active[pj]
    st = ori_src[:, pj] - ori_src[:, pi]
    dt = ori_dst[:, pj] - ori_dst[:, pi]
    v1 = torch.sqrt((st * st).sum(0))
    v2 = torch.sqrt((dt * dt).sum(0))
    bin_idx, num_bins = ratio_bin_indices(
        v2 / torch.where(v1 > 0, v1, torch.ones_like(v1)),
        max_scale=params.hist_max_scale,
        bins_per_unit=params.hist_bins_per_unit,
    )
    peak_bin, _ = sort_peak_bin(bin_idx, ok, num_bins)
    return peak_bin


def _fill_reduced_pool(
    ori_src, ori_dst, active, peak_bin, n_l: int, params: SolverParams, pairs, keys
):
    """Rejection fill of the reduced pool: of the init_reject_budget random
    pairs `pairs`, keep those passing the window test (uniform over the
    reduced set) and compact them by the sort keys `keys`. red_count is
    estimated as n_l times the acceptance rate. Returns (red_i, red_j,
    red_count estimate, pool count)."""
    c = ori_src.shape[1]
    pool_cap, fill_cap = _pool_caps(params)
    budget = params.init_reject_budget
    pi, pj = pairs
    member = active[pi] & active[pj] & _pair_window_test(ori_src, ori_dst, pi, pj, params, peak_bin)
    accept = member.sum()
    red_count_est = torch.clamp(
        (accept.to(_F32) / budget * n_l).to(_I64), max=params.reduced_cap
    )
    red_i, red_j, pool = masked_random_compact(member, pi, pj, fill_cap, max_index=c, keys=keys)
    red_i, red_j = _pad_pool(red_i, red_j, pool_cap)
    return red_i, red_j, red_count_est, pool


class InitDraws(NamedTuple):
    """Random inputs of the init stage. A field left None is drawn from the
    stage's generator; a test passes the JAX package's draws instead."""

    ab: torch.Tensor | None = None  # (2,) hash constants of the dense compaction
    peak_pairs: tuple | None = None  # (pi, pj), init_peak_sample pairs
    fill_pairs: tuple | None = None  # (pi, pj), init_reject_budget pairs
    fill_keys: torch.Tensor | None = None  # (init_reject_budget,) sort keys
    exact_keys: torch.Tensor | None = None  # (C(C-1)/2,) sort keys of "exact"

    def resolve(self, c: int, params: SolverParams, generator, device, peak: bool):
        """These draws with the missing fill draws drawn, and the peak
        pairs too when `peak`."""

        def pairs(given, n):
            return _random_pairs(n, c, generator, device) if given is None else given

        return self._replace(
            peak_pairs=pairs(self.peak_pairs, params.init_peak_sample) if peak else None,
            fill_pairs=pairs(self.fill_pairs, params.init_reject_budget),
            fill_keys=(
                random_sort_keys(params.init_reject_budget, generator, device)
                if self.fill_keys is None else self.fill_keys
            ),
        )


class InitPeak(NamedTuple):
    """The scale peak of a "dense" or "exact_hist" init (`_init_peak`), which
    the init builds its reduced set around."""

    peak: torch.Tensor  # () int64, the peak bin taken
    certified: torch.Tensor  # () bool, the histogram's own peak passed its certificate
    red_exact: torch.Tensor | None  # () int64, the exact |peak ± 1| count ("exact_hist")


def peak_apart(params: SolverParams, c: int) -> bool:
    """Whether the init of C correspondences takes a certified histogram
    peak, which `_init_peak` computes apart from the reduced set: the scale
    estimated on the "dense" or "exact_hist" route."""
    return params.estimate_scaling and init_route(params, c) in ("dense", "exact_hist")


def _init_peak(ori_src, ori_dst, keep_mask, params: SolverParams, peak_pairs) -> InitPeak:
    """The scale peak of the "dense" and "exact_hist" inits.

    "dense": `exact_peak_bin` (the histogram kernel, coarse and fine pass)
    gives the peak and its certificate. "exact_hist": the histogram kernel
    sweeps all pairs into exact_hist_bins bins of width 1 / hist_bins_per_unit
    (the tail clamped into the last), giving the exact peak bin and the exact
    |peak ± 1| count; the peak is certified when the clamp bin holds less
    than it and it is not at the window's edge. Where the certificate fails
    the subsample peak over the random pairs `peak_pairs` is taken; both
    candidates are computed and torch.where picks, so no host read."""
    active = keep_mask == 1
    red_exact = None
    if init_route(params, ori_src.shape[1]) == "dense":
        peak_k, _, certified = exact_peak_bin(
            ori_src, ori_dst, active, bins_per_unit=params.hist_bins_per_unit
        )
    else:
        nb = params.exact_hist_bins
        counts = pair_ratio_histogram(
            ori_src, ori_dst, active, bins_per_unit=params.hist_bins_per_unit, num_bins=nb
        )
        interior = counts[: nb - 1]
        peak_k = torch.argmax(interior)
        certified = (counts[nb - 1] < _pick(interior, peak_k)) & (peak_k < nb - 2)
        start = torch.clamp(peak_k - 1, 0, nb - 3)
        red_exact = counts.index_select(0, start + torch.arange(3, device=counts.device)).sum()
        # peak 0 slides the 3-bin window to {0, 1, 2}; membership is {0, 1}.
        red_exact = red_exact - torch.where(peak_k == 0, counts[2], torch.zeros_like(counts[2]))
    peak_sub = _subsample_peak(ori_src, ori_dst, active, params, peak_pairs)
    return InitPeak(torch.where(certified, peak_k, peak_sub), certified, red_exact)


def _init_stage_sampled(ori_src, ori_dst, keep_mask, params: SolverParams, draws: InitDraws):
    """Large-C init without the O(C^2) universe: the peak bin from a pair
    subsample (scale estimated), then the rejection fill; red_count is an
    estimate."""
    c = ori_src.shape[1]
    active = keep_mask == 1
    peak_bin = torch.zeros((), dtype=_I64, device=ori_src.device)
    if params.estimate_scaling:
        peak_bin = _subsample_peak(ori_src, ori_dst, active, params, draws.peak_pairs)
    return _fill_reduced_pool(
        ori_src, ori_dst, active, peak_bin, c * (c - 1) // 2, params,
        draws.fill_pairs, draws.fill_keys,
    )


def _init_stage_exact_hist(ori_src, ori_dst, keep_mask, params: SolverParams, draws: InitDraws,
                           peak: InitPeak):
    """Large-C scale-estimation init with the exact histogram peak `peak`
    (`_init_peak`): the rejection fill around the peak bin; red_count is the
    exact |peak ± 1| count where the peak is certified, else the fill's
    estimate. Both are computed and chosen by torch.where, so the choice
    costs no host read."""
    c = ori_src.shape[1]
    active = keep_mask == 1
    red_i, red_j, red_est, pool = _fill_reduced_pool(
        ori_src, ori_dst, active, peak.peak, c * (c - 1) // 2, params,
        draws.fill_pairs, draws.fill_keys,
    )
    red_count = torch.where(
        peak.certified, torch.clamp(peak.red_exact, max=params.reduced_cap), red_est
    )
    return red_i, red_j, red_count, pool


def beta_count(ori_src, ori_dst, keep_mask, params: SolverParams) -> torch.Tensor:
    """The exact known-scale reduced-set size: the beta count kernel sweeps
    every active pair's window test (registration.cc:744-767). () int64."""
    beta = 2.0 * params.noise_bound * math.sqrt(params.cbar2)
    return pair_beta_count(ori_src, ori_dst, beta, keep_mask == 1)


def _init_stage_exact_beta(ori_src, ori_dst, keep_mask, params: SolverParams, draws: InitDraws,
                           red_exact: torch.Tensor):
    """Large-C known-scale init with the exact reduced-set size `red_exact`
    (`beta_count`), so red_count (which sizes the floor(|reduced| * rate)
    samples) is exact; the pool is the rejection fill of the sampled mode."""
    c = ori_src.shape[1]
    active = keep_mask == 1
    red_i, red_j, _, pool = _fill_reduced_pool(
        ori_src, ori_dst, active, torch.zeros((), dtype=_I64, device=ori_src.device),
        c * (c - 1) // 2, params, draws.fill_pairs, draws.fill_keys,
    )
    return red_i, red_j, torch.clamp(red_exact, max=params.reduced_cap), pool


def _init_stage_exact(ori_src, ori_dst, keep_mask, params: SolverParams, keys, generator):
    """The gather-based exact sweep over all C(C-1)/2 TIMs: the histogram
    peak ±1 (scale estimated, peak by sort_peak_bin) or the known-scale
    test with the user noise bound, compacted by the sort keys `keys`."""
    c = ori_src.shape[1]
    pool_cap, fill_cap = _pool_caps(params)
    active = keep_mask == 1
    src_tims, idx_i, idx_j, pair_active = compute_tims(ori_src, active)
    dst_tims = gather_tims(ori_dst, idx_i, idx_j)
    if params.estimate_scaling:
        v1 = torch.sqrt((src_tims * src_tims).sum(0))
        v2 = torch.sqrt((dst_tims * dst_tims).sum(0))
        bin_idx, num_bins = ratio_bin_indices(
            v2 / torch.where(v1 > 0, v1, torch.ones_like(v1)),
            max_scale=params.hist_max_scale,
            bins_per_unit=params.hist_bins_per_unit,
        )
        peak, _ = sort_peak_bin(bin_idx, pair_active, num_bins)
        reduced = (torch.abs(bin_idx - peak) <= 1) & pair_active
    else:
        _, reduced, _ = select_scale_inliers(
            src_tims, dst_tims, params.noise_bound, params.cbar2, active=pair_active
        )
    red_count = torch.clamp(reduced.sum(), max=params.reduced_cap)
    red_i, red_j, pool = masked_random_compact(
        reduced, idx_i, idx_j, fill_cap, max_index=c, keys=keys, generator=generator
    )
    red_i, red_j = _pad_pool(red_i, red_j, pool_cap)
    return red_i, red_j, red_count, pool


def _init_stage_dense(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    keep_mask: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    ab: torch.Tensor | None = None,
    peak_bin: torch.Tensor | None = None,
):
    """Exact reduced set over the dense pair grid (registration.cc:744-767),
    compacted by `ops.init.dense_init` (on a card the kernel
    csrc/dense_init.cu, which holds no (C, C) array). Known scale: pair
    (i < j) is a member when | ‖s_j - s_i‖ - ‖d_j - d_i‖ | <= 2 noise_bound
    sqrt(cbar2). Scale estimated: when its ratio bin floor(ratio *
    hist_bins_per_unit) lies within ±1 of `peak_bin`, `_init_peak`'s
    (`exact_peak_bin`, or where its certificate fails the subsample peak).

    Pair norms come from ‖a-b‖² = ‖a‖² + ‖b‖² - 2ab. Members are compacted
    into `fill` slots by their priority, a multiplicative-xorshift hash of
    the flat pair position seeded by the two constants `ab`, so an over-cap
    reduced set is thinned uniformly.

    Returns (red_i (pool,), red_j (pool,), red_count (), pool_count ()).
    """
    c = ori_src.shape[1]
    dev = ori_src.device
    pool_cap, fill_cap = _pool_caps(params)
    num_bins = int(params.hist_max_scale) * params.hist_bins_per_unit
    if ab is None:
        ab = torch.randint(1, 2**31 - 1, (2,), generator=generator, device=dev)
    beta = 2.0 * params.noise_bound * math.sqrt(params.cbar2)
    return dense_init(
        ori_src, ori_dst, keep_mask, ab.to(device=dev, dtype=_I64), peak_bin, beta,
        params.hist_bins_per_unit, num_bins, fill_cap, pool_cap, params.reduced_cap,
    )


def init_route(params: SolverParams, c: int) -> str:
    """The init mode that runs for C correspondences. "auto" takes the JAX
    package's accelerator route on every device: "dense" up to
    dense_init_max_c, then "exact_hist" (scale estimated) or "exact_beta"
    (known scale). "exact_hist" without scale estimation and "exact_beta"
    with it become "sampled", as in the JAX package."""
    mode = params.init_mode
    if mode == "auto":
        if c <= params.dense_init_max_c:
            mode = "dense"
        else:
            mode = "exact_hist" if params.estimate_scaling else "exact_beta"
    if mode == "exact_hist" and not params.estimate_scaling:
        mode = "sampled"
    if mode == "exact_beta" and params.estimate_scaling:
        mode = "sampled"
    if mode not in ("dense", "exact", "sampled", "exact_hist", "exact_beta"):
        raise ValueError(f"unknown init_mode {params.init_mode!r}")
    if mode == "dense" and c > DENSE_INIT_MAX_C:
        raise ValueError(f"the dense init takes at most {DENSE_INIT_MAX_C} correspondences (its "
                         f"kernel's limit), got {c}")
    return mode


def _init_stage(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    keep_mask: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    draws: InitDraws = InitDraws(),
    peak: InitPeak | None = None,
):
    """Initial reduced set (registration.cc:682-767), compacted into an
    explicit (i, j) pair-index array; the mode comes from `init_route`.
    keep_mask: (C,) in {1, 0, -1} from the histogram pre-filter. `draws`
    holds any random inputs given instead of drawn. On a route of
    `peak_apart` the init is the scale peak (`_init_peak`, or the `peak`
    given) and the reduced set around it.

    Returns (red_i (pool,), red_j (pool,), red_count (), pool_count ())."""
    c = ori_src.shape[1]
    mode = init_route(params, c)
    if mode == "exact":
        return _init_stage_exact(ori_src, ori_dst, keep_mask, params, draws.exact_keys, generator)
    if peak is None and peak_apart(params, c):
        pairs = draws.peak_pairs
        if pairs is None:
            pairs = _random_pairs(params.init_peak_sample, c, generator, ori_src.device)
        peak = _init_peak(ori_src, ori_dst, keep_mask, params, pairs)
    if mode == "dense":
        return _init_stage_dense(ori_src, ori_dst, keep_mask, params, generator, draws.ab,
                                 None if peak is None else peak.peak)
    draws = draws.resolve(c, params, generator, ori_src.device,
                          peak=mode == "sampled" and params.estimate_scaling)
    if mode == "exact_hist":
        return _init_stage_exact_hist(ori_src, ori_dst, keep_mask, params, draws, peak)
    if mode == "exact_beta":
        return _init_stage_exact_beta(ori_src, ori_dst, keep_mask, params, draws,
                                      beta_count(ori_src, ori_dst, keep_mask, params))
    return _init_stage_sampled(ori_src, ori_dst, keep_mask, params, draws)


# =============================================================================
# Stage 1b (optional): clique-seeded warm start
# =============================================================================


def _edge_graph(i: torch.Tensor, j: torch.Tensor, ok: torch.Tensor, c: int) -> torch.Tensor:
    """(..., C, C) bool graph with the undirected edges (i, j) where ok;
    i/j/ok (..., E). Masked edges write into a sentinel cell that is sliced
    off."""
    sentinel = c * c
    idx = torch.cat([i * c + j, j * c + i], dim=-1)
    target = torch.where(torch.cat([ok, ok], dim=-1), idx, sentinel)
    flat = torch.zeros(i.shape[:-1] + (sentinel + 1,), dtype=torch.bool, device=i.device)
    flat = flat.scatter(-1, target, True)
    return flat[..., :sentinel].reshape(i.shape[:-1] + (c, c))


def dense_consistency_adjacency(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    red_i: torch.Tensor,
    red_j: torch.Tensor,
    red_pool: torch.Tensor,
    params: SolverParams,
    active: torch.Tensor,
) -> torch.Tensor:
    """The exact (C, C) consistency graph of the clique seed, the reduced-set
    membership tests of registration.cc:744-767 over the dense pair grid.

    Known scale: the beta window | |d_src| - |d_dst| | <= 2 nb sqrt(cbar2).
    Estimated scale: the ratio bin floor(ratio * hist_bins_per_unit) within
    ±1 of the peak, the peak being the median bin of the pool members
    (red_i/red_j/red_pool, peak ±1 members by construction). Distances come
    from the ‖a‖² + ‖b‖² - 2ab form, as in the JAX package; pairs at the
    window's edge may flip against it where the float32 sums run in
    another order."""
    c = ori_src.shape[1]
    dev = ori_src.device
    v1 = pdist(ori_src)
    v2 = pdist(ori_dst)
    if params.estimate_scaling:
        num_bins = int(params.hist_max_scale) * params.hist_bins_per_unit
        ratio = v2 / torch.where(v1 > 0, v1, torch.ones_like(v1))
        bins = float_bins(ratio * params.hist_bins_per_unit, num_bins)
        st = ori_src[:, red_j] - ori_src[:, red_i]
        dt = ori_dst[:, red_j] - ori_dst[:, red_i]
        p1 = torch.sqrt((st * st).sum(0))
        p2 = torch.sqrt((dt * dt).sum(0))
        pb = float_bins(p2 / torch.where(p1 > 0, p1, torch.ones_like(p1)) * params.hist_bins_per_unit, num_bins)
        slot_ok = torch.arange(red_i.shape[0], device=dev) < red_pool
        pb_sorted = torch.sort(torch.where(slot_ok, pb, 1 << 30)).values
        peak = _pick(pb_sorted, torch.clamp(red_pool // 2 - 1, min=0))
        member = torch.abs(bins - peak) <= 1
    else:
        beta = 2.0 * params.noise_bound * math.sqrt(params.cbar2)
        member = torch.abs(v1 - v2) <= beta
    iu = torch.arange(c, device=dev)
    return member & (iu[:, None] != iu[None, :]) & active[:, None] & active[None, :]


def _clique_seed_stage(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    red_i: torch.Tensor,
    red_j: torch.Tensor,
    red_pool: torch.Tensor,
    params: SolverParams,
    active: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    scale_u: torch.Tensor | None = None,
    max_steps: int | None = None,
    sync_free: bool = False,
    repeat=None,
    steps_run: torch.Tensor | None = None,
) -> tuple[WarmState, torch.Tensor, int]:
    """Greedy clique over the reduced-set consistency graph, then one basic
    step over the clique's chain TIMs, as a warm-state seed (the JAX
    package's `_clique_seed_stage`; no such stage exists in registration.cc,
    see its docstring there).

    With `active` (the current correspondence mask) and C within the dense
    window, the graph is the exact `dense_consistency_adjacency`; otherwise
    it is scattered from the pool's edges. The greedy runs on triangle
    ordering. At most clique_cap members (the first by index) form the
    chain (k, k+1 mod m); `scale_u` gives the basic step's scale draws.
    With `max_steps` the greedy runs that many steps and reads nothing on the
    host (C - 1 steps reach any clique of C points); with `repeat` it runs
    on the device until no candidate is left (`greedy_clique`); `sync_free`
    asks the same of the basic step's rotation, and `repeat` its loop on the
    device (`solver.basic.rotation_batch`).

    Returns (seed WarmState, ok () bool — at least clique_seed_min_size
    members, host reads of the greedy). Where not ok the seed is the
    identity and must not be adopted."""
    adj = _seed_graph(ori_src, ori_dst, red_i, red_j, red_pool, params, active)
    clique, reads = greedy_clique(adj, order_scores=triangle_scores(adj), max_steps=max_steps,
                                  repeat=repeat, steps_run=steps_run)
    warm, ok = _seed_from_clique(ori_src, ori_dst, clique, params, generator, scale_u, sync_free,
                                 repeat)
    return warm, ok, reads


def _seed_graph(ori_src, ori_dst, red_i, red_j, red_pool, params: SolverParams, active=None):
    """The clique seed's (C, C) consistency graph (`_clique_seed_stage`)."""
    c = ori_src.shape[1]
    if active is not None and c <= params.dense_init_max_c:
        return dense_consistency_adjacency(ori_src, ori_dst, red_i, red_j, red_pool, params, active)
    slot_ok = torch.arange(red_i.shape[0], device=ori_src.device) < red_pool
    return _edge_graph(red_i, red_j, slot_ok, c)


def _seed_from_clique(ori_src, ori_dst, clique, params: SolverParams, generator=None,
                      scale_u=None, sync_free: bool = False, repeat=None):
    """The clique seed's warm state from its (C,) clique mask
    (`_clique_seed_stage`): (seed WarmState, ok)."""
    c = ori_src.shape[1]
    dev = ori_src.device
    cap = params.clique_cap
    m = torch.clamp(clique.sum(), max=cap)

    # Compact the member indices to (cap,); members past the cap drop out.
    pos = torch.cumsum(clique.to(_I64), 0) - 1
    write = torch.where(clique & (pos < cap), pos, cap)
    cq = torch.zeros(cap + 1, dtype=_I64, device=dev).scatter(
        0, write, torch.arange(c, device=dev)
    )[:cap]
    ar = torch.arange(cap, device=dev)
    nxt = (ar + 1) % torch.clamp(m, min=1)
    res = basic_step(
        ori_src, ori_dst, cq, cq[nxt], ar < m, params, WarmState.initial(dev),
        generator, scale_u, sync_free, repeat,
    )
    ok = m >= params.clique_seed_min_size
    warm = WarmState(
        scale=torch.where(ok, res.scale, torch.ones_like(res.scale)),
        rotation=torch.where(ok, res.rotation, torch.eye(3, dtype=_F32, device=dev)),
        translation=torch.where(ok, res.translation, torch.zeros_like(res.translation)),
        first_time=device_flag(False, dev),
    )
    return warm, ok


# =============================================================================
# Stage 2: sample the L-sampled set for one host round
# =============================================================================


def _sample_stage(
    red_i: torch.Tensor,
    red_j: torch.Tensor,
    red_count: torch.Tensor,
    pool: torch.Tensor,
    l_rate,
    params: SolverParams,
    num_points: int,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
):
    """Draw floor(|reduced| * L_sampled_rate) TIMs without replacement
    (registration.cc:834-895): the top of Gumbel keys over the valid pool
    slots is a uniform random subset; a floor of 0 takes the whole reduced
    set. Sizes cap at sampled_cap. `l_rate`: a float or a float32 scalar on
    the device; `gumbel`: optional (pool,) keys.

    Returns (s_i (S,), s_j (S,), slot mask (S,), sampled_count (),
    sampled point mask (C,))."""
    dev = red_i.device
    r_cap = red_i.shape[0]
    cap = min(params.sampled_cap, r_cap)
    rate = as_scalar(l_rate, _F32, dev)
    want = torch.floor(red_count.to(_F32) * rate).to(_I64)
    want = torch.where(want == 0, red_count, want)
    count = torch.minimum(torch.clamp(want, max=cap), pool)

    slot_ok = torch.arange(r_cap, device=dev) < pool
    g = _gumbel((r_cap,), generator, dev) if gumbel is None else gumbel.to(dev, _F32)
    score = torch.where(slot_ok, g, -math.inf)
    # Sorted output keeps the -inf (invalid) slots last.
    vals, top = torch.topk(score, cap, sorted=True)
    count = torch.minimum(count, (vals > -math.inf).sum())
    rank_ok = torch.arange(cap, device=dev) < count
    zero = torch.zeros_like(top)
    s_i = torch.where(rank_ok, red_i[top], zero)
    s_j = torch.where(rank_ok, red_j[top], zero)
    pt_mask = endpoint_mask(s_i, s_j, rank_ok, num_points)
    return s_i, s_j, rank_ok, count, pt_mask


# =============================================================================
# Stage 3: the local RANSAC loop (batched hypotheses)
# =============================================================================


class HypExtras(NamedTuple):
    """Stage masks of the winning basic iteration, behind the inlier getters
    (registration.h:600-746)."""

    b_i: torch.Tensor  # (bcap,) basic TIM endpoint indices
    b_j: torch.Tensor  # (bcap,)
    scale_inliers: torch.Tensor  # (bcap,) bool
    rotation_inliers: torch.Tensor  # (bcap,) bool
    translation_inliers: torch.Tensor  # (C,) bool
    translation_points: torch.Tensor  # (C,) bool — points fed to translation

    @staticmethod
    def zeros(bcap: int, c: int, device) -> "HypExtras":
        def z(n, dtype):
            return torch.zeros(n, dtype=dtype, device=device)

        return HypExtras(
            z(bcap, _I64), z(bcap, _I64), z(bcap, torch.bool), z(bcap, torch.bool),
            z(c, torch.bool), z(c, torch.bool),
        )


class LocalState(NamedTuple):
    best: WarmState  # best sampled solution (also the next batch's warm)
    best_count: torch.Tensor  # () best sampled inlier count
    local_r: torch.Tensor  # ()
    pro_local: torch.Tensor  # ()
    iterations: int  # batches run (counted on the host)
    hypotheses: torch.Tensor  # () hypotheses consumed
    escalate: torch.Tensor  # () bool — stagnation triggered
    done: torch.Tensor  # () bool
    extras: HypExtras
    extras_valid: torch.Tensor  # () bool — extras ever populated
    host_syncs: int  # host reads: the greedy clique's, and from `_local_stage` `done` once a batch


def exact_clique_points(adj: torch.Tensor, active: torch.Tensor, time_limit_s: float,
                        live: torch.Tensor | None = None) -> torch.Tensor:
    """The exact maximum clique of each (C, C) graph of a (B, C, C) batch
    among its active points (B, C), by the native branch and bound on the
    host (`clique.pmc.exact_max_clique`): one copy of the masked graphs to
    the host, B searches under `time_limit_s` each, one copy of the (B, C)
    member masks back. The JAX package reaches the same search through
    `jax.pure_callback`. Without the library (no toolchain) this raises: the
    solver's exact round has no heuristic stand-in.

    `live`: an optional (B,) bool, the graphs to search; the others give no
    members and are not copied. Under `torch.func.vmap` (the batched plan)
    the searches of every vmapped graph run in one call, one after another,
    as `pure_callback(..., vmap_method="sequential")` runs them."""
    return torch.ops.psulvsb_tpu_torch.exact_clique_points(adj, active, live, float(time_limit_s))


@torch.library.custom_op("psulvsb_tpu_torch::exact_clique_points", mutates_args=())
def _exact_clique_points(adj: torch.Tensor, active: torch.Tensor, live: torch.Tensor | None,
                         time_limit_s: float) -> torch.Tensor:
    """`exact_clique_points` over graphs (..., C, C) with any leading dims."""
    c = adj.shape[-1]
    lead = adj.shape[:-2]
    graphs = (adj & active[..., None, :] & active[..., :, None]).reshape(-1, c, c)
    out = np.zeros((graphs.shape[0], c), bool)
    rows = np.arange(graphs.shape[0])
    if live is not None:
        rows = np.flatnonzero(live.expand(lead).reshape(-1).cpu().numpy())
        graphs = graphs.index_select(0, torch.as_tensor(rows, device=adj.device))
    for row, g in zip(rows, graphs.cpu().numpy()):
        out[row] = pmc.exact_max_clique_mask(g, None, time_limit_s)
    return torch.as_tensor(out, device=adj.device).reshape(lead + (c,))


@_exact_clique_points.register_vmap
def _exact_clique_points_vmap(info, in_dims, adj, active, live, time_limit_s):
    """The vmapped graphs are more graphs of the batch: one copy, their
    searches in turn."""
    n = info.batch_size

    def lead(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)

    out = _exact_clique_points(lead(adj, in_dims[0]), lead(active, in_dims[1]),
                               None if live is None else lead(live, in_dims[2]), time_limit_s)
    return out, 0


def local_max_batches(params: SolverParams) -> int:
    """The most batches one local round runs: local_batch_ceiling_factor
    times local_max_iter hypotheses, and one batch more."""
    factor = params.local_batch_ceiling_factor
    return max(2, -(-factor * params.local_max_iter // params.hypothesis_batch) + 1)


def _local_round(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    s_i: torch.Tensor,
    s_j: torch.Tensor,
    s_ok: torch.Tensor,
    sampled_count: torch.Tensor,
    sampled_pt_mask: torch.Tensor,
    b_rate,
    b_rate_is_one: bool,
    host_r: torch.Tensor,
    warm_in: WarmState,
    thr: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    clique_max_steps: int | None = None,
    track_extras: bool = True,
    sync_free: bool = False,
    repeat=None,
    clique_live: torch.Tensor | None = None,
    scale_span=contextlib.nullcontext,
    with_start: bool = True,
):
    """One host round's local RANSAC loop (registration.cc:903-1398) as its
    starting `LocalState` and a function `step(state, g, u) -> LocalState`
    that runs one batch of `hypothesis_batch` hypotheses: `g` (batch, S)
    Gumbel keys, or the int64 draws they come from (`ops.local.keys_of`),
    pick each hypothesis' basic set, `u` (batch,
    scale_max_draws) uniforms (or None: drawn from `generator`) feed the
    1-point scale consensus; `b_rate` is a float or a float32 scalar on the
    device. A step decides everything with selects on the
    device, `warm.first_time` included, so it reads nothing on the host
    (with `clique_max_steps`, the b_rate == 1.0 greedy clique neither: see
    `greedy_clique`; with `sync_free`, an "eigh" or FGR rotation neither:
    see `solver.basic.rotation_batch`, which with `repeat` runs its loop on
    the device); the caller reads `state.done` when
    it wants to stop early. The one step that always goes to the host is the
    b_rate == 1.0 round under `exact_clique_callback` with PMC_EXACT: its
    graphs are copied to the host, searched there and the members copied
    back (`exact_clique_points`), for the hypotheses of a live pair only when
    `clique_live` (a () bool: the batched plan's pair mask) is given.
    Without `track_extras` the winning hypothesis' stage masks
    (`state.extras`, behind the inlier getters) are not carried along.
    `scale_span()` gives the context around each batch's scale estimate (a
    traced plan's stamps). Without `with_start` the starting state is not
    made (None): a caller that keeps the state itself makes nothing a batch.

    The endpoint route, every batch but the b_rate == 1.0 round's and those
    of a sampled set under twice the basic cap (`2 bcap < C`), is
    `ops.local.local_pick`, the scale estimate and the rotation, then
    `ops.local.local_accept`: on a card a hand-written kernel on each side
    of the rotation estimator; on the CPU the plain versions."""
    dev = ori_src.device
    cap = s_i.shape[0]
    bcap = min(params.basic_cap, cap)
    c = ori_src.shape[1]
    rule = AcceptRule.of(params)
    known_scale = not params.estimate_scaling
    endpoints = not b_rate_is_one and 2 * bcap < c
    # Clique point selection at the b_rate == 1.0 escalation
    # (registration.cc:1000-1056, 1238-1244). PMC_EXACT, PMC_HEU and
    # KCORE_HEU all run the greedy on triangle ordering here, as in the JAX
    # solver; PMC_EXACT with exact_clique_callback goes to the native exact
    # search on the host instead (graph.cc:84-124).
    mode = params.resolve_inlier_selection()
    run_clique = b_rate_is_one and mode != InlierSelectionMode.NONE
    exact_clique = mode == InlierSelectionMode.PMC_EXACT and params.exact_clique_callback

    def noise_consts():
        return (torch.full((), params.inner_noise_bound, dtype=_F32, device=dev),
                torch.full((), params.inner_cbar2, dtype=_F32, device=dev))

    def clique_points(b_i, b_j, src_t, dst_t, sel_ok, sc_inl):
        """Each hypothesis' clique over the points, in the graph of its basic
        TIMs that pass the known-scale test (the scale inliers at known
        scale), restricted to the sampled points. Returns (clique, host
        reads)."""
        if params.estimate_scaling:
            _, sc_inl, _ = select_scale_inliers(src_t, dst_t, *noise_consts(), sel_ok)
        adj = _edge_graph(b_i, b_j, sc_inl, c)
        act = sampled_pt_mask.expand(b_i.shape[0], c)
        if exact_clique:
            live = None if clique_live is None else clique_live.expand(b_i.shape[0])
            return exact_clique_points(adj, act, params.max_clique_time_limit, live), 1
        return greedy_clique(
            adj, act, order_scores=triangle_scores(adj, act), max_steps=clique_max_steps
        )

    def rotate(pk: Pick, u: torch.Tensor | None, warm: WarmState):
        """The scale and the rotation of a picked batch (registration.cc:
        937-1107): (scales, scale inliers, rotations, rotation inliers)."""
        if known_scale:
            # Known scale: rotation consumes ALL basic TIMs (registration.cc:
            # 984-991); the scale-inlier mask backs the getter only.
            scale, sc_inl, dst_t, noise, rot_mask = pk.scale, pk.sc_inl, pk.dst_t, pk.noise, pk.sel_ok
        else:
            nb, cb2 = noise_consts()
            with scale_span():
                scale, sc_inl, _ = solve_scale_tls(
                    pk.src_t, pk.dst_t, nb, cb2, active=pk.sel_ok, warm_scale=warm.scale,
                    use_warm=pk.use_warm, max_draws=params.scale_max_draws,
                    estimator=params.scale_estimator, u=u, generator=generator,
                )
            # De-scale the dst TIMs and widen the noise bound
            # (registration.cc:1102-1107); rotation runs on the scale inliers.
            inv_s = 1.0 / torch.clamp(scale, min=1e-30)
            dst_t, noise, rot_mask = pk.dst_t * inv_s[:, None, None], nb * 2.0 * inv_s, sc_inl
        rots, rot_inl = rotation_batch(
            pk.src_t, dst_t, rot_mask, noise, warm.rotation, pk.use_warm, params, sync_free,
            repeat,
        )
        return scale, sc_inl, rots, rot_inl

    def eval_batch(g: torch.Tensor, u: torch.Tensor | None, warm: WarmState):
        """Evaluate `batch` hypotheses off the endpoint route
        (registration.cc:908-1256): basic set, scale, one GNC kernel launch
        for all, the clique points' translation or the full translation,
        scoring on the sampled points."""
        basic_choose = basic_choose_of(sampled_count, b_rate, bcap, b_rate_is_one)
        pk = local_pick_reference(g, s_i, s_j, s_ok, basic_choose, ori_src, ori_dst, bcap,
                                  warm.first_time, params.inner_noise_bound, params.inner_cbar2,
                                  known_scale)
        scale, sc_inl, rots, rot_inl = rotate(pk, u, warm)
        nb, cb2 = noise_consts()
        clique_reads = 0
        if run_clique:
            t_pts, clique_reads = clique_points(pk.b_i, pk.b_j, pk.src_t, pk.dst_t, pk.sel_ok,
                                                sc_inl)
        else:
            t_pts = endpoint_mask(pk.b_i, pk.b_j, rot_inl, c)
        moved = scale[:, None, None] * mm(rots, ori_src)
        t_s, t_inl, _ = solve_translation(
            moved, ori_dst, nb, cb2, active=t_pts,
            warm_translation=warm.translation, use_warm=pk.use_warm,
        )
        trans = t_s * (1.0 / torch.clamp(scale, min=1e-30))[:, None]
        counts, _ = score_transform(
            ori_src, ori_dst, sampled_pt_mask, scale, rots, trans, thr
        )
        sims = similar(scale, rots, trans, warm, rule)
        extras = (pk.b_i, pk.b_j, sc_inl, rot_inl, t_inl, t_pts)
        return scale, rots, trans, counts, sims, extras, clique_reads

    def step(st: LocalState, g: torch.Tensor, u: torch.Tensor | None) -> LocalState:
        warm = st.best
        clique_reads = 0
        if endpoints:
            pk = local_pick(g, s_i, s_j, s_ok, sampled_count, b_rate, ori_src, ori_dst, bcap,
                            warm.first_time, params.inner_noise_bound, params.inner_cbar2,
                            known_scale)
            scale, sc_inl, rots, rot_inl = rotate(pk, u, warm)
            acc = local_accept(ori_src, ori_dst, sampled_pt_mask, pk.b_i, pk.b_j, rot_inl, rots,
                               scale, warm, st, host_r, thr, rule, sc_inl, track_extras,
                               pk.ticket)
        else:
            scales, rots, transs, counts, sims, extras_b, clique_reads = eval_batch(g, u, warm)
            acc = accept_replay(ori_src, ori_dst, sampled_pt_mask, counts, sims, scales, rots,
                                transs, warm, st, host_r, thr, rule, b_rate_is_one,
                                extras_b if track_extras else None)
        return LocalState(
            best=acc.best,
            best_count=acc.best_count,
            local_r=acc.local_r,
            pro_local=acc.pro_local,
            iterations=st.iterations + 1,
            hypotheses=acc.hypotheses,
            escalate=acc.escalate,
            done=acc.done,
            extras=HypExtras(*acc.extras) if track_extras else st.extras,
            extras_valid=acc.extras_valid,
            host_syncs=st.host_syncs + clique_reads,
        )

    if not with_start:
        return None, step
    zero_i = torch.zeros((), dtype=_I64, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    start = LocalState(
        best=warm_in,
        best_count=zero_i,
        local_r=zero_i,
        pro_local=torch.zeros((), dtype=_F32, device=dev),
        iterations=0,
        hypotheses=zero_i,
        escalate=false,
        done=false,
        extras=HypExtras.zeros(bcap, c, dev),
        extras_valid=false,
        host_syncs=0,
    )
    return start, step


def _local_stage(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    s_i: torch.Tensor,
    s_j: torch.Tensor,
    s_ok: torch.Tensor,
    sampled_count: torch.Tensor,
    sampled_pt_mask: torch.Tensor,
    b_rate: float,
    b_rate_is_one: bool,
    host_r: torch.Tensor,
    warm_in: WarmState,
    thr: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    gumbels: torch.Tensor | None = None,
    scale_us: torch.Tensor | None = None,
) -> LocalState:
    """The local RANSAC loop of one host round (registration.cc:903-1398),
    `hypothesis_batch` hypotheses at a time (`_local_round`'s steps). The
    loop reads `done` on the host once per batch. `gumbels`: optional
    (max_batches, batch, S) keys that pick each hypothesis' basic set, or a
    function of the batch index that gives them; `scale_us`: optional
    (max_batches, batch, scale_max_draws) uniforms of the 1-point scale
    consensus, or such a function."""
    dev = ori_src.device
    state, step = _local_round(
        ori_src, ori_dst, s_i, s_j, s_ok, sampled_count, sampled_pt_mask, b_rate,
        b_rate_is_one, host_r, warm_in, thr, params, generator,
    )
    batch, cap = params.hypothesis_batch, s_i.shape[0]
    def pick_draw(draws, it):
        return draws(it) if callable(draws) else draws[it]

    for it in range(local_max_batches(params)):
        if gumbels is None:
            g = _gumbel((batch, cap), generator, dev)
        else:
            g = pick_draw(gumbels, it).to(dev, _F32)
        state = step(state, g, None if scale_us is None else pick_draw(scale_us, it))
        if bool(state.done):
            break
    # One read of `done` a batch, beside the greedy clique's own.
    return state._replace(host_syncs=state.host_syncs + state.iterations)


# =============================================================================
# Stage 4: host scoring + probabilistic self-update bookkeeping
# =============================================================================


class HostState(NamedTuple):
    inlier_counter: torch.Tensor  # (C,) int64 — weightedSVD weights
    inlier_history: torch.Tensor  # (C,) int64 in {-1, 0, 1}
    residual_history: torch.Tensor  # (C,)
    final_inliers: torch.Tensor  # (C,) int64 {0, 1}
    keep_mask: torch.Tensor  # (C,) int64 {1, 0, -1}
    active: torch.Tensor  # (C,) bool — current correspondence set
    inl_kept: torch.Tensor  # (C,) bool — kept host-inliers (inlier_map)
    best: WarmState  # best host solution
    best_count: torch.Tensor  # () int64
    host_r: torch.Tensor  # () int64
    pro_host: torch.Tensor  # ()

    @staticmethod
    def initial(c: int, keep_mask: torch.Tensor) -> "HostState":
        dev = keep_mask.device
        keep_mask = keep_mask.to(_I64)
        return HostState(
            inlier_counter=torch.zeros(c, dtype=_I64, device=dev),
            inlier_history=torch.full((c,), -1, dtype=_I64, device=dev),
            residual_history=torch.zeros(c, dtype=_F32, device=dev),
            final_inliers=torch.zeros(c, dtype=_I64, device=dev),
            keep_mask=keep_mask,
            active=keep_mask == 1,
            inl_kept=torch.zeros(c, dtype=torch.bool, device=dev),
            best=WarmState.initial(dev),
            best_count=torch.zeros((), dtype=_I64, device=dev),
            host_r=torch.zeros((), dtype=_I64, device=dev),
            pro_host=torch.zeros((), dtype=_F32, device=dev),
        )


def _host_stage(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    hs: HostState,
    best_sampled: WarmState,
    local_r: torch.Tensor,
    b_rate_is_one: bool,
    thr: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    u: torch.Tensor | None = None,
):
    """Host scoring of the local round's winner on the ORIGINAL set plus
    the probabilistic self-update bookkeeping (registration.cc:1399-1488).
    `u`: optional (C,) uniforms for the re-admission and demotion draws.

    Returns (new HostState, new_corr (C,) bool, take () bool — whether the
    round's sampled best displaced the host best)."""
    c = ori_src.shape[1]
    dev = ori_src.device
    host_r = hs.host_r + local_r

    moved = best_sampled.scale * (
        mm(best_sampled.rotation, ori_src) + best_sampled.translation[:, None]
    )
    res = torch.sqrt(((ori_dst - moved) ** 2).sum(0))
    # keep_mask == -2 marks padding columns, which never vote.
    real = hs.keep_mask > -2
    is_inl = (res <= thr) & real
    curr_count = is_inl.sum()
    inlier_counter = hs.inlier_counter + is_inl.to(_I64)

    # Probabilistic re-admission (registration.cc:1428-1436).
    if u is None:
        u = torch.rand(c, generator=generator, device=dev, dtype=_F32)
    u = u.to(dev, _F32)
    p_in = inlier_probability(res, params.noise_bound_dataset)
    hist = hs.inlier_history
    readmit_ok = (hist == -1) | (hist == 1) | ((hist == 0) & (u <= p_in))
    new_corr = is_inl & (hs.keep_mask == 0) & readmit_ok
    if not params.enable_self_update:
        new_corr = torch.zeros_like(new_corr)

    # Demotion on miss (the published intent of registration.cc:1438).
    p_prev = inlier_probability(hs.residual_history, params.noise_bound_dataset)
    demote = (~is_inl) & ((hist == 0) | ((hist == 1) & (u > p_prev)))

    final_inliers = torch.where(new_corr, 1, hs.final_inliers)
    kept_inl = is_inl & (hs.keep_mask == 1)
    final_inliers = torch.where(kept_inl, 1, final_inliers)
    final_inliers = torch.where(demote, 0, final_inliers)

    # Host best update (registration.cc:1454-1462).
    take = (curr_count > hs.best_count) | (hs.pro_host == 0.0)
    if b_rate_is_one:
        take = take | (curr_count >= hs.best_count)
    best = WarmState(
        scale=torch.where(take, best_sampled.scale, hs.best.scale),
        rotation=torch.where(take, best_sampled.rotation, hs.best.rotation),
        translation=torch.where(take, best_sampled.translation, hs.best.translation),
        first_time=device_flag(False, dev),
    )
    best_count = torch.where(take, curr_count, hs.best_count)
    n_real = torch.clamp(real.sum(), min=1).to(_F32)
    w = best_count.to(_F32) / n_real
    pro_host = 1.0 - torch.pow(1.0 - w, host_r.to(_F32))

    new_hs = HostState(
        inlier_counter=inlier_counter,
        inlier_history=is_inl.to(_I64),
        residual_history=res,
        final_inliers=final_inliers,
        keep_mask=torch.where(new_corr, 1, hs.keep_mask),
        active=hs.active | new_corr,
        inl_kept=kept_inl,
        best=best,
        best_count=best_count,
        host_r=host_r,
        pro_host=pro_host,
    )
    return new_hs, new_corr, take


def _self_update_pairs(
    red_i: torch.Tensor,
    red_j: torch.Tensor,
    red_count: torch.Tensor,
    pool: torch.Tensor,
    new_corr: torch.Tensor,
    inl_kept: torch.Tensor,
    params: SolverParams,
):
    """Append the self-update TIMs to the compacted reduced set
    (registration.cc:786-832): every pair between a newly admitted point and
    a kept host-inlier point or another new point. Admitted points and
    members cap at self_update_new_cap / member_cap; appends beyond the pool
    are dropped (written to a sentinel slot that is sliced off)."""
    dev = red_i.device
    c = new_corr.shape[0]
    r_cap = red_i.shape[0]
    n_cap = params.self_update_new_cap
    m_cap = params.self_update_member_cap
    points = torch.arange(c, device=dev)

    def compact(mask, cap):
        pos = torch.cumsum(mask.to(_I64), 0) - 1
        write = torch.where(mask & (pos < cap), pos, cap)
        lst = torch.full((cap + 1,), -1, dtype=_I64, device=dev).scatter(0, write, points)
        return lst[:cap], torch.clamp(mask.sum(), max=cap)

    member = inl_kept | new_corr
    new_list, n_new = compact(new_corr, n_cap)
    mem_list, n_mem = compact(member, m_cap)

    # (n_cap, m_cap) candidate grid; a new-new pair counts once (member > new).
    nn = new_list[:, None]
    mb = mem_list[None, :]
    valid = (
        (torch.arange(n_cap, device=dev)[:, None] < n_new)
        & (torch.arange(m_cap, device=dev)[None, :] < n_mem)
        & (nn != mb)
        & (~new_corr[torch.clamp(mb, min=0)] | (mb > nn))
    )
    vf = valid.reshape(-1)
    pif = torch.minimum(nn, mb).reshape(-1)
    pjf = torch.maximum(nn, mb).reshape(-1)
    dest = pool + torch.cumsum(vf.to(_I64), 0) - 1
    write = torch.where(vf & (dest < r_cap), dest, r_cap)
    pad = torch.zeros(1, dtype=red_i.dtype, device=dev)
    red_i = torch.cat([red_i, pad]).scatter(0, write, pif)[:r_cap]
    red_j = torch.cat([red_j, pad]).scatter(0, write, pjf)[:r_cap]
    added = torch.minimum(vf.sum(), r_cap - pool)
    # red_count is the |reduced| count, clamped by reduced_cap (it may
    # exceed the materialized pool).
    return red_i, red_j, torch.clamp(red_count + added, max=params.reduced_cap), pool + added


# =============================================================================
# Stage 5: weighted-SVD refinement + RMSE gate
# =============================================================================


def _finalize_stage(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    hs: HostState,
    best_sampled: WarmState,
    params: SolverParams,
    rot_method: str = "eigh",
):
    """weightedSVD refinement seeded from the sampled best with per-point
    inlier-hit-count weights, kept only if the masked RMSE over
    final_inliers improves (registration.cc:1502-1525), in the s*(R p + t)
    model with s = the sampled best's scale (1 at known scale):
    `ops.finalize.refit_reference`.

    With params.translation_rescue, the translation is then re-stabbed over
    all real correspondences under the final rotation and the host best's
    scale (robust.translation.global_translation_vote) and adopted only on a
    strict gain of global support. `rot_method` names the eigen-solver of
    the fit's rotation (core.linalg.rot_from_correlation): "jacobi" reads
    nothing on the host.

    Returns (rotation, translation, refined () bool, rescued () bool)."""
    rotation, translation, better = refit_reference(
        ori_src, ori_dst, hs.inlier_counter, hs.final_inliers, best_sampled, hs.best, rot_method
    )
    rescued = torch.zeros((), dtype=torch.bool, device=ori_src.device)
    if params.translation_rescue:
        t_res, sup_new, sup_cur = global_translation_vote(
            ori_src, ori_dst, rotation, hs.best.scale, hs.keep_mask > -2,
            params.noise_bound, params.cbar2, translation,
        )
        rescued = sup_new > sup_cur
        translation = torch.where(rescued, t_res, translation)
    return rotation, translation, better, rescued


def _finalize_counted(ori_src, ori_dst, hs: HostState, best_sampled: WarmState, thr,
                      params: SolverParams, rot_method: str = "eigh"):
    """`_finalize_stage`, and the solve's final_inlier_count: the consensus
    of the pose it returns (the host best's scale with the final rotation
    and translation) where the refinement was kept or the translation
    rescued, else `hs.best_count` itself. The count is the returned pose's
    (registration.cc:669, :1417-1444), not the host best's before the
    refinement, which registration.cc:1528 and the JAX package return.

    Returns (rotation, translation, count, refined () bool, rescued () bool)."""
    rotation, translation, refined, rescued = _finalize_stage(
        ori_src, ori_dst, hs, best_sampled, params, rot_method
    )
    moved = pose_consensus(ori_src, ori_dst, hs.keep_mask, hs.best.scale, rotation, translation,
                           thr)
    count = torch.where(refined | rescued, moved, hs.best_count)
    return rotation, translation, count, refined, rescued


def _finalize_pose(ori_src, ori_dst, hs: HostState, best_sampled: WarmState, thr,
                   params: SolverParams, rot_method: str = "eigh"):
    """(rotation, translation, count) of `_finalize_counted`. On a card,
    with the Jacobi eigen-solve and no translation rescue, that is one
    launch of `ops.finalize.finalize_fit` (the one-launch solve's
    finalize); elsewhere the plain chain."""
    if ori_src.is_cuda and rot_method == "jacobi" and not params.translation_rescue:
        return finalize_fit(ori_src, ori_dst, hs.inlier_counter, hs.final_inliers, hs.keep_mask,
                            best_sampled, hs.best, hs.best_count, thr)[:3]
    return _finalize_counted(ori_src, ori_dst, hs, best_sampled, thr, params, rot_method)[:3]


# =============================================================================
# The draws of a solve
# =============================================================================

DRAW_SPAN = 1 << 62  # every draw is an int64 in [0, 2^62)


def fused_scan_rounds(params: SolverParams) -> int:
    """Host-round count of the one-dispatch solve: `max_host_rounds` capped
    by the projected wall-clock budget, value for value what the JAX
    function gives.

    The staged solver checks the host clock between rounds
    (registration.cc:1475); one graph launch cannot. The budget is applied
    when the plan is built: at most time_budget_s / fused_round_ceiling_s
    rounds run, the ceiling being a pessimistic bound on one round's time
    (config.py). At the reference caps it never binds."""
    rounds = params.max_host_rounds
    if (
        params.fused_round_ceiling_s > 0
        and params.time_budget_s > 0
        and math.isfinite(params.time_budget_s)
    ):
        rounds = min(rounds, max(1, int(params.time_budget_s / params.fused_round_ceiling_s)))
    return rounds


class DrawLayout:
    """Where every random draw of one solve lies in one int64 buffer.

    The JAX package derives the keys of round r from (key, r)
    (psulvsb.py:1614, fused.py:118-121) and those of local batch k from
    (round key, k) (psulvsb.py:1065-1066), so what a batch draws does not
    depend on how many batches earlier rounds ran. This layout does the same
    with places: the init's draws, the clique seed's scale uniforms
    ("u_seed", one slot: a solve seeds at most once), and per round r the
    sample stage's uniforms ("u_sample"), the host stage's ("u_host") and
    per batch k the basic sets' ("u_local") and the 1-point scale
    consensus' ("u_scale"). `fill` draws the whole buffer with one call on
    the caller's generator; a place is read as integers (`integers`) or
    float32 uniforms (`uniform`). Its size depends on (params, C, rounds)
    only."""

    def __init__(self, params: SolverParams, c: int, rounds: int):
        self.c = c
        self.rounds = rounds
        self.batches = local_max_batches(params)
        self.route = init_route(params, c)
        pool_cap, _ = _pool_caps(params)
        s_cap = min(params.sampled_cap, pool_cap)
        hb = params.hypothesis_batch
        self.scale = params.estimate_scaling and params.scale_estimator == "ransac1pt"
        shapes: dict[str, tuple] = {}
        if self.route == "exact":
            shapes["exact_keys"] = (c * (c - 1) // 2,)
        else:
            if params.estimate_scaling:
                shapes["peak_a"] = shapes["peak_b"] = (params.init_peak_sample,)
            if self.route == "dense":
                shapes["ab"] = (2,)
            else:
                shapes["fill_a"] = shapes["fill_b"] = shapes["fill_keys"] = (
                    params.init_reject_budget,)
        if self.scale and (params.clique_eager or params.clique_lazy):
            shapes["u_seed"] = (params.scale_max_draws,)
        shapes["u_sample"] = (rounds, pool_cap)
        shapes["u_host"] = (rounds, c)
        shapes["u_local"] = (rounds, self.batches, hb, s_cap)
        if self.scale:
            shapes["u_scale"] = (rounds, self.batches, hb, params.scale_max_draws)
        self.places: dict[str, tuple[int, tuple]] = {}
        offset = 0
        for name, shape in shapes.items():
            self.places[name] = (offset, shape)
            offset += math.prod(shape)
        self.size = offset

    def fill(self, generator: torch.Generator | None, device, out: torch.Tensor | None = None):
        """Every draw of a solve, from one call on `generator` (into `out`
        when given)."""
        if out is None:
            out = torch.empty(self.size, dtype=_I64, device=device)
        return out.random_(0, DRAW_SPAN, generator=generator)

    def has(self, name: str) -> bool:
        return name in self.places

    def view(self, draws: torch.Tensor, name: str, *index) -> torch.Tensor:
        """The place's draws at `index`: ints, or 0-d index tensors on the
        device, taken with index_select (indexing by a tensor reads it on
        the host)."""
        offset, shape = self.places[name]
        out = draws[offset:offset + math.prod(shape)].view(shape)
        for i in index:
            out = out[i] if isinstance(i, int) else out.index_select(0, i.reshape(1))[0]
        return out

    def integers(self, draws: torch.Tensor, name: str, low: int, high: int) -> torch.Tensor:
        """The place's draws as integers in [low, high)."""
        return low + self.view(draws, name) % (high - low)

    def uniform(self, draws: torch.Tensor, name: str, *index) -> torch.Tensor:
        """The place's draws (at `index`: a round, a batch) as float32
        uniforms in [0, 1) with 24 random bits, as torch.rand makes them."""
        return uniform_of(self.view(draws, name, *index))

    def pairs(self, draws: torch.Tensor, prefix: str):
        """The init's random pairs (pi, pj) of the place `prefix` ("peak",
        "fill"); None where the layout has none."""
        if not self.has(f"{prefix}_a"):
            return None
        return _draw_pairs(self.integers(draws, f"{prefix}_a", 0, self.c),
                           self.integers(draws, f"{prefix}_b", 0, max(self.c - 1, 1)))

    def init_draws(self, draws: torch.Tensor) -> InitDraws:
        """The init stage's random inputs."""
        if self.route == "exact":
            return InitDraws(exact_keys=self.integers(draws, "exact_keys", 0, _KEY_SPAN))

        return InitDraws(
            ab=self.integers(draws, "ab", 1, 2**31 - 1) if self.has("ab") else None,
            peak_pairs=self.pairs(draws, "peak"),
            fill_pairs=self.pairs(draws, "fill"),
            fill_keys=self.integers(draws, "fill_keys", 0, _KEY_SPAN) if self.has("fill_keys")
            else None,
        )

    def seed_u(self, draws: torch.Tensor) -> torch.Tensor | None:
        return self.uniform(draws, "u_seed") if self.has("u_seed") else None

    def scale_u(self, draws: torch.Tensor, r: int, k) -> torch.Tensor | None:
        return self.uniform(draws, "u_scale", r, k) if self.scale else None


# =============================================================================
# Orchestration
# =============================================================================


def psulvsb_solve(
    ori_src: torch.Tensor,
    ori_dst: torch.Tensor,
    keep_mask: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    profile: bool = False,
) -> tuple[RegistrationSolution, dict]:
    """Full PSULVSB solve on (3, C) float32 correspondence tensors.

    keep_mask: (C,) integer tensor in {1, 0, -1} from the histogram
    pre-filter (-2 marks padding columns). All tensors stay on the device
    of ori_src; `generator` (on that device) supplies every random draw,
    in one call before the init (`DrawLayout`, sized for
    `fused_scan_rounds(params)` rounds; a round beyond them, which only a
    wall-clock budget below the projection lets run, takes its draws from
    one more such call for every that many rounds).

    The host-round loop runs in Python with the wall-clock budget checked
    between rounds, as registration.cc:1475 does. profile=True adds
    per-stage wall times (info["stage_s"]) with a device synchronization
    after each stage, so a profiled solve is slower than a plain one.
    The solution's final_inlier_count is the returned pose's consensus
    (`_finalize_counted`); info["best_count"] is the host best's before the
    refinement, the JAX solver's final_inlier_count.
    Besides the JAX solver's info, info reports "clique_seeded" (a clique
    seed ran and was adopted), "clique_rounds" (b_rate == 1.0 rounds that
    ran the clique branch), "exact_clique_searches" (native exact searches
    of those rounds, one a hypothesis), "translation_rescued" (() bool) and
    "host_syncs".
    """
    t_start = time.monotonic()
    pin_float32()
    c = ori_src.shape[1]
    params.check_port_supported()
    dev = ori_src.device
    ori_src = ori_src.to(_F32)
    ori_dst = ori_dst.to(device=dev, dtype=_F32)
    keep_mask = keep_mask.to(device=dev, dtype=_I64)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    stage_s: dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        """A profiled stage: `utils.timing.timed` from a synchronised card to
        the stage's end on it, a host span "solve.<name>" with tracing on."""
        if not profile:
            return fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with timing.timed(f"solve.{name}", sync_on=ori_src) as span:
            out = fn(*args, **kw)
        stage_s[name] = stage_s.get(name, 0.0) + span["elapsed_s"]
        return out

    layout = DrawLayout(params, c, fused_scan_rounds(params))
    draws = layout.fill(generator, dev)
    more_draws = draws  # the draws of rounds past the layout's

    def round_draws(r):
        nonlocal more_draws
        if r < layout.rounds:
            return draws, r
        if r % layout.rounds == 0:
            more_draws = layout.fill(generator, dev)
        return more_draws, r % layout.rounds

    red_i, red_j, red_count, red_pool = timed(
        "init", _init_stage, ori_src, ori_dst, keep_mask, params, None,
        layout.init_draws(draws),
    )
    # adoptive_thr_multiplier = 1 + |reduced| / |ori| (registration.cc:669).
    n_reduced_pts, n_real = torch.stack(
        [(keep_mask == 1).sum(), (keep_mask >= -1).sum()]
    ).tolist()
    host_syncs = 1
    thr = torch.tensor(
        params.pr_noise * (1.0 + n_reduced_pts / max(n_real, 1)), dtype=_F32, device=dev
    )

    hs = HostState.initial(c, keep_mask)
    warm = WarmState.initial(dev)
    gror_used = False
    if params.gror_init:
        # GROR initial alignment (registration_artificial.cc:571-576) seeds
        # the warm state, over every real correspondence (padding, -2,
        # excluded): GROR is a front stage the pre-filter does not gate.
        g = timed(
            "gror", gror_align, ori_src, ori_dst, params.gror_resolution,
            params.gror_k_optimal, corr_active=keep_mask > -2, device=dev,
        )
        host_syncs += 1
        if bool(g.inliers.sum() >= 3):
            warm = WarmState(torch.ones((), dtype=_F32, device=dev), g.rotation,
                             g.translation, first_time=device_flag(False, dev))
            gror_used = True
    clique_seeded = False  # a clique seed ran and was adopted

    def clique_seed(active):
        """Run the clique seed; adopt it when it holds enough members."""
        nonlocal warm, clique_seeded, host_syncs
        warm_seed, seed_ok, reads = timed(
            "clique_seed", _clique_seed_stage, ori_src, ori_dst, red_i, red_j, red_pool,
            params, active, None, layout.seed_u(draws),
        )
        host_syncs += reads + 1
        if bool(seed_ok):
            warm = warm_seed
            clique_seeded = True

    if params.clique_eager:
        clique_seed(keep_mask == 1)  # a successful seed wins over GROR's
    lazy_pending = params.clique_lazy
    use_clique = params.resolve_inlier_selection() != InlierSelectionMode.NONE
    clique_rounds = 0
    searches_before = pmc.EXACT_SEARCHES
    rate_idx = 0
    longholi = False
    best_sampled = warm
    best_extras: HypExtras | None = None
    best_count = 0
    rounds = 0
    total_hypotheses = 0
    total_local_batches = 0

    for _round in range(params.max_host_rounds):
        rounds += 1
        l_rate, b_rate = RATE_SCHEDULE[rate_idx]
        b_one = b_rate >= 1.0
        rd, r = round_draws(rounds - 1)
        s_i, s_j, s_ok, s_count, s_pts = timed(
            "sample", _sample_stage, red_i, red_j, red_count, red_pool, l_rate,
            params, c, None, gumbel_of(layout.uniform(rd, "u_sample", r)),
        )
        local = timed(
            "local", _local_stage, ori_src, ori_dst, s_i, s_j, s_ok, s_count, s_pts,
            b_rate, b_one, hs.host_r, warm, thr, params, None,
            lambda k: gumbel_of(layout.uniform(rd, "u_local", r, k)),
            (lambda k: layout.scale_u(rd, r, k)) if layout.scale else None,
        )
        host_syncs += local.host_syncs
        clique_rounds += int(b_one and use_clique)
        best_sampled = local.best
        total_local_batches += local.iterations
        hs, new_corr, host_take = timed(
            "host", _host_stage, ori_src, ori_dst, hs, best_sampled, local.local_r,
            b_one, thr, params, None, layout.uniform(rd, "u_host", r),
        )
        # One host read for every decision of the round.
        hyp, extras_valid, take, pro_host, escalate, n_new, best_count = torch.stack(
            [
                t.to(torch.float64)
                for t in (
                    local.hypotheses, local.extras_valid, host_take, hs.pro_host,
                    local.escalate, new_corr.sum(), hs.best_count,
                )
            ]
        ).tolist()
        host_syncs += 1
        total_hypotheses += int(hyp)
        if take:
            # The host best came from this round: its winning hypothesis's
            # stage masks back the inlier getters, unless the warm state
            # survived every batch unbeaten.
            best_extras = local.extras if extras_valid else None
        warm = WarmState(
            hs.best.scale, hs.best.rotation, hs.best.translation,
            first_time=device_flag(False, dev),
        )

        # Stop checks at the host boundary (registration.cc:1475-1484).
        elapsed = time.monotonic() - t_start
        if pro_host > params.host_confidence or longholi or elapsed > params.time_budget_s:
            break
        if rate_idx == len(RATE_SCHEDULE) - 1:
            longholi = True
        # Escalation decided inside the local loop takes effect next round
        # (registration.cc:1377-1388).
        if escalate and rate_idx < len(RATE_SCHEDULE) - 1:
            rate_idx += 1
        # Self-update: fold newly admitted points into the reduced set.
        if n_new > 0:
            red_i, red_j, red_count, red_pool = timed(
                "self_update", _self_update_pairs, red_i, red_j, red_count,
                red_pool, new_corr, hs.inl_kept, params,
            )
        # Lazy clique seed ("auto"): once, on the first escalation, over the
        # reduced set after the self-update.
        if lazy_pending and escalate:
            lazy_pending = False
            clique_seed(hs.keep_mask == 1)

    # Final refinement (registration.cc:1499-1528).
    if params.enable_refinement and best_count != 0:
        rotation, translation, count, refined, rescued = timed(
            "finalize", _finalize_counted, ori_src, ori_dst, hs, best_sampled, thr, params
        )
    else:
        rotation, translation, count = hs.best.rotation, hs.best.translation, hs.best_count
        refined = torch.zeros((), dtype=torch.bool, device=dev)
        rescued = refined

    # valid is false on a zero-inlier outcome (the reference sets it true
    # unconditionally on loop exit, registration.cc:1531).
    solution = RegistrationSolution(
        valid=hs.best_count > 0,
        scale=hs.best.scale,
        rotation=rotation,
        translation=translation,
        final_inlier_count=count,
    )
    ex = best_extras
    info = {
        "best_count": hs.best_count,
        "pro_host": hs.pro_host,
        "host_r": hs.host_r,
        "rounds": rounds,
        "refined": refined,
        "inlier_counter": hs.inlier_counter,
        "final_inliers": hs.final_inliers,
        "scale_inliers": None if ex is None else ex.scale_inliers,
        "rotation_inliers": None if ex is None else ex.rotation_inliers,
        "translation_inliers": None if ex is None else ex.translation_inliers,
        "translation_points": None if ex is None else ex.translation_points,
        "basic_tims_i": None if ex is None else ex.b_i,
        "basic_tims_j": None if ex is None else ex.b_j,
        "gror_init": gror_used,
        "clique_seeded": clique_seeded,
        "clique_rounds": clique_rounds,
        "exact_clique_searches": pmc.EXACT_SEARCHES - searches_before,
        "translation_rescued": rescued,
        "init_mode": init_route(params, c),
        "stage_s": stage_s if profile else None,
        "elapsed_s": time.monotonic() - t_start,
        "total_hypotheses": total_hypotheses,
        "total_local_batches": total_local_batches,
        "host_syncs": host_syncs,
    }
    return solution, info


def write_iteration_stats(path: str, info: dict) -> None:
    """static.txt-equivalent iteration-count dump of a solve's `info` (host
    rounds, local batches, hypotheses; written by the WT variant and read by
    teaser_cpp_ply_main.cc:448-466)."""
    with open(path, "w") as f:
        f.write(f"{info['rounds']}\n")
        f.write(f"{info['total_local_batches']}\n")
        f.write(f"{info['total_hypotheses']}\n")
