"""Classic TEASER-style decoupled solve on a full correspondence set (port
of psulvsb_tpu/solver/classic.py).

The upstream pipeline without the PSULVSB loop: scale TLS over all
complete-graph TIMs -> max-clique inlier pruning over the scale-consistency
graph -> rotation on chain (or complete) TIMs of the clique points ->
component-wise translation, for API parity with upstream
`RobustRegistrationSolver` usage (registration-test.cc) and as the serial
harness's fallback retry.

Host-orchestrated: the clique stage decides on the host what the later stages
see. The C (C - 1) / 2 TIMs (1.78 M columns at C = 1889, 12.5 M at C = 5000)
and the (C, C) consistency graph are built and stay on the device of the
inputs; only PMC_EXACT copies the graph to the host, for the native search.
Convention: upstream reports the translation with dst = s * R * src + t (no
`t /= s`: that division is a modification of the fork, registration.cc:1250),
unlike `psulvsb_solve`.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.clique.kcore import greedy_clique, max_kcore_mask
from psulvsb_tpu_torch.pairs.tims import compute_tims
from psulvsb_tpu_torch.robust.scale import select_scale_inliers, solve_scale_tls
from psulvsb_tpu_torch.robust.translation import scatter_or, solve_translation
from psulvsb_tpu_torch.rotation.fgr import fgr_rotation
from psulvsb_tpu_torch.rotation.gnc import gnc_tls_rotation
from psulvsb_tpu_torch.solver.config import (
    InlierGraphFormulation,
    InlierSelectionMode,
    RotationEstimationAlgorithm,
    SolverParams,
)
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils.precision import mm, pin_float32
from psulvsb_tpu_torch.utils.scalars import as_scalar


def _max_clique(adj: torch.Tensor, mode: InlierSelectionMode, params: SolverParams) -> torch.Tensor:
    """MaxCliqueSolver::findMaxClique's dispatch (graph.cc:12-125) on a
    (C, C) bool graph on the device; the members as a sorted index tensor
    there. PMC_EXACT: the native exact search on the host, under
    params.max_clique_time_limit (only a caller on the CPU without a
    toolchain falls through to the greedy, `pmc.exact_search_available`; on
    the card that raises, and so does a build or a library that fails). PMC_HEU: the greedy on core ordering. KCORE_HEU: the
    largest core."""
    if mode == InlierSelectionMode.PMC_EXACT and pmc.exact_search_available(adj.device):
        members = pmc.exact_max_clique(adj.cpu().numpy(), params.max_clique_time_limit)
        return torch.as_tensor(members, dtype=torch.int64, device=adj.device)
    if mode == InlierSelectionMode.KCORE_HEU:
        mask = max_kcore_mask(adj)
    else:
        mask, _ = greedy_clique(adj)
    return torch.nonzero(mask)[:, 0]


def consistency_graph(
    idx_i: torch.Tensor, idx_j: torch.Tensor, edges: torch.Tensor, c: int
) -> torch.Tensor:
    """The (C, C) bool graph, on the device, with the undirected edge
    (idx_i, idx_j) wherever `edges` (registration.cc:1000-1017)."""
    adj = torch.zeros((c, c), dtype=torch.bool, device=idx_i.device)
    adj[idx_i, idx_j] = edges
    return adj | adj.T


def solve_decoupled(
    src: torch.Tensor,
    dst: torch.Tensor,
    params: SolverParams,
    generator: torch.Generator | None = None,
    active: torch.Tensor | None = None,
    scale_u: torch.Tensor | None = None,
) -> tuple[RegistrationSolution, dict]:
    """Upstream decoupled solve with the caller's noise bound (no PSULVSB
    loop). src/dst: (3, C) tensors; the solve runs where they lie. Returns
    (solution, info dict with the inlier masks).

    Stage order and semantics follow the upstream solve(): scale -> clique
    -> chain-TIM rotation -> translation, all with params.noise_bound /
    params.rotation_* (the inner_* overrides belong to the PSULVSB loop).
    `scale_u`: optional (scale_max_draws,) uniforms of the 1-point scale
    consensus, else drawn from `generator`.

    The rotation is the single-problem `rotation.gnc.gnc_tls_rotation` (or
    `fgr_rotation`) at every size of the clique's TIM set, as in the JAX
    package, which runs it outside any kernel: a COMPLETE set over a large
    clique exceeds what the batched GNC kernel serves, and one route for all
    sizes keeps the result independent of the size. On a clique of at most one
    point the solve aborts (registration.cc:1032-1036): valid is False, the
    masks computed so far are kept and the stages that never ran are None."""
    pin_float32()
    src = src.to(torch.float32)
    dst = dst.to(device=src.device, dtype=torch.float32)
    c = src.shape[1]
    dtype, dev = src.dtype, src.device
    if active is None:
        active = torch.ones(c, dtype=torch.bool, device=dev)
    src_tims, idx_i, idx_j, pair_active = compute_tims(src, active)
    dst_tims = dst[:, idx_j] - dst[:, idx_i]

    # --- scale (registration.cc:958-991) ------------------------------------
    if params.estimate_scaling:
        scale, scale_inliers, _ = solve_scale_tls(
            src_tims, dst_tims, params.noise_bound, params.cbar2, active=pair_active,
            max_draws=params.scale_max_draws, estimator=params.scale_estimator,
            u=scale_u, generator=generator,
        )
    else:
        scale, scale_inliers, _ = select_scale_inliers(
            src_tims, dst_tims, params.noise_bound, params.cbar2, active=pair_active
        )
    del src_tims, dst_tims

    # --- max-clique inlier selection (registration.cc:1000-1056) ------------
    mode = params.resolve_inlier_selection()
    if mode != InlierSelectionMode.NONE:
        clique = _max_clique(consistency_graph(idx_i, idx_j, scale_inliers, c), mode, params)
        if clique.numel() <= 1:
            # Clique abort (registration.cc:1032-1036).
            sol = RegistrationSolution(
                valid=torch.zeros((), dtype=torch.bool, device=dev),
                scale=scale,
                rotation=torch.eye(3, dtype=dtype, device=dev),
                translation=torch.zeros(3, dtype=dtype, device=dev),
                final_inlier_count=torch.zeros((), dtype=torch.int64, device=dev),
            )
            return sol, {
                "max_clique": clique.tolist(),
                "scale_inliers": scale_inliers,
                "rotation_inliers": None,
                "translation_inliers": None,
                "translation_points": None,
            }
    else:
        clique = torch.nonzero(active)[:, 0]

    # --- rotation TIMs over the clique (upstream chain graph) ---------------
    m = clique.numel()
    if params.rotation_tim_graph == InlierGraphFormulation.CHAIN:
        r_i = clique
        r_j = clique[(torch.arange(m, device=dev) + 1) % max(m, 1)]  # the chain wraps around
    else:  # COMPLETE over the clique points
        a, b = torch.triu_indices(m, m, 1, device=dev)
        r_i, r_j = clique[a], clique[b]
    rot_src = src[:, r_j] - src[:, r_i]
    rot_dst = dst[:, r_j] - dst[:, r_i]

    # De-scale, and the widened noise bound (registration.cc:1102-1108).
    inv_s = 1.0 / torch.clamp(scale, min=1e-30)
    rot_dst = rot_dst * inv_s
    rot_nb = as_scalar(params.noise_bound, dtype, dev) * 2.0 * inv_s
    loop = dict(
        max_iterations=params.rotation_max_iterations,
        gnc_factor=params.rotation_gnc_factor,
        cost_threshold=params.rotation_cost_threshold,
    )
    if params.rotation_estimation_algorithm != RotationEstimationAlgorithm.GNC_TLS:
        rot = fgr_rotation(rot_src, rot_dst, rot_nb, **loop)
        rotation, rotation_inliers = rot.rotation, rot.inliers
    else:
        rot = gnc_tls_rotation(rot_src, rot_dst, rot_nb, rot_method=params.gnc_rot_method, **loop)
        rotation, rotation_inliers = rot.rotation, rot.inliers

    # --- translation point set (endpoint dedup, registration.cc:1114-1154) --
    trans_points = scatter_or(
        c, torch.cat([r_i, r_j]), torch.cat([rotation_inliers, rotation_inliers])
    )

    # --- translation (upstream: on s * R * src; t is NOT divided by s) ------
    moved = scale * mm(rotation, src)
    translation, trans_inliers, _ = solve_translation(
        moved, dst, params.noise_bound, params.cbar2, active=trans_points
    )

    solution = RegistrationSolution(
        valid=torch.ones((), dtype=torch.bool, device=dev),
        scale=scale,
        rotation=rotation,
        translation=translation,
        final_inlier_count=trans_inliers.sum(),
    )
    info = {
        "scale_inliers": scale_inliers,
        "rotation_inliers": rotation_inliers,
        "translation_inliers": trans_inliers,
        "translation_points": trans_points,
        "max_clique": clique.tolist(),
        "basic_tims_i": r_i,
        "basic_tims_j": r_j,
    }
    return solution, info
