"""The solver side of the end-to-end front-end protocol (port of
psulvsb_tpu/eval/frontend_protocol.py's `NOISE_BOUND` and
`frontend_solver_params`). The front-end pipeline itself (voxel, ISS,
FPFH, matching) is not ported yet (ROADMAP.md Queue 1 item 15)."""

from __future__ import annotations

from psulvsb_tpu_torch.solver.config import SolverParams

# The voxel leaf of the front end quantizes keypoints by up to about half a
# leaf per axis, so the solver's bound is the leaf, 0.3 on extent-40 scenes.
NOISE_BOUND = 0.3


def frontend_solver_params(**overrides) -> SolverParams:
    """preset_kitti at the front end's noise bound, with GROR initial
    alignment and the global translation rescue: the descriptor regime's two
    measured failure modes at about 1% inliers (GNC plateaus that GROR's
    edge search escapes, and repeated-geometry translation aliasing that the
    gated global re-stab corrects)."""
    return SolverParams.preset_kitti(
        **{
            "noise_bound": NOISE_BOUND,
            "noise_bound_dataset": NOISE_BOUND,
            "gror_init": True,
            "translation_rescue": True,
            **overrides,
        }
    )
