"""Real-scan registration (port of psulvsb_tpu/eval/realscan.py): the
reference's FPFH+ICP example (examples/teaser_python_fpfh_icp/example.py:
two real depth-sensor scans, voxel 0.05, FPFH, mutual-NN matching, the
solve, ICP refinement) on this package's own stages: io/ply,
frontend/voxel, frontend/normals, frontend/fpfh, frontend/matcher,
api.register_pair, frontend/icp.

No ground-truth matrix ships with the pair, so "registered" is judged as
the example judges it: the coarse pose must seed ICP into convergence, with
an inlier RMSE well under the voxel, a large share of source points within
the ICP gate (fitness), and the coarse rotation a few degrees from the
refined one.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

# The reference's example scans (cloud_bin_0.ply: 258k points, cloud_bin_4.ply:
# 313k) live in a checkout of the reference repository, whose root the
# environment variable PSULVSB_REFERENCE_ROOT names; they are not in this tree.
_REF_DATA = os.path.join(os.environ.get("PSULVSB_REFERENCE_ROOT", ""), "examples",
                         "teaser_python_fpfh_icp", "data")
REALSCAN_PLYS = (
    os.path.join(_REF_DATA, "cloud_bin_0.ply"),
    os.path.join(_REF_DATA, "cloud_bin_4.ply"),
)


def realscan_available() -> bool:
    """Whether the reference's two example scans can be read."""
    return "PSULVSB_REFERENCE_ROOT" in os.environ and all(os.path.exists(p) for p in REALSCAN_PLYS)


def register_realscan(
    src_ply: str,
    dst_ply: str,
    voxel: float = 0.05,
    caps: dict | None = None,
    seed: int = 0,
    device="cuda",
) -> dict:
    """voxel -> normals -> FPFH -> mutual match -> PSULVSB -> ICP on a scan
    pair, on `device` (the card unless the caller asks for the CPU).
    Returns the pipeline's observables (counts, the timed solve, the coarse
    pose, ICP's convergence).

    Stage parameters mirror the reference example (example.py:7,54,
    helpers.py:9-17): voxel 0.05, FPFH radius 5 voxel, noise bound = voxel,
    mutual filter on."""
    from psulvsb_tpu_torch.api import register_pair
    from psulvsb_tpu_torch.frontend.fpfh import compute_fpfh
    from psulvsb_tpu_torch.frontend.icp import icp_point_to_point
    from psulvsb_tpu_torch.frontend.knn import knn
    from psulvsb_tpu_torch.frontend.matcher import match_features
    from psulvsb_tpu_torch.frontend.normals import estimate_normals
    from psulvsb_tpu_torch.frontend.voxel import voxel_downsample
    from psulvsb_tpu_torch.io.ply import read_ply
    from psulvsb_tpu_torch.solver.config import SolverParams
    from psulvsb_tpu_torch.solver.fused import resolve_device
    from psulvsb_tpu_torch.utils.precision import pin_float32

    device = resolve_device(device)
    pin_float32()
    src_cloud = read_ply(src_ply)
    dst_cloud = read_ply(dst_ply)

    def features(cloud):
        down = voxel_downsample(cloud, voxel)
        pts = torch.as_tensor(np.asarray(down, np.float32), device=device)
        normals = estimate_normals(pts, k=20, solve_dtype=torch.float64)
        return down, pts, compute_fpfh(pts, normals, radius=5 * voxel, k=48).cpu().numpy()

    src_d, src_dt, src_f = features(src_cloud)
    dst_d, dst_dt, dst_f = features(dst_cloud)
    corres = match_features(src_d, dst_d, src_f, dst_f, seed=seed, device=device)

    src_m = src_dt[:, torch.as_tensor(corres[:, 0], device=device)]
    dst_m = dst_dt[:, torch.as_tensor(corres[:, 1], device=device)]
    params = SolverParams.preset_artificial(
        noise_bound=voxel, noise_bound_dataset=voxel, **(caps or {})
    )

    def solve(s):
        gen = torch.Generator(device=device).manual_seed(s)
        return register_pair(src_m, dst_m, params, gen, device=device)[0]

    solve(seed)  # untimed: the kernels' first use builds them
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    sol = solve(seed + 1)
    translation = sol.translation.cpu()
    solve_s = time.perf_counter() - t0

    icp = icp_point_to_point(
        src_dt, dst_dt, init_rotation=sol.rotation, init_translation=sol.translation,
        max_correspondence_distance=2 * voxel, max_iterations=100,
    )
    # Fitness: the share of source points with a dst neighbour within the
    # ICP gate under the refined transform (the Open3D fitness).
    moved = icp.rotation @ src_dt + icp.translation[:, None]
    _, d2 = knn(moved, dst_dt, k=1)
    fitness = float((d2[:, 0] <= (2 * voxel) ** 2).float().mean())

    r_coarse = sol.rotation.cpu().numpy().astype(np.float64)
    r_ref = icp.rotation.cpu().numpy().astype(np.float64)
    cosang = (np.trace(r_ref.T @ r_coarse) - 1.0) / 2.0
    return {
        "n_raw_src": int(src_cloud.shape[1]),
        "n_raw_dst": int(dst_cloud.shape[1]),
        "n_down_src": int(src_d.shape[1]),
        "n_down_dst": int(dst_d.shape[1]),
        "n_corr": int(corres.shape[0]),
        "solve_s": solve_s,
        "rotation": sol.rotation.cpu().numpy(),
        "translation": translation.numpy(),
        "icp_rotation": icp.rotation.cpu().numpy(),
        "icp_translation": icp.translation.cpu().numpy(),
        "icp_rmse": float(icp.rmse),
        "icp_fitness": fitness,
        "icp_iters": int(icp.iterations),
        "rot_vs_icp_deg": float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))),
    }
