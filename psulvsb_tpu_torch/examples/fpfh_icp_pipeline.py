"""Raw-cloud pipeline: voxel -> normals -> FPFH -> match -> PSULVSB -> ICP
(port of examples/fpfh_icp_pipeline.py).

Equivalent of the FPFH+ICP python example
(the reference's examples/teaser_python_fpfh_icp/example.py + helpers.py:
o3d voxel downsample, FPFH, mutual-NN matching, TEASER solve, o3d ICP
refinement) — all stages native here. Without PLYs it registers a
synthetic pair with a known ground truth and reports the errors.

Usage:
    python -m psulvsb_tpu_torch.examples.fpfh_icp_pipeline [src.ply dst.ply] \
        [--voxel 0.05] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from psulvsb_tpu_torch.api import register_pair
from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.core.se3 import random_se3
from psulvsb_tpu_torch.eval.synthetic import synthetic_cloud
from psulvsb_tpu_torch.frontend.fpfh import compute_fpfh
from psulvsb_tpu_torch.frontend.icp import icp_point_to_point
from psulvsb_tpu_torch.frontend.matcher import match_features
from psulvsb_tpu_torch.frontend.normals import estimate_normals
from psulvsb_tpu_torch.frontend.voxel import voxel_downsample
from psulvsb_tpu_torch.io.ply import read_ply
from psulvsb_tpu_torch.solver.config import SolverParams


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.fpfh_icp_pipeline")
    ap.add_argument("ply", nargs="*", help="src.ply dst.ply (synthetic if none)")
    ap.add_argument("--voxel", type=float, default=0.05)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)

    gt = None
    if len(args.ply) == 2:
        src_cloud = read_ply(args.ply[0])
        dst_cloud = read_ply(args.ply[1])
    else:
        src_cloud = synthetic_cloud(800, seed=0)
        gt = random_se3(np.random.default_rng(1), max_translation=1.0)
        dst_cloud = (gt.rotation @ src_cloud + gt.translation[:, None]).astype(np.float32)

    def features(cloud):
        down = voxel_downsample(cloud, args.voxel)
        pts = torch.as_tensor(np.asarray(down, np.float32), device=device)
        normals = estimate_normals(pts, k=20)
        return down, compute_fpfh(pts, normals, radius=5 * args.voxel, k=48).cpu().numpy()

    src_d, src_f = features(src_cloud)
    dst_d, dst_f = features(dst_cloud)
    corres = match_features(src_d, dst_d, src_f, dst_f, device=device)
    print(f"{corres.shape[0]} correspondences")

    params = SolverParams.preset_artificial(noise_bound=args.voxel,
                                            noise_bound_dataset=args.voxel)
    sol, _ = register_pair(
        np.asarray(src_d[:, corres[:, 0]], np.float32),
        np.asarray(dst_d[:, corres[:, 1]], np.float32),
        params, torch.Generator(device=device).manual_seed(0), device=device,
    )
    print("coarse rotation:\n", sol.rotation.cpu().numpy())

    icp = icp_point_to_point(
        torch.as_tensor(np.asarray(src_d, np.float32), device=device),
        torch.as_tensor(np.asarray(dst_d, np.float32), device=device),
        init_rotation=sol.rotation,
        init_translation=sol.translation,
        max_correspondence_distance=2 * args.voxel,
    )
    rotation = icp.rotation.cpu().numpy().astype(np.float64)
    translation = icp.translation.cpu().numpy().astype(np.float64)
    print("refined rotation:\n", rotation)
    print(f"ICP iterations: {int(icp.iterations)}, inlier RMSE: {float(icp.rmse):.5f}")
    out = {
        "correspondences": int(corres.shape[0]),
        "icp_iterations": int(icp.iterations),
        "icp_rmse": float(icp.rmse),
        "rotation": rotation.tolist(),
        "translation": translation.tolist(),
    }
    if gt is not None:
        out["rotation_error_deg"] = angular_error_deg_np(gt.rotation, rotation)
        out["translation_error"] = float(np.linalg.norm(translation - gt.translation))
        print("rotation error (deg):", out["rotation_error_deg"])
    return out


if __name__ == "__main__":
    main()
