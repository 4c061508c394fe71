"""KITTI-scale raw-cloud pipeline: 100k points end to end on one card
(port of examples/kitti_scale_pipeline.py).

The BASELINE.md eval configs include "KITTI odometry pairs (~100k pts)".
This example exercises the full raw-cloud path at that size — voxel-grid
downsample -> normals -> ISS keypoints -> FPFH-33 -> NN matching
(eval/corr_gen.py, the teaser_cpp_ply.cc:179-329 equivalent) -> fused
PSULVSB solve (solver/fused.psulvsb_register) — on a synthetic
outdoor-scale pair with a known SE(3).

By default the fixture is `structured_scene` — ground plane + box
buildings + poles, i.e. the planar/corner structure FPFH keys on — and the
example reports the front-end MATCH INLIER RATE (fraction of produced
correspondences within the noise bound of the GT mapping), the front-end
quality number. `--blobby` switches to the spherical-harmonics cloud, a
hostile fixture for FPFH (no planar structure) whose match quality only
lower-bounds real scans.

Usage:
    python -m psulvsb_tpu_torch.examples.kitti_scale_pipeline [n_points] \
        [--blobby] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.core.se3 import random_se3
from psulvsb_tpu_torch.eval.corr_gen import generate_correspondences
from psulvsb_tpu_torch.eval.synthetic import structured_scene, synthetic_cloud
from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.fused import psulvsb_register
from psulvsb_tpu_torch.utils.timing import Timer


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.kitti_scale_pipeline")
    ap.add_argument("n_points", nargs="?", type=int, default=100_000)
    ap.add_argument("--blobby", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)
    n_pts = args.n_points
    rng = np.random.default_rng(0)

    if args.blobby:
        base = np.asarray(synthetic_cloud(n_pts, seed=3)) * 20.0  # 40 m scene
    else:
        base = np.asarray(structured_scene(n_pts, seed=3, extent=40.0))
    t = random_se3(np.random.default_rng(2), max_translation=10.0)
    rot = np.asarray(t.rotation, np.float64)
    trans = np.asarray(t.translation, np.float64)
    dst_cloud = rot @ base + trans[:, None] + rng.normal(size=base.shape) * 0.02

    t0 = time.perf_counter()
    src_kp, dst_m = generate_correspondences(base, dst_cloud, noise_bound=0.3, device=device)
    t_gen = time.perf_counter() - t0
    c = src_kp.shape[1]
    # Front-end quality: a produced correspondence is a true match when the
    # GT-transformed source keypoint lands within the noise bound of its
    # matched target point.
    resid = np.linalg.norm(rot @ src_kp + trans[:, None] - dst_m, axis=0)
    inlier_rate = float(np.mean(resid < 0.3))
    print(
        f"n_pts={n_pts}: corr_gen {t_gen:.1f} s -> {c} correspondences, "
        f"match inlier rate {inlier_rate:.2f}"
    )
    if c < 50:
        raise SystemExit("too few keypoint correspondences")

    # The solver's noise bound must cover the correspondence error scale:
    # keypoints come from two INDEPENDENT voxel grids at leaf 0.3, so even
    # true matches carry up to ~half-leaf quantization offsets per cloud on
    # top of sensor noise (preset_kitti's 0.1 undershoots that). Scale is
    # known (odometry is rigid): under estimate_scaling the structured
    # scene's correlated wall-to-wall mismatches can collapse the scale TLS
    # to zero consensus — the reference's real-data program likewise runs
    # known-scale unless unknownScale is requested.
    params = SolverParams.preset_kitti(
        noise_bound=0.3, noise_bound_dataset=0.3, estimate_scaling=False,
        sampled_cap=4096, basic_cap=1024, hypothesis_batch=16,
    )
    keep = np.ones(c, np.int64)
    src_t = torch.as_tensor(src_kp, dtype=torch.float32, device=device)
    dst_t = torch.as_tensor(dst_m, dtype=torch.float32, device=device)
    s = psulvsb_register(src_t, dst_t, keep, 0, params, device=device)  # build + warm
    timer = Timer("solve").start()
    s = psulvsb_register(src_t, dst_t, keep, 1, params, device=device)
    t_solve = timer.stop(sync_on=s.rotation)
    re = angular_error_deg_np(rot, s.rotation.cpu().numpy())
    te = float(np.linalg.norm(s.translation.cpu().numpy().astype(np.float64) - trans))
    print(f"solve {t_solve * 1e3:.0f} ms  rot_err {re:.3f} deg  trans_err {te:.3f} m")
    return {
        "correspondences": int(c), "match_inlier_rate": inlier_rate, "corr_gen_s": t_gen,
        "solve_ms": t_solve * 1e3, "rotation_error_deg": re, "translation_error": te,
        "valid": bool(s.valid),
    }


if __name__ == "__main__":
    main()
