"""Registration from learned descriptors (3DSmoothNet/FCGF-style; port of
examples/learned_descriptor_bench.py).

Equivalent of the 3DSmoothNet benchmark example
(the reference's examples/teaser_python_3dsmooth/teaser_python_3dsmooth.py +
bench_utils.py): load keypoints + precomputed learned descriptors, match by
mutual nearest neighbor in descriptor space, register, report errors vs a
ground-truth transform.

Inputs: two .npz files with arrays `points` (3, N) or (N, 3) and
`features` (N, D), plus an optional 4x4 ground-truth text file.

Usage:
    python -m psulvsb_tpu_torch.examples.learned_descriptor_bench src.npz dst.npz \
        [--gt GT.txt] [--noise-bound 0.05] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from psulvsb_tpu_torch.api import register_pair
from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.frontend.matcher import match_features
from psulvsb_tpu_torch.solver.config import SolverParams


def load_npz(path):
    d = np.load(path)
    pts = d["points"]
    if pts.shape[0] != 3:
        pts = pts.T
    return pts.astype(np.float32), d["features"].astype(np.float32)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.learned_descriptor_bench")
    ap.add_argument("src_npz")
    ap.add_argument("dst_npz")
    ap.add_argument("--gt", default=None, help="4x4 ground-truth matrix file")
    ap.add_argument("--noise-bound", type=float, default=0.05)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)

    src_pts, src_f = load_npz(args.src_npz)
    dst_pts, dst_f = load_npz(args.dst_npz)
    corres = match_features(src_pts, dst_pts, src_f, dst_f,
                            use_crosscheck=True, use_tuple_test=False, device=device)
    print(f"{corres.shape[0]} mutual-NN descriptor matches")

    params = SolverParams.preset_artificial(
        noise_bound=args.noise_bound, noise_bound_dataset=args.noise_bound
    )
    sol, _ = register_pair(
        src_pts[:, corres[:, 0]],
        dst_pts[:, corres[:, 1]],
        params,
        torch.Generator(device=device).manual_seed(0),
        device=device,
    )
    rotation = sol.rotation.cpu().numpy().astype(np.float64)
    translation = sol.translation.cpu().numpy().astype(np.float64)
    print("rotation:\n", rotation)
    print("translation:", translation)
    print("inliers:", int(sol.final_inlier_count))
    out = {"matches": int(corres.shape[0]), "inliers": int(sol.final_inlier_count),
           "valid": bool(sol.valid)}
    if args.gt:
        gt = np.loadtxt(args.gt)
        out["rotation_error_deg"] = angular_error_deg_np(gt[:3, :3], rotation)
        out["translation_error"] = float(np.linalg.norm(gt[:3, 3] - translation))
        print("rotation error (deg):", out["rotation_error_deg"])
        print("translation error:", out["translation_error"])
    return out


if __name__ == "__main__":
    main()
