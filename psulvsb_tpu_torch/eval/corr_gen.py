"""Correspondence generator: raw cloud pair -> matched keypoint pairs (port
of psulvsb_tpu/eval/corr_gen.py; the reference's correspondence generator,
teaser_cpp_ply.cc:179-329): voxel-grid downsample (leaf = noise bound) ->
ISS keypoints (salient 6r, non-max 4r, gamma 0.975) -> FPFH -> nearest
neighbour in feature space -> 'sx sy sz tx ty tz' text file.
"""

from __future__ import annotations

import numpy as np
import torch

from psulvsb_tpu_torch.frontend.fpfh import compute_fpfh
from psulvsb_tpu_torch.frontend.iss import iss_keypoints
from psulvsb_tpu_torch.frontend.knn import knn
from psulvsb_tpu_torch.frontend.normals import estimate_normals
from psulvsb_tpu_torch.frontend.voxel import voxel_downsample
from psulvsb_tpu_torch.utils.precision import pin_float32


def generate_correspondences(
    src_cloud: np.ndarray,
    dst_cloud: np.ndarray,
    noise_bound: float,
    normal_k: int = 20,
    fpfh_radius_mult: float = 5.0,
    iss_salient_mult: float = 6.0,
    iss_non_max_mult: float = 4.0,
    neighbor_cap: int = 64,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """((3, C) src keypoints, (3, C) matched dst points), numpy; the stages
    after the voxel grid run on `device`, the card unless the caller asks
    for the CPU."""
    from psulvsb_tpu_torch.solver.fused import resolve_device

    device = resolve_device(device)
    pin_float32()

    def keypoints_and_features(cloud):
        down = voxel_downsample(np.asarray(cloud), noise_bound)
        pts = torch.as_tensor(np.asarray(down, np.float32), device=device)
        normals = estimate_normals(pts, k=normal_k, solve_dtype=torch.float64)
        kp_mask = iss_keypoints(pts, salient_radius=iss_salient_mult * noise_bound,
                                non_max_radius=iss_non_max_mult * noise_bound, k=neighbor_cap)
        feats = compute_fpfh(pts, normals, radius=fpfh_radius_mult * noise_bound,
                             k=neighbor_cap)
        kp = torch.nonzero(kp_mask)[:, 0]
        return down[:, kp.cpu().numpy()], feats[kp]

    src_kp, src_f = keypoints_and_features(src_cloud)
    dst_kp, dst_f = keypoints_and_features(dst_cloud)
    if src_kp.shape[1] == 0 or dst_kp.shape[1] == 0:
        return np.zeros((3, 0)), np.zeros((3, 0))
    # PCL CorrespondenceEstimation: for each source keypoint the nearest
    # target keypoint in feature space (teaser_cpp_ply.cc:206-214).
    nn = knn(src_f.T, dst_f.T, k=1, dist_dtype=torch.float64)[0][:, 0].cpu().numpy()
    return src_kp, dst_kp[:, nn]


def write_corr_file(path: str, src: np.ndarray, dst: np.ndarray) -> None:
    """'sx sy sz tx ty tz' per line (the @corr.txt format)."""
    rows = np.concatenate([np.asarray(src).T, np.asarray(dst).T], axis=1)
    np.savetxt(path, rows, fmt="%.8g")
