"""End-to-end front-end protocol (port of
psulvsb_tpu/eval/frontend_protocol.py): raw clouds -> voxel / normals /
[ISS] / FPFH / mutual nearest neighbours -> reference-format correspondence
files -> the batched harness (the reference's generator,
teaser_cpp_ply.cc:179-329).

Every correspondence the solver sees here comes from the descriptor front
end on partially overlapping structured scenes, so its wrong matches carry
the spatial clustering and repeated geometry of real FPFH, and keypoints
outside the overlap are genuinely unmatched.

A pair's front end runs at ONE padded cloud bucket (FRONT_BUCKET) with
active masks through every stage, as in the JAX package, where it lets one
compiled program serve every pair; here it keeps the device shapes of every
pair alike.

The scene and its two views come from np.random.default_rng(seed), as in
the JAX package, so they are equal; the pose comes from this package's
numpy `random_se3` on a stream of its own (JAX draws it from
jax.random.PRNGKey(seed)), or from `pose`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from psulvsb_tpu_torch.core.se3 import random_se3
from psulvsb_tpu_torch.eval.synthetic import structured_scene
from psulvsb_tpu_torch.frontend.fpfh import compute_fpfh
from psulvsb_tpu_torch.frontend.iss import iss_keypoints
from psulvsb_tpu_torch.frontend.knn import knn
from psulvsb_tpu_torch.frontend.normals import estimate_normals
from psulvsb_tpu_torch.frontend.voxel import voxel_downsample
from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.utils.padding import pad_columns
from psulvsb_tpu_torch.utils.precision import pin_float32

# The voxel leaf of the front end quantizes keypoints by up to about half a
# leaf per axis, so the solver's bound is the leaf, 0.3 on extent-40 scenes
# (tests/test_structured_scene.py measured it for the JAX package).
NOISE_BOUND = 0.3
FRONT_BUCKET = 8192
SCENE_POINTS = 24000
EXTENT = 40.0


def _extract_padded(cloud: np.ndarray, bucket: int = FRONT_BUCKET, keypoints: str = "all",
                    device="cuda"):
    """voxel (host) -> normals -> [ISS] -> FPFH at one padded shape on
    `device`. Returns (points (3, bucket) float32, match mask (bucket,) bool,
    features (bucket, 33) float32), tensors on `device`.

    keypoints="iss" restricts the match mask to ISS keypoints (the
    reference generator's); "all" matches every downsampled point, the
    regime of the reference's 3DMatch FPFH files, and the one that survives
    partial overlap (ISS maxima of independently voxelized views repeat
    about 15% of the time, voxel representatives always have a counterpart
    within a leaf). A downsampled cloud larger than the bucket is evenly
    strided down, never cut to a prefix, which would crop the scene."""
    from psulvsb_tpu_torch.solver.fused import resolve_device

    device = resolve_device(device)
    down = np.asarray(voxel_downsample(np.asarray(cloud), NOISE_BOUND))
    m = down.shape[1]
    if m > bucket:
        down = down[:, np.linspace(0, m - 1, bucket).astype(int)]
        m = bucket
    pts = torch.as_tensor(pad_columns(down.astype(np.float32), bucket), device=device)
    active = torch.arange(bucket, device=device) < m
    normals = estimate_normals(pts, k=20, active=active, solve_dtype=torch.float64)
    if keypoints == "iss":
        kp = iss_keypoints(pts, salient_radius=6.0 * NOISE_BOUND,
                           non_max_radius=4.0 * NOISE_BOUND, k=64, active=active) & active
    else:
        kp = active
    feats = compute_fpfh(pts, normals, radius=5.0 * NOISE_BOUND, k=64, active=active)
    return pts, kp, feats


def mutual_matches(sf: torch.Tensor, skp: torch.Tensor, df: torch.Tensor,
                   dkp: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Mutual nearest neighbours in feature space between two padded
    clouds (matcher.cc:184-218's cross-check with active masks): (source
    rows, their destination rows), numpy. Queries span every bucket row;
    rows outside `skp` are dropped after the readback."""
    nn_sd = knn(sf.T, df.T, k=1, point_active=dkp, dist_dtype=torch.float64)[0][:, 0]
    nn_ds = knn(df.T, sf.T, k=1, point_active=skp, dist_dtype=torch.float64)[0][:, 0]
    nn_sd, nn_ds = nn_sd.cpu().numpy(), nn_ds.cpu().numpy()
    src_idx = np.where(skp.cpu().numpy() & (nn_ds[nn_sd] == np.arange(nn_sd.size)))[0]
    return src_idx, nn_sd[src_idx]


def frontend_views(
    seed: int,
    n_points: int = SCENE_POINTS,
    overlap_keep: float = 0.65,
    pose: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The raw clouds of a front-end pair (numpy, float64): a structured
    scene -> two partial views (each keeps `overlap_keep` of the scene along
    a random direction, from opposite ends, overlapping in the middle) ->
    independent sensor jitter -> dst moved by a random SE(3), or by `pose`
    (R, t). Returns ((3, Na) src cloud, (3, Nb) dst cloud, (4, 4) GT)."""
    rng = np.random.default_rng(seed)
    scene = np.asarray(structured_scene(n_points, seed=seed, extent=EXTENT), np.float64)
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    proj = d @ scene
    view_a = scene[:, proj <= np.quantile(proj, overlap_keep)]
    view_b = scene[:, proj >= np.quantile(proj, 1.0 - overlap_keep)]

    if pose is None:
        se3 = random_se3(np.random.default_rng((seed, 1)), max_translation=10.0)
        pose = (se3.rotation, se3.translation)
    rot = np.asarray(pose[0], np.float64)
    trans = np.asarray(pose[1], np.float64)
    src_cloud = view_a + rng.normal(size=view_a.shape) * 0.02
    dst_cloud = rot @ view_b + trans[:, None] + rng.normal(size=view_b.shape) * 0.02
    gt = np.eye(4)
    gt[:3, :3] = rot
    gt[:3, 3] = trans
    return src_cloud, dst_cloud, gt


def make_frontend_pair(
    seed: int,
    n_points: int = SCENE_POINTS,
    overlap_keep: float = 0.65,
    max_corr: int = 6144,
    pose: tuple[np.ndarray, np.ndarray] | None = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One raw-scan-style pair (`frontend_views`) through the whole front
    end on `device`, the card unless the caller asks for the CPU: voxel /
    normals / FPFH / mutual matching. Returns ((3, C) src keypoints, (3, C)
    matched dst points, (4, 4) GT matrix), float64; C varies with what the
    front end found."""
    from psulvsb_tpu_torch.solver.fused import resolve_device

    device = resolve_device(device)
    pin_float32()
    src_cloud, dst_cloud, gt = frontend_views(seed, n_points, overlap_keep, pose)
    sp, skp, sf = _extract_padded(src_cloud, device=device)
    dp, dkp, df = _extract_padded(dst_cloud, device=device)
    src_idx, dst_idx = mutual_matches(sf, skp, df, dkp)
    if src_idx.size > max_corr:
        keep = np.linspace(0, src_idx.size - 1, max_corr).astype(int)
        src_idx, dst_idx = src_idx[keep], dst_idx[keep]
    src_kp = sp.cpu().numpy().astype(np.float64)[:, src_idx]
    dst_m = dp.cpu().numpy().astype(np.float64)[:, dst_idx]
    return src_kp, dst_m, gt


def write_frontend_benchmark(
    data_root: str,
    scenes: list[str],
    n_pairs: int = 60,
    seed: int = 0,
    device="cuda",
) -> None:
    """Write a reference-format benchmark tree whose correspondences come
    from the front end (pairs.txt + @corr.txt + @GTmat.txt + gt.log, the
    layout eval/realdata.py reads); pair i of scene si has the seed
    seed + 9173 si + 31 i."""
    for si, scene in enumerate(scenes):
        scene_dir = os.path.join(data_root, scene)
        os.makedirs(scene_dir, exist_ok=True)
        labels = []
        gt_log_blocks = []
        for i in range(n_pairs):
            a, b = i, i + 1
            src, dst, gt = make_frontend_pair(seed + 9173 * si + 31 * i, device=device)
            stem = os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}")
            np.savetxt(stem + "@corr.txt", np.concatenate([src, dst]).T, fmt="%.8f")
            np.savetxt(stem + "@GTmat.txt", gt, fmt="%.10f")
            labels.append((a, b))
            gt_log_blocks.append(
                f"{a} {b} {n_pairs + 1}\n"
                + "\n".join(" ".join(f"{v:.10f}" for v in row) for row in gt)
            )
        with open(os.path.join(scene_dir, "pairs.txt"), "w") as f:
            f.write("\n".join(f"{a} {b}" for a, b in labels) + "\n")
        with open(os.path.join(scene_dir, "gt.log"), "w") as f:
            f.write("\n".join(gt_log_blocks) + "\n")


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
