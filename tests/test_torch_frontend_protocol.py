"""The front-end protocol of the port (eval/frontend_protocol.py,
eval/corr_gen.py, eval/realscan.py) against the JAX package's.

The scene, the two views and their jitter come from the same numpy streams
in both packages; the pose is fed from JAX's draw. What differs is float32
rounding in the front end (tests/test_torch_frontend.py states where):
- `_extract_padded` at bucket 1024: points and active masks equal; each
  package estimates its own normals (the port's in float64), and FPFH's
  swap rule on planes turns their ~1e-6 differences into other bins: at
  most 20% of the feature rows off by more than 1e-2 (7.4-15% measured),
  at most 2.5% of the ISS keypoint labels different;
- `make_frontend_pair` at its defaults (24000 scene points, bucket 8192,
  seed 62 of JAX's test_match_quality_regime): the same GT, C within 2% of
  JAX's, at least 90% of JAX's correspondences among the port's (95.3% on
  this seed), and the regime JAX's test states (C >= 800, >= 20 true
  inliers);
- `write_frontend_benchmark`: the files read back equal by both packages'
  readers;
- `generate_correspondences` (ISS keypoints) on a small pair: counts within
  10% and at least 80% of JAX's correspondences among the port's.
`register_realscan` runs on two PLYs that the test writes; the reference's
real scans are not in this tree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psulvsb_tpu.core.se3 import random_se3 as jax_random_se3
from psulvsb_tpu.eval import corr_gen as jcg
from psulvsb_tpu.eval import frontend_protocol as jfp
from psulvsb_tpu.eval import realdata as jrd
from psulvsb_tpu.io.ply import read_ply as jax_read_ply
from psulvsb_tpu_torch.eval import corr_gen, frontend_protocol as fp, realdata as rd, realscan
from psulvsb_tpu_torch.io.ply import read_ply, write_ply

FEATURE_ROWS_OFF = 0.2
FEATURE_TOL = 1e-2


def _jax_pose(seed):
    se3 = jax_random_se3(jax.random.PRNGKey(seed), max_translation=10.0, dtype=jnp.float32)
    return np.asarray(se3.rotation), np.asarray(se3.translation)


def _rows(src, dst):
    return {tuple(np.round(c, 5)) for c in np.concatenate([src, dst]).T}


def _views(seed, n_points, overlap=0.65):
    """The two jittered partial views of make_frontend_pair, dst unmoved."""
    src, dst, _ = fp.frontend_views(seed, n_points, overlap, pose=(np.eye(3), np.zeros(3)))
    return src, dst


def test_extract_padded_matches_jax():
    cloud, _ = _views(5, 8000)
    jp, jk, jf = jfp._extract_padded(cloud, bucket=1024)
    tp, tk, tf = fp._extract_padded(cloud, bucket=1024, device="cpu")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))  # strided, never truncated
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int(tk.sum()) == 1024
    off = np.abs(tf.numpy() - np.asarray(jf)).max(1) > FEATURE_TOL
    assert off.mean() <= FEATURE_ROWS_OFF, off.mean()
    jp, jk, _ = jfp._extract_padded(cloud, bucket=1024, keypoints="iss")
    tp, tk, _ = fp._extract_padded(cloud, bucket=1024, keypoints="iss", device="cpu")
    assert 0 < int(tk.sum()) < 1024
    assert (tk.numpy() != np.asarray(jk)).mean() <= 0.025


def test_make_frontend_pair_at_its_defaults_matches_jax():
    seed = 62
    js, jd, jgt = jfp.make_frontend_pair(seed)
    ts, td, tgt = fp.make_frontend_pair(seed, pose=_jax_pose(seed), device="cpu")
    np.testing.assert_array_equal(tgt, jgt)
    assert ts.shape[0] == 3 and ts.shape == td.shape and ts.dtype == np.float64
    c = ts.shape[1]
    assert abs(c - js.shape[1]) <= 0.02 * js.shape[1]
    assert len(_rows(js, jd) & _rows(ts, td)) >= 0.9 * js.shape[1]
    resid = np.linalg.norm(tgt[:3, :3] @ ts + tgt[:3, 3:4] - td, axis=0)
    assert c >= 800 and int((resid < fp.NOISE_BOUND).sum()) >= 20
    # The port's own pose: a proper rotation, translation within 10.
    _, _, own = fp.make_frontend_pair(seed, n_points=3000, max_corr=50, device="cpu")
    np.testing.assert_allclose(own[:3, :3] @ own[:3, :3].T, np.eye(3), atol=1e-6)
    assert np.linalg.norm(own[:3, 3]) < 10.0 and own[3].tolist() == [0, 0, 0, 1]


def test_frontend_benchmark_files_read_by_both_packages(tmp_path, monkeypatch):
    """The tree's layout and formats, with a stand-in for make_frontend_pair
    (held above) that records the seeds it is asked for."""
    seeds = []

    def pair(seed, device):
        assert device == "cpu"
        seeds.append(seed)
        rng = np.random.default_rng(seed)
        src = rng.uniform(-20, 20, size=(3, 40 + seed % 7))
        gt = np.eye(4)
        gt[:3, :3] = np.asarray(fp.random_se3(rng).rotation, np.float64)
        gt[:3, 3] = rng.normal(size=3)
        return src, gt[:3, :3] @ src + gt[:3, 3:4], gt

    monkeypatch.setattr(fp, "make_frontend_pair", pair)
    root = str(tmp_path / "fe")
    fp.write_frontend_benchmark(root, ["s0", "s1"], n_pairs=2, seed=11, device="cpu")
    assert seeds == [11, 42, 11 + 9173, 42 + 9173]
    for scene in ("s0", "s1"):
        scene_dir = os.path.join(root, scene)
        labels = rd.read_pair_labels(os.path.join(scene_dir, "pairs.txt"))
        assert labels == jrd.read_pair_labels(os.path.join(scene_dir, "pairs.txt")) == [(0, 1),
                                                                                        (1, 2)]
        logs = rd.read_gt_log(os.path.join(scene_dir, "gt.log"))
        for a, b in labels:
            corr, gt_path = rd.pair_files(scene_dir, a, b)
            src, dst = rd.read_corr_file(corr)
            jsrc, jdst = jrd.read_corr_file(corr)
            np.testing.assert_array_equal(src, jsrc)
            np.testing.assert_array_equal(dst, jdst)
            gt = rd.read_gt_mat(gt_path)
            np.testing.assert_array_equal(gt, jrd.read_gt_mat(gt_path))
            np.testing.assert_allclose(logs[(a, b)], gt, atol=1e-9)
            np.testing.assert_allclose(gt[:3, :3] @ src + gt[:3, 3:4], dst, atol=1e-6)


def test_generate_correspondences_matches_jax(tmp_path):
    src_cloud, dst_cloud = _views(3, 6000)
    js, jd = jcg.generate_correspondences(src_cloud, dst_cloud, 0.3)
    ts, td = corr_gen.generate_correspondences(src_cloud, dst_cloud, 0.3, device="cpu")
    assert ts.shape == td.shape and ts.shape[0] == 3
    assert abs(ts.shape[1] - js.shape[1]) <= 0.1 * js.shape[1]
    assert len(_rows(js, jd) & _rows(ts, td)) >= 0.8 * js.shape[1]
    path = str(tmp_path / "c@corr.txt")
    corr_gen.write_corr_file(path, ts, td)
    src, dst = rd.read_corr_file(path)
    np.testing.assert_allclose(src, ts, rtol=1e-7)
    np.testing.assert_allclose(dst, td, rtol=1e-7)


@pytest.fixture(scope="module")
def scan_plys(tmp_path_factory):
    """Two views of a small structured scene, the second moved by a known
    pose, written as binary PLYs (the real scans of the reference are not
    in this tree)."""
    root = tmp_path_factory.mktemp("scans")
    src, dst = _views(21, 12000, overlap=0.8)
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                    [0, 0, 1]])
    trans = np.array([1.0, -0.5, 0.2])
    paths = str(root / "a.ply"), str(root / "b.ply")
    write_ply(paths[0], src)
    write_ply(paths[1], rot @ dst + trans[:, None])
    return paths, rot, trans


def test_register_realscan_on_written_plys(scan_plys):
    (a, b), rot, trans = scan_plys
    np.testing.assert_array_equal(read_ply(a), jax_read_ply(a))
    res = realscan.register_realscan(a, b, voxel=0.3, caps=dict(sampled_cap=1024, basic_cap=128,
                                                                hypothesis_batch=4),
                                     device="cpu")
    assert res["n_raw_src"] > res["n_down_src"] > 1000 and res["n_corr"] >= 50
    assert np.isfinite(res["icp_rmse"]) and res["icp_rmse"] < 0.3
    assert res["icp_fitness"] > 0.5 and res["icp_iters"] < 100
    assert res["rot_vs_icp_deg"] < 10.0
    cosang = (np.trace(rot.T @ res["icp_rotation"].astype(np.float64)) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 2.0
    assert np.linalg.norm(res["icp_translation"] - trans) < 0.3
    assert realscan.realscan_available() == ("PSULVSB_REFERENCE_ROOT" in os.environ and all(
        os.path.exists(p) for p in realscan.REALSCAN_PLYS))


def test_entry_points_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    cloud, _ = _views(5, 3000)
    calls = [
        lambda: fp.make_frontend_pair(1, n_points=3000),
        lambda: fp._extract_padded(cloud, bucket=1024),
        lambda: fp.write_frontend_benchmark(str(tmp_path / "x"), ["s"], n_pairs=1),
        lambda: corr_gen.generate_correspondences(cloud, cloud, 0.3),
        lambda: realscan.register_realscan("a.ply", "b.ply"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
