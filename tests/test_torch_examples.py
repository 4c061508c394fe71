"""The seven examples of the port (`psulvsb_tpu_torch/examples/`), each
through its `main(argv)` with `--device cpu` at a small size, gated on what
it returns: the pose against the ground truth where there is one (RE < 5
deg, TE < 0.3, the protocols' success criteria), the certifier's two
verdicts, counts and recall otherwise. Without `--device cpu`, where there
is no card, every example exits non-zero.

The JAX examples draw their poses from `jax.random.PRNGKey`, the port's
from numpy, so each port example is held to the truth, not to JAX's
numbers; tests/test_examples.py keeps the JAX examples import-tested."""

import os

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch.core.se3 import random_se3
from psulvsb_tpu_torch.eval import frontend_protocol as fp
from psulvsb_tpu_torch.eval import make_dataset
from psulvsb_tpu_torch.examples import (
    benchmark_3dmatch,
    certify_demo,
    fpfh_icp_pipeline,
    generate_correspondences,
    kitti_scale_pipeline,
    learned_descriptor_bench,
    psulvsb_demo,
)
from psulvsb_tpu_torch.io.ply import write_ply

RE_MAX, TE_MAX = 5.0, 0.3
CPU = ["--device", "cpu"]
TURN = random_se3(np.random.default_rng(11)).rotation
SHIFT = np.array([1.0, -0.5, 0.2])

# Each example's arguments, as far as its --device check; the files need
# not exist, since the device is resolved before any input is read.
ARGV = {
    psulvsb_demo: [],
    certify_demo: [],
    fpfh_icp_pipeline: [],
    generate_correspondences: ["a.ply", "b.ply", "out.txt"],
    learned_descriptor_bench: ["a.npz", "b.npz"],
    kitti_scale_pipeline: ["1000"],
    benchmark_3dmatch: ["--data-root", "data", "--out", "out"],
}


def test_seven_examples_mirror_the_jax_folder():
    here = os.path.dirname(os.path.abspath(__file__))
    jax_names = sorted(f for f in os.listdir(os.path.join(here, "..", "examples"))
                       if f.endswith(".py"))
    assert sorted(m.__name__.rsplit(".", 1)[1] + ".py" for m in ARGV) == jax_names


@pytest.mark.parametrize("module", list(ARGV), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_example_without_card_exits_nonzero(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs there")
    with pytest.raises(SystemExit) as e:
        module.main(ARGV[module])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


def test_psulvsb_demo(tmp_path):
    out = psulvsb_demo.main(["--trials", "2", "--outliers", "0.5",
                             "--out", str(tmp_path / "demo"), *CPU])
    stats = out["clouds"]["synthetic"]
    assert out["recall"] == {"synthetic": 1.0}
    assert stats["angle_error_deg"][0] < RE_MAX and stats["trans_error"][0] < TE_MAX
    assert os.path.exists(tmp_path / "demo" / "Average.csv")


def test_certify_demo():
    out = certify_demo.main(CPU)
    assert out["estimate_certified"] and not out["identity_certified"]
    assert out["estimate_gap"] < 1e-3


def test_fpfh_icp_pipeline_synthetic():
    out = fpfh_icp_pipeline.main(CPU)
    assert out["correspondences"] > 0 and np.isfinite(out["icp_rmse"])
    assert out["rotation_error_deg"] < RE_MAX and out["translation_error"] < TE_MAX


@pytest.fixture(scope="module")
def scan_pair(tmp_path_factory):
    """Two PLYs of a small structured-scene pair (partial views, moved by a
    known pose), and its 4x4 ground truth."""
    d = tmp_path_factory.mktemp("scans")
    a, b, gt = fp.frontend_views(11, n_points=3000, pose=(TURN, SHIFT))
    write_ply(str(d / "a.ply"), a)
    write_ply(str(d / "b.ply"), b)
    return d, gt


def test_fpfh_icp_pipeline_on_plys(scan_pair):
    d, gt = scan_pair
    out = fpfh_icp_pipeline.main([str(d / "a.ply"), str(d / "b.ply"), "--voxel", "0.3", *CPU])
    assert "rotation_error_deg" not in out  # no ground truth with PLYs
    rot = np.asarray(out["rotation"])
    cos = (np.trace(gt[:3, :3].T @ rot) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < RE_MAX
    assert np.linalg.norm(np.asarray(out["translation"]) - gt[:3, 3]) < TE_MAX


def test_generate_correspondences(scan_pair):
    d, gt = scan_pair
    out = generate_correspondences.main(
        [str(d / "a.ply"), str(d / "b.ply"), str(d / "pair@corr.txt"), "--noise-bound", "0.3",
         *CPU])
    rows = np.loadtxt(d / "pair@corr.txt").reshape(-1, 6)
    assert out["correspondences"] == rows.shape[0] > 0
    moved = gt[:3, :3] @ rows[:, :3].T + gt[:3, 3:4]
    assert (np.linalg.norm(moved - rows[:, 3:].T, axis=0) < 0.3).sum() >= 10


def test_learned_descriptor_bench(tmp_path):
    """Descriptors of 300 keypoints, 40% of them seen in both clouds with
    nearby descriptors, the rest new points with fresh descriptors."""
    rng = np.random.default_rng(8)
    n, d = 300, 32
    src = rng.uniform(-1, 1, size=(3, n)).astype(np.float32)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    gt = np.eye(4)
    gt[:3, :3], gt[:3, 3] = TURN, SHIFT
    dst = (TURN @ src + SHIFT[:, None] + rng.uniform(-0.01, 0.01, (3, n))).astype(np.float32)
    dst_feats = feats + rng.normal(size=feats.shape).astype(np.float32) * 0.05
    new = rng.permutation(n)[: int(0.6 * n)]
    dst[:, new] = rng.uniform(-3, 3, size=(3, new.size))
    dst_feats[new] = rng.normal(size=(new.size, d))
    perm = rng.permutation(n)
    np.savez(tmp_path / "src.npz", points=src, features=feats)
    np.savez(tmp_path / "dst.npz", points=dst[:, perm].T, features=dst_feats[perm])
    np.savetxt(tmp_path / "gt.txt", gt)
    out = learned_descriptor_bench.main([str(tmp_path / "src.npz"), str(tmp_path / "dst.npz"),
                                         "--gt", str(tmp_path / "gt.txt"), *CPU])
    assert out["matches"] >= 0.4 * n and out["valid"]
    assert out["rotation_error_deg"] < RE_MAX and out["translation_error"] < TE_MAX


def test_kitti_scale_pipeline():
    out = kitti_scale_pipeline.main(["4000", *CPU])
    assert out["correspondences"] >= 50 and out["valid"]
    assert out["rotation_error_deg"] < RE_MAX and out["translation_error"] < TE_MAX


def test_benchmark_3dmatch(tmp_path):
    """A one-scene make_dataset tree of 2 pairs at ddtime 1: the serial
    harness, the batched one, and the batched one resumed from its sidecar."""
    data = str(tmp_path / "data")
    make_dataset.write_benchmark(data, ["scene"], n_pairs=2, n_corr=300)
    common = ["--data-root", data, "--scenes", "scene", "--ddtime", "1", *CPU]
    serial = benchmark_3dmatch.main([*common, "--out", str(tmp_path / "serial")])
    batched = benchmark_3dmatch.main([*common, "--out", str(tmp_path / "batched"), "--batched"])
    resumed = benchmark_3dmatch.main([*common, "--out", str(tmp_path / "batched"), "--batched",
                                      "--resume"])
    assert serial["mean_recall"] == batched["mean_recall"] == resumed["mean_recall"] == 1.0
    assert serial["summary"]["scene"]["pairs"] == 2
    assert resumed["summary"]["scene"]["timing"] == "resumed"
    assert os.path.exists(tmp_path / "serial" / "scene_fpfh_0.csv")
