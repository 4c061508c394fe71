"""`correct` on the CPU at a tiny size: a sound run passes; the control
(the plain reference in bfloat16 in the program's place, also with its
rotation made orthonormal again in float32) and each fault planted in the
timed path fail."""

import time

import pytest
import torch

from cardbench import harness, probe

SEED = 2**32 + 17


def run(root, cell, mode):
    return probe.probe(cell, [SEED], 2.0, [mode], torch.device("cpu"), root=root)[0]


def test_a_sound_run_is_correct(tiny_root):
    line = run(tiny_root, "3dmatch.inorder", "sound")
    assert line["correct"], line
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", ["3dmatch.inorder", "3dmatch.vectorized", "kitti.online"])
@pytest.mark.parametrize("mode", ["control", "control_f32", "stale", "half", "altered"])
def test_control_and_faults_are_not_correct(tiny_root, cell, mode):
    line = run(tiny_root, cell, mode)
    assert not line["correct"], line


def test_an_altered_keep_mask_is_not_correct(tiny_root):
    line = run(tiny_root, "kitti.online", "keep")
    assert not line["correct"]
    assert line["checks"]["keep_off_share"] > 0.5


def test_the_result_line_has_the_contracts_keys(tiny_root):
    cell = harness.Cell(tiny_root, "kitti.online")
    res = harness.run_cell(cell, SEED, 1.0, True, torch.device("cpu"),
                           time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(res["device"])
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "pipeline.outside_ms.online" in res["metrics"]
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_a_rotation_made_orthonormal_again_fails_by_its_pose(tiny_root):
    """bfloat16 arithmetic behind a float32 rotation passes `orth_err`; the
    pose gaps to the float64 fit catch it."""
    line = run(tiny_root, "3dmatch.inorder", "control_f32")
    checks = line["checks"]
    assert checks["orth_err"] < 1e-5
    assert not line["correct"]
