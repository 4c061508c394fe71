"""Without a card, or without the program beside it, run.py exits non-zero
within seconds and prints no result."""

import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT


def run(cwd, script):
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, script, "--workload", "kitti.online", "--seed",
                          str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=120)
    return out, time.monotonic() - t0


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out, seconds = run(ROOT, "cardbench/run.py")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
    assert seconds < 60


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out, _ = run(tmp_path, "cardbench/run.py")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no program" in out.stderr
