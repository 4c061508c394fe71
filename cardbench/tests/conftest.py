"""The benchmark's CPU tests: `python -m pytest cardbench/tests -q` from the
root of the repository. A tiny tree (the benchmark's files, small sizes)
lets the harness run on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SIZES = {"3dmatch": ([200, 300], [256, 512]), "kitti": ([200, 300], [256, 512])}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of BENCHMARK.json and cardbench/ with every configuration cut
    to 200 and 300 correspondences and every workload to a few pairs, for
    runs on the CPU in seconds."""
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(ROOT / "cardbench", root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, (sizes, buckets) in TINY_SIZES.items():
        path = root / "cardbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["sizes"], cfg["buckets"] = sizes, buckets
        path.write_text(json.dumps(cfg))
    for path in (root / "cardbench" / "workloads").glob("*.json"):
        w = json.loads(path.read_text())
        p = w["params"]
        p.update(pool_per_size=4, warmup_calls=1)
        if "batch" in p:
            p["batch"] = 2
        if "sizes" in p:
            p["sizes"] = [300]
        if "keep_sample" in p:
            p["keep_sample"] = 3
        # 200-300 points at 20 m defeat the pre-filter's normals: many solves miss.
        w["limits"]["missed_share"] = 0.6
        path.write_text(json.dumps(w))
    return root
