"""The port's full-cardinality sweep on the card, FULLSCALE_h100/, must back
what the README's PyTorch/CUDA section says of it, the way
tests/test_fullscale_artifact.py holds the JAX section to FULLSCALE_r*/:
the reference's pair counts (1623 3DMatch pairs over the 8 test scenes, 555
KITTI pairs), CSV rows behind every claimed pair, recall recomputed from
the rows, the known-scale protocol in every sidecar, the walls, and the
card's name and power limit as nvidia-smi gave them."""

import csv
import glob
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "FULLSCALE_h100")

THREEDMATCH_SPLIT = {
    "7-scenes-redkitchen": 506,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 156,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 208,
    "sun3d-hotel_uc-scan3": 226,
    "sun3d-hotel_umd-maryland_hotel1": 104,
    "sun3d-hotel_umd-maryland_hotel3": 54,
    "sun3d-mit_76_studyroom-76-1studyroom2": 292,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 77,
}


@pytest.fixture(scope="module")
def summary():
    path = os.path.join(ARTIFACT, "summary.json")
    assert os.path.exists(path), "FULLSCALE_h100/summary.json is missing: a partial sweep " \
        "is never committed"
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_section():
    """The README's PyTorch/CUDA section, up to the next top-level heading,
    with its line breaks as spaces."""
    with open(os.path.join(ROOT, "README.md")) as f:
        text = f.read()
    start = text.index("## PyTorch/CUDA port")
    end = text.find("\n## ", start + 1)
    return " ".join(text[start:end if end > 0 else None].split())


def _rows(dataset):
    rows = []
    for path in sorted(glob.glob(os.path.join(ARTIFACT, dataset, "*_fpfh_0.csv"))):
        with open(path) as f:
            rows += [(os.path.basename(path), r) for r in csv.DictReader(f)]
    return rows


def test_both_datasets_at_full_cardinality(summary):
    assert summary["3dmatch"]["pairs"] == summary["3dmatch"]["pairs_expected"] == 1623
    assert summary["kitti"]["pairs"] == summary["kitti"]["pairs_expected"] == 555
    for ds in ("3dmatch", "kitti"):
        assert summary[ds]["ddtime"] == 10
        assert summary[ds]["solves"] == 10 * summary[ds]["pairs"]
        assert summary[ds]["caps"] == {"sampled_cap": 2048, "basic_cap": 256,
                                       "hypothesis_batch": 4}


def test_scene_csvs_back_the_summary(summary):
    for scene, want in THREEDMATCH_SPLIT.items():
        with open(os.path.join(ARTIFACT, "3dmatch", f"{scene}_fpfh_0.csv")) as f:
            assert len(list(csv.DictReader(f))) == want, scene
    assert len(_rows("kitti")) == 555
    assert set(summary["3dmatch"]["per_scene_recall"]) == set(THREEDMATCH_SPLIT)
    assert set(summary["kitti"]["per_scene_recall"]) == {f"kitti_seq{i:02d}" for i in range(8)}


def test_recall_recomputes_from_rows(summary):
    for ds in ("3dmatch", "kitti"):
        rows = _rows(ds)
        succ = sum(r["Success"] == "1" for _, r in rows)
        assert len(rows) == summary[ds]["pairs"]
        assert succ / len(rows) == pytest.approx(summary[ds]["recall"], abs=5e-4)
        for scene, recall in summary[ds]["per_scene_recall"].items():
            mine = [r for name, r in rows if name == f"{scene}_fpfh_0.csv"]
            assert sum(r["Success"] == "1" for r in mine) / len(mine) == pytest.approx(
                recall, abs=5e-4)


def test_metas_match_protocol():
    """Known scale (main.cc:319), the projected per-retry time gate, and the
    port's backend in every scene's sidecar."""
    metas = glob.glob(os.path.join(ARTIFACT, "*", "*_fpfh_0.csv.meta.json"))
    assert len(metas) == 16
    for path in metas:
        with open(path) as f:
            fp = json.load(f)["fingerprint"]
        assert "estimate_scaling=False" in fp["params"]
        assert fp["time_gate"] == "projected-per-retry"
        assert fp["backend"] == "torch"


def test_readme_port_section_quotes_the_artifact(summary, port_section):
    assert "FULLSCALE_h100/" in port_section
    assert f"{summary['3dmatch']['pairs']} 3DMatch pairs" in port_section
    assert f"{summary['kitti']['pairs']} KITTI pairs" in port_section
    for ds in ("3dmatch", "kitti"):
        assert f"{summary[ds]['sweep_wall_s']:g} s" in port_section, ds
        assert f"{summary[ds]['card']}, {summary[ds]['power_limit']}" in port_section, ds
    all_one = all(v == 1.0 for ds in ("3dmatch", "kitti")
                  for v in summary[ds]["per_scene_recall"].values())
    assert ("recall 1.0 on every scene of both datasets" in port_section) == all_one
