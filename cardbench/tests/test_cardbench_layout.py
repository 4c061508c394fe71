"""The benchmark is driven by data: every name in BENCHMARK.json has its
file, and a cell, traffic mix or metric added as files is found with no
change to the code."""

import json
import shutil

import pytest

from cardbench import harness
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_names_files_that_exist(cell):
    c = harness.Cell(ROOT, cell)
    assert c.traffic_class().__name__ == "Traffic"
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))
    assert c.config["name"] == c.entry["config"]
    assert set(c.workload["limits"]) >= {"orth_err", "scale_err", "count_off_share",
                                         "missed_share", "rot_gap_deg_p50",
                                         "trans_gap_p50"}
    # The configuration and traffic mix are named in BENCHMARK.json alone.
    assert set(c.workload) == {"kind", "params", "limits", "why"}


def test_every_metric_and_config_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        c = harness.Cell(ROOT, w["name"])
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, traffic mix, traffic kind and metric written as
    files in a copy of the tree, with their BENCHMARK.json entries."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "cardbench/configs/kitti.json").read_text())
    cfg["name"] = "wide"
    cfg["sizes"], cfg["buckets"] = [12000], [12288]
    (tmp_path / "cardbench/configs/wide.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "wide", "source": "https://example.org/wide",
                             "file": "cardbench/configs/wide.json", "reduced": [],
                             "why": "a wide deployment"})
    (tmp_path / "cardbench/traffic/burst.py").write_text(
        "from cardbench.traffic_base import PairTraffic\n\n\nclass Traffic(PairTraffic):\n"
        "    pass\n")
    (tmp_path / "cardbench/metrics/wide.bursts.py").write_text(
        "def read(run):\n    return None\n")
    (tmp_path / "cardbench/workloads/wide.burst.json").write_text(json.dumps({
        "kind": "burst",
        "params": {"pool_per_size": 2}, "limits": {}, "why": "bursts"}))
    bench["workloads"].append({"name": "wide.burst", "config": "wide", "traffic": "burst",
                               "chips": 1, "why": "bursts"})
    bench["per_layer"].append({"name": "wide.bursts", "unit": "bursts", "better": "lower",
                               "source": "program_counter", "layer": "pair batch",
                               "moves": "pairs_per_s", "workloads": ["wide.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(tmp_path, "wide.burst")
    assert cell.config["sizes"] == [12000]
    assert cell.traffic_class().__name__ == "Traffic"
    assert [m["name"] for m in cell.per_layer] == ["wide.bursts"]
    assert cell.reader("wide.bursts")(None) is None
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "recall_pct", "setup_s"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell(ROOT, "no.such.cell")


def test_the_plan_memory_reads_the_programs_own_count():
    class Run:
        plans = [{"nbytes": 3 * 2**30}, {"nbytes": 2**29}]
    c = harness.Cell(ROOT, "3dmatch.vectorized")
    assert c.reader("plan.mem_gib.vectorized")(Run()) == 3.5
    Run.plans = []
    assert c.reader("plan.mem_gib.vectorized")(Run()) is None
