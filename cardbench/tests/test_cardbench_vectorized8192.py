"""The cell at 3DMatch's widest bucket, `3dmatch.vectorized8192`: 3DMatch's
pairs of 6500 with a pair axis. It is found by name with its configuration,
traffic and metric; its plan memory reader reads the plans and gives None
without them; and the cell cut to a tiny size is correct when sound and not
when stale or a control."""

import time

import pytest
import torch

from cardbench import harness, probe
from conftest import ROOT

NAME = "3dmatch.vectorized8192"
SEED = 2**32 + 29


def test_the_cell_and_its_metric_are_found_by_name():
    cell = harness.Cell(ROOT, NAME)
    assert cell.entry["config"] == "3dmatch" and cell.chips == 1
    assert cell.workload["kind"] == "batch" and cell.traffic_class().__name__ == "Traffic"
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "recall_pct", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["plan.mem_gib.wide"]
    for m in cell.per_layer:
        assert NAME in m["workloads"] and m["moves"] == "pairs_per_s"
        assert callable(cell.reader(m["name"]))


def test_the_cell_takes_3dmatchs_largest_size_with_a_pair_axis():
    cell = harness.Cell(ROOT, NAME)
    params = cell.workload["params"]
    assert params["sizes"] == [6500] and params["vectorized"] and params["batch"] == 64
    assert dict(zip(cell.config["sizes"], cell.config["buckets"]))[6500] == 8192
    assert cell.config["buckets"][-1] == 8192


class Run:
    def __init__(self, plans=()):
        self.cuda = False
        self.traffic = None
        self.plans = list(plans)


def test_the_plan_memory_reader_reads_the_plans_and_none_without():
    read = harness.Cell(ROOT, NAME).reader("plan.mem_gib.wide")
    assert read(Run([{"nbytes": 3 * 2**30}, {"nbytes": 2**29}])) == 3.5
    assert read(Run()) is None


@pytest.mark.parametrize("mode", ["sound", "stale", "control"])
def test_the_tiny_cell_is_judged_under_the_cells_limits(tiny_root, mode):
    line = probe.probe(NAME, [SEED], 2.0, [mode], torch.device("cpu"), root=tiny_root)[0]
    assert line["correct"] == (mode == "sound"), line


def test_the_tiny_cells_traced_run_reads_the_plans(tiny_root):
    cell = harness.Cell(tiny_root, NAME)
    res = harness.run_cell(cell, SEED, 1.0, True, torch.device("cpu"), time.perf_counter())
    assert res["metrics"]["plan.mem_gib.wide"]["value"] > 0
