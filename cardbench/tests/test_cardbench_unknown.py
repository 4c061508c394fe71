"""The unknown-scale cell, `3dmatch_unknown.inorder`: found by name with its
configuration, traffic and metrics; the configuration is 3dmatch with the
keys the judge reads for the reference's unknownScale protocol
(teaser_cpp_ply_main.cc:319); the new readers read a constructed trace and
give None without a card or a trace; and the cell cut to a tiny size, under
its own limits, is correct when sound and not when the answers' scale is
left at 1."""

import json
import shutil

import pytest
import torch

from cardbench import harness, probe, tracing
from conftest import ROOT

CELL = "3dmatch_unknown.inorder"
CONFIG = "3dmatch_unknown"
NEW_METRICS = ("stages.peak_ms.unknown", "stages.scale_pct.unknown",
               "pair_ratio_hist.roofline_pct.unknown")
SEED = 2**32 + 17
MS = 1_000_000  # ns


def test_the_cell_and_its_metrics_are_found_by_name():
    cell = harness.Cell(ROOT, CELL)
    assert cell.entry["config"] == CONFIG and cell.chips == 1
    assert cell.workload["kind"] == "batch" and cell.traffic_class().__name__ == "Traffic"
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "recall_pct", "setup_s"}
    assert tuple(m["name"] for m in cell.per_layer) == NEW_METRICS
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "pairs_per_s"
        assert callable(cell.reader(m["name"]))


def test_the_configuration_is_3dmatch_at_an_unknown_scale():
    """Every key the generator and the judge read is 3dmatch's, but the
    scale estimated, the targets stretched in [1, 5) and recall asking the
    scale within 0.1 of the pair's."""
    known = json.loads((ROOT / "cardbench/configs/3dmatch.json").read_text())
    cfg = harness.Cell(ROOT, CELL).config
    assert cfg["name"] == CONFIG
    assert cfg["test_scale"] == {"low": 1.0, "high": 5.0}
    assert cfg["criteria"] == {**known["criteria"], "max_scale_err": 0.1}
    assert cfg["solver"] == {**known["solver"], "estimate_scaling": True}
    for key in ("preset", "noise_bound", "scene_scale", "max_translation", "outlier_mode",
                "outlier_rates", "sizes", "buckets"):
        assert cfg[key] == known[key], key
    assert harness.solver_params(cfg).estimate_scaling
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}[CONFIG]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


def test_the_limits_are_those_of_the_readings():
    """The limits PERF.md sets from the card's readings: the known-scale
    orth_err and count_off_share, the configuration's scale error, and the
    pose gaps over clean pairs."""
    limits = harness.Cell(ROOT, CELL).workload["limits"]
    assert limits == {"orth_err": 1e-4, "scale_err": 0.1, "count_off_share": 0.05,
                      "missed_share": 0.05, "rot_gap_deg_p50": 0.015, "trans_gap_p50": 0.05}


class Run:
    def __init__(self, reading, cuda=False):
        self.cache = {tracing.KEY: reading}
        self.cuda = cuda
        self.traffic = None


def snapshot(stages):
    return {"device": stages, "counters": {"solves": 4, "pairs": 4}}


def test_the_span_readers_read_a_constructed_trace():
    cell = harness.Cell(ROOT, CELL)
    reading = {"snap": snapshot({"solve": {"ns": 40 * MS, "count": 4},
                                 "solve.init.peak": {"ns": 2 * MS, "count": 4},
                                 "solve.local": {"ns": 20 * MS, "count": 24},
                                 "solve.local.scale": {"ns": 5 * MS, "count": 24}})}
    assert cell.reader("stages.peak_ms.unknown")(Run(reading)) == pytest.approx(0.5)
    assert cell.reader("stages.scale_pct.unknown")(Run(reading)) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_the_new_readers_give_none_without_a_card_or_a_trace(metric):
    """No trace (a program without the tracing), a trace without the new
    spans (a program that does not stamp them), or no card."""
    reader = harness.Cell(ROOT, CELL).reader(metric)
    assert reader(Run(None)) is None
    known = {"snap": snapshot({"solve": {"ns": 40 * MS, "count": 4},
                               "solve.local": {"ns": 20 * MS, "count": 24}})}
    assert reader(Run(known)) is None


@pytest.fixture(scope="module")
def unknown_tiny(tiny_root, tmp_path_factory):
    """The tiny tree with the unknown-scale configuration cut to 200 and 300
    correspondences and its cell to a few pairs, under the cell's own
    limits."""
    root = tmp_path_factory.mktemp("unknown_tiny")
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    path = root / "cardbench/configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    tiny = json.loads((root / "cardbench/configs/3dmatch.json").read_text())
    cfg["sizes"], cfg["buckets"] = tiny["sizes"], tiny["buckets"]
    path.write_text(json.dumps(cfg))
    work = json.loads((ROOT / "cardbench/workloads" / f"{CELL}.json").read_text())
    work["params"].update(pool_per_size=4, warmup_calls=1, batch=2)
    (root / "cardbench/workloads" / f"{CELL}.json").write_text(json.dumps(work))
    return root


@pytest.mark.parametrize("mode", ["sound", "unscaled"])
def test_the_tiny_cell_is_judged_under_the_cells_limits(unknown_tiny, mode):
    line = probe.probe(CELL, [SEED], 2.0, [mode], torch.device("cpu"), root=unknown_tiny)[0]
    assert line["correct"] == (mode == "sound"), line
    if mode == "unscaled":
        assert line["checks"]["scale_err"] > 0.1
    else:
        assert line["checks"]["count_off_share"] <= 0.05
