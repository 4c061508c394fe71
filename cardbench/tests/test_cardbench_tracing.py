"""The readers of the program's own tracing (`cardbench/tracing.py`) on a
constructed run: each metric from a snapshot made by hand, None where the
program has no tracing, and a traced window on the CPU at a tiny size."""

import time

import pytest
import torch

from cardbench import harness, tracing
from conftest import ROOT

MS = 1_000_000  # ns


def snapshot():
    """A window of 100 ms on the card's clock: two calls of one pair each,
    a pre-filter span and a solve in each, one gap between them."""
    return {
        "window_ns": [0, 100 * MS],
        "device": {"solve": {"ns": 60 * MS, "count": 2},
                   "solve.local": {"ns": 40 * MS, "count": 9},
                   "solve.control": {"ns": 6 * MS, "count": 2},
                   "pipeline.prefilter": {"ns": 10 * MS, "count": 2},
                   "call.outside_graph": {"ns": 4 * MS, "count": 2}},
        "counters": {"solves": 2, "pairs": 2, "rounds": 6, "local_batches": 9},
        "solves": [[10 * MS, 40 * MS, "C=2048 #1", 0, 1], [60 * MS, 90 * MS, "C=2048 #1", 1, 1]],
        "calls": [[1, 0, 42 * MS], [2, 50 * MS, 95 * MS]],
        "gaps": [{"start_ns": 42 * MS, "end_ns": 50 * MS, "span": "caller"}],
        "gaps_by_span": {"caller": {"ns": 8 * MS, "count": 1, "longest_ns": 8 * MS}},
    }


class Run:
    def __init__(self, reading):
        self.cache = {tracing.KEY: reading}


READING = {"snap": snapshot(), "seconds": 0.1,
           "records": [{"elapsed_s": 0.045}, {"elapsed_s": 0.035}]}
EXPECTED = {
    "stages.solve_ms.throughput": 30.0,
    "stages.solve_ms.online": 30.0,
    "stages.control_pct.throughput": 10.0,
    "stages.local_batches.throughput": 4.5,
    "pipeline.prefilter_ms.online": 5.0,
    "device.gap_pct.throughput": 8.0,
    "device.gap_pct.online": 8.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_reads_the_snapshot(metric):
    cell = harness.Cell(ROOT, "kitti.online" if metric.endswith("online")
                        else "kitti.inorder")
    assert metric in {m["name"] for m in cell.per_layer}
    assert cell.reader(metric)(Run(READING)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_gives_none_without_a_trace(metric):
    reader = harness.Cell(ROOT, "kitti.inorder").reader(metric)
    assert reader(Run(None)) is None


def test_a_program_without_tracing_gives_none(monkeypatch):
    class Bare:
        cache: dict = {}
        traffic = object()
        window_s = 1.0

    monkeypatch.setattr(tracing, "_timing", lambda: None)
    assert tracing.traced_window(Bare()) is None and Bare.cache[tracing.KEY] is None


def test_the_readings_agree_on_the_constructed_window():
    got = tracing.agreement(READING)
    # (30 + 30 ms of solves + 8 ms of gap) of 100 ms; (5 + 30) of a mean 40 ms.
    assert got["solves_plus_gaps_pct"] == pytest.approx(68.0)
    assert got["prefilter_plus_solve_pct_of_elapsed"] == pytest.approx(87.5)
    assert not got["solves_overlap"] and not got["gap_in_solve"]
    snap = snapshot()
    snap["gaps"].append({"start_ns": 85 * MS, "end_ns": 88 * MS, "span": "caller"})
    assert tracing.agreement({"snap": snap, "records": []})["gap_in_solve"]


def test_a_traced_window_on_the_cpu_reads_every_new_metric(tiny_root):
    """A traced run at a tiny size: the readers run their traced window
    after the cell's and report every metric named for the cell."""
    for name in ("kitti.online", "3dmatch.vectorized"):
        cell = harness.Cell(tiny_root, name)
        res = harness.run_cell(cell, 2**33 + 3, 1.0, True, torch.device("cpu"),
                               time.perf_counter())
        for metric in (m["name"] for m in cell.per_layer if m["name"] in EXPECTED):
            assert res["metrics"][metric]["value"] >= 0, (name, metric)
