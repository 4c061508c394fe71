"""The cell past the dense init, `whu_tls.inorder`: WHU-TLS at 10000 and
14000 correspondences, the known-scale "exact_beta" init. It is found by
name with its configuration, traffic and metrics; a WHU-TLS pair of 14000
columns is
made, padded to its bucket and judged a hit with its truth; the new
readers read a constructed trace and give None without a card, a trace or
plans; and the WHU-TLS cell cut to a tiny size, with the dense init's
bound lowered so that the tiny sizes take the same route, is correct when
sound and not when stale, its traced run reading the fill span."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from cardbench import harness, probe, tracing
from cardbench.reference import judge as ref_judge
from cardbench.reference.oracle import oracle_answer
from cardbench.traffic_base import PairTraffic
from conftest import ROOT

NAME = "whu_tls.inorder"
NEW_METRICS = ("stages.fill_ms.whu", "pair_beta_count.roofline_pct.whu", "plan.mem_gib.wide")
SEED = 2**32 + 29
MS = 1_000_000  # ns


def test_the_cell_and_its_metrics_are_found_by_name():
    cell = harness.Cell(ROOT, NAME)
    assert cell.entry["config"] == "whu_tls" and cell.chips == 1
    assert cell.workload["kind"] == "batch" and cell.traffic_class().__name__ == "Traffic"
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "recall_pct", "setup_s"}
    assert tuple(m["name"] for m in cell.per_layer) == NEW_METRICS
    for m in cell.per_layer:
        assert NAME in m["workloads"] and m["moves"] == "pairs_per_s"
        assert callable(cell.reader(m["name"]))


def test_the_configuration_is_the_whu_tls_deployment():
    cfg = harness.Cell(ROOT, "whu_tls.inorder").config
    assert cfg["preset"] == "whu_tls" and cfg["noise_bound"] == 0.15
    assert cfg["solver"] == {"sampled_cap": 2048, "basic_cap": 256, "hypothesis_batch": 4,
                             "estimate_scaling": False}
    assert (cfg["scene_scale"], cfg["max_translation"]) == (30.0, 15.0)
    assert cfg["sizes"] == [10000, 14000] and cfg["buckets"] == [10240, 14336]
    assert cfg["outlier_rates"] == [0.6, 0.75, 0.85, 0.9, 0.93, 0.95]
    assert cfg["criteria"] == {"max_rot_deg": 5.0, "max_trans": 0.9}
    known = json.loads((ROOT / "cardbench/configs/3dmatch.json").read_text())
    assert cfg["guarantees"] == known["guarantees"] and "test_scale" not in cfg
    params = harness.solver_params(cfg)
    assert not params.estimate_scaling and params.noise_bound == 0.15
    assert all(c > params.dense_init_max_c for c in cfg["buckets"])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["whu_tls"]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


class FakeRun:
    def __init__(self, config, params):
        self.params = None
        self.device = torch.device("cpu")
        self.config = config
        self.workload = {"params": params}
        self.seed = SEED


def test_a_whu_tls_pair_of_14000_is_padded_and_its_truth_is_a_hit():
    cfg = harness.Cell(ROOT, "whu_tls.inorder").config
    traffic = PairTraffic(FakeRun(cfg, {"pool_per_size": 1, "sizes": [14000]}))
    traffic.make_pool()
    src, dst, keep = traffic.padded(14000)
    assert src.shape == (1, 3, 14336) and (keep[0, 14000:] == -2).all()
    assert (keep[0, :14000] == 1).all()
    pair = traffic.pair((14000, 0))
    thr = ref_judge.inlier_threshold(cfg["noise_bound"], np.ones(14000))
    explained = ref_judge.residuals(pair.src, pair.dst, 1.0, pair.rotation,
                                    pair.translation) <= thr
    answer = {"valid": True, "scale": 1.0, "rotation": pair.rotation,
              "translation": pair.translation, "count": int(explained.sum())}
    reading = ref_judge.judge(pair, answer, thr, int(explained.sum()), cfg["criteria"],
                              oracle_answer(pair, thr, torch.float64), None)
    assert reading["recall"] and not reading["missed"] and not reading["count_off"]
    assert reading["rot_gap_deg"] < 0.05 and reading["trans_gap"] < 0.05


class Run:
    def __init__(self, reading=None, cuda=False, plans=()):
        self.cache = {tracing.KEY: reading}
        self.cuda = cuda
        self.traffic = None
        self.plans = list(plans)


def test_the_readers_read_a_constructed_trace_and_plans():
    cell = harness.Cell(ROOT, "whu_tls.inorder")
    reading = {"snap": {"device": {"solve": {"ns": 40 * MS, "count": 4},
                                   "solve.init.fill": {"ns": 2 * MS, "count": 4}},
                        "counters": {"solves": 4, "pairs": 4}}}
    assert cell.reader("stages.fill_ms.whu")(Run(reading)) == pytest.approx(0.5)
    plans = [{"nbytes": 3 * 2**30}, {"nbytes": 2**29}]
    assert cell.reader("plan.mem_gib.wide")(Run(plans=plans)) == 3.5


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_the_new_readers_give_none_without_a_card_a_trace_or_plans(metric):
    reader = harness.Cell(ROOT, "whu_tls.inorder").reader(metric)
    assert reader(Run(None)) is None
    dense = {"snap": {"device": {"solve": {"ns": 40 * MS, "count": 4}},
                      "counters": {"solves": 4, "pairs": 4}}}
    assert reader(Run(dense)) is None


@pytest.fixture(scope="module")
def whu_tiny(tiny_root, tmp_path_factory):
    """The tiny tree with the WHU-TLS configuration cut to 200 and 300
    correspondences, its dense bound under them so that they take the
    "exact_beta" route, and its cell cut to a few pairs, under the cell's
    own limits."""
    root = tmp_path_factory.mktemp("whu_tiny")
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    path = root / "cardbench/configs/whu_tls.json"
    cfg = json.loads(path.read_text())
    cfg["sizes"], cfg["buckets"] = [200, 300], [256, 512]
    cfg["solver"].update(dense_init_max_c=128, init_reject_budget=1 << 14)
    path.write_text(json.dumps(cfg))
    work = json.loads((ROOT / "cardbench/workloads/whu_tls.inorder.json").read_text())
    work["params"].update(pool_per_size=4, warmup_calls=1, batch=2)
    (root / "cardbench/workloads/whu_tls.inorder.json").write_text(json.dumps(work))
    return root


@pytest.mark.parametrize("mode", ["sound", "stale"])
def test_the_tiny_cell_is_judged_under_the_cells_limits(whu_tiny, mode):
    cell = harness.Cell(whu_tiny, "whu_tls.inorder")
    params = harness.solver_params(cell.config)
    from psulvsb_tpu_torch.solver.psulvsb import init_route

    assert {init_route(params, c) for c in cell.config["buckets"]} == {"exact_beta"}
    line = probe.probe("whu_tls.inorder", [SEED], 2.0, [mode], torch.device("cpu"),
                       root=whu_tiny)[0]
    assert line["correct"] == (mode == "sound"), line


def test_the_tiny_cells_traced_run_reads_the_fill_and_the_plans(whu_tiny):
    cell = harness.Cell(whu_tiny, "whu_tls.inorder")
    res = harness.run_cell(cell, SEED, 1.0, True, torch.device("cpu"), time.perf_counter())
    assert res["metrics"]["stages.fill_ms.whu"]["value"] > 0
    assert res["metrics"]["plan.mem_gib.wide"]["value"] > 0
    assert "pair_beta_count.roofline_pct.whu" not in res["metrics"]  # no card
