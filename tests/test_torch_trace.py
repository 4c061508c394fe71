"""The port's tracing (psulvsb_tpu_torch/utils/timing.py) on the CPU: host
spans, the fused plan's stage spans, the pipeline's and the pair batch's
spans and device stamps, the gaps and the clock's calibration.

On the CPU a stamp reads the host clock, so the plain version of a traced
plan gives the span names and counts that its graph gives on a card, and
they are held here to the plan's own `stats`. Counts are compared exactly;
span times only by order and nesting (a CPU run gives no device time). The
CUDA case holds a captured plan's stamps to its `stats`, and its node count
to the untraced plan's, and skips here (`python -m pytest
tests/test_torch_trace.py -m cuda --noconftest` on a card). Where the scale
is estimated, two spans lie inside their stages (the init's scale peak, each
local batch's scale estimate), and the closing stamps count the scale peaks
that failed their certificate and the returned counts that are not the host
best's.
"""

import json
import os

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch import SolverParams, psulvsb_register, psulvsb_solve, register_batch
from psulvsb_tpu_torch.eval.pipeline import solve_with_prefilter
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.utils import timing

CAPS = dict(sampled_cap=256, basic_cap=64, hypothesis_batch=4)
C = 200
STAGES = {n for n in timing.SOLVE_SPANS if n.count(".") == 1}  # the stages of a solve
NESTED = {"solve.init.peak": "solve.init", "solve.local.scale": "solve.local"}


def _pair(seed: int, outliers: float = 0.6, c: int = C):
    pair = make_synthetic_pair(np.random.default_rng(seed), synthetic_cloud(c, seed=seed + 1),
                               0.01, outliers, max_translation=2.0)
    src = torch.as_tensor(np.asarray(pair.src), dtype=torch.float32)
    dst = torch.as_tensor(np.asarray(pair.dst), dtype=torch.float32)
    return src, dst, torch.ones(c, dtype=torch.int64)


def _case(name: str):
    """(params, pair, solve seed) of tests/test_torch_fused.py's small twins:
    the anchor, GROR, and the lazy clique seed (97% outliers, where the
    first escalation runs the seed)."""
    if name == "anchor":
        return SolverParams.preset_artificial(clique_init="off", **CAPS), _pair(1), 7
    if name == "gror":
        return SolverParams.preset_artificial_gror(gror_k_optimal=150, **CAPS), _pair(1), 2
    if name == "unknown":  # the scale estimated, the target stretched by 2.5
        src, dst, keep = _pair(1, outliers=0.75)
        return SolverParams.preset_3dmatch(estimate_scaling=True, **CAPS), (src, 2.5 * dst, keep), 6
    return (SolverParams.preset_artificial(clique_init="auto", **CAPS),
            _pair(5, outliers=0.97, c=300), 3)


@pytest.fixture
def tracing():
    """Tracing on over a fresh window, and off again after the test."""
    fused.clear_plan_cache()
    timing.enable(True)
    timing.start()
    try:
        yield
    finally:
        timing.enable(False)
        fused.clear_plan_cache()
        timing.start()


def _params(**kw):
    return SolverParams.preset_artificial(**CAPS, **kw)


def test_tracing_off_records_nothing():
    fused.clear_plan_cache()
    timing.enable(False)
    timing.start()
    src, dst, keep = _pair(0)
    params = _params()
    psulvsb_register(src, dst, keep, 3, params, device="cpu")
    solve_with_prefilter(src.numpy(), dst.numpy(), params, 4, device="cpu")
    register_batch(src[None].repeat(2, 1, 1), dst[None].repeat(2, 1, 1),
                   keep[None].repeat(2, 1), [5, 6], params, device="cpu")
    assert fused.plan_for(params, C, "cpu").trace is None
    snap = timing.snapshot()
    assert snap["spans"] == [] and snap["device"] == {} and snap["calls"] == []
    assert snap["solves"] == [] and snap["gaps"] == []
    assert all(v == 0 for v in snap["counters"].values())


@pytest.mark.parametrize("case", ["anchor", "lazy_seed", "gror"])
def test_plain_version_span_tree_follows_stats(tracing, case):
    params, (src, dst, keep), seed = _case(case)
    psulvsb_register(src, dst, keep, seed, params, device="cpu")
    plan = fused.plan_for(params, src.shape[1], "cpu")
    assert plan.trace is not None
    stats = plan.stats
    snap = timing.snapshot()
    ops = snap["device"]
    assert ops["solve"]["count"] == 1
    assert ops["solve.local"]["count"] == stats["local_batches"]
    assert ops["solve.sample"]["count"] == stats["rounds"]
    assert ops["solve.host"]["count"] == stats["rounds"]
    assert ops["solve.init"]["count"] == ops["solve.finalize"]["count"] == 1
    assert ops.get("solve.clique_seed", {"count": 0})["count"] == int(stats["seeded"])
    assert snap["counters"]["rounds"] == stats["rounds"]
    assert snap["counters"]["local_batches"] == stats["local_batches"]
    # Stages plus the control are the whole solve, and each stage lies
    # inside its solve, the stages one after another.
    stage_ns = sum(v["ns"] for k, v in ops.items() if k in STAGES)
    assert stage_ns + ops["solve.control"]["ns"] == ops["solve"]["ns"]
    assert ops["solve.control"]["ns"] >= 0
    (start, end, plan_label, index, pairs), = snap["solves"]
    assert index == 0 and pairs == 1
    stages = sorted((s, e, n) for n, p, s, e in snap["timeline"] if n != "solve")
    assert len(stages) == sum(ops[k]["count"] for k in STAGES if k in ops)
    assert all(start <= s <= e <= end for s, e, _ in stages)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def _scaled_batch(pairs: int):
    """Unknown-scale pairs at 75% wrong matches, targets stretched by 1.5 to 3.5."""
    out = []
    for k in range(pairs):
        p = make_synthetic_pair(np.random.default_rng(60 + k), synthetic_cloud(C, seed=61 + k),
                                0.01, 0.75, max_translation=2.0, outlier_mode="mismatch",
                                test_scale=1.5 + 2.0 * k)
        out.append((torch.as_tensor(np.asarray(p.src), dtype=torch.float32),
                    torch.as_tensor(np.asarray(p.dst), dtype=torch.float32),
                    torch.ones(C, dtype=torch.int64)))
    return tuple(torch.stack(x) for x in zip(*out))


def _solve_batch(params, src, dst, keep, seeds, vectorized):
    sols = register_batch(src, dst, keep, seeds, params, vectorized=vectorized, device="cpu")
    pairs = len(seeds) if vectorized else None
    plan = fused.plan_for(params, C, "cpu", pairs=pairs)
    return sols, plan


@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_scale_spans_nest_in_their_stages_and_the_counters_count(tracing, scaled, vectorized):
    """At an estimated scale each init holds a scale peak span and each
    local batch a scale estimate span; `init_uncertified` counts the pairs
    whose histogram peak failed its certificate and `count_refit` the pairs
    whose returned count is not the host best's. At known scale neither span
    is stamped and no peak is counted. `solve.control` is the solve less its
    stages, the spans inside them not subtracted again."""
    from psulvsb_tpu_torch.ops.hist import exact_peak_bin

    params = SolverParams.preset_3dmatch(estimate_scaling=scaled, **CAPS)
    src, dst, keep = _scaled_batch(2)
    seeds = [4, 5]
    sols, plan = _solve_batch(params, src, dst, keep, seeds, vectorized)
    batches = plan.stats["local_batches"]
    snap = timing.snapshot()
    ops, counters = snap["device"], snap["counters"]
    tops = sum(v["ns"] for k, v in ops.items() if k in STAGES)
    assert ops["solve.control"]["ns"] == ops["solve"]["ns"] - tops
    if not scaled:
        assert not set(NESTED) & set(ops) and counters["init_uncertified"] == 0
    else:
        assert ops["solve.init.peak"]["count"] == ops["solve.init"]["count"]
        assert ops["solve.local.scale"]["count"] == ops["solve.local"]["count"]
        if vectorized:  # one span a chunk, the batches of its longest pair
            assert ops["solve.init"]["count"] == 1
            assert ops["solve.local"]["count"] == max(batches)
        for inner, outer in NESTED.items():
            outers = [(s, e) for n, _, s, e in snap["timeline"] if n == outer]
            for n, _, s, e in snap["timeline"]:
                if n == inner:
                    assert any(a <= s <= e <= b for a, b in outers), (inner, s, e)
        certified = [bool(exact_peak_bin(src[k], dst[k], keep[k] == 1)[2]) for k in range(2)]
        assert counters["init_uncertified"] == certified.count(False)
    # The returned counts that are not the host best's, from the staged solve.
    refit = 0
    for k, seed in enumerate(seeds):
        sol, info = psulvsb_solve(src[k], dst[k], keep[k], params,
                                  torch.Generator().manual_seed(seed))
        assert int(sol.final_inlier_count) == int(sols.final_inlier_count[k])
        refit += int(sol.final_inlier_count) != int(info["best_count"])
    assert counters["count_refit"] == refit
    if vectorized:
        assert refit == int((sols.final_inlier_count != plan.bufs["hs.best_count"]).sum())


@pytest.mark.parametrize("pairs", [None, 2])
def test_a_traced_scale_plan_holds_the_untraced_buffers_and_answers(pairs):
    """Every scale plan computes the init's peak apart from the rest; tracing
    only stamps around it: the traced plan holds the untraced plan's
    buffers and gives its answers bit for bit."""
    params = SolverParams.preset_3dmatch(estimate_scaling=True, **CAPS)
    src, dst, keep = _scaled_batch(2)
    held, answers = {}, {}
    fused.clear_plan_cache()
    try:
        for traced in (False, True):
            timing.enable(traced)
            sols, plan = _solve_batch(params, src, dst, keep, [8, 9], pairs is not None)
            assert plan.peak_apart
            held[traced] = {name: tuple(t.shape) for name, t in plan.bufs.items()}
            answers[traced] = sols
    finally:
        timing.enable(False)
        fused.clear_plan_cache()
        timing.start()
    assert held[False] == held[True]
    assert all(torch.equal(a, b) for a, b in zip(answers[False], answers[True]))


def test_a_closing_stamp_counts_by_the_kind_of_its_values():
    """On the host, as csrc/graph_cond.cu on a card: int64 values above the
    threshold, int64 values other than the others', bool flags that are
    false; each into its own counter."""
    rounds = batches = torch.zeros(3, dtype=torch.int64)
    record = timing.SpanRecord(("solve", "solve.init"), torch.device("cpu"), rounds, batches,
                               3, "counting")
    timing.start()
    record.stamp(1, False)
    record.stamp(1, True, torch.tensor([5, 9, 12]), 8, 0)
    record.stamp(1, False)
    record.stamp(1, True, torch.tensor([True, False, False]), 0, 1)
    record.stamp(1, False)
    record.stamp(1, True, torch.tensor([3, 4, 5]), 0, 2, torch.tensor([3, 0, 5]))
    record.read()
    counters = timing.snapshot()["counters"]
    assert [counters[n] for n in timing.STAMP_COUNTERS] == [2, 2, 1]


def test_the_kernels_record_head_is_the_hosts():
    src = open(os.path.join(os.path.dirname(fused.__file__), "..", "csrc", "graph_cond.cu")).read()
    assert f"#define RECORD_HEAD {timing.RECORD_HEAD}\n" in src
    assert timing.RECORD_HEAD == 4 + len(timing.STAMP_COUNTERS)


def test_one_calls_spans_share_a_request_id(tracing):
    params = _params()
    src, dst, keep = _pair(2)
    for seed in (1, 2):
        solve_with_prefilter(src.numpy(), dst.numpy(), params, seed, device="cpu")
    snap = timing.snapshot()
    calls = [s for s in snap["spans"] if s["name"] == "pipeline"]
    assert len(calls) == 2 and calls[0]["request"] != calls[1]["request"]
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        root = s
        while root["parent"] is not None:
            root = by_id[root["parent"]]
        assert root["name"] == "pipeline" and s["request"] == root["request"]
    names = {s["name"] for s in snap["spans"]}
    assert {"pipeline.stage", "pipeline.prefilter", "pipeline.solve", "pipeline.sync",
            "plan.solve"} <= names
    # The plan's host span names the index of its device span.
    assert [s["index"] for s in snap["spans"] if s["name"] == "plan.solve"] == [0, 1]
    assert [s[3] for s in snap["solves"]] == [0, 1]


def test_prefilter_lies_inside_its_pipeline_call(tracing):
    params = _params()
    src, dst, keep = _pair(3)
    solve_with_prefilter(src.numpy(), dst.numpy(), params, 5, device="cpu")
    snap = timing.snapshot()
    host = {s["name"]: s for s in snap["spans"]}
    outer, pre = host["pipeline"], host["pipeline.prefilter"]
    assert outer["start_ns"] <= pre["start_ns"] <= pre["end_ns"] <= outer["end_ns"]
    (request, first, last), = snap["calls"]
    (name, dev_request, s, e), = snap["device_spans"]
    assert name == "pipeline.prefilter" and dev_request == request == outer["request"]
    assert first <= s <= e <= last
    (solve_start, solve_end, *_), = snap["solves"]
    assert e <= solve_start and solve_end <= last
    assert snap["device"]["pipeline.prefilter"] == {"ns": e - s, "count": 1}
    outside = snap["device"]["call.outside_graph"]
    assert outside["count"] == 1
    assert outside["ns"] == (last - first) - (e - s) - (solve_end - solve_start)


def test_in_order_batch_counters_sum_the_single_solves(tracing):
    params = _params()
    pairs = [_pair(10 + k) for k in range(3)]
    seeds = [21, 22, 23]
    src = torch.stack([p[0] for p in pairs])
    dst = torch.stack([p[1] for p in pairs])
    keep = torch.stack([p[2] for p in pairs])
    register_batch(src, dst, keep, seeds, params, device="cpu")
    snap = timing.snapshot()
    timing.start()
    rounds = batches = 0
    plan = fused.plan_for(params, C, "cpu")
    for (s, d, k), seed in zip(pairs, seeds):
        psulvsb_register(s, d, k, seed, params, device="cpu")
        rounds += plan.stats["rounds"]
        batches += plan.stats["local_batches"]
    c = snap["counters"]
    assert (c["solves"], c["pairs"], c["rounds"], c["local_batches"]) == (3, 3, rounds, batches)
    names = [s["name"] for s in snap["spans"]]
    assert names.count("batch") == names.count("batch.stage") == 1
    assert names.count("batch.solve") == names.count("batch.copy") == 3
    assert len(snap["calls"]) == 1 and len(snap["solves"]) == 3


def test_batched_plan_stamps_the_chunk_and_counts_every_pair(tracing):
    params = _params()
    pairs = [_pair(30 + k) for k in range(2)]
    src = torch.stack([p[0] for p in pairs])
    dst = torch.stack([p[1] for p in pairs])
    keep = torch.stack([p[2] for p in pairs])
    register_batch(src, dst, keep, [1, 2], params, vectorized=True, device="cpu")
    plan = fused.plan_for(params, C, "cpu", pairs=2)
    stats = plan.stats
    snap = timing.snapshot()
    c = snap["counters"]
    assert (c["solves"], c["pairs"]) == (1, 2)
    assert c["rounds"] == sum(stats["rounds"]) and c["local_batches"] == sum(stats["local_batches"])
    # One span a chunk: the rounds of the pair that runs longest.
    assert snap["device"]["solve.sample"]["count"] == max(stats["rounds"])
    assert snap["solves"][0][4] == 2


def test_records_survive_the_plan_cache_and_plans_are_kept_apart(tracing):
    params = _params()
    src, dst, keep = _pair(4)
    psulvsb_register(src, dst, keep, 1, params, device="cpu")
    traced = fused.plan_for(params, C, "cpu")
    timing.enable(False)
    plain = fused.plan_for(params, C, "cpu")
    timing.enable(True)
    assert traced is not plain and plain.trace is None
    assert traced is fused.plan_for(params, C, "cpu")
    fused.clear_plan_cache()  # release() reads the record before it goes
    snap = timing.snapshot()
    assert snap["counters"]["solves"] == 1 and snap["device"]["solve"]["count"] == 1


def test_profiled_staged_solve_records_its_stages_as_host_spans(tracing):
    params = _params()
    src, dst, keep = _pair(5)
    _, info = psulvsb_solve(src, dst, keep, params, torch.Generator().manual_seed(2),
                            profile=True)
    snap = timing.snapshot()
    spans: dict = {}
    for s in snap["spans"]:
        spans[s["name"]] = spans.get(s["name"], 0) + (s["end_ns"] - s["start_ns"])
    assert {f"solve.{k}" for k in info["stage_s"]} == set(spans)
    for k, seconds in info["stage_s"].items():
        assert spans[f"solve.{k}"] <= seconds * 1e9 + 1e6


def test_gaps_go_to_the_innermost_span_open_over_most_of_them():
    # Host spans on the device clock: (id, name, start, end, parent).
    spans = [[1, "pipeline", 100, 400, None], [2, "pipeline.stage", 100, 180, 1],
             [3, "pipeline.sync", 330, 400, 1], [4, "pipeline", 520, 800, None],
             [5, "pipeline.stage", 520, 700, 4]]
    calls = [(170, 320), (650, 790), (20, 60)]
    gaps = timing.attribute_gaps(calls, spans)
    # 60-170: no span before 100 (40 ns), pipeline.stage 100-170 (70 ns);
    # 320-650: pipeline 320-330 and pipeline.sync 330-400, then none 400-520
    # (120 ns), then pipeline.stage 520-650 (130 ns).
    assert [(g["start_ns"], g["end_ns"], g["span"]) for g in gaps] == [
        (60, 170, "pipeline.stage"), (320, 650, "pipeline.stage")]
    assert timing.attribute_gaps([(0, 10), (40, 50)], [])[0]["span"] == "caller"
    assert timing.attribute_gaps([(0, 10), (5, 50)], spans) == []


def test_calibration_fit_takes_the_line_through_both_ends():
    start = {"host_ns": 1_000, "device_ns": 51_000, "halfwidth_ns": 3,
             "tries": [[1_000, 51_000, 3], [1_100, 51_104, 5]]}
    end = {"host_ns": 1_001_000, "device_ns": 1_051_100, "halfwidth_ns": 4,
           "tries": [[1_001_000, 1_051_100, 4], [1_001_200, 1_051_296, 6]]}
    fit = timing.fit_clock(start, end)
    assert fit["slope"] == pytest.approx(1.0001)
    assert fit["drift_ppm"] == pytest.approx(100.0)
    assert fit["offset_ns"] + fit["slope"] * 1_000 == pytest.approx(51_000)
    # Residuals of the four tries: 0, |51_104 - 51_100.01|, 0 and
    # |1_051_296 - 1_051_300.02|; their median lies between 0 and 3.99.
    assert fit["residual_ns"] == pytest.approx(3.99 / 2, abs=0.01)
    assert fit["halfwidth_ns"] == 4
    alone = timing.fit_clock(None, end)
    assert alone["slope"] == 1.0 and alone["offset_ns"] == 50_100


def test_device_spans_pair_openings_with_closings():
    stamps = [("call", 1, False, 10), ("pipeline.prefilter", 1, False, 12),
              ("pipeline.prefilter", 1, True, 20), ("call", 1, True, 30),
              ("call", 2, False, 40), ("call", 2, True, 45), ("call", 3, True, 50)]
    assert timing.device_spans(stamps) == [("pipeline.prefilter", 1, 12, 20), ("call", 1, 10, 30),
                                           ("call", 2, 40, 45)]


def test_span_is_a_shared_no_op_while_off():
    timing.enable(False)
    assert timing.span("x") is timing.span("y")
    with timing.span("x") as s:
        assert s is None
    timing.device_stamp(torch.device("cpu"), "call", False)
    assert timing.current_request() is None


def test_trace_exports_host_and_device_spans_on_one_timeline(tmp_path):
    params = _params()
    src, dst, keep = _pair(6)
    fused.clear_plan_cache()
    with timing.trace(str(tmp_path / "tr")) as d:
        solve_with_prefilter(src.numpy(), dst.numpy(), params, 9, device="cpu")
    fused.clear_plan_cache()
    assert not timing.enabled()
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        data = json.load(f)
    events = [e for e in data["traceEvents"] if e["ph"] == "X"]
    host = {e["name"] for e in events if e["pid"] == 0}
    card = {e["name"] for e in events if e["pid"] == 1}
    assert {"pipeline", "pipeline.prefilter", "plan.solve"} <= host
    assert {"solve", "solve.init", "solve.sample", "solve.local", "call",
            "pipeline.prefilter"} <= card
    assert all(e["dur"] >= 0 for e in events)
    assert {o["name"] for o in data["otherData"]["breakdown"]["ops"]} >= {"solve", "solve.control"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["anchor", "lazy_seed", "unknown"])
def test_cuda_captured_stamps_follow_stats_and_cost_no_nodes_untraced(name):
    """A captured plan's stamps give the counts of its `stats`, and the
    same plan captured with tracing off has fewer graph nodes, short by
    exactly the stamps and launch marks that it leaves out. At an estimated
    scale the scale peak and each batch's scale estimate are stamped too,
    and the counters agree with the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    params, (src, dst, keep), seed = _case(name)
    c = src.shape[1]
    fused.clear_plan_cache()
    timing.enable(True)
    try:
        psulvsb_register(src, dst, keep, seed + 1, params)  # builds the traced plan
        timing.start()
        psulvsb_register(src, dst, keep, seed, params)
        traced = fused.plan_for(params, c, "cuda")
        stats = traced.stats
        snap = timing.snapshot()
    finally:
        timing.enable(False)
    ops = snap["device"]
    assert stats["graph_launches"] == 1 and ops["solve"]["count"] == 1
    assert ops["solve.local"]["count"] == stats["local_batches"]
    assert ops["solve.sample"]["count"] == stats["rounds"]
    assert snap["counters"]["rounds"] == stats["rounds"]
    assert snap["counters"]["local_batches"] == stats["local_batches"]
    (start, end, *_), = snap["solves"]
    assert 0 < end - start and ops["solve.control"]["ns"] >= 0
    assert ops["solve.control"]["ns"] == ops["solve"]["ns"] - sum(
        v["ns"] for k, v in ops.items() if k in STAGES)
    if name == "unknown":
        assert ops["solve.init.peak"]["count"] == 1
        assert ops["solve.local.scale"]["count"] == stats["local_batches"]
        timing.enable(True)
        try:
            timing.start()
            psulvsb_register(src, dst, keep, seed, params, device="cpu")  # the plain version
            plain = timing.snapshot()["counters"]
        finally:
            timing.enable(False)
        assert snap["counters"]["init_uncertified"] == plain["init_uncertified"]
        refit = int(traced.bufs["sol.count"].cpu() != traced.bufs["hs.best_count"].cpu())
        assert snap["counters"]["count_refit"] == refit
    else:
        assert not set(NESTED) & set(ops)
    psulvsb_register(src, dst, keep, seed, params)  # the untraced plan
    plain = fused.plan_for(params, c, "cuda")
    assert plain.trace is None and plain.stamp_nodes == plain.mark_nodes == 0
    assert traced.stamp_nodes > 0 and traced.mark_nodes > 0
    assert plain.graph_nodes == traced.graph_nodes - traced.stamp_nodes - traced.mark_nodes
    fused.clear_plan_cache()
    timing.start()
