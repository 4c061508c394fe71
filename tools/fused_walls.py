"""Walls, host traffic and operations of a tree's one-dispatch solve, on one
CUDA card, in a process that has not run torch.profiler before them.

    python tools/fused_walls.py [ROOT] [path ... | sweep | nodes]

ROOT (default: this checkout) is a checkout of the repository, for example
a `git archive` of the parent commit unpacked under build/. The script
imports ROOT's own chip_smoke.py and psulvsb_tpu_torch and, for each of
the paths of ROOT's chip_smoke `FUSED_PATHS` (or those named that it has),
builds the path's plan with two solves, then times 5 solves of chip_smoke's
phase 13 seeds in turns, staged `psulvsb_solve` and `psulvsb_register`
(staged, fused, fused, staged; the wall of each to a device
synchronization), and reads the plan's stats after each fused solve:
graph launches (or, in a tree whose solve replays segments, replays) and
host reads a solve, the plan's build seconds, graph nodes and bytes where
the tree reports them. Then `register_batch` at B = 32 on the anchor
protocol, in order and with pairs in flight, in turns. Last, for each path,
torch.profiler over 3 fused solves: device operations and host-issued
operations (kernel, graph, copy and fill calls) a solve.

With the word `sweep` among the paths the script times chip_smoke's phase
19 dataset sweep instead, by bucket group: its scene is written, each
bucket's plan built, and for each pad bucket in turn
eval.batch_harness.run_scene_batched runs over three of the bucket's pairs
at the phase's ddtime, at known and at unknown scale, once to warm and then
twice timed: the wall a solve of each group (no profiler in the process).

With the word `nodes` the script measures the conditional nodes alone
(solver/conditional.py): graphs of 2100 dependent one-element additions,
flat, in 30 taken IF bodies, and flat beside 20 or 200 untaken IF nodes;
the device time a replay (CUDA events, 20 replays) and the host's time to
issue one, so the cost of a node taken or not.

Every timed figure comes before the first profiler session: a process that
had run torch.profiler launched a graph with many conditional nodes about
twice as slow as a fresh one. Printed with the card's name and power
limit. Compare two trees only within one call of this script each, in
turns (parent, change, change, parent).
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SEEDS = [100 + i for i in range(cs.N_TIMED_SOLVES)]
BATCH = 32


def plan_stats(plan) -> dict:
    stats = dict(plan.stats)
    launches = stats.get("graph_launches", stats.get("graph_replays"))
    return {"graph_launches": launches, "host_reads": stats["host_reads"]}


def plan_figures(plan) -> dict:
    return {name: getattr(plan, name) for name in
            ("build_s", "capture_s", "instantiate_s", "graph_nodes", "conditional_nodes",
             "nbytes") if hasattr(plan, name)}


def path_walls(name, device) -> dict:
    from psulvsb_tpu_torch import psulvsb_solve
    from psulvsb_tpu_torch.solver.fused import plan_for, psulvsb_register

    params, case, _, _ = cs.fused_case(name)
    src, dst, keep = cs.on_device(case, device)
    plan = plan_for(params, src.shape[1], device)

    def staged(seed):
        return psulvsb_solve(src, dst, keep, params,
                             torch.Generator(device=device).manual_seed(seed))

    def fused(seed):
        return psulvsb_register(src, dst, keep, seed, params)

    fused(0)
    fused(1)
    traffic = []
    for seed in SEEDS:
        fused(seed)
        traffic.append(plan_stats(plan))
    staged(0)
    turns = [cs.timed_walls(f, SEEDS) for f in (staged, fused, fused, staged)]
    med = [statistics.median(t) for t in turns]
    return {
        "path": name, "C": src.shape[1], "wall_ms_staged": [med[0], med[3]],
        "wall_ms_fused": [med[1], med[2]],
        "graph_launches": [t["graph_launches"] for t in traffic],
        "host_reads": [t["host_reads"] for t in traffic], "plan": plan_figures(plan),
    }


def batch_rates(device) -> dict:
    import numpy as np

    from psulvsb_tpu_torch import register_batch
    from psulvsb_tpu_torch.parallel import pairs

    params = cs.path_case("anchor")[0]
    src_np, dst_np = cs.batch_cases("anchor", BATCH)[:2]
    src = torch.as_tensor(src_np, device=device)
    dst = torch.as_tensor(dst_np, device=device)
    keep = torch.ones((BATCH, src.shape[2]), dtype=torch.int64, device=device)
    seeds = [300 + i for i in range(BATCH)]
    # The in-flight form: vectorized=True in a tree that has no batched form.
    in_flight = getattr(pairs, "_register_in_flight", None) or (
        lambda *args: register_batch(*args, vectorized=True))

    def batch(vectorized):
        if vectorized:
            return in_flight(src, dst, keep, seeds, params)
        return register_batch(src, dst, keep, seeds, params)

    batch(False)
    batch(True)
    rates = {"in order": [], "in flight": []}
    for vectorized in (False, True, True, False):
        wall = cs.timed_walls(lambda _: batch(vectorized), [0])[0]
        rates["in flight" if vectorized else "in order"].append(BATCH / (wall * 1e-3))
    return {"batch": "anchor", "B": BATCH, "pairs_per_s": rates,
            "C": int(np.asarray(src_np).shape[2])}


SWEEP_GROUP_PAIRS = 3


def sweep_groups(device, card) -> None:
    import os
    import tempfile

    from psulvsb_tpu_torch.eval import batch_harness, make_dataset, realdata
    from psulvsb_tpu_torch.utils.padding import pad_to_bucket

    params = cs.sweep_params()
    crit = realdata.SuccessCriteria.threedmatch()
    with tempfile.TemporaryDirectory(prefix="psulvsb_sweep_") as root:
        make_dataset.write_benchmark(
            root, [cs.SWEEP_SCENE], n_pairs=cs.SWEEP_PAIRS, n_corr=cs.SWEEP_SIZES, seed=0)
        scene = os.path.join(root, cs.SWEEP_SCENE)
        groups: dict[int, list] = {}
        for a, b in realdata.read_pair_labels(os.path.join(scene, "pairs.txt")):
            c = realdata.read_corr_file(realdata.pair_files(scene, a, b)[0])[0].shape[1]
            groups.setdefault(pad_to_bucket(c), []).append((a, b))
        for unknown, ddtime in ((False, cs.SWEEP_DDTIME), (True, cs.SWEEP_UNKNOWN_DDTIME)):
            run_params = params.replace(estimate_scaling=unknown)
            batch_harness.warm_scene(scene, run_params)
            for bucket, labels in sorted(groups.items()):
                label_file = os.path.join(root, f"group_{bucket}.txt")
                with open(label_file, "w") as f:
                    f.writelines(f"{a} {b}\n" for a, b in labels[:SWEEP_GROUP_PAIRS])

                def run():
                    return batch_harness.run_scene_batched(
                        scene, label_file, run_params, crit, os.path.join(root, "group.csv"),
                        ddtime=ddtime, unknown_scale=unknown, seed=0)

                run()
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    stats = run()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                solves = stats["split"]["solves"]
                print(json.dumps({
                    "sweep": "unknown" if unknown else "known", "bucket": bucket,
                    "pairs": stats["pairs"], "solves": solves, "recall": stats["recall"],
                    "ms_a_solve": [w * 1e3 / solves for w in walls],
                    "solve_s": stats["split"]["solve_s"], "tree": str(ROOT), "card": card}))


def conditional_nodes(device, card) -> None:
    from psulvsb_tpu_torch.solver.conditional import GraphControl

    x = torch.zeros(8, device=device)
    yes = torch.ones((), dtype=torch.bool, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)
    n = 2100

    def adds(k):
        for _ in range(k):
            x.add_(1.0)

    def flat(ctl):
        adds(n)

    def in_ifs(ctl):
        for _ in range(30):
            with ctl.when(yes):
                adds(n // 30)

    def untaken(k):
        def build(ctl):
            adds(n)
            for _ in range(k):
                with ctl.when(no):
                    adds(10)
        return build

    for name, build in (("flat", flat), ("30 taken IFs", in_ifs),
                        ("20 untaken IFs", untaken(20)), ("200 untaken IFs", untaken(200))):
        ctl = GraphControl(device, torch.zeros(1, dtype=torch.int64, device=device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            build(ctl)
        ctl.close()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(json.dumps({"graph": name, "kernels": n, "conditional_nodes": ctl.conditionals,
                          "device_ms_a_replay": start.elapsed_time(end) / 20,
                          "host_ms_to_issue": host_ms, "card": card}))


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_walls: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from psulvsb_tpu_torch import psulvsb_register
    from psulvsb_tpu_torch.utils.precision import pin_float32

    pin_float32()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    cs.build_all()
    asked = sys.argv[2:]
    if "sweep" in asked:
        sweep_groups(device, card)
        return 0
    if "nodes" in asked:
        conditional_nodes(device, card)
        return 0
    paths = [p for p in cs.FUSED_PATHS if not asked or p in asked]
    rows = {}
    for name in paths:
        rows[name] = {**path_walls(name, device), "tree": str(ROOT), "card": card}
        print(json.dumps(rows[name]))
    print(json.dumps({**batch_rates(device), "tree": str(ROOT), "card": card}))
    for name in paths:
        params, case, _, _ = cs.fused_case(name)
        src, dst, keep = cs.on_device(case, device)
        dev_ops, host_ops = cs.profiled_operations(
            lambda: psulvsb_register(src, dst, keep, 7, params))
        print(json.dumps({"path": name, "device_ops": dev_ops, "host_issued_ops": host_ops,
                          "tree": str(ROOT), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
