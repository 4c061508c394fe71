"""The program's tracing on the card (psulvsb_tpu_torch/utils/timing.py):
its clock, what it costs, and what it shows.

    python3 tools/trace_probe.py clock
    python3 tools/trace_probe.py cost --cells kitti.online,kitti.inorder --seeds 1,2,3 --seconds 20
    python3 tools/trace_probe.py modes --builds 8 --seconds 6
    python3 tools/trace_probe.py export --seconds 2
    python3 tools/trace_probe.py nodes --cells 3dmatch.inorder,kitti.inorder --seed 1
    python3 tools/trace_probe.py setup --cell kitti.online --seed 1
    python3 tools/trace_probe.py share --cells kitti.online,3dmatch.inorder --seconds 10
    python3 tools/trace_probe.py builds --cells 3dmatch.vectorized8192 --seed 1 --seconds 20

from the root of a checkout with a card. Each mode prints JSON lines and
writes them to <out>/<mode>.jsonl (`--out`, build/trace_probe by default).

- clock: `%globaltimer`'s resolution (the smallest non-zero difference
  between consecutive stamps, in a graph of back-to-back stamp kernels and
  in eager launches), and the calibration of the host clock against it over
  windows of 2 s: residual, half-width, drift;
- cost: cells of cardbench run as `--trace 0` runs them (the same readers),
  in turns with the program's tracing off and on, the same seeds; a traced
  turn's snapshot of its own window (`at_window=timing.start`) gives its
  per-layer readings and the breakdown;
- modes: the plans of one cell (kitti.inorder by default) built again and
  again in one process with one seed, each build's window traced: the
  pairs a second and each stage's device ms a pair, to tell a plan build's
  two speeds apart by stage;
- export: `timing.trace` over a window of kitti.online's requests, the
  Chrome trace kept under <out>/export/;
- nodes: graph nodes of the untraced and traced plans that each cell's
  traffic builds in its set-up (`--cells`, `--seed`), with the conditional
  nodes, the stamps and the launch marks a traced plan captures (on a
  program without tracing: the untraced plans alone), and the launches of
  each kernel the graph holds (`captured_launches`, where the program
  keeps them: finalize_fit once a plan);
- setup: one cell's set-up in this process, as cardbench/run.py times it
  from the process's start, split: the imports, the pool, each warm-up
  call of a traffic that makes them one by one (kitti.online; the first
  of a size builds its plan: build, capture, instantiate) and the plans'
  own figures. One process is one reading: run it once a process;
- share: one traced window of each cell, its readings (as `cost` prints a
  traced turn's) with the fused-route share of its local batches: the
  local batch kernels' launches in the window, counted on the device,
  over the window's local batches (a vectorized cell launches once a
  chunk's batch, for its P pairs), the finalize and the beta count kernels'
  launches over the window's solves (a chunk's solve in a vectorized cell;
  the beta count runs on the "exact_beta" init route alone). Every traced
  turn prints the shares;
- builds: one untraced run of each cell as `--trace 0` runs it, with the
  plans built counted in the set-up and inside the window, the plans
  resident at the window's end, each plan's `nbytes` and `plan_bytes`
  estimate, and the card's free memory at the window's start and its
  allocation peak.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()  # the setup mode's clock starts here, as cardbench/run.py's

ROOT = Path(__file__).resolve().parents[1]


def emit(mode: str, row: dict) -> None:
    out = Path(ARGS.out)
    out.mkdir(parents=True, exist_ok=True)
    line = json.dumps(row, default=float)
    print(line, flush=True)
    with open(out / f"{mode}.jsonl", "a") as f:
        f.write(line + "\n")


def _timing():
    from psulvsb_tpu_torch.utils import timing

    return timing if hasattr(timing, "snapshot") else None


def clock(args) -> None:
    import torch

    from psulvsb_tpu_torch.utils import timing
    from psulvsb_tpu_torch.utils.timing import launch_stamp

    dev = torch.device("cuda", 0)
    n = 1024
    buf = torch.zeros(3 * n + timing.RECORD_HEAD, dtype=torch.int64, device=dev)
    launch_stamp(buf, 0, False, n)  # builds and loads the library
    torch.cuda.synchronize(dev)
    side = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for k in range(n):
            launch_stamp(buf, k, False, n)
    for form in ("graph", "eager"):
        buf.zero_()
        if form == "graph":
            graph.replay()
        else:
            for k in range(n):
                launch_stamp(buf, k, False, n)
        torch.cuda.synchronize(dev)
        t = buf[:n].tolist()
        diffs = [b - a for a, b in zip(t, t[1:])]
        nonzero = [d for d in diffs if d > 0]
        emit("clock", {"what": "resolution", "form": form, "stamps": n,
                       "min_nonzero_ns": min(nonzero) if nonzero else None,
                       "zero_diffs": sum(1 for d in diffs if d == 0),
                       "median_ns": statistics.median(diffs),
                       "distinct_smallest": sorted(set(nonzero))[:8],
                       "mod_32": sorted({d % 32 for d in nonzero})[:8],
                       "mod_1000": sorted({d % 1000 for d in nonzero})[:8]})
    a = torch.ones((2048, 2048), device=dev)
    for k in range(args.windows):
        timing.enable(True)
        timing.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize(dev)
        snap = timing.snapshot()
        timing.enable(False)
        emit("clock", {"what": "calibration", "window_s": args.seconds, **snap["calibration"]})


ARGS = argparse.Namespace(root=ROOT, device="cuda", out=ROOT / "build" / "trace_probe")


def _cell(name: str):
    from cardbench import harness

    return harness.Cell(Path(ARGS.root), name)


def _device():
    import torch

    return torch.device(ARGS.device, 0) if ARGS.device == "cuda" else torch.device("cpu")


def _traced_turn(cell, seed: int, seconds: float, timing):
    """One `--trace 0` run of the cell with the program's tracing on and
    the window snapshotted; (result, snapshot, the window's records)."""
    from cardbench import harness

    got = {}

    def at_window():
        got["launches"] = _launches()
        timing.start()

    def after(run):
        got["snap"] = timing.snapshot()
        got["records"] = list(run.records)
        got["launches"] = {k: v - got["launches"].get(k, 0) for k, v in _launches().items()}

    timing.enable(True)
    try:
        res = harness.run_cell(cell, seed, seconds, False, _device(),
                               time.perf_counter(), at_window=at_window, after_window=after)
    finally:
        timing.enable(False)
    snap = dict(got["snap"], launches=got["launches"])
    return res, snap, got["records"]


def _launches() -> dict:
    """The kernels' launch counts, the traced plans' device counts added."""
    from psulvsb_tpu_torch.ops._build import LAUNCHES
    from psulvsb_tpu_torch.solver import fused

    fused.flush_launch_counts()
    return dict(LAUNCHES)


def fused_route(snap) -> dict:
    """The window's local batch kernel launches against its local batches,
    and its finalize and beta count kernel launches against its solves (a
    vectorized cell's solve is a chunk's)."""
    launches = snap.get("launches", {})
    batches = snap["counters"]["local_batches"]
    solves = snap["counters"]["solves"]
    accept = launches.get("local_accept")
    fit = launches.get("finalize_fit")
    beta = launches.get("pair_beta_count")
    return {"local_pick_launches": launches.get("local_pick"), "local_accept_launches": accept,
            "local_batches": batches,
            "share": None if accept is None or not batches else accept / batches,
            "finalize_fit_launches": fit, "solves": solves,
            "finalize_share": None if fit is None or not solves else fit / solves,
            "pair_beta_count_launches": beta,
            "beta_share": None if beta is None or not solves else beta / solves}


def _readings(snap, records, seconds: float) -> dict:
    from cardbench import tracing
    from psulvsb_tpu_torch.utils import timing

    reading = {"snap": snap, "records": records, "seconds": seconds}
    return {
        "fused_route": fused_route(snap),
        "solve_ms_per_pair": tracing.solve_ms_per_pair(snap),
        "control_pct": tracing.control_pct(snap),
        "local_batches_per_pair": tracing.local_batches_per_pair(snap),
        "prefilter_ms": tracing.prefilter_ms(snap),
        "gap_pct": tracing.gap_pct(snap),
        "agreement": tracing.agreement(reading),
        "counters": snap["counters"],
        "calibration": {k: snap["calibration"][k] for k in
                        ("residual_ns", "halfwidth_ns", "drift_ppm")},
        "breakdown": timing.breakdown(snap),
        "window_device_s": tracing.window_ns(snap) / 1e9,
    }


def cost(args) -> None:
    from cardbench import harness

    timing = _timing()
    seeds = [int(s) for s in args.seeds.split(",")]
    for name in args.cells.split(","):
        cell = _cell(name)
        for k, seed in enumerate(seeds):
            order = (False, True) if k % 2 == 0 else (True, False)
            for on in order:
                if on:
                    res, snap, records = _traced_turn(cell, seed, args.seconds, timing)
                    extra = _readings(snap, records, args.seconds)
                else:
                    res = harness.run_cell(cell, seed, args.seconds, False, _device(),
                                           time.perf_counter())
                    extra = {}
                emit("cost", {"cell": name, "seed": seed, "trace": on, "card": harness.card_line(),
                              "correct": res["correct"],
                              "metrics": {m: v["value"] for m, v in res["metrics"].items()},
                              **extra})


def modes(args) -> None:
    from cardbench import harness, tracing

    timing = _timing()
    cell = _cell(args.cell)
    for k in range(args.builds):
        res, snap, records = _traced_turn(cell, args.seed, args.seconds, timing)
        pairs = snap["counters"]["pairs"]
        stages = {name: v["ns"] / 1e6 / pairs for name, v in snap["device"].items()} \
            if pairs else {}
        emit("modes", {"cell": args.cell, "build": k, "seed": args.seed,
                       "card": harness.card_line(),
                       "pairs_per_s": res["metrics"]["pairs_per_s"]["value"],
                       "ms_per_pair": stages, "counters": snap["counters"],
                       "fused_route": fused_route(snap),
                       "gap_pct": tracing.gap_pct(snap)})


def share(args) -> None:
    from cardbench import harness

    timing = _timing()
    for name in args.cells.split(","):
        res, snap, records = _traced_turn(_cell(name), args.seed, args.seconds, timing)
        emit("share", {"cell": name, "seed": args.seed, "card": harness.card_line(),
                       "correct": res["correct"],
                       "metrics": {m: v["value"] for m, v in res["metrics"].items()},
                       **_readings(snap, records, args.seconds)})


def export(args) -> None:
    import torch

    from cardbench import harness

    timing = _timing()
    cell = _cell("kitti.online")
    run = harness.Run(cell, args.seed, _device(), False)
    run.traffic = cell.traffic_class()(run)
    timing.enable(True)
    try:
        run.traffic.setup()
        out = Path(ARGS.out) / "export"
        i = 0
        with timing.trace(str(out)):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                run.traffic.request(i)
                i += 1
            if run.cuda:
                torch.cuda.synchronize()
    finally:
        timing.enable(False)
        run.traffic.release()
    name = sorted(out.iterdir())[-1]
    data = json.loads(name.read_text())
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    names = {}
    for e in events:
        names.setdefault(f"pid{e['pid']}", set()).add(e["name"])
    emit("export", {"file": str(name), "requests": i, "events": len(events),
                    "names": {k: sorted(v) for k, v in names.items()},
                    "span_ms": max(e["ts"] + e["dur"] for e in events) / 1e3,
                    "calibration": data["otherData"]["calibration"]})


def nodes(args) -> None:
    import torch

    from cardbench import harness

    timing = _timing()
    for name in args.cells.split(","):
        cell = _cell(name)
        for traced in ((False, True) if timing is not None else (False,)):
            run = harness.Run(cell, args.seed, _device(), False)
            traffic = run.traffic = cell.traffic_class()(run)
            if timing is not None:
                timing.enable(traced)
            try:
                traffic.setup()
                if run.cuda:
                    torch.cuda.synchronize()
                for plan in traffic.plans():
                    emit("nodes", {"cell": name, "c": plan.c, "pairs": plan.pairs,
                                   "traced": traced, "graph_nodes": plan.graph_nodes,
                                   "conditional_nodes": plan.conditional_nodes,
                                   "stamp_nodes": getattr(plan, "stamp_nodes", None),
                                   "mark_nodes": getattr(plan, "mark_nodes", None),
                                   "captured_launches": getattr(plan, "captured_launches",
                                                                None),
                                   "tree": args.tree})
            finally:
                if timing is not None:
                    timing.enable(False)
                traffic.release()


def setup(args) -> None:
    import torch

    from cardbench import harness
    from psulvsb_tpu_torch.ops import _build

    imports_s = time.perf_counter() - T_START
    cell = _cell(args.cell)
    run = harness.Run(cell, args.seed, _device(), False)
    traffic = run.traffic = cell.traffic_class()(run)
    steps = []

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            if run.cuda:
                torch.cuda.synchronize()
            steps.append({"step": name, "args": [x for x in a if isinstance(x, int)][:2],
                          "s": time.perf_counter() - t0})
            return out
        return call

    traffic.make_pool = timed("pool", traffic.make_pool)
    if hasattr(traffic, "_call"):
        traffic._call = timed("call", traffic._call)
    traffic.setup()
    plans = [{**harness.plan_summary(p), "instantiate_s": p.instantiate_s,
              "graph_nodes": p.graph_nodes} for p in traffic.plans()]
    if run.cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    emit("setup", {"cell": args.cell, "seed": args.seed, "tree": args.tree,
                   "card": harness.card_line(), "setup_s": setup_s, "imports_s": imports_s,
                   "steps": steps, "plans": plans,
                   "library_build_s": {k: v["seconds"] for k, v in _build.BUILD_INFO.items()}})
    traffic.release()


def builds(args) -> None:
    import torch

    from cardbench import harness
    from psulvsb_tpu_torch.solver import fused

    built = [0]
    init = fused.ReplayPlan.__init__

    def counted(self, *a, **kw):
        built[0] += 1
        init(self, *a, **kw)

    for name in args.cells.split(","):
        cell = _cell(name)
        got = {}

        def at_window():
            got["setup"] = built[0]
            got["free_gib"] = (torch.cuda.mem_get_info()[0] / 2**30
                               if torch.cuda.is_available() else None)

        def after(run):
            got["window"] = built[0] - got["setup"]
            got["resident"] = [{**harness.plan_summary(p),
                                "estimate": fused.plan_bytes(p.params, p.c, p.pairs)}
                               for p in fused._PLANS.values()]

        built[0] = 0
        fused.ReplayPlan.__init__ = counted
        try:
            res = harness.run_cell(cell, args.seed, args.seconds, False, _device(),
                                   time.perf_counter(), at_window=at_window, after_window=after)
        finally:
            fused.ReplayPlan.__init__ = init
        emit("builds", {"cell": name, "seed": args.seed, "tree": args.tree,
                        "card": harness.card_line(), "correct": res["correct"],
                        "metrics": {m: v["value"] for m, v in res["metrics"].items()},
                        "memory_peak_gib": res["device"]["memory_peak_bytes"] / 2**30,
                        "plans_built_in_setup": got["setup"],
                        "plans_built_in_window": got["window"],
                        "free_gib_at_window": got["free_gib"], "resident": got["resident"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("clock", "cost", "modes", "export", "nodes", "setup", "share",
                                     "builds"))
    ap.add_argument("--cells", default="kitti.online,kitti.inorder,3dmatch.inorder,"
                                        "3dmatch.vectorized")
    ap.add_argument("--cell", default="kitti.inorder")
    ap.add_argument("--seeds", default="9100000001,9100000002,9100000003")
    ap.add_argument("--seed", type=int, default=9100000004)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--builds", type=int, default=8)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--tree", default="change")
    ap.add_argument("--root", default=str(ROOT), help="the tree whose cardbench/ runs")
    ap.add_argument("--device", default="cuda", help="cpu rehearses a mode at a tiny size")
    ap.add_argument("--out", default=str(ARGS.out), help="where the JSON lines and traces go")
    args = ap.parse_args(argv)
    ARGS.root, ARGS.device, ARGS.out = args.root, args.device, args.out
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_probe needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    globals()[args.mode](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
