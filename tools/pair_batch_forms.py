"""Pairs per second of `register_batch`'s three forms, in turns, and the
batched form's figures, on one CUDA card.

    python tools/pair_batch_forms.py [case ...]

Cases (default: all): anchor8, anchor32, anchor128 (the anchor protocol at
B = 8, 32, 128), unknown8 (the unknown-scale protocol, C = 5000, scale
estimated), bucket4096, bucket6144, bucket8192 (B = 8 of the 3DMatch
protocol at known scale padded to the sweep's buckets, the sweep's preset
with clique "auto"), lazy8192 (B = 8 of the lazy seed's path at the 8192
bucket, scale estimated, 95% outliers: pairs whose rounds and batches differ
most); the pairs are chip_smoke's `batch_cases`, a pair a seed. The cases
run one after another in one process, and the plan cache makes room for
each case's plans by itself. For each case: the inputs on the card, each
form called once (its plans built and captured), then one call of each form timed in turns, in
order, in flight, batched, batched, in flight, in order (host wall to a
device synchronization): pairs per second. Every batched pair is held to
its in-order row (which is its solve alone): valid and inlier count equal,
rotation, translation and scale within chip_smoke.BATCH_TOL. The batched
plan's P, device bytes, build, capture and instantiate seconds and graph
nodes, and the graph launches of one call. After every wall (a process that
has run torch.profiler launches conditional graphs slower): device
operations a pair of each form at B = 8 (torch.profiler over one call).
Last, the GNC and histogram kernels' pair axes at P = 1 and 8
(chip_smoke's `gnc_pair_axis`, `peak_pair_axis`): device time a launch and
the bound. One JSON line a case, with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CASES = {"anchor8": ("anchor", 8), "anchor32": ("anchor", 32), "anchor128": ("anchor", 128),
         "unknown8": ("unknown", 8), "bucket4096": ("bucket4096", 8),
         "bucket6144": ("bucket6144", 8), "bucket8192": ("bucket8192", 8),
         "lazy8192": ("lazy8192", 8)}
FORMS = ("in order", "in flight", "batched")
PROFILED_B = 8  # device operations are counted on the B = 8 cases only


def run_case(name, b, device, card) -> tuple:
    from psulvsb_tpu_torch import RegistrationSolution, register_batch
    from psulvsb_tpu_torch.parallel.pairs import _register_in_flight, pairs_per_chunk
    from psulvsb_tpu_torch.solver.fused import plan_for

    src_np, dst_np, keep_np, _, params = cs.batch_cases(name, b)
    src = torch.as_tensor(src_np, device=device)
    dst = torch.as_tensor(dst_np, device=device)
    keep = torch.as_tensor(keep_np, device=device)
    c = src.shape[2]
    seeds = [300 + i for i in range(b)]

    def batch(form):
        if form == "in flight":
            return _register_in_flight(src, dst, keep, seeds, params)
        return register_batch(src, dst, keep, seeds, params, vectorized=form == "batched")

    sols = {form: batch(form) for form in FORMS}
    p = pairs_per_chunk(c, b, device)
    plan = plan_for(params, c, device, pairs=p)
    torch.cuda.synchronize()
    worst = 0.0
    for i in range(b):
        got = RegistrationSolution(*(f[i] for f in sols["batched"]))
        want = RegistrationSolution(*(f[i] for f in sols["in order"]))
        if (bool(got.valid) != bool(want.valid)
                or int(got.final_inlier_count) != int(want.final_inlier_count)):
            raise AssertionError(f"{name} B={b}: batched pair {i} differs in valid or count")
        worst = max(worst, cs.solution_difference(got, want))
    if worst > cs.BATCH_TOL:
        raise AssertionError(f"{name} B={b}: a batched pair off its solve alone by {worst}")
    before = plan.graph_launches
    rates = {form: [] for form in FORMS}
    for form in FORMS + FORMS[::-1]:
        wall = cs.timed_walls(lambda _: batch(form), [0])[0]
        rates[form].append(b / (wall * 1e-3))
    stats = plan.stats
    row = {
        "case": f"{name} B={b}", "C": c, "P": p, "pairs_per_s": rates,
        "batched_vs_alone_max_diff": worst,
        "graph_launches_a_call": (plan.graph_launches - before) // 2,
        "rounds": stats["rounds"], "local_batches": stats["local_batches"],
        "seeded": stats["seeded"], "plan": cs.plan_figures(plan), "card": card,
    }
    return row, batch


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("pair_batch_forms: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from psulvsb_tpu_torch.utils.precision import pin_float32

    device = torch.device("cuda", 0)
    card = cs.card_line()
    pin_float32()
    cs.build_all()
    names = argv or list(CASES)
    calls = {}
    for key in names:
        name, b = CASES[key]
        row, batch = run_case(name, b, device, card)
        print(json.dumps(row), flush=True)
        if b == PROFILED_B:
            calls[key] = (b, batch)
    # The profiler comes after every wall; a form's plans are built again by
    # the call before the profiled one.
    from psulvsb_tpu_torch.solver.fused import clear_plan_cache

    def profiled(batch, form, b):
        clear_plan_cache()  # one form's plans alive at a time
        return cs.profiled_operations(lambda: batch(form), reps=1)[0] / b

    for key, (b, batch) in calls.items():
        ops = {form: profiled(batch, form, b) for form in FORMS}
        print(json.dumps({"case": key, "device_ops_a_pair": ops, "card": card}), flush=True)
    rng = np.random.default_rng(0)
    gnc = cs.gnc_pair_axis(rng, device)
    peak = cs.peak_pair_axis(device)
    print(json.dumps({"gnc_pair_axis": {str(k): v for k, v in gnc["times"].items()},
                      "peak_pair_axis": {str(k): v for k, v in peak["times"].items()},
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
