"""Pairs per second of `register_batch`'s three forms, in turns, and the
batched form's figures, on one CUDA card.

    python tools/pair_batch_forms.py [case ...]

Cases (default: all): anchor8, anchor32, anchor128 (the anchor protocol at
B = 8, 32, 128), unknown8 (the unknown-scale protocol, C = 5000, scale
estimated), bucket4096, bucket6144, bucket8192 (B = 8 of the 3DMatch
protocol at known scale padded to the sweep's buckets, the sweep's preset
with clique "auto"), lazy8192 (B = 8 of the lazy seed's path at the 8192
bucket, scale estimated, 95% outliers: pairs whose rounds and batches differ
most), and the settings beyond the dense init: gror8 (the GROR preset at its
defaults on the anchor protocol), wide_beta8 and wide_hist8 (the anchor and
unknown-scale protocols at C = 12000: exact_beta, exact_hist), fgr8 and
eigh8 (the anchor protocol with FGR or the "eigh" GNC), exact_clique4 (the
hostile pair's protocol with the exact clique callback, B = 4, the native
search on one thread; its plans run eagerly); the pairs are chip_smoke's
`batch_cases`, a pair a seed. The cases
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
operations a pair in order and batched at B <= 8 but FGR, on the same plans
run eagerly (torch.profiler over one call; chip_smoke's BATCH_PROFILED says
why not on the graphs).
Before the device operations, the four kernels' pair axes at P = 1 and 8
(chip_smoke's `gnc_pair_axis`, `peak_pair_axis`, `beta_pair_axis`,
`degree_pair_axis`): device time a launch and the bound. One JSON line a case, with the card's
name and power limit.
"""

from __future__ import annotations

import contextlib
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
         "lazy8192": ("lazy8192", 8), "gror8": ("gror", 8), "wide_beta8": ("wide_beta", 8),
         "wide_hist8": ("wide_hist", 8), "fgr8": ("fgr", 8), "eigh8": ("eigh", 8),
         "exact_clique4": ("exact_clique", 4)}
FORMS = ("in order", "in flight", "batched")
PROFILED_B = 8  # device operations are counted on the cases of B <= 8 only
# The forms whose device operations are counted (the in-flight form runs the
# in-order form's plans), on those plans run eagerly: chip_smoke's
# BATCH_PROFILED says why. FGR's eager profile does not end in minutes.
PROFILED_FORMS = ("in order", "batched")
NOT_PROFILED = ("fgr8",)


def case_batch(name, b, device):
    """(batch(form), C, params) of a case: its pairs on the card and one call
    of register_batch in a form."""
    from psulvsb_tpu_torch import register_batch
    from psulvsb_tpu_torch.parallel.pairs import _register_in_flight

    src_np, dst_np, keep_np, _, params = cs.batch_cases(name, b)
    src = torch.as_tensor(src_np, device=device)
    dst = torch.as_tensor(dst_np, device=device)
    keep = torch.as_tensor(keep_np, device=device)
    seeds = [300 + i for i in range(b)]

    def batch(form, graphs=True):
        if form == "in flight":
            return _register_in_flight(src, dst, keep, seeds, params, graphs=graphs)
        return register_batch(src, dst, keep, seeds, params, vectorized=form == "batched",
                              graphs=graphs)

    return batch, src.shape[2], params


def search_for(name):
    """The exact clique's batches search on one thread (chip_smoke's rule)."""
    return cs.one_thread_search() if name == "exact_clique" else contextlib.nullcontext()


def run_case(name, b, device, card) -> dict:
    from psulvsb_tpu_torch import RegistrationSolution
    from psulvsb_tpu_torch.parallel.pairs import pairs_per_chunk
    from psulvsb_tpu_torch.solver.fused import plan_for

    batch, c, params = case_batch(name, b, device)
    sols = {form: batch(form) for form in FORMS}
    p = pairs_per_chunk(c, b, device, params)
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
    return row


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("pair_batch_forms: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from psulvsb_tpu_torch.solver.fused import clear_plan_cache
    from psulvsb_tpu_torch.utils.precision import pin_float32

    device = torch.device("cuda", 0)
    card = cs.card_line()
    pin_float32()
    cs.build_all()
    names = argv or list(CASES)
    for key in names:
        name, b = CASES[key]
        with search_for(name):
            print(json.dumps(run_case(name, b, device, card)), flush=True)
    # The kernels' pair axes before the long profiles: late in a process that
    # has recorded many windows, torch.profiler may record no launch at all.
    rng = np.random.default_rng(0)
    axes = {"gnc_pair_axis": cs.gnc_pair_axis(rng, device),
            "peak_pair_axis": cs.peak_pair_axis(device),
            "beta_pair_axis": cs.beta_pair_axis(device),
            "degree_pair_axis": cs.degree_pair_axis(device)}
    print(json.dumps({**{name: {str(k): v for k, v in axis["times"].items()}
                            for name, axis in axes.items()}, "card": card}))
    # The profiler comes after every wall, over the eager plans; a form's
    # plans are built by the call before the profiled one, one form's plans
    # alive at a time.
    for key in names:
        name, b = CASES[key]
        if b > PROFILED_B or key in NOT_PROFILED:
            continue
        batch, _, _ = case_batch(name, b, device)
        ops = {}
        with search_for(name):
            for form in PROFILED_FORMS:
                clear_plan_cache()
                ops[form] = cs.profiled_operations(lambda: batch(form, graphs=False),
                                                   reps=1, host=False)[0] / b
        print(json.dumps({"case": key, "device_ops_a_pair_eager": ops, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
