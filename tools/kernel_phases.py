"""The kernel phases of a tree's chip_smoke.py, and the two redesigned
kernels' front doors timed the same way in any tree, on one CUDA card.

    python tools/kernel_phases.py [ROOT]

ROOT (default: this checkout) is a checkout of the repository, for example
a `git archive` of the parent commit unpacked under build/. The script
imports ROOT's own chip_smoke.py and psulvsb_tpu_torch, builds the
kernels, runs chip_smoke's phase 3 (GNC kernel vs plain) and phase 5
(pair-grid kernels vs plain), then times, at the solve paths' shapes:

- ops.gnc.gnc_batch at (B, N) = (4, 256) (the anchor's batch) and
  (16, 1024), on chip_smoke's gnc_problem inputs;
- ops.hist.exact_peak_bin at C = 1250 (the front end) and 5000 (unknown
  scale), on chip_smoke's hist_inputs (test scale 3.7);

each as a front door (CUDA events, median of 20 calls) and under
torch.profiler (10 calls): the port kernel's launches and device time a
call, and every device operation a call. For the GNC kernel also its cost
an iteration: device time at 1, 2, 5, 10 and 20 forced iterations (a
negative cost threshold never converges), fitted by a line whose slope is
the time an iteration of the longest hypothesis and whose intercept the
rest of a launch. Printed with the card's name and power limit. Compare
two trees only within one call of this script each, in turns (parent,
change, change, parent). The script keeps its own profiler helpers, since
an older tree's chip_smoke.py may lack the ones chip_smoke has now.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPS = 10
FORCED_ITERATIONS = (1, 2, 5, 10, 20)


def device_ops(fn) -> tuple[dict, int]:
    """({device operation name: [microseconds]}, calls) over REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out, REPS


def kernel_us(fn, kernel: str) -> float:
    ops, calls = device_ops(fn)
    return sum(us for name, v in ops.items() if f"{kernel}_kernel" in name for us in v) / calls


def report(label: str, kernel: str, fn) -> None:
    front = cs.median_ms(fn)
    ops, calls = device_ops(fn)
    mine = [us for name, v in ops.items() if f"{kernel}_kernel" in name for us in v]
    every = [us for v in ops.values() for us in v]
    print(f"[phases] {label}: front door {front:.4f} ms (median of 20, CUDA events); "
          f"{len(mine) / calls:.1f} {kernel} launches a call, {sum(mine) / calls:.2f} us of "
          f"its device time a call (mean {statistics.mean(mine):.2f} us a launch); "
          f"{len(every) / calls:.1f} device operations a call, {sum(every) / calls:.2f} us")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    from psulvsb_tpu_torch.ops import gnc, hist
    from psulvsb_tpu_torch.utils.precision import pin_float32

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"[phases] tree {ROOT}; card: {card}")
    pin_float32()
    cs.build_all()
    cs.phase_kernel_vs_plain(device)
    cs.phase_pair_kernels(device)

    rng = np.random.default_rng(0)
    for b, n in ((4, 256), (16, 1024)):
        args = cs.gnc_problem(rng, b, n, device) + (False,)
        report(f"gnc_batch B={b} N={n}", "gnc_batch", lambda: gnc.gnc_batch(*args, **cs.LOOP))
        loop = dict(cs.LOOP, cost_threshold=-1.0)
        us = [kernel_us(lambda: gnc.gnc_batch(*args, **dict(loop, max_iterations=i)), "gnc_batch")
              for i in FORCED_ITERATIONS]
        slope, intercept = np.polyfit(FORCED_ITERATIONS, us, 1)
        print(f"[phases] gnc_batch B={b} N={n} forced iterations "
              + ", ".join(f"{i}: {u:.2f} us" for i, u in zip(FORCED_ITERATIONS, us))
              + f"; {slope:.3f} us an iteration + {intercept:.2f} us")
    for c in (1250, 5000):
        src, dst, act = cs.hist_inputs(c, c, device, 3.7)
        report(f"exact_peak_bin C={c}", "pair_ratio_hist",
               lambda: hist.exact_peak_bin(src, dst, act))
    print(f"[phases] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
