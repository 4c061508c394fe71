"""The kernel phases of a tree's chip_smoke.py, and the four kernels' front
doors timed the same way in any tree, on one CUDA card.

    python tools/kernel_phases.py [ROOT]

ROOT (default: this checkout) is a checkout of the repository, for example
a `git archive` of the parent commit unpacked under build/. The script
imports ROOT's own chip_smoke.py and psulvsb_tpu_torch, builds the
kernels, runs chip_smoke's phase 3 (GNC kernel vs plain), phase 5
(pair-grid kernels vs plain), phase 8 (consistency degree vs plain) and,
where ROOT's chip_smoke has it, the local batch's phase (the pick and
accept kernels of csrc/local_batch.cu against their plain chain at the
cells' buckets, P = 1 and 8) and the finalize's phase (the finalize_fit
kernel of csrc/finalize_fit.cu against its plain chain, the same buckets
and pair counts), then times, at the solve paths' shapes:

- ops.gnc.gnc_batch at (B, N) = (4, 256) (the anchor's batch) and
  (16, 1024), on chip_smoke's gnc_problem inputs;
- ops.hist.exact_peak_bin at C = 1250 (the front end) and 5000 (unknown
  scale), on chip_smoke's hist_inputs (test scale 3.7);
- ops.pairs.consistency_degree (tau 0.1) at C = 1250 (the front end), 1889
  (the anchor pair) and 8192, on chip_smoke's degree_inputs, and
  ops.hist.pair_beta_count (beta 0.1) at C = 5000, 12000 (the wide path)
  and 16384, on chip_smoke's hist_inputs (test scale 1): each with the
  input's mask (about 80% of the points active), with a mask of ones (what
  a solve passes) and on the active points alone with a mask of ones (what
  a compaction of the active points inside the launch could reach at best);
- where ROOT's csrc/pair_beta_count.cu knows the macro BETA_EXACT_ONLY, the
  beta count built with it (the exact test on every pair, no fast test), a
  library of its own under build/, at the same sizes with every point
  active;

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

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPS = 10
FORCED_ITERATIONS = (1, 2, 5, 10, 20)


def device_ops(fn) -> tuple[dict, int]:
    """({device operation name: [microseconds]}, calls) over REPS calls. The
    profiler now and then loses a window's device records: a window with
    fewer device operations than calls is taken again, up to six times; it
    is idle for a while at both ends, as chip_smoke's is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if sum(len(v) for v in out.values()) >= REPS:
            break
        print("[phases] the profiler lost a window's device records: again")
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
          f"its device time a call (mean {statistics.mean(mine or [float('nan')]):.2f} us a "
          f"launch); "
          f"{len(every) / calls:.1f} device operations a call, {sum(every) / calls:.2f} us")


def masked_cases(src, dst, act):
    """(label, src, dst, mask) of a pair-grid input: as it comes, with every
    point active, and its active points alone."""
    ones = torch.ones_like(act)
    s, d = src[:, act].contiguous(), dst[:, act].contiguous()
    return [
        (f"{int(act.sum())} of {act.shape[0]} active", src, dst, act),
        ("all active", src, dst, ones),
        (f"its {s.shape[1]} active points alone", s, d, ones[: s.shape[1]]),
    ]


def exact_only_beta_count():
    """ROOT's beta-count kernel built with -DBETA_EXACT_ONLY, or None where
    the source does not know the macro."""
    from psulvsb_tpu_torch.ops import _build, hist

    src = _build.CSRC_DIR / "pair_beta_count.cu"
    if "BETA_EXACT_ONLY" not in src.read_text():
        return None
    out = _build.BUILD_DIR / "libpair_beta_count-exact-only.so"
    subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DBETA_EXACT_ONLY", "-I", str(_build.CSRC_DIR),
         "-o", str(out), str(src)],
        check=True, capture_output=True,
    )
    fn = ctypes.CDLL(str(out)).pair_beta_count_launch
    fn.restype = ctypes.c_int
    fn.argtypes = hist._BETA_ARGTYPES
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    from psulvsb_tpu_torch.ops import _build, gnc, hist, pairs
    from psulvsb_tpu_torch.utils.precision import pin_float32

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"[phases] tree {ROOT}; card: {card}")
    pin_float32()
    cs.build_all()
    cs.phase_kernel_vs_plain(device)
    cs.phase_pair_kernels(device)
    cs.phase_degree_kernel(device)
    if hasattr(cs, "phase_local_batch"):
        cs.phase_local_batch(device, card)
    if hasattr(cs, "phase_finalize_fit"):
        cs.phase_finalize_fit(device, card)

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
    for c in (1250, 1889, 8192):
        for label, s, d, a in masked_cases(*cs.degree_inputs(c, c, device)):
            report(f"consistency_degree C={c}, {label}", "consistency_degree",
                   lambda: pairs.consistency_degree(s, d, 0.1, a))
    beta_cases = [(c, case) for c in (5000, 12000, 16384)
                  for case in masked_cases(*cs.hist_inputs(c, c, device, 1.0))]
    for c, (label, s, d, a) in beta_cases:
        report(f"pair_beta_count C={c}, {label}", "pair_beta_count",
               lambda: hist.pair_beta_count(s, d, 0.1, a))
    exact_only = exact_only_beta_count()
    if exact_only is not None:
        _build._LAUNCHERS["pair_beta_count"] = exact_only
        for c, (label, s, d, a) in beta_cases:
            if label != "all active":
                continue
            report(f"pair_beta_count built with BETA_EXACT_ONLY, C={c}, {label}",
                   "pair_beta_count", lambda: hist.pair_beta_count(s, d, 0.1, a))
    print(f"[phases] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
