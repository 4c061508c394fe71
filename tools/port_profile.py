"""Device-time breakdown of the PyTorch port's solve paths on one CUDA card.

    python tools/port_profile.py [anchor|unknown|gror|frontend|wide ...]

For each named path, two warm-up solves, then 5 solves through
RobustRegistrationSolver under torch.profiler (CPU and CUDA activities).
Printed per path: the card, the wall time of the profiled solves, the
device busy time per solve (the sum of the kernel events' durations; one
stream, so they do not overlap) and its share of the wall time, device
operations and kernel-launch calls per solve, the kernels that took the
most device time, and each of the port's own kernels' launches per solve
and device time per launch. The paths are chip_smoke.py's (`path_case`):

- anchor: SolverParams.preset_anchor() on the bench anchor pair (C = 1889,
  90% displaced outliers, noise 0.05);
- unknown: the unknown-scale 3DMatch protocol (C = 5000, 85% mismatch
  outliers, noise 0.01, data seed 5) through preset_3dmatch with scale
  estimation and the clique stages off;
- gror: SolverParams.preset_artificial_gror() at the caps on the anchor pair;
- frontend: eval.frontend_protocol.frontend_solver_params() at the caps on
  tests/data/frontend_aliasing/pair_seed1375 (C = 1250);
- wide: SolverParams.preset_anchor() on the anchor protocol at C = 12000,
  beyond the dense init: the "exact_beta" route (not in the default list).
"""

from __future__ import annotations

import collections
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import KERNELS, card_line, path_case  # noqa: E402
from psulvsb_tpu_torch import RobustRegistrationSolver  # noqa: E402

N_SOLVES = 5


def profile_path(name, device, card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params, (src, dst, _) = path_case(name)
    src = torch.as_tensor(src, device=device)
    dst = torch.as_tensor(dst, device=device)
    for seed in (0, 1):
        RobustRegistrationSolver(params, seed=seed, device=device).solve(src, dst)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for seed in range(100, 100 + N_SOLVES):
            RobustRegistrationSolver(params, seed=seed, device=device).solve(src, dst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                    "cudaLaunchKernelExC"))
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    per = N_SOLVES
    print(f"[{name}] card: {card}; {per} solves in {wall * 1e3:.2f} ms of wall "
          f"({wall * 1e3 / per:.2f} ms a solve); device busy {busy_us / 1e3 / per:.3f} ms a "
          f"solve, {100 * busy_us / 1e6 / wall:.1f}% of wall; {len(kernels) / per:.0f} device "
          f"operations and {launches / per:.0f} kernel-launch calls a solve")
    for kname, us in by_name.most_common(8):
        print(f"[{name}]   {100 * us / busy_us:5.1f}%  {us / 1e3 / per:.3f} ms a solve  "
              f"{kname[:110]}")
    for kernel in KERNELS:
        runs = [e.time_range.elapsed_us() for e in kernels if f"{kernel}_kernel" in e.name]
        if runs:
            print(f"[{name}] port kernel {kernel}: {len(runs) / per:.1f} launches a solve, "
                  f"{statistics.mean(runs):.2f} us of device time a launch "
                  f"(median {statistics.median(runs):.2f}), "
                  f"{100 * sum(runs) / busy_us:.2f}% of device time")


def main() -> int:
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    for name in sys.argv[1:] or ["anchor", "unknown", "gror", "frontend"]:
        profile_path(name, device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
