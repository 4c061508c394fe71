"""Device-time breakdown of the PyTorch port's solve paths on one CUDA card.

    python tools/port_profile.py [anchor|unknown|gror|frontend|wide|hostile ...]
    python tools/port_profile.py fused [path ...]
    python tools/port_profile.py batch [path ...]

For each named path, two warm-up solves, then 5 solves through
RobustRegistrationSolver under torch.profiler (CPU and CUDA activities);
after the word `fused` the solves go through solver.fused.psulvsb_register
(replayed CUDA graphs), after `batch` through one
parallel.pairs.register_batch of the 5 pairs in order and one with pairs in
flight (each profiled on its own). The profiler's window is idle for 20 ms
at both ends, and a window that lost device records (fewer launches of a
port kernel than the path's solves made) is taken again.
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

from chip_smoke import (  # noqa: E402
    KERNELS,
    PROFILER_ATTEMPTS,
    PROFILER_MARGIN_S,
    card_line,
    fused_case,
    read_launches,
    reset_launches,
)
from psulvsb_tpu_torch import (  # noqa: E402
    RobustRegistrationSolver,
    psulvsb_register,
    register_batch,
)

N_SOLVES = 5
SEEDS = list(range(100, 100 + N_SOLVES))


def runner(mode, params, src, dst, device):
    """fn(seeds): the path's solves of `seeds` in the given mode."""
    keep = torch.ones(src.shape[1], dtype=torch.int64, device=device)
    if mode == "staged":
        return lambda seeds: [
            RobustRegistrationSolver(params, seed=s, device=device).solve(src, dst) for s in seeds
        ]
    if mode == "fused":
        return lambda seeds: [psulvsb_register(src, dst, keep, s, params) for s in seeds]
    vectorized = mode == "batch in flight"
    return lambda seeds: register_batch(
        src.expand(len(seeds), 3, -1), dst.expand(len(seeds), 3, -1),
        keep.expand(len(seeds), -1), seeds, params, vectorized=vectorized,
    )


def profile_path(name, device, card, mode="staged"):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params, (src, dst, _), _, _ = fused_case(name)
    src = torch.as_tensor(src, device=device)
    dst = torch.as_tensor(dst, device=device)
    solve = runner(mode, params, src, dst, device)
    solve([0, 1])
    solve(SEEDS)  # a replayed path has captured every segment these seeds take
    torch.cuda.synchronize()
    for _ in range(PROFILER_ATTEMPTS):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_MARGIN_S)
            t0 = time.perf_counter()
            solve(SEEDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILER_MARGIN_S)
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        made = read_launches()
        seen = {k: sum(f"{k}_kernel" in e.name for e in kernels) for k in KERNELS}
        if all(seen[k] >= made[k] for k in KERNELS):
            break
        print(f"[{name}] the profiler recorded {seen} of the launches {made}: again")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                    "cudaLaunchKernelExC", "cudaGraphLaunch"))
    name = name if mode == "staged" else f"{name}, {mode}"
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    per = N_SOLVES
    print(f"[{name}] card: {card}; {per} solves in {wall * 1e3:.2f} ms of wall "
          f"({wall * 1e3 / per:.2f} ms a solve); device busy {busy_us / 1e3 / per:.3f} ms a "
          f"solve, {100 * busy_us / 1e6 / wall:.1f}% of wall; {len(kernels) / per:.0f} device "
          f"operations and {launches / per:.0f} kernel- and graph-launch calls a solve")
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
    modes = ["staged"]
    for name in sys.argv[1:] or ["anchor", "unknown", "gror", "frontend"]:
        if name == "fused":
            modes = ["fused"]
        elif name == "batch":
            modes = ["batch in order", "batch in flight"]
        else:
            for mode in modes:
                profile_path(name, device, card, mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
