"""Device-time breakdown of the PyTorch port's solve paths on one CUDA card.

    python tools/port_profile.py [anchor|unknown|gror|frontend|wide|hostile ...]
    python tools/port_profile.py fused [path ...]
    python tools/port_profile.py batch [path ...]
    python tools/port_profile.py sweep

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

`sweep` profiles the dataset sweep of chip_smoke's phase 19 instead: its
scene is written, each bucket's plan is built and captured, and then, for each
pad bucket in turn, eval.batch_harness.run_scene_batched runs over three of the
bucket's pairs at the phase's ddtime (one pre-filter pass to ten solves, the
sweep's own ratio), at known and at unknown scale, under the profiler. Printed
per group: the harness's own split of its timed region, the device busy share
of the wall, the operations a solve and the kernels that took the most device
time.
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


SWEEP_GROUP_PAIRS = 3


def profile_sweep(device, card):
    """One bucket group of phase 19's sweeps at a time under the profiler."""
    import os
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
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
                torch.cuda.synchronize()
                for _ in range(PROFILER_ATTEMPTS):
                    reset_launches()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        time.sleep(PROFILER_MARGIN_S)
                        stats = run()
                        torch.cuda.synchronize()
                        time.sleep(PROFILER_MARGIN_S)
                    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                    seen = sum("gnc_batch_kernel" in e.name for e in kernels)
                    if seen >= read_launches()["gnc_batch"]:
                        break
                    print(f"[sweep {bucket}] the profiler lost device records: again")
                split = stats["split"]
                wall, solves = split["wall_s"], split["solves"]
                busy_us = sum(e.time_range.elapsed_us() for e in kernels)
                by_name = collections.Counter()
                for e in kernels:
                    by_name[e.name] += e.time_range.elapsed_us()
                tag = f"sweep {'unknown' if unknown else 'known'} bucket {bucket}"
                print(f"[{tag}] card: {card}; {stats['pairs']} pairs, {solves} solves, recall "
                      f"{stats['recall']:.2f}; timed region {wall * 1e3:.1f} ms "
                      f"({wall * 1e3 / solves:.2f} ms a solve): pre-filter "
                      f"{split['prefilter_s'] * 1e3:.1f}, flatten {split['flatten_s'] * 1e3:.1f}, "
                      f"solves {split['solve_s'] * 1e3:.1f}, readback "
                      f"{split['readback_s'] * 1e3:.2f} ms; scoring (untimed) "
                      f"{split['scoring_s'] * 1e3:.1f} ms; device busy {busy_us / 1e3:.1f} ms, "
                      f"{100 * busy_us / 1e6 / wall:.1f}% of the timed region (under the "
                      f"profiler); {len(kernels) / solves:.0f} device operations a solve; "
                      f"launches {read_launches()}")
                for kname, us in by_name.most_common(8):
                    print(f"[{tag}]   {100 * us / busy_us:5.1f}%  {us / 1e3 / solves:.3f} ms a "
                          f"solve  {kname[:110]}")
                for kernel in KERNELS:
                    runs = [e.time_range.elapsed_us() for e in kernels
                            if f"{kernel}_kernel" in e.name]
                    if runs:
                        print(f"[{tag}] port kernel {kernel}: {len(runs) / solves:.1f} launches "
                              f"a solve, {statistics.mean(runs):.2f} us of device time a launch, "
                              f"{100 * sum(runs) / busy_us:.2f}% of device time")


def main() -> int:
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    modes = ["staged"]
    for name in sys.argv[1:] or ["anchor", "unknown", "gror", "frontend"]:
        if name == "sweep":
            profile_sweep(device, card)
        elif name == "fused":
            modes = ["fused"]
        elif name == "batch":
            modes = ["batch in order", "batch in flight"]
        else:
            for mode in modes:
                profile_path(name, device, card, mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
