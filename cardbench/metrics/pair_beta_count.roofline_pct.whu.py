"""pair_beta_count.roofline_pct.whu: `ops.hist.pair_beta_count` (the exact
known-scale reduced-set size, one launch a solve past the dense init) alone
at each bucket of the cell, on one of the cell's own pairs of that size
with its real columns active and the configuration's beta, timed with CUDA
events over replays of a captured graph of launches (as the kernel runs
inside the plan's graph), as a share of counts.pair_grid_bound(
"pair_beta_count", C, real columns, its output bytes), the bounds and times
summed over the buckets. None without a card."""

import math
import sys

from cardbench import counts

LAUNCHES = 50  # launches in the timed graph
REPLAYS = 5
OUT_BYTES = 8  # the int64 count


def _launch_ms(run, n: int) -> tuple[float, int, int]:
    """ms a launch at size n's bucket, the bucket, the real columns."""
    import torch

    from psulvsb_tpu_torch.ops.hist import pair_beta_count

    src, dst, keep = run.traffic.padded(n)
    dev = run.device
    src, dst = (torch.as_tensor(a[0], device=dev) for a in (src, dst))
    act = torch.as_tensor(keep[0] == 1, device=dev)
    beta = 2.0 * run.params.noise_bound * math.sqrt(run.params.cbar2)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            pair_beta_count(src, dst, beta, act)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            pair_beta_count(src, dst, beta, act)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    del graph
    return start.elapsed_time(end) / (REPLAYS * LAUNCHES), src.shape[1], int(act.sum())


def read(run):
    if not run.cuda or run.traffic is None:
        return None
    bound_sum = ms_sum = 0.0
    for n in run.traffic.sizes:
        ms, c, n_active = _launch_ms(run, n)
        bound, by = counts.pair_grid_bound("pair_beta_count", c, n_active, OUT_BYTES)
        print(f"pair_beta_count at C={c}, {n_active} active: {ms:.6f} ms a launch, bound "
              f"{bound:.6f} ms by {by}", file=sys.stderr)
        bound_sum += bound
        ms_sum += ms
    return 100.0 * bound_sum / ms_sum if ms_sum > 0 else None
