"""Device readings that several metric readers share: the idle share from
NVML's samples, and the GNC kernel's share of its roofline."""

from __future__ import annotations

import statistics
import sys

import numpy as np

from cardbench import counts

GNC_LAUNCHES = 100  # launches in the timed graph
GNC_REPLAYS = 5


def idle_pct(run):
    """100 less the mean utilization.gpu of the window's samples; None
    without samples."""
    return 100.0 - statistics.fmean(run.util) if run.util else None


def gnc_problem(run, hypotheses: int, n: int, beta: float, rng):
    """`hypotheses` GNC problems of n TIMs each, drawn from the cell's own
    pairs as the solve's reduced set holds them: differences of two
    correspondences whose lengths agree within `beta` in both clouds."""
    pairs = [p for n_pairs in run.traffic.pool.values() for p in n_pairs]
    src = np.zeros((hypotheses, 3, n), np.float32)
    dst = np.zeros_like(src)
    act = np.zeros((hypotheses, n), bool)
    for h in range(hypotheses):
        pair = pairs[h % len(pairs)]
        c = pair.src.shape[1]
        i, j = rng.integers(0, c, size=(2, 256 * n))
        s_tim = pair.src[:, j] - pair.src[:, i]
        d_tim = pair.dst[:, j] - pair.dst[:, i]
        ok = (i != j) & (np.abs(np.linalg.norm(d_tim, axis=0)
                                - np.linalg.norm(s_tim, axis=0)) <= beta)
        pick = np.flatnonzero(ok)[:n]
        src[h, :, :pick.size], dst[h, :, :pick.size] = s_tim[:, pick], d_tim[:, pick]
        act[h, :pick.size] = True
    return src, dst, act


def gnc_roofline_pct(run):
    """`ops.gnc.gnc_batch` at the launch shape of the cell's plan, cold
    (no warm rotation), timed with CUDA events over replays of a graph of
    GNC_LAUNCHES launches (as the kernel runs inside the plan's graph), as a
    share of counts.bound_ms over the iterations these inputs need."""
    if not run.cuda:
        return None
    if "gnc_roofline_pct" in run.cache:
        return run.cache["gnc_roofline_pct"]
    import torch

    from psulvsb_tpu_torch.ops.gnc import gnc_batch

    params = run.params
    pairs = max(p["pairs"] or 1 for p in run.plans)
    hyp, n = pairs * params.hypothesis_batch, params.basic_cap
    rng = np.random.default_rng([run.seed % (1 << 64), 1 << 35])
    beta = 2.0 * run.config["noise_bound"]
    src, dst, act = gnc_problem(run, hyp, n, beta, rng)
    nb = 2.0 * params.inner_noise_bound  # the rotation's bound at known scale
    loop = dict(max_iterations=params.inner_rotation_max_iterations,
                gnc_factor=params.inner_rotation_gnc_factor,
                cost_threshold=params.inner_rotation_cost_threshold)
    dev = run.device
    args = (torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev),
            torch.as_tensor(act, device=dev), torch.full((hyp,), nb, device=dev))
    if pairs > 1:
        warm = (torch.eye(3, device=dev).expand(pairs, 3, 3).contiguous(),
                torch.zeros(pairs, dtype=torch.bool, device=dev))
    else:
        warm = (torch.eye(3, device=dev), torch.zeros((), dtype=torch.bool, device=dev))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            gnc_batch(*args, *warm, **loop)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GNC_LAUNCHES):
            gnc_batch(*args, *warm, **loop)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GNC_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / (GNC_REPLAYS * GNC_LAUNCHES)
    iters = counts.gnc_iterations(src, dst, act, nb, **loop)
    bound, by = counts.bound_ms(counts.gnc_bytes(hyp, n, pairs), counts.gnc_ops(iters, act))
    print(f"gnc_batch at ({hyp}, 3, {n}), {pairs} pair(s): {ms:.6f} ms a launch, bound "
          f"{bound:.7f} ms by {by}, iterations {iters.tolist()}", file=sys.stderr)
    del graph
    run.cache["gnc_roofline_pct"] = 100.0 * bound / ms
    return run.cache["gnc_roofline_pct"]
