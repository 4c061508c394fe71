"""Full per-pair registration pipeline: normals -> normal-angle histogram
pre-filter -> PSULVSB solve (counterpart of psulvsb_tpu/eval/pipeline.py).

The sequence both reference programs run per pair (PSULVSB.cc:303-328,
teaser_cpp_ply_main.cc:330-422): PCL normals (k = 20),
histogram_outlier_removal producing keep_mask, then
RobustRegistrationSolver::solve on the reduced set.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.frontend.histogram_filter import normal_angle_histogram_filter
from psulvsb_tpu_torch.frontend.normals import estimate_normals
from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.fused import as_generator, psulvsb_register, resolve_device
from psulvsb_tpu_torch.solver.psulvsb import psulvsb_solve
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils import timing
from psulvsb_tpu_torch.utils.padding import DEFAULT_PAD_BUCKETS, pad_columns, pad_to_bucket
from psulvsb_tpu_torch.utils.precision import pin_float32


class PipelineResult(NamedTuple):
    solution: RegistrationSolution
    keep_mask: torch.Tensor  # (padded C,) int64: 1, 0, -1, and -2 on padding
    elapsed_s: float


def pad_bucket(c: int, pad_buckets: tuple[int, ...] = DEFAULT_PAD_BUCKETS) -> int:
    """The padded size a C-correspondence pair is solved at, and so the size
    its replay plan is built for. Beyond the largest bucket it grows
    (1024-aligned) rather than truncate: see utils.padding.pad_to_bucket."""
    return pad_to_bucket(c, pad_buckets)


def solve_with_prefilter(
    src,
    dst,
    params: SolverParams,
    generator_or_seed,
    normal_k: int = 20,
    fused: bool = True,
    pad_buckets: tuple[int, ...] = DEFAULT_PAD_BUCKETS,
    use_prefilter: bool = True,
    device="cuda",
) -> PipelineResult:
    """src/dst: (3, C) matched correspondence matrices (the original set),
    numpy or tensors; the solve runs on `device` (the card unless the caller
    asks for the CPU).

    Inputs are padded to a size bucket (keep_mask = -2 on padding, which
    never votes anywhere in the solver), so a sweep over pairs of varying C
    reuses a handful of replay plans.

    use_prefilter: the normal-angle histogram filter permanently discards
    (-1) bins far from the peak (PSULVSB.cc:156-168). An inlier's src/dst
    normal angle spreads with the rotation's magnitude, so large-rotation
    pairs can lose true inliers to the -1 bucket with no self-update
    recourse; pass False to feed the solver the full set.

    fused: the one-dispatch `psulvsb_register` (the default), else the
    staged `psulvsb_solve`. `elapsed_s` ends after the solution is on the
    device.

    With tracing on (`utils.timing`) the call is the host span "pipeline",
    its parts "pipeline.stage" (numpy to padded device tensors),
    "pipeline.prefilter", "pipeline.solve" (the draws and the graph launch)
    and "pipeline.sync"; the card is stamped at the call's first and last
    device operation (device span "call") and around the pre-filter (device
    span "pipeline.prefilter")."""
    device = resolve_device(device)
    pin_float32()
    with timing.span("pipeline"):
        with timing.span("pipeline.stage"):
            src = np.asarray(torch.as_tensor(src).cpu(), np.float32)
            dst = np.asarray(torch.as_tensor(dst).cpu(), np.float32)
            c = src.shape[1]
            target = pad_bucket(c, pad_buckets)
            timing.device_stamp(device, "call", False)
            src_p = torch.as_tensor(pad_columns(src, target), device=device)
            dst_p = torch.as_tensor(pad_columns(dst, target), device=device)
            valid = torch.arange(target, device=device) < c
        t0 = time.monotonic()

        with timing.span("pipeline.prefilter"):
            timing.device_stamp(device, "pipeline.prefilter", False)
            if use_prefilter:
                src_normals = estimate_normals(src_p, k=normal_k, active=valid)
                dst_normals = estimate_normals(dst_p, k=normal_k, active=valid)
                keep_mask, _ = normal_angle_histogram_filter(src_normals, dst_normals,
                                                             active=valid)
                keep_mask = torch.where(valid, keep_mask, -2)
            else:
                keep_mask = torch.where(valid, 1, -2).to(torch.int64)
            timing.device_stamp(device, "pipeline.prefilter", True)

        with timing.span("pipeline.solve"):
            gen = as_generator(generator_or_seed, device)
            if fused:
                sol = psulvsb_register(src_p, dst_p, keep_mask, gen, params, device=device)
            else:
                sol, _ = psulvsb_solve(src_p, dst_p, keep_mask, params, gen)
        timing.device_stamp(device, "call", True)
        with timing.span("pipeline.sync"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return PipelineResult(solution=sol, keep_mask=keep_mask,
                              elapsed_s=time.monotonic() - t0)
