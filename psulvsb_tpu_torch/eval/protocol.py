"""The published PSULVSB synthetic experiment protocol (port of
psulvsb_tpu/eval/protocol.py).

Equivalent of the PSULVSB example program's main loop (PSULVSB.cc:224-515): per cloud,
`trials` runs of {random SE(3) + noise + outliers -> normals -> histogram
pre-filter -> solve}, per-trial scale/rotation/translation/time/RMSE errors,
mean and sigma aggregation to a per-cloud CSV and a global Average.csv. The
data of a trial comes from a numpy generator and the solve's draws from a
torch generator, both seeded from (seed, cloud name, trial).
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple

import numpy as np

from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.pipeline import solve_with_prefilter
from psulvsb_tpu_torch.eval.reporting import mean_std, write_csv
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair
from psulvsb_tpu_torch.solver.config import SolverParams


class TrialResult(NamedTuple):
    scale_error: float
    angle_error_deg: float
    trans_error: float
    rmse: float
    time_s: float


def run_trial(
    seed,
    src: np.ndarray,
    params: SolverParams,
    noise_bound: float = 0.05,
    outlier_rate: float = 0.9,
    device="cuda",
) -> TrialResult:
    """One trial on the (3, N) cloud `src`. seed: an int or a sequence of
    ints (np.random.SeedSequence entropy); its first child seeds the data,
    its second the solve."""
    k_data, k_solve = np.random.SeedSequence(seed).spawn(2)
    pair = make_synthetic_pair(
        np.random.default_rng(k_data), np.asarray(src, np.float32), noise_bound=noise_bound,
        outlier_rate=outlier_rate,
    )
    solve_seed = int(k_solve.generate_state(1, np.uint64)[0] >> 2)
    res = solve_with_prefilter(pair.src, pair.dst, params, solve_seed, device=device)
    sol = res.solution

    gt = pair.transform
    # One readback, then scoring in numpy float64.
    s_f = float(sol.scale)
    r64 = sol.rotation.cpu().numpy().astype(np.float64)
    t64 = sol.translation.cpu().numpy().astype(np.float64)
    src64 = np.asarray(pair.src, np.float64)
    gt_r64 = np.asarray(gt.rotation, np.float64)
    gt_t64 = np.asarray(gt.translation, np.float64)
    scale_err = abs(s_f - float(gt.scale))
    angle_err = angular_error_deg_np(gt_r64, r64)
    trans_err = float(np.linalg.norm(t64 - gt_t64))
    # RMSE against the noiseless ground-truth placement over ALL points
    # (PSULVSB.cc computes it against src_gt = T * src).
    gt_pts = gt_r64 @ src64 + gt_t64[:, None]
    est_pts = s_f * (r64 @ src64 + t64[:, None])
    rmse = float(np.sqrt(np.mean(np.sum((gt_pts - est_pts) ** 2, axis=0))))
    return TrialResult(scale_err, angle_err, trans_err, rmse, res.elapsed_s)


def run_protocol(
    clouds: dict[str, np.ndarray],
    params: SolverParams,
    out_dir: str,
    trials: int = 100,
    noise_bound: float = 0.05,
    outlier_rate: float = 0.9,
    seed: int = 0,
    device="cuda",
) -> dict[str, dict]:
    """clouds: {name: (3, N) array}. Writes <name>.csv per cloud and
    Average.csv; returns the aggregate stats dict."""
    os.makedirs(out_dir, exist_ok=True)
    aggregates = {}
    avg_rows = []
    for name, cloud in clouds.items():
        rows = []
        results: list[TrialResult] = []
        name_tag = zlib.crc32(name.encode()) % (1 << 30)  # deterministic
        for t in range(trials):
            # (seed, name, trial) as one entropy: no two clouds share a stream.
            r = run_trial((seed, name_tag, t), cloud, params, noise_bound, outlier_rate, device)
            results.append(r)
            rows.append([t, r.scale_error, r.angle_error_deg, r.trans_error, r.rmse, r.time_s])
        write_csv(
            os.path.join(out_dir, f"{name}.csv"),
            ["trial", "ScaleError", "AngleError", "TransError", "RMSE", "Time"],
            rows,
        )
        stats = {}
        for field in TrialResult._fields:
            stats[field] = mean_std([getattr(r, field) for r in results])
        aggregates[name] = stats
        avg_rows.append([name] + [x for field in TrialResult._fields for x in stats[field]])
    write_csv(
        os.path.join(out_dir, "Average.csv"),
        ["cloud"]
        + [f"{field}_{suffix}" for field in TrialResult._fields for suffix in ("mean", "std")],
        avg_rows,
    )
    return aggregates
