"""Roofline arithmetic: the published peaks of one H100 and the operations
and bytes of the port's kernels, counted from their shapes and inputs.
Copied from chip_smoke.py (PEAK_F32_FLOPS, PEAK_HBM_BYTES, OPS_PER_PAIR,
GNC_OPS_PER_COLUMN, GNC_OPS_PER_ITERATION, bound_ms, pair_grid_bound) so that
the yardstick does not move with the program; `gnc_iterations` counts what a
GNC-TLS launch's inputs need, in plain numpy."""

from __future__ import annotations

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Floating-point operations per unit of work, counted from each kernel's
# expression: a pair distance is 3 subtractions, 3 products, 2 sums and a
# square root (9); the window tests add a few more. Each function is
# symmetric, so its bound counts each pair i < j once.
OPS_PER_PAIR = {
    "pair_ratio_hist": 2 * 9 + 5,  # two distances, ratio, scale, floor, offset, divide
    "pair_beta_count": 2 * 9 + 3,  # two distances, difference, |.|, compare
    "consistency_degree": 2 * 9 + 3 + 2,  # as beta, plus one to each endpoint's degree
}
# GNC per active column and iteration: weighted correlation (3 + 18),
# residual R x - y and its square (15 + 3 + 5), TLS weight update (6),
# cost (2); plus 5 squarings of the 4x4 Davenport matrix per iteration.
GNC_OPS_PER_COLUMN = 52
GNC_OPS_PER_ITERATION = 5 * 2 * 64
PEAK_BINS = (128 + 1) * 16 + 1  # exact_peak_bin's full pass at its defaults


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 peak; and which bounds."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pair_grid_bound(name: str, c: int, n_active: int, out_bytes: int) -> tuple[float, str]:
    """bound_ms of a pair-grid kernel over C points of which n_active take
    part: each point (two float32 triples and a mask byte) read once, the
    output written once, OPS_PER_PAIR[name] operations per active pair i < j."""
    return bound_ms(c * 25 + out_bytes, n_active * (n_active - 1) // 2 * OPS_PER_PAIR[name])


def gnc_bytes(hypotheses: int, n: int, pairs: int) -> int:
    """One gnc_batch launch: per hypothesis its float32 TIM triples and a
    bool mask in, the inlier mask out, a noise bound and a rotation; per
    pair a warm rotation and its flag."""
    return hypotheses * n * (4 * 3 + 4 * 3 + 1 + 1) + hypotheses * (4 + 36) + pairs * 37


def gnc_ops(iterations: np.ndarray, active: np.ndarray) -> float:
    """Operations of a launch whose hypotheses ran `iterations` each over
    their active columns (`active` (H, N) bool)."""
    cols = active.sum(1)
    return float((iterations * (cols * GNC_OPS_PER_COLUMN + GNC_OPS_PER_ITERATION)).sum())


def _weighted_rotation(src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> np.ndarray:
    u, _, vh = np.linalg.svd((dst * w) @ src.T)
    fix = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vh))])
    return u @ fix @ vh


def gnc_iterations(src: np.ndarray, dst: np.ndarray, active: np.ndarray, noise_bound: float,
                   max_iterations: int, gnc_factor: float, cost_threshold: float) -> np.ndarray:
    """Iterations of each hypothesis of a cold GNC-TLS launch
    (registration.cc:1563-1692): src, dst (H, 3, N), active (H, N); the
    loop stops on a degenerate first step or when the cost moves less than
    `cost_threshold`, and counts the iteration it stops in."""
    nb_sq = noise_bound * noise_bound
    nb_sq = 1e-2 if nb_sq < 1e-16 else nb_sq  # the floor of registration.cc:1592-1595
    out = np.zeros(src.shape[0], np.int64)
    for h in range(src.shape[0]):
        s, d = np.asarray(src[h], np.float64), np.asarray(dst[h], np.float64)
        a = np.asarray(active[h], np.float64)
        w, prev, mu = a.copy(), np.inf, 1.0
        for it in range(max_iterations):
            r_sq = ((d - _weighted_rotation(s, d, w * a) @ s) ** 2).sum(0)
            out[h] += 1
            if it == 0:
                mu = 1.0 / (2.0 * r_sq[a > 0].max(initial=-np.inf) / nb_sq - 1.0)
                if mu <= 0:
                    break
            cost = float((w * r_sq * a).sum())
            th1, th2 = (mu + 1.0) / mu * nb_sq, mu / (mu + 1.0) * nb_sq
            mid = np.sqrt(nb_sq * mu * (mu + 1.0) / np.maximum(r_sq, 1e-30)) - mu
            w = np.where(r_sq >= th1, 0.0, np.where(r_sq <= th2, 1.0, np.clip(mid, 0.0, 1.0))) * a
            if abs(cost - prev) < cost_threshold:
                break
            prev = cost
            mu *= gnc_factor
    return out
