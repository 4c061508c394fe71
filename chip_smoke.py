"""Smoke run of the PyTorch/CUDA port (psulvsb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device — the card's name and power limit (nvidia-smi); no CUDA device
   is a failure;
2. build — compile the four kernels (csrc/gnc_batch.cu,
   csrc/pair_ratio_hist.cu, csrc/pair_beta_count.cu,
   csrc/consistency_degree.cu; the last three share csrc/pair_sweep.cuh)
   with nvcc, one process each, all started together, and print ptxas's
   register lines;
3. kernel vs plain — ops.gnc.gnc_batch (the kernel) against
   gnc_batch_reference (plain PyTorch) on the card, at (B, N) = (4, 256),
   (16, 1024), (4, 2048), (3, 197) and at B = 1 and 16 for N = 1, 10, 11,
   32, 255, 256, 257, 1024, 1025, 2048 (the edges of the kernel's
   variants), with 30% gross outliers, half the columns masked, with and
   without a warm start (the flag as a Python bool at every shape, and as a
   0-d tensor on the device at the four main shapes): max |dR| <= 1e-4 and
   inlier masks agreeing on >= 99.5% of active columns; the <= 10-inlier fail-safe at 10 and 11
   fitting columns and the noise floor (a bound of 5e-9) as the plain
   version; an all-inactive hypothesis gives the identity and no inliers;
   N = 0 raises; medians of 20 timed runs (CUDA events) at (4, 256) and
   (16, 1024), and the profiler's device time a launch there, where a call
   must run one kernel and no other device operation;
4. slice — the bench anchor pair (C = 1889, 90% displaced outliers, noise
   0.05) solved through RobustRegistrationSolver(SolverParams.
   preset_anchor()) on the card: one warm-up and 5 timed solves with
   different seeds, each valid with RE < 5 deg and TE < 0.3, and the
   kernel's launch count, reset just before, must have grown;
5. pair-grid kernels vs plain — ops.hist.pair_ratio_histogram and
   pair_beta_count (the kernels) against their plain PyTorch versions on
   the card at C = 197, 1889, 5000, 12000 with about 20% of the points
   inactive: the coarse window (128 bins, stride 16, clamped), the fine
   window (48 bins, stride 1, dropped, lo > 0), the exact_hist window (512
   bins, clamped), exact_peak_bin's full pass (2065 bins, clamped) and the
   widest window (4096 bins, dropped, lo on the device), and beta at the
   3DMatch and artificial presets' values: counts equal. The beta count
   also at the edges of the tile sizes (C = 1, 2, 31 ... 4097) with all,
   80% and one of the points active, and on the edge-of-beta fixture
   (pairs whose difference is beta - 2 ... beta + 2 ulp exactly, on an axis
   and turned), at beta and 3 ulp to either side: counts equal.
   exact_peak_bin must launch the kernel once a call and give the plain
   two-pass version's peak, count and certificate, and a 200x scale must
   not be certified. Medians of 20 timed runs (CUDA events) at C = 1250,
   5000 and 16384 (the beta count at 5000, 12000 and 16384), and
   exact_peak_bin's and the beta count's device time a launch (profiler),
   where a call must run the kernel and the zeroing of its counts only;
6. slice, unknown scale — the 3DMatch unknownScale protocol at C = 5000
   (noise 0.01, 85% mismatch outliers, dst stretched by a test scale drawn
   in [1, 5) from the seed) solved through RobustRegistrationSolver(
   SolverParams.preset_3dmatch(estimate_scaling=True, ...)) with the clique
   stages off: one warm-up and 5 timed solves, each valid with RE < 5 deg,
   TE < 0.3 and scale error <= 0.1; the histogram kernel must have launched
   once a solve (exact_peak_bin) and the GNC kernel must have launched;
7. slice, beyond the dense window — at C = 12000 one known-scale solve
   (preset_anchor, the anchor protocol) routed to "exact_beta", which must
   launch the beta-count kernel, and one unknown-scale solve (the protocol
   of phase 6) routed to "exact_hist", which must launch the histogram
   kernel, each gated like its protocol;
8. consistency degree vs plain — ops.pairs.consistency_degree (the kernel)
   against consistency_degree_reference on the card at C = 197, 1250, 1889,
   5000, 8192 and at the edges of the tile sizes (C = 1, 2, 31 ... 4097)
   with all, 80% and one of the points active, tau = 0.1 and 0.2: degrees
   must be equal. C = 0 raises; an all-inactive input gives zeros. Medians
   of 20 timed runs (CUDA events) at C = 1250, 1889 and 8192, and the
   device time a launch (profiler), where a call must run the kernel and
   the zeroing of its degrees only;
9. slice, artificial GROR preset — the anchor pair through
   RobustRegistrationSolver(SolverParams.preset_artificial_gror(caps
   (2048, 256, 4))) at its own defaults (clique "auto", PMC_EXACT on the
   greedy, K 800, resolution 0.05): one warm-up and 5 timed solves, each
   valid with RE < 5 deg, TE < 0.3 and GROR's seed adopted; the degree
   kernel launched once a solve and the GNC kernel launched; one profiled
   solve with its "gror" stage;
10. slice, front-end preset — the two committed real-correspondence pairs
   of tests/data/frontend_aliasing/ through eval.frontend_protocol.
   frontend_solver_params(caps (2048, 256, 4)), 5 seeds each:
   pair_seed1375 must pass the KITTI gates (RE < 5 deg, TE < 0.6) on every
   seed, pair_seed10300 is printed; the degree and GNC kernels must have
   launched, the histogram kernel once a solve;
11. clique stages — (a) one preset_artificial_gror(clique_init="eager")
   solve of the anchor pair, which must adopt the clique seed and pass the
   anchor's gates; (b) the anchor protocol at 99% displaced outliers with
   the bench anchor's own program (preset_artificial at the caps, clique
   "auto", PMC_EXACT) over 12 seeds, across which the lazy seed must have
   been adopted and a b_rate == 1.0 clique round must have run; recall is
   printed beside the JAX package's CPU recall on the same pair; (c) the
   peak device memory of the clique round's batched triangle products at
   C = 8192 (printed);
12. replay against eager — solver.fused.psulvsb_register with graphs=True
   (each segment of the solve a replayed CUDA graph) and graphs=False (the
   same segments run eagerly), same seed, on the anchor, the unknown-scale
   pair (C = 5000), the wide pair (C = 12000), the GROR preset,
   pair_seed1375 under the front-end preset and the hostile pair: the
   solutions must be equal (difference 0), on a second pair of the same
   shape through the same plan too; each plan's build time, segments and
   device bytes are printed;
13. the fused path — psulvsb_register on each of those paths over 5 seeds
   under phase 4's pose gates (KITTI's for the real pair; the hostile pair
   is printed beside its staged recall), walls a solve in turns (staged,
   fused, fused, staged) in one process, graph replays and host reads a
   solve, device operations and host-issued operations a solve
   (torch.profiler); the launch counts, which include every replayed
   launch, set to 0 before each path and read after it;
14. the pair batch — parallel.pairs.register_batch at B = 8 and 32 on the
   anchor protocol (a pair a seed) and at B = 8 on the unknown-scale one,
   in order and with pairs in flight (vectorized=True): every pair gated on
   RE < 5 deg and TE < 0.3 against its ground truth and equal to its solve
   alone; pairs per second beside B serial psulvsb_solve calls, in turns;
15. the pipeline — eval.pipeline.solve_with_prefilter on pair_seed1375
   padded to its 2048 bucket through psulvsb_register, the pre-filter off
   (KITTI gates) and on (the keep-mask counts are printed);
16. result — the card line, a JSON line of per-kernel figures (time,
   plain time, bound, launches on the fused path that runs it), and the
   final JSON line {"ok": true, "device": {...}}.

Every launch count is set to 0 just before a phase drives a solve path and
read just after it; launches made to compare a kernel with its plain
version are not counted in any path. A replayed graph launches the kernels
it captured without calling their wrappers: the plan adds those to the
wrappers' counts at each replay (a capture itself launches nothing and is
not counted).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROT_TOL = 1e-4  # float32 sums in another order over <= 100 iterations
MASK_AGREE = 0.995
KERNEL_SHAPES = [(4, 256), (16, 1024), (4, 2048), (3, 197)]
# Both kernel variants (a warp a hypothesis up to N = 256, a block beyond)
# and every column count a thread, at their edges.
BOUNDARY_N = (1, 10, 11, 32, 255, 256, 257, 1024, 1025, 2048)
BOUNDARY_B = (1, 16)
TIMED_SHAPES = [(4, 256), (16, 1024)]
PROFILED_REPS = 10
PROFILER_MARGIN_S = 0.02
PROFILER_ATTEMPTS = 6
LOOP = dict(max_iterations=100, gnc_factor=1.4, cost_threshold=0.005)
ANCHOR_C = 1889
N_TIMED_SOLVES = 5
KERNELS = ("gnc_batch", "pair_ratio_hist", "pair_beta_count", "consistency_degree")
CAPS = dict(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)  # bench.py:95
DEGREE_SIZES = [197, 1250, 1889, 5000, 8192]
DEGREE_TIMED_SIZES = [1250, 1889, 8192]  # the front end's C, the anchor's, the dense limit
# The edges of the pair sweep's tiles (32, 64 or 128 points a side, by C).
EDGE_SIZES = (1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 2047, 2048, 2049, 4095, 4096, 4097)
MASKS = ("all", "80%", "one")  # active points of a pair-grid input
GROR_TAUS = (0.1, 0.2)  # 2 gror_resolution: the artificial preset, the default
FRONTEND_DIR = Path(__file__).resolve().parent / "tests" / "data" / "frontend_aliasing"
FRONTEND_TAGS = ("pair_seed1375", "pair_seed10300")
FRONTEND_GATED = "pair_seed1375"
# RE, TE, scale error: the protocols' success criteria (bench.py:423-426),
# and the KITTI gates (teaser_cpp_ply_main.cc:714; a real pair's scale is
# not scored).
LIMITS = (5.0, 0.3, 0.1)
KITTI_LIMITS = (5.0, 0.6, 0.1)
HOSTILE_RATE = 0.99
HOSTILE_DATA_SEED = 5
# About a third of the solve seeds reach a b_rate == 1.0 round; twelve keep
# the gate off the edge of any one random stream.
HOSTILE_SOLVE_SEEDS = tuple(range(12))
# The JAX package's recall on the hostile pair on the CPU, one key per solve
# seed (tools/port_jax_reference.py; the JAX random stream differs from the
# port's, so the two are compared as recalls).
JAX_CPU_HOSTILE_RECALL = "12/12"
CLIQUE_MEMORY_C = 8192
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
HIST_SIZES = [197, 1889, 5000, 12000]
HIST_TIMED_SIZES = [1250, 5000, 16384]  # the front end's C, the unknown-scale C, wide
BETA_TIMED_SIZES = [5000, 12000, 16384]  # the wide path's C = 12000 between two earlier sizes
EDGE_PAIRS = 512  # points a cluster of the edge-of-beta fixture
PEAK_BINS = (128 + 1) * 16 + 1  # exact_peak_bin's full pass at its defaults
BETAS = {"3dmatch": 0.02, "artificial": 0.1}  # 2 noise_bound sqrt(cbar2)
UNKNOWN_C = 5000  # bench.py:102, the mean 3DMatch pair size
UNKNOWN_RATE = 0.85  # eval/make_dataset.py:38
WIDE_C = 12000  # beyond dense_init_max_c = 8192


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gnc_problem(rng, b, n, device):
    """B rotation problems: noisy rotated TIMs, 30% gross outliers, about
    half the columns masked."""
    from psulvsb_tpu_torch.core.linalg import _quat_to_rot

    q = rng.normal(size=(b, 4))
    rots = _quat_to_rot(torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True)))
    rots = rots.to(torch.float32).numpy()
    src = rng.normal(size=(b, 3, n)).astype(np.float32)
    dst = np.einsum("bij,bjn->bin", rots, src).astype(np.float32)
    dst += rng.uniform(-0.01, 0.01, size=dst.shape).astype(np.float32)
    k = int(0.3 * n)
    dst[:, :, :k] += rng.normal(size=(b, 3, k)).astype(np.float32) * 2.0
    act = rng.uniform(size=(b, n)) < 0.5
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return t(src), t(dst), t(act), torch.full((b,), 0.1, device=device), t(rots[0])


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 peak; and which bounds."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pair_grid_bound(name: str, act: torch.Tensor, out_bytes: int):
    """bound_ms of a pair-grid function over the active points of `act`:
    each point (two float32 triples and a mask byte) read once, the output
    written once, OPS_PER_PAIR[name] operations per active pair i < j."""
    n = int(act.sum())
    c = act.shape[0]
    return bound_ms(c * 25 + out_bytes, n * (n - 1) // 2 * OPS_PER_PAIR[name])


def median_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_kernels(fn, reps=PROFILED_REPS) -> dict:
    """{device operation name: [device microseconds of each]} over `reps`
    calls of fn under torch.profiler, after one warm-up call. The window is
    idle for a while at both ends, so that records whose device time stamps
    are mapped a little off the host's clock still fall inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def kernel_device_us(fn, kernel: str, reps=PROFILED_REPS, others=0) -> float:
    """Mean device microseconds of `kernel`'s launches over `reps` profiled
    calls of fn; fails unless it launched once a call and the calls ran at
    most `others` other device operations each. The profiler now and then
    loses a window's device records: a window with fewer launches than
    calls is taken again, up to PROFILER_ATTEMPTS times."""
    for _ in range(PROFILER_ATTEMPTS):
        ops = profiled_kernels(fn, reps)
        runs = [us for name, v in ops.items() if f"{kernel}_kernel" in name for us in v]
        rest = sum(len(v) for name, v in ops.items() if f"{kernel}_kernel" not in name)
        if len(runs) >= reps:
            break
        print(f"[profiler] {len(runs)} {kernel} launches recorded over {reps} calls: again")
    if len(runs) != reps or rest > others * reps:
        raise AssertionError(f"{reps} calls must launch {kernel} {reps} times with at most "
                             f"{others * reps} other device operations: {ops.keys()}")
    return statistics.mean(runs)


def check_gnc(what, rk, ik, rr, ir, act) -> float:
    """max |dR| of kernel vs plain; fails beyond ROT_TOL, on masks agreeing
    on fewer than MASK_AGREE of the active columns, or an inactive inlier."""
    torch.cuda.synchronize()
    err = float((rk - rr).abs().max())
    agree = float(((ik == ir) & act).sum() / act.sum()) if bool(act.any()) else 1.0
    print(f"[kernel] {what}: max|dR|={err:.3e} mask agreement={agree:.5f}")
    if not err <= ROT_TOL:
        raise AssertionError(f"{what}: rotation mismatch {err} > {ROT_TOL}")
    if not agree >= MASK_AGREE:
        raise AssertionError(f"{what}: inlier masks agree on {agree} < {MASK_AGREE}")
    if (ik & ~act).any():
        raise AssertionError(f"{what}: kernel marked an inactive column as inlier")
    return err


def fail_safe_problem(rng, k, device, n=40):
    """One hypothesis of n active columns, k of them fitting the rotation
    and the rest gross outliers, with the true rotation as warm start."""
    src, dst, _, _, rot = gnc_problem(rng, 1, n, device)
    dst = torch.einsum("ij,bjn->bin", rot, src)
    dst[:, :, k:] += 10.0
    return src, dst, torch.ones(1, n, dtype=torch.bool, device=device), rot


def phase_kernel_vs_plain(device) -> dict:
    from psulvsb_tpu_torch.ops import gnc

    rng = np.random.default_rng(0)
    max_err = 0.0
    shapes = KERNEL_SHAPES + [(b, n) for n in BOUNDARY_N for b in BOUNDARY_B]
    for b, n in shapes:
        for use_warm in (False, True):
            src, dst, act, nb, warm = gnc_problem(rng, b, n, device)
            args = (src, dst, act, nb, warm, use_warm)
            rk, ik = gnc.gnc_batch(*args, **LOOP)
            rr, ir = gnc.gnc_batch_reference(*args, **LOOP)
            max_err = max(max_err, check_gnc(f"B={b} N={n} warm={use_warm}", rk, ik, rr, ir, act))

    # use_warm as a flag on the device, which a captured launch follows.
    for b, n in KERNEL_SHAPES:
        for use_warm in (False, True):
            src, dst, act, nb, warm = gnc_problem(rng, b, n, device)
            flag = torch.full((), use_warm, dtype=torch.bool, device=device)
            rk, ik = gnc.gnc_batch(src, dst, act, nb, warm, flag, **LOOP)
            rr, ir = gnc.gnc_batch_reference(src, dst, act, nb, warm, flag, **LOOP)
            max_err = max(max_err, check_gnc(f"B={b} N={n} device flag={use_warm}", rk, ik, rr,
                                             ir, act))

    # The front door's rules, now inside the kernel: the <= 10-inlier
    # fail-safe and the noise-bound floor (a tight threshold runs the loop
    # until the outliers drop out).
    for k in (10, 11):
        src, dst, act, rot = fail_safe_problem(rng, k, device)
        one = torch.full((1,), 0.1, device=device)
        rk, ik = gnc.gnc_batch(src, dst, act, one, rot, True, **LOOP)
        rr, ir = gnc.gnc_batch_reference(src, dst, act, one, rot, True, **LOOP)
        max_err = max(max_err, check_gnc(f"{k} fitting columns of 40", rk, ik, rr, ir, act))
        if not torch.equal(ik, ir) or int(ik.sum()) != (40 if k <= 10 else k):
            raise AssertionError(f"fail-safe at {k} inliers: kernel kept {int(ik.sum())}")
    tight = dict(LOOP, cost_threshold=1e-6)
    src, dst, act, _, warm = gnc_problem(rng, 4, 256, device)
    floored = {}
    for nbv in (5e-9, 0.1):
        nb = torch.full((4,), nbv, device=device)
        rk, ik = gnc.gnc_batch(src, dst, act, nb, warm, False, **tight)
        rr, ir = gnc.gnc_batch_reference(src, dst, act, nb, warm, False, **tight)
        max_err = max(max_err, check_gnc(f"noise bound {nbv}", rk, ik, rr, ir, act))
        floored[nbv] = ik
    # Unfloored, a bound of 5e-9 rejects every column and the fail-safe
    # keeps them all; floored, it keeps what 0.1 keeps.
    if not int(floored[5e-9].sum()) < int(act.sum()):
        raise AssertionError("a noise bound of 5e-9 must take the 1e-2 floor")
    print("[kernel] fail-safe at 10 and 11 inliers and the noise floor as the plain version")

    # Edge cases of the front door on the card.
    src, dst, act, nb, _ = gnc_problem(rng, 3, 64, device)
    act[1] = False
    rk, ik = gnc.gnc_batch(src, dst, act, nb, torch.eye(3, device=device), False, **LOOP)
    if not torch.equal(rk[1].cpu(), torch.eye(3)) or bool(ik[1].any()):
        raise AssertionError("all-inactive hypothesis must give identity, no inliers")
    try:
        empty = torch.zeros(2, 3, 0, device=device)
        gnc.gnc_batch(empty, empty, torch.zeros(2, 0, dtype=torch.bool, device=device),
                      nb[:2], torch.eye(3, device=device), False, **LOOP)
    except ValueError:
        pass
    else:
        raise AssertionError("N = 0 must raise ValueError")
    print("[kernel] all-inactive hypothesis -> identity, no inliers; N=0 raises")

    from psulvsb_tpu_torch.rotation.gnc import floor_noise_sq, gnc_tls_batched

    times = {}
    for b, n in TIMED_SHAPES:
        src, dst, act, nb, warm = gnc_problem(rng, b, n, device)
        args = (src, dst, act, nb, warm, False)
        ms = median_ms(lambda: gnc.gnc_batch(*args, **LOOP))
        plain = median_ms(lambda: gnc.gnc_batch_reference(*args, **LOOP))
        # One launch and no other device operation a call.
        dev_us = kernel_device_us(lambda: gnc.gnc_batch(*args, **LOOP), "gnc_batch")
        # The bound counts the iterations these inputs run (the plain loop's
        # count) over each hypothesis' active columns.
        _, _, _, iters = gnc_tls_batched(
            src, dst, act, floor_noise_sq(nb), warm, False, rot_method="power", **LOOP
        )
        ops = float((iters * (act.sum(1) * GNC_OPS_PER_COLUMN + GNC_OPS_PER_ITERATION)).sum())
        # Bytes: the float32 TIM triples, the bool mask in and inliers out,
        # a noise bound and a rotation per hypothesis, the warm start.
        bound = bound_ms(b * n * (4 * 3 + 4 * 3 + 1 + 1) + b * (4 + 36) + 36, ops)
        times[(b, n)] = (ms, plain, bound)
        # The launch lasts as long as its longest hypothesis.
        print(f"[kernel] B={b} N={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(median of 20, CUDA events); device {dev_us:.2f} us a launch (profiler, mean "
              f"of {PROFILED_REPS}), {dev_us / int(iters.max()):.3f} us an iteration of the "
              f"longest hypothesis; iterations {iters.tolist()}, bound "
              f"{bound[0]:.6f} ms by {bound[1]}")
    return {"max_abs_err": max_err, "times": times}


def anchor_case(c=ANCHOR_C, rate=0.9, data_seed=1, cloud_seed=0):
    """The bench anchor protocol (noise 0.05, displaced outliers) at C
    points: (src, dst, truth), truth = (rotation, translation, test scale)."""
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

    pair = make_synthetic_pair(
        np.random.default_rng(data_seed), synthetic_cloud(c, seed=cloud_seed), 0.05, rate
    )
    t = pair.transform
    return pair.src, pair.dst, (t.rotation, t.translation, float(t.scale))


def unknown_scale_case(c, seed):
    """The 3DMatch unknownScale protocol: noise 0.01, 85% mismatch
    outliers, dst stretched by a test scale drawn in [1, 5) from the seed."""
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

    rng = np.random.default_rng(seed)
    test_scale = 1.0 + 4.0 * rng.uniform()
    pair = make_synthetic_pair(
        rng, synthetic_cloud(c, seed=seed), 0.01, UNKNOWN_RATE, outlier_mode="mismatch",
        test_scale=test_scale,
    )
    t = pair.transform
    return pair.src, pair.dst, (t.rotation, t.translation, float(t.scale))


def unknown_scale_params():
    from psulvsb_tpu_torch import InlierSelectionMode, SolverParams

    return SolverParams.preset_3dmatch(
        estimate_scaling=True, clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE,
        **CAPS,
    )


def frontend_case(tag):
    """A committed real-correspondence pair: (src, dst, truth), the test
    scale None (the translation is compared as it comes)."""
    corr = np.loadtxt(FRONTEND_DIR / f"{tag}_corr.txt").astype(np.float32)
    gt = np.loadtxt(FRONTEND_DIR / f"{tag}_gt.txt")
    return corr[:, :3].T.copy(), corr[:, 3:].T.copy(), (gt[:3, :3], gt[:3, 3], None)


def path_case(name):
    """(params, case) of a solve path that chip_smoke times:
    anchor, unknown, gror, frontend or wide (the anchor protocol at
    C = 12000, routed to "exact_beta")."""
    from psulvsb_tpu_torch import SolverParams
    from psulvsb_tpu_torch.eval.frontend_protocol import frontend_solver_params

    if name == "anchor":
        return SolverParams.preset_anchor(), anchor_case()
    if name == "unknown":
        return unknown_scale_params(), unknown_scale_case(UNKNOWN_C, 5)
    if name == "gror":
        return SolverParams.preset_artificial_gror(**CAPS), anchor_case()
    if name == "frontend":
        return frontend_solver_params(**CAPS), frontend_case(FRONTEND_GATED)
    if name == "wide":
        return SolverParams.preset_anchor(), anchor_case(WIDE_C, data_seed=3, cloud_seed=3)
    raise ValueError(f"unknown path {name!r}")


def score_solution(tag, sol, truth, limits=LIMITS):
    """(valid, RE deg, TE, scale error, success) of a solution against
    truth = (rotation, translation, test scale), scored as the batch harness
    scores it; a non-finite solution raises."""
    from psulvsb_tpu_torch.core.metrics import angular_error_deg_np

    rot_true, t_true, test_scale = truth
    rot = sol.rotation.cpu().numpy().astype(np.float64)
    trans = sol.translation.cpu().numpy().astype(np.float64)
    scale = float(sol.scale)
    if not (np.isfinite(rot).all() and np.isfinite(trans).all() and np.isfinite(scale)):
        raise AssertionError(f"{tag}: non-finite solution")
    re = angular_error_deg_np(rot_true, rot)
    if test_scale is None:  # a real pair: its scale is not scored
        te, se = float(np.linalg.norm(trans - t_true)), float("nan")
    else:  # psulvsb_tpu/eval/batch_harness.py:386-402
        te = float(np.linalg.norm(trans * scale / test_scale - t_true))
        se = abs(scale - test_scale)
    valid = bool(sol.valid)
    ok = valid and re < limits[0] and te < limits[1] and (test_scale is None or se <= limits[2])
    return valid, re, te, se, ok


def run_solve(tag, params, case, seed, device, route=None, limits=LIMITS, gate=True):
    """One solve of case = (src, dst, truth) through RobustRegistrationSolver
    on the card, scored as the batch harness scores it. Non-finite output,
    or an init route other than `route`, raises; with `gate`, so does a
    solve that is not valid or misses a limit of (RE, TE, scale error).
    Returns (wall seconds, info, success)."""
    from psulvsb_tpu_torch import RobustRegistrationSolver

    src, dst, _ = case
    src = torch.as_tensor(src, device=device)
    dst = torch.as_tensor(dst, device=device)
    solver = RobustRegistrationSolver(params, seed=seed, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(src, dst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sol.rotation.device != device:
        raise AssertionError(f"the solve ran on {sol.rotation.device}, not {device}")
    valid, re, te, se, ok = score_solution(tag, sol, case[2], limits)
    scale = float(sol.scale)
    info = solver._info
    print(f"[{tag}] seed={seed}: valid={valid} RE={re:.4f} deg TE={te:.5f} scale={scale:.4f} "
          f"(error {se:.5f}) init={info['init_mode']} gror={info['gror_init']} "
          f"clique_seeded={info['clique_seeded']} clique_rounds={info['clique_rounds']} "
          f"rescued={bool(info['translation_rescued'])} rounds={info['rounds']} "
          f"batches={info['total_local_batches']} host_syncs={info['host_syncs']} "
          f"wall={wall * 1e3:.2f} ms")
    if route is not None and info["init_mode"] != route:
        raise AssertionError(f"{tag}: init took {info['init_mode']!r}, expected {route!r}")
    if gate and not ok:
        raise AssertionError(f"{tag} solve failed: valid={valid} RE={re} TE={te} scale error={se}")
    return wall, info, ok


def drive_path(name, device, card, route=None):
    """One warm-up and N_TIMED_SOLVES gated solves of path_case(name), the
    launch counts set to 0 just before and read just after; then one
    profiled solve's per-stage wall times (a device sync after each stage).
    Returns (the solves' infos, launches)."""
    from psulvsb_tpu_torch import psulvsb_solve

    params, case = path_case(name)
    reset_launches()
    runs = [run_solve(name, params, case, seed, device, route)
            for seed in [0] + [100 + i for i in range(N_TIMED_SOLVES)]]
    launches = read_launches()
    walls = [w for w, _, _ in runs[1:]]
    c = case[0].shape[1]
    print(f"[{name}] C={c}: median wall {statistics.median(walls) * 1e3:.2f} ms over "
          f"{N_TIMED_SOLVES} solves (min {min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
          f"host syncs per solve {[i['host_syncs'] for _, i, _ in runs[1:]]}; launches over "
          f"{N_TIMED_SOLVES + 1} solves {launches}; card: {card}")
    _, info = psulvsb_solve(
        torch.as_tensor(case[0], device=device), torch.as_tensor(case[1], device=device),
        torch.ones(c, dtype=torch.int64, device=device), params,
        torch.Generator(device=device).manual_seed(7), profile=True,
    )
    stages = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in info["stage_s"].items())
    print(f"[{name}] profiled solve stages: {stages}")
    return [i for _, i, _ in runs], launches


def phase_slice(device, card: str) -> dict:
    _, launches = drive_path("anchor", device, card)
    if launches["gnc_batch"] <= 0:
        raise AssertionError("the anchor solves never launched the GNC kernel")
    return {"launches": launches["gnc_batch"]}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from psulvsb_tpu_torch.ops import gnc, hist, pairs

    gnc.KERNEL_LAUNCHES = 0
    pairs.KERNEL_LAUNCHES = 0
    for name in hist.KERNEL_LAUNCHES:
        hist.KERNEL_LAUNCHES[name] = 0


def read_launches() -> dict:
    from psulvsb_tpu_torch.ops import gnc, hist, pairs

    return {
        "gnc_batch": gnc.KERNEL_LAUNCHES, **hist.KERNEL_LAUNCHES,
        "consistency_degree": pairs.KERNEL_LAUNCHES,
    }


def hist_inputs(c, seed, device, test_scale):
    """A 3DMatch-protocol pair of C points (noise 0.01, 85% mismatch
    outliers) with dst stretched by test_scale, and an active mask with
    about 20% of the points off, as device tensors."""
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

    rng = np.random.default_rng(seed)
    pair = make_synthetic_pair(
        rng, synthetic_cloud(c, seed=seed), 0.01, UNKNOWN_RATE, outlier_mode="mismatch",
        test_scale=test_scale,
    )
    act = rng.uniform(size=c) >= 0.2
    return tuple(torch.as_tensor(x, device=device) for x in (pair.src, pair.dst, act))


def compare_counts(what: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Total count difference between kernel and plain, which must be 0."""
    g = got.cpu().numpy().reshape(-1).astype(np.int64)
    w = want.cpu().numpy().reshape(-1).astype(np.int64)
    diff = int(np.abs(g - w).sum())
    if diff:
        raise AssertionError(f"{what}: kernel counts differ from the plain version's by {diff}")
    return diff


def mask_of(kind: str, c: int, rng, device):
    """An active mask of C points: None (all active), about 80% of them, or
    one of them."""
    if kind == "all":
        return None
    act = rng.uniform(size=c) >= 0.2 if kind == "80%" else np.arange(c) == rng.integers(c)
    return torch.as_tensor(act, device=device)


def beta_edge_inputs(beta: float, seed: int, device, turned: bool, n: int = EDGE_PAIRS):
    """Clouds of 2n points whose pairs sit on the edge of the beta window:
    n points at the origin of both clouds and n on the x axis at v1 (source)
    and v2 (destination), with v2 - v1 = float32(beta) + m ulp(beta), m in
    -2 ... 2, exactly: v2 lies in the binade above beta's on its grid of
    2 ulp and v1 = v2 - beta - m ulp below it on the grid of ulp, and
    sqrt(x x) = x in IEEE arithmetic, so each of the n n pairs between the
    clusters has the difference beta + m ulp to the last bit. `turned`: each
    cloud rotated and shifted, which moves every difference by a few ulp
    either way. Returns (src, dst) on the device."""
    rng = np.random.default_rng(seed)
    b = float(np.float32(beta))
    e = int(np.floor(np.log2(b)))
    ulp = 2.0 ** (e - 23)
    v2 = 2.0 ** (e + 1) + 2 * ulp * rng.integers(0, 2 ** 22, size=n)
    v1 = v2 - b - ulp * rng.integers(-2, 3, size=n)
    for v in (v1, v2):
        if not ((v > 0).all() and (v.astype(np.float32).astype(np.float64) == v).all()):
            raise AssertionError(f"the edge fixture for beta={beta} is not exact in float32")
    clouds = []
    for v in (v1, v2):
        pts = np.zeros((3, 2 * n))
        pts[0, n:] = v
        if turned:
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            pts = q @ pts + rng.normal(size=(3, 1))
        clouds.append(torch.as_tensor(pts.astype(np.float32), device=device))
    return tuple(clouds)


def beta_thresholds(beta: float) -> list[float]:
    """float32(beta) and the values 3 ulp to either side of it."""
    b = np.float32(beta)
    ulp = float(np.spacing(b))
    return [float(b) - 3 * ulp, float(b), float(b) + 3 * ulp]


def phase_pair_kernels(device) -> dict:
    from psulvsb_tpu_torch.ops import hist

    worst = {"hist": 0, "beta": 0}
    for c in HIST_SIZES:
        # Test scale 3.7: the ratio peak (fine bin 74) sits inside the
        # coarse window and the fine window starts past 0.
        src, dst, act = hist_inputs(c, c, device, 3.7)
        coarse = hist.pair_ratio_histogram_reference(src, dst, act, num_bins=128, stride=16)
        lo = max(int(coarse.argmax()) - 1, 0) * 16
        if lo <= 0:
            raise AssertionError(f"the fine window must start past 0, got lo={lo}")
        windows = {
            "coarse 128/16 clamp": dict(num_bins=128, stride=16, clamp_overflow=True),
            f"fine 48/1 drop lo={lo}": dict(num_bins=48, lo_bin=lo, stride=1, clamp_overflow=False),
            "exact_hist 512 clamp": dict(num_bins=512, clamp_overflow=True),
            f"full {PEAK_BINS}/1 clamp": dict(num_bins=PEAK_BINS, clamp_overflow=True),
            f"widest {hist.MAX_BINS}/1 drop lo={lo} (device)": dict(
                num_bins=hist.MAX_BINS, lo_bin=torch.tensor(lo, device=device),
                clamp_overflow=False),
        }
        for wname, kw in windows.items():
            got = hist.pair_ratio_histogram(src, dst, act, **kw)
            want = hist.pair_ratio_histogram_reference(src, dst, act, **kw)
            diff = compare_counts(f"C={c} {wname}", got, want)
            worst["hist"] = max(worst["hist"], diff)
            print(f"[pairs] C={c} histogram {wname}: total {int(want.sum())}, "
                  f"peak bin {int(want.argmax())}, count difference {diff}")
        src1, dst1, _ = hist_inputs(c, c, device, 1.0)
        for preset, beta in BETAS.items():
            got = hist.pair_beta_count(src1, dst1, beta, act)
            want = hist.pair_beta_count_reference(src1, dst1, beta, act)
            diff = compare_counts(f"C={c} beta {beta}", got, want)
            worst["beta"] = max(worst["beta"], diff)
            print(f"[pairs] C={c} beta count ({preset}, beta={beta}): {int(want)}, "
                  f"difference {diff}")
        before = hist.KERNEL_LAUNCHES["pair_ratio_hist"]
        k = [int(x) for x in hist.exact_peak_bin(src, dst, act)]
        if hist.KERNEL_LAUNCHES["pair_ratio_hist"] != before + 1:
            raise AssertionError("exact_peak_bin must launch the histogram kernel once a call")
        p = [int(x) for x in hist.exact_peak_bin_reference(src, dst, act)]
        if k != p:
            raise AssertionError(f"C={c}: exact_peak_bin {k} != plain {p}")
        print(f"[pairs] C={c} exact_peak_bin (peak, count, certified) = {tuple(k)}, as the "
              f"plain two passes, in one launch")
    rng = np.random.default_rng(0)
    for c in EDGE_SIZES:
        src1, dst1, _ = hist_inputs(c, c, device, 1.0)
        for kind in MASKS:
            act = mask_of(kind, c, rng, device)
            for beta in BETAS.values():
                compare_counts(f"C={c} {kind} active, beta {beta}",
                               hist.pair_beta_count(src1, dst1, beta, act),
                               hist.pair_beta_count_reference(src1, dst1, beta, act))
    print(f"[pairs] beta count at C = {', '.join(map(str, EDGE_SIZES))} with {', '.join(MASKS)} "
          f"of the points active, beta {list(BETAS.values())}: difference 0")
    for beta in BETAS.values():
        for turned in (False, True):
            src1, dst1 = beta_edge_inputs(beta, 17, device, turned)
            counts = []
            for b in beta_thresholds(beta):
                want = hist.pair_beta_count_reference(src1, dst1, b)
                compare_counts(f"edge of beta {beta}, threshold {b!r}",
                               hist.pair_beta_count(src1, dst1, b), want)
                counts.append(int(want))
            # The fixture is on the edge: 3 ulp of beta move pairs across it.
            if not counts[0] < counts[1] < counts[2]:
                raise AssertionError(f"edge fixture for beta {beta} is off the edge: {counts}")
            print(f"[pairs] edge of beta {beta} ({'turned' if turned else 'on an axis'}, "
                  f"C={src1.shape[1]}): counts {counts} at beta - 3 ulp, beta, beta + 3 ulp, "
                  f"difference 0")
    src, dst, act = hist_inputs(1889, 7, device, 200.0)
    k = [int(x) for x in hist.exact_peak_bin(src, dst, act)]
    p = [int(x) for x in hist.exact_peak_bin_reference(src, dst, act)]
    if k != p or k[2]:
        raise AssertionError(f"200x scale: exact_peak_bin {k}, plain {p}; must not certify")
    print(f"[pairs] 200x scale: exact_peak_bin {tuple(k)}, not certified, as plain")

    times = {}
    for c in HIST_TIMED_SIZES:
        src, dst, act = hist_inputs(c, c, device, 3.7)
        cases = {
            "exact_peak_bin": (
                lambda: hist.exact_peak_bin(src, dst, act),
                lambda: hist.exact_peak_bin_reference(src, dst, act),
            ),
            "hist coarse 128/16": (
                lambda: hist.pair_ratio_histogram(src, dst, act, num_bins=128, stride=16),
                lambda: hist.pair_ratio_histogram_reference(src, dst, act, num_bins=128, stride=16),
            ),
            "hist exact_hist 512": (
                lambda: hist.pair_ratio_histogram(src, dst, act, num_bins=512),
                lambda: hist.pair_ratio_histogram_reference(src, dst, act, num_bins=512),
            ),
        }
        bounds = {
            # The full pass's counts, the peak, its count and the certificate.
            "exact_peak_bin": pair_grid_bound("pair_ratio_hist", act, PEAK_BINS * 8 + 17),
            "hist coarse 128/16": pair_grid_bound("pair_ratio_hist", act, 128 * 8),
            "hist exact_hist 512": pair_grid_bound("pair_ratio_hist", act, 512 * 8),
        }
        for label, (kern, plain) in cases.items():
            ms = median_ms(kern)
            plain_ms = median_ms(plain)
            times[(label, c)] = (ms, plain_ms, bounds[label])
            print(f"[pairs] C={c} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(median of 20, CUDA events); bound {bounds[label][0]:.6f} ms by "
                  f"{bounds[label][1]}")
        # One launch and the zeroing of its counts a call.
        dev_us = kernel_device_us(
            lambda: hist.exact_peak_bin(src, dst, act), "pair_ratio_hist", others=1
        )
        print(f"[pairs] C={c} exact_peak_bin: device {dev_us:.2f} us a launch (profiler, mean "
              f"of {PROFILED_REPS})")
    for c in BETA_TIMED_SIZES:
        src, dst, act = hist_inputs(c, c, device, 1.0)
        ms = median_ms(lambda: hist.pair_beta_count(src, dst, 0.1, act))
        plain_ms = median_ms(lambda: hist.pair_beta_count_reference(src, dst, 0.1, act))
        bound = pair_grid_bound("pair_beta_count", act, 8)
        times[("beta 0.1", c)] = (ms, plain_ms, bound)
        # One launch and the zeroing of its count a call.
        dev_us = kernel_device_us(
            lambda: hist.pair_beta_count(src, dst, 0.1, act), "pair_beta_count", others=1
        )
        print(f"[pairs] C={c} beta 0.1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of "
              f"20, CUDA events); device {dev_us:.2f} us a launch (profiler, mean of "
              f"{PROFILED_REPS}); bound {bound[0]:.6f} ms by {bound[1]}")
    return {"max_diff": worst, "times": times}


def phase_unknown_scale(device, card: str) -> dict:
    _, launches = drive_path("unknown", device, card, route="dense")
    # exact_peak_bin: one histogram launch a solve.
    if launches["pair_ratio_hist"] != N_TIMED_SOLVES + 1 or launches["gnc_batch"] <= 0:
        raise AssertionError(f"the unknown-scale solves must launch the histogram kernel once "
                             f"each and the GNC kernel: {launches}")
    return {"launches": launches}


def phase_wide(device) -> dict:
    reset_launches()
    run_solve("wide", *path_case("wide"), 1, device, "exact_beta")
    beta = read_launches()
    if beta["pair_beta_count"] <= 0 or beta["gnc_batch"] <= 0:
        raise AssertionError(f"the C={WIDE_C} known-scale solve missed a kernel: {beta}")
    reset_launches()
    run_solve("wide", unknown_scale_params(), unknown_scale_case(WIDE_C, 4), 1, device,
              "exact_hist")
    hist_run = read_launches()
    if hist_run["pair_ratio_hist"] <= 0 or hist_run["gnc_batch"] <= 0:
        raise AssertionError(f"the C={WIDE_C} unknown-scale solve missed a kernel: {hist_run}")
    print(f"[wide] C={WIDE_C}: launches, known scale {beta}; unknown scale {hist_run}")
    return {"beta": beta, "hist": hist_run}


def degree_inputs(c, seed, device):
    """An anchor-protocol pair of C points (noise 0.05, 90% displaced
    outliers) and an active mask with about 20% of the points off."""
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

    rng = np.random.default_rng(seed)
    pair = make_synthetic_pair(rng, synthetic_cloud(c, seed=seed), 0.05, 0.9)
    act = rng.uniform(size=c) >= 0.2
    return tuple(torch.as_tensor(x, device=device) for x in (pair.src, pair.dst, act))


def phase_degree_kernel(device) -> dict:
    from psulvsb_tpu_torch.ops import pairs

    worst = 0
    rng = np.random.default_rng(0)
    for c in DEGREE_SIZES + list(EDGE_SIZES):
        src, dst, _ = degree_inputs(c, c, device)
        for kind in MASKS:
            act = mask_of(kind, c, rng, device)
            for tau in GROR_TAUS:
                before = pairs.KERNEL_LAUNCHES
                got = pairs.consistency_degree(src, dst, tau, act)
                if pairs.KERNEL_LAUNCHES != before + 1:
                    raise AssertionError("consistency_degree must launch its kernel once a call")
                want = pairs.consistency_degree_reference(src, dst, tau, act)
                torch.cuda.synchronize()
                what = f"C={c} {kind} active, tau={tau}"
                worst = max(worst, compare_counts(what, got, want))
                if act is not None and bool(got[~act].any()):
                    raise AssertionError(f"{what}: an inactive point has a degree")
                if c in DEGREE_SIZES:
                    print(f"[degree] {what}: mean degree {float(want.float().mean()):.2f}, "
                          f"max {int(want.max())}, kernel vs plain difference 0")
    print(f"[degree] C = {', '.join(map(str, EDGE_SIZES))} with {', '.join(MASKS)} of the "
          f"points active, tau {list(GROR_TAUS)}: difference 0")
    x = torch.zeros(3, 5, device=device)
    if pairs.consistency_degree(x, x, 0.1, torch.zeros(5, dtype=torch.bool, device=device)).any():
        raise AssertionError("an all-inactive input must give zero degrees")
    try:
        pairs.consistency_degree(x[:, :0], x[:, :0], 0.1)
    except ValueError:
        pass
    else:
        raise AssertionError("C = 0 must raise ValueError")
    print("[degree] all-inactive input -> zeros; C=0 raises")

    times = {}
    for c in DEGREE_TIMED_SIZES:
        src, dst, act = degree_inputs(c, c, device)
        ms = median_ms(lambda: pairs.consistency_degree(src, dst, 0.1, act))
        plain_ms = median_ms(lambda: pairs.consistency_degree_reference(src, dst, 0.1, act))
        bound = pair_grid_bound("consistency_degree", act, 4 * c)
        times[c] = (ms, plain_ms, bound)
        # One launch and the zeroing of its degrees a call.
        dev_us = kernel_device_us(
            lambda: pairs.consistency_degree(src, dst, 0.1, act), "consistency_degree", others=1
        )
        print(f"[degree] C={c}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, "
              f"CUDA events); device {dev_us:.2f} us a launch (profiler, mean of "
              f"{PROFILED_REPS}); bound {bound[0]:.6f} ms by {bound[1]}")
    return {"max_diff": worst, "times": times}


def phase_gror_slice(device, card: str) -> dict:
    infos, launches = drive_path("gror", device, card)
    if not all(i["gror_init"] for i in infos):
        raise AssertionError("GROR's seed was not adopted")
    if launches["consistency_degree"] != N_TIMED_SOLVES + 1 or launches["gnc_batch"] <= 0:
        raise AssertionError(f"the GROR solves must launch the degree kernel once each: {launches}")
    return {"launches": launches}


def phase_frontend(device, card: str) -> dict:
    from psulvsb_tpu_torch.eval.frontend_protocol import frontend_solver_params

    params = frontend_solver_params(**CAPS)
    reset_launches()
    summary = {}
    for tag in FRONTEND_TAGS:
        case = frontend_case(tag)
        results = [
            run_solve(f"frontend {tag}", params, case, seed, device,
                      limits=KITTI_LIMITS, gate=tag == FRONTEND_GATED)
            for seed in range(N_TIMED_SOLVES)
        ]
        summary[tag] = sum(ok for _, _, ok in results)
        walls = [w for w, _, _ in results]
        print(f"[frontend] {tag} (C={case[0].shape[1]}): {summary[tag]} of {N_TIMED_SOLVES} "
              f"pass the KITTI gates; rescue adopted in "
              f"{sum(bool(i['translation_rescued']) for _, i, _ in results)}; median wall "
              f"{statistics.median(walls) * 1e3:.2f} ms")
    launches = read_launches()
    print(f"[frontend] launches over {len(FRONTEND_TAGS) * N_TIMED_SOLVES} solves {launches}; "
          f"card: {card}")
    for name in ("consistency_degree", "pair_ratio_hist", "gnc_batch"):
        if launches[name] <= 0:
            raise AssertionError(f"the front-end solves never launched {name}: {launches}")
    if launches["pair_ratio_hist"] != len(FRONTEND_TAGS) * N_TIMED_SOLVES:
        raise AssertionError(f"exact_peak_bin must launch the histogram kernel once a solve: "
                             f"{launches}")
    return {"launches": launches, "passed": summary}


def phase_clique(device, card: str) -> dict:
    from psulvsb_tpu_torch import SolverParams
    from psulvsb_tpu_torch.clique import triangle_scores

    # (a) the eager seed on the anchor pair.
    reset_launches()
    _, info, _ = run_solve(
        "clique eager", SolverParams.preset_artificial_gror(clique_init="eager", **CAPS),
        anchor_case(), 0, device,
    )
    eager = read_launches()
    if not info["clique_seeded"] or eager["gnc_batch"] <= 0:
        raise AssertionError(f"the eager clique seed did not run and adopt: {info['clique_seeded']}")
    print(f"[clique] eager seed adopted; launches {eager}")

    # (b) the lazy seed and the b_rate == 1.0 round at 99% displaced outliers.
    case = anchor_case(rate=HOSTILE_RATE, data_seed=HOSTILE_DATA_SEED)
    params = SolverParams.preset_artificial(**CAPS)  # the bench anchor's program
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    runs = [run_solve("clique hostile", params, case, seed, device, gate=False)
            for seed in HOSTILE_SOLVE_SEEDS]
    hostile = read_launches()
    peak = torch.cuda.max_memory_allocated(device)
    seeded = sum(bool(i["clique_seeded"]) for _, i, _ in runs)
    rounds = sum(i["clique_rounds"] for _, i, _ in runs)
    with_rounds = sum(i["clique_rounds"] > 0 for _, i, _ in runs)
    print(f"[clique] {HOSTILE_RATE:.0%} displaced, C={ANCHOR_C}, data seed {HOSTILE_DATA_SEED}: "
          f"lazy seed adopted in {seeded} of {len(runs)} solves, b_rate == 1.0 clique rounds "
          f"{rounds} in {with_rounds} solves; recall {sum(ok for _, _, ok in runs)}/{len(runs)} "
          f"(JAX on the CPU: "
          f"{JAX_CPU_HOSTILE_RECALL}); peak device memory {peak / 2**20:.1f} MiB; launches "
          f"{hostile}; card: {card}")
    if seeded == 0 or rounds == 0:
        raise AssertionError(f"the clique stages did not run: seeded {seeded}, rounds {rounds}")

    # (c) memory of the clique round's batched products at C = 8192.
    c = CLIQUE_MEMORY_C
    gen = torch.Generator(device=device).manual_seed(0)
    adj = torch.rand((4, c, c), generator=gen, device=device) < 0.01
    adj = adj | adj.transpose(1, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    scores = triangle_scores(adj)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("non-finite triangle scores")
    print(f"[clique] triangle_scores over (4, {c}, {c}) graphs: {ms:.2f} ms, peak device "
          f"memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return {"seeded": seeded, "rounds": rounds}


FUSED_PATHS = ("anchor", "unknown", "wide", "gror", "frontend", "hostile")
BATCH_SIZES = {"anchor": (8, 32), "unknown": (8,)}
BATCH_C = {"anchor": ANCHOR_C, "unknown": UNKNOWN_C}
PIPELINE_BUCKET = 2048


def fused_case(name, variant=0):
    """(params, case, limits, gated) of a path the fused solve is held on:
    path_case's, or the hostile pair of phase 11. variant 1 is a second pair
    of the same shape: other data seeds for the synthetic protocols, the
    columns turned by one for the real pair."""
    from psulvsb_tpu_torch import SolverParams

    if name == "hostile":  # recall is printed, not gated: phase 11 (b)
        case = anchor_case(rate=HOSTILE_RATE, data_seed=HOSTILE_DATA_SEED + variant)
        return SolverParams.preset_artificial(**CAPS), case, LIMITS, False
    params, case = path_case(name)
    if variant:
        if name == "frontend":
            case = (np.roll(case[0], 1, axis=1), np.roll(case[1], 1, axis=1), case[2])
        elif name == "unknown":
            case = unknown_scale_case(UNKNOWN_C, 6)
        else:
            c = case[0].shape[1]
            case = anchor_case(c, data_seed=11, cloud_seed=11)
    return params, case, (KITTI_LIMITS if name == "frontend" else LIMITS), True


def on_device(case, device):
    """A case's clouds and an all-ones keep mask as device tensors."""
    src = torch.as_tensor(case[0], device=device)
    dst = torch.as_tensor(case[1], device=device)
    return src, dst, torch.ones(src.shape[1], dtype=torch.int64, device=device)


def solution_difference(a, b) -> float:
    """Largest absolute difference over two solutions' fields."""
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def phase_replay_vs_eager(device, card: str) -> dict:
    """Phase 12: replayed graphs against the same segments run eagerly."""
    from psulvsb_tpu_torch.solver.fused import plan_for, psulvsb_register

    plans = {}
    for name in FUSED_PATHS:
        for variant in (0, 1):
            params, case, _, _ = fused_case(name, variant)
            src, dst, keep = on_device(case, device)
            for seed in (3, 4):
                replayed = psulvsb_register(src, dst, keep, seed, params)
                eager = psulvsb_register(src, dst, keep, seed, params, graphs=False)
                torch.cuda.synchronize()
                diff = solution_difference(replayed, eager)
                print(f"[replay] {name} pair {variant} seed {seed}: valid={bool(replayed.valid)} "
                      f"inliers={int(replayed.final_inlier_count)} replay - eager = {diff}")
                if diff != 0.0 or bool(replayed.valid) != bool(eager.valid):
                    raise AssertionError(f"{name}: a replayed plan differs from its eager run by "
                                         f"{diff}")
        plan = plan_for(params, src.shape[1], device)
        plans[name] = {"build_s": plan.build_s, "segments": len(plan.segments),
                       "bytes": plan.nbytes}
        print(json.dumps({"plan": name, "C": src.shape[1], "build_s": round(plan.build_s, 3),
                          "segments": len(plan.segments), "bytes": plan.nbytes,
                          "MiB": round(plan.nbytes / 2**20, 1), "card": card}))
    return plans


def timed_walls(fn, seeds) -> list[float]:
    """Wall milliseconds of fn(seed), each to a device synchronization."""
    walls = []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(seed)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def profiled_operations(fn, reps: int = 3) -> tuple[float, float]:
    """(device operations, host-issued operations) a call of fn over `reps`
    calls under torch.profiler: kernels, copies and fills that ran on the
    card, and the host's launch, graph-launch, copy and fill calls. A window
    that lost its device records is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    issued = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
              "cuLaunchKernel")
    for _ in range(PROFILER_ATTEMPTS):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_MARGIN_S)
        events = list(prof.events())
        on_device_n = sum(e.device_type == DeviceType.CUDA for e in events)
        host_n = sum(e.device_type == DeviceType.CPU and e.name.startswith(issued) for e in events)
        if on_device_n >= reps:
            break
        print(f"[profiler] {on_device_n} device records over {reps} solves: again")
    return on_device_n / reps, host_n / reps


def phase_fused_paths(device, card: str) -> dict:
    """Phase 13: the fused path's gates, walls, reads and launches."""
    from psulvsb_tpu_torch import psulvsb_solve
    from psulvsb_tpu_torch.solver.fused import plan_for, psulvsb_register

    out = {}
    seeds = [100 + i for i in range(N_TIMED_SOLVES)]
    for name in FUSED_PATHS:
        params, case, limits, gated = fused_case(name)
        src, dst, keep = on_device(case, device)
        plan = plan_for(params, src.shape[1], device)

        def staged(seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            return psulvsb_solve(src, dst, keep, params, gen)

        def fused(seed):
            return psulvsb_register(src, dst, keep, seed, params)

        fused(0)  # every segment this path takes is captured before the count
        reset_launches()
        passed, reads, replays, syncs, staged_passed = 0, [], [], [], 0
        for seed in seeds:
            sol = fused(seed)
            valid, re, te, se, ok = score_solution(f"fused {name}", sol, case[2], limits)
            stats = dict(plan.stats)
            reads.append(stats["host_reads"])
            replays.append(stats["graph_replays"])
            print(f"[fused {name}] seed={seed}: valid={valid} RE={re:.4f} deg TE={te:.5f} "
                  f"scale error {se:.5f} rounds={stats['rounds']} "
                  f"batches={stats['local_batches']} host_reads={stats['host_reads']} "
                  f"graph_replays={stats['graph_replays']}")
            if gated and not ok:
                raise AssertionError(f"fused {name} seed {seed} failed its gate: valid={valid} "
                                     f"RE={re} TE={te} scale error={se}")
            passed += ok
        launches = read_launches()
        for seed in seeds:
            sol_s, info = staged(seed)
            syncs.append(info["host_syncs"])
            staged_passed += score_solution(f"staged {name}", sol_s, case[2], limits)[4]
            if reads[len(syncs) - 1] > info["host_syncs"] - 1:
                raise AssertionError(f"fused {name}: more host reads than the staged solver")
        turns = [timed_walls(f, seeds) for f in (staged, fused, fused, staged)]
        med = [statistics.median(t) for t in turns]
        dev_f, host_f = profiled_operations(lambda: fused(7))
        dev_s, host_s = profiled_operations(lambda: staged(7))
        out[name] = {
            "path": name, "C": src.shape[1], "passed": passed, "staged_passed": staged_passed,
            "solves": len(seeds),
            "wall_ms_staged": [med[0], med[3]], "wall_ms_fused": [med[1], med[2]],
            "host_reads_fused": reads, "host_syncs_staged": syncs, "graph_replays": replays,
            "device_ops_fused": dev_f, "host_issued_ops_fused": host_f,
            "device_ops_staged": dev_s, "host_issued_ops_staged": host_s,
            "launches": launches, "plan_build_s": round(plan.build_s, 3),
            "plan_bytes": plan.nbytes, "card": card,
        }
        print(json.dumps(out[name]))
        if launches["gnc_batch"] < sum(r for r in replays) // 4:
            raise AssertionError(f"fused {name}: the replays' GNC launches were not counted: "
                                 f"{launches}")
    need = {"unknown": "pair_ratio_hist", "wide": "pair_beta_count", "gror": "consistency_degree",
            "frontend": "consistency_degree"}
    for name, kernel in need.items():
        if out[name]["launches"][kernel] != N_TIMED_SOLVES:
            raise AssertionError(f"fused {name} must launch {kernel} once a solve: "
                                 f"{out[name]['launches']}")
    return out


def batch_cases(name, b):
    """B pairs of a protocol, a pair a seed: stacked (src, dst), truths."""
    cases = [
        anchor_case(data_seed=200 + i, cloud_seed=200 + i) if name == "anchor"
        else unknown_scale_case(UNKNOWN_C, 200 + i)
        for i in range(b)
    ]
    src = np.stack([c[0] for c in cases]).astype(np.float32)
    dst = np.stack([c[1] for c in cases]).astype(np.float32)
    return src, dst, [c[2] for c in cases]


def phase_pair_batch(device, card: str) -> list:
    """Phase 14: register_batch in its two forms beside serial solves."""
    from psulvsb_tpu_torch import RegistrationSolution, psulvsb_solve, register_batch
    from psulvsb_tpu_torch.solver.fused import psulvsb_register

    rows = []
    for name, sizes in BATCH_SIZES.items():
        params = path_case(name)[0] if name == "anchor" else unknown_scale_params()
        for b in sizes:
            src_np, dst_np, truths = batch_cases(name, b)
            src = torch.as_tensor(src_np, device=device)
            dst = torch.as_tensor(dst_np, device=device)
            keep = torch.ones((b, src.shape[2]), dtype=torch.int64, device=device)
            seeds = [300 + i for i in range(b)]

            def serial():
                for i in range(b):
                    gen = torch.Generator(device=device).manual_seed(seeds[i])
                    psulvsb_solve(src[i], dst[i], keep[i], params, gen)

            def batch(vectorized):
                return register_batch(src, dst, keep, seeds, params, vectorized=vectorized)

            forms = {"in order": batch(False), "in flight": batch(True)}  # plans built here
            torch.cuda.synchronize()
            for form, sols in forms.items():
                for i in range(b):
                    one = RegistrationSolution(*(f[i] for f in sols))
                    valid, re, te, se, ok = score_solution(f"batch {name} {form} pair {i}", one,
                                                           truths[i])
                    if not ok:
                        raise AssertionError(f"batch {name} B={b} {form}: pair {i} failed its "
                                             f"gate: valid={valid} RE={re} TE={te} scale {se}")
            for i in (0, b - 1):
                alone = psulvsb_register(src[i], dst[i], keep[i], seeds[i], params)
                for form, sols in forms.items():
                    diff = solution_difference(
                        RegistrationSolution(*(f[i] for f in sols)), alone)
                    if diff != 0.0:
                        raise AssertionError(f"batch {name} {form}: pair {i} differs from its "
                                             f"solve alone by {diff}")
            order = ((serial, "serial"), (lambda: batch(False), "in order"),
                     (lambda: batch(True), "in flight"))
            rates = {label: [] for _, label in order}
            for fn, label in order + order[::-1]:  # in turns, there and back
                wall = timed_walls(lambda _: fn(), [0])[0]
                rates[label].append(b / (wall * 1e-3))
            rows.append({
                "batch": name, "B": b, "C": src.shape[2], "gated_pairs": b,
                "pairs_per_s_serial_staged": rates["serial"],
                "pairs_per_s_register_batch": rates["in order"],
                "pairs_per_s_vectorized": rates["in flight"], "card": card,
            })
            print(json.dumps(rows[-1]))
    return rows


def phase_pipeline(device, card: str) -> dict:
    """Phase 15: pad to the bucket, the pre-filter off and on, the fused solve."""
    from psulvsb_tpu_torch import solve_with_prefilter
    from psulvsb_tpu_torch.eval.frontend_protocol import frontend_solver_params
    from psulvsb_tpu_torch.eval.pipeline import pad_bucket

    params = frontend_solver_params(**CAPS)
    src, dst, truth = frontend_case(FRONTEND_GATED)
    c = src.shape[1]
    if pad_bucket(c) != PIPELINE_BUCKET:
        raise AssertionError(f"{FRONTEND_GATED} (C={c}) must pad to {PIPELINE_BUCKET}")
    out = {"pair": FRONTEND_GATED, "C": c, "bucket": PIPELINE_BUCKET, "card": card}
    for use_prefilter in (False, True):
        solve_with_prefilter(src, dst, params, 0, use_prefilter=use_prefilter)  # builds the plan
        res = solve_with_prefilter(src, dst, params, 1, use_prefilter=use_prefilter)
        keep = res.keep_mask.cpu().numpy()
        if keep.shape != (PIPELINE_BUCKET,) or not (keep[c:] == -2).all() or (keep[:c] == -2).any():
            raise AssertionError("padding columns must be the -2 entries of the keep mask")
        valid, re, te, _, ok = score_solution(f"pipeline prefilter={use_prefilter}", res.solution,
                                              truth, KITTI_LIMITS)
        if int(res.solution.final_inlier_count) > c:
            raise AssertionError("a padding column was counted as an inlier")
        counts = {str(v): int((keep == v).sum()) for v in (1, 0, -1, -2)}
        tag = "prefilter_on" if use_prefilter else "prefilter_off"
        out[tag] = {"valid": valid, "RE_deg": re, "TE": te, "passes_kitti": ok,
                    "keep_mask_counts": counts, "elapsed_ms": res.elapsed_s * 1e3}
        # The pre-filter may discard true inliers of a large-rotation pair
        # (pipeline.py's docstring): only the unfiltered solve is gated.
        if not use_prefilter and not ok:
            raise AssertionError(f"pipeline without the pre-filter failed the KITTI gates: "
                                 f"valid={valid} RE={re} TE={te}")
    print(json.dumps(out))
    return out


def build_all() -> None:
    """Build every kernel, one nvcc each, all started together."""
    from psulvsb_tpu_torch.ops._build import BUILD_INFO, load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(load_library, KERNELS))
    for name in KERNELS:
        info = BUILD_INFO[name]
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        what = f"nvcc {info['seconds']:.2f} s; " + " | ".join(regs) if info["log"] else "cached"
        print(f"[build] {name}.cu: {what}")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    from psulvsb_tpu_torch.utils.precision import pin_float32

    pin_float32()
    build_all()

    kern = phase_kernel_vs_plain(device)
    sl = phase_slice(device, card)
    pairs = phase_pair_kernels(device)
    unknown = phase_unknown_scale(device, card)
    wide = phase_wide(device)
    degree = phase_degree_kernel(device)
    gror = phase_gror_slice(device, card)
    phase_frontend(device, card)
    phase_clique(device, card)
    phase_replay_vs_eager(device, card)
    fused = phase_fused_paths(device, card)
    phase_pair_batch(device, card)
    phase_pipeline(device, card)

    def row(name, source, replaces, path, staged, err, timed):
        """`launches`: over the fused path's N_TIMED_SOLVES solves, replayed
        launches included; `launches_staged`: over the staged path's solves."""
        ms, plain_ms, (bound, bound_by) = timed
        if staged <= 0 or fused[path]["launches"][name] <= 0:
            raise AssertionError(f"{name} did not launch on the {path} path")
        return {
            "name": name, "route": "cuda", "source": f"psulvsb_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": fused[path]["launches"][name],
            "launches_staged": staged, "path": path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            # No single PyTorch call computes any of these functions.
            "library_ms": None,
        }

    print(card_line())
    print(json.dumps({"kernels": [
        row("gnc_batch", "gnc_batch.cu", "psulvsb_tpu/ops/pallas_gnc.py:235", "anchor",
            sl["launches"], kern["max_abs_err"], kern["times"][(4, 256)]),
        row("pair_ratio_hist", "pair_ratio_hist.cu", "psulvsb_tpu/ops/pallas_hist.py:120",
            "unknown", unknown["launches"]["pair_ratio_hist"], pairs["max_diff"]["hist"],
            pairs["times"][("exact_peak_bin", UNKNOWN_C)]),
        row("pair_beta_count", "pair_beta_count.cu", "psulvsb_tpu/ops/pallas_hist.py:241",
            "wide", wide["beta"]["pair_beta_count"], pairs["max_diff"]["beta"],
            pairs["times"][("beta 0.1", WIDE_C)]),
        row("consistency_degree", "consistency_degree.cu",
            "psulvsb_tpu/ops/pallas_pairs.py:53", "gror",
            gror["launches"]["consistency_degree"], degree["max_diff"],
            degree["times"][ANCHOR_C]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
