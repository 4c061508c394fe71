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
16. the classic solve — RobustRegistrationSolver.solve_decoupled (scale ->
   max clique -> rotation by the single-problem GNC loop, which the JAX
   package too runs outside any kernel -> translation) on the anchor pair (C = 1889, 90%
   displaced, known scale) and on an unknown-scale pair (C = 1889, the
   protocol of phase 6), PMC_EXACT through the native library, which must
   have been built from native/maxclique.cpp: RE < 5 deg, TE < 0.3 in the
   upstream convention (t not divided by s), scale error <= 0.1; the clique
   returned must be a clique of the scale-consistency graph of the size
   that exact_max_clique finds on it, printed beside the greedy's, with the
   wall;
17. the exact clique round — the hostile pair of phase 11 with
   exact_clique_callback=True over the same 12 seeds, staged and fused: a
   b_rate == 1.0 round must have gone through the native exact search (the
   searches are counted), recall is printed beside the greedy's and not
   gated (as in phase 11 (b)), and the wall a solve beside the greedy's, in
   turns, staged and fused;
18. FGR and "eigh" — the anchor with rotation_estimation_algorithm=FGR and
   with gnc_rot_method="eigh", staged and fused (replayed against eager),
   under phase 4's gates; the "eigh" solves must launch the GNC kernel 0
   times and count the plain route, and a "power" solve right after must
   launch it again;
19. the dataset sweep — eval.make_dataset.write_benchmark of one 3DMatch
   scene (30 pairs of 3500, 5000 and 6500 correspondences: the 4096, 6144
   and 8192 buckets; 60-95% mismatch outliers), then
   eval.batch_harness.run_benchmark_batched over register_batch with
   preset_3dmatch at the caps (2048, 256, 4): ddtime 10 at known scale (300
   solves, the pre-filter on), then ddtime 2 with unknown_scale=True, which
   launches the histogram kernel. Recall, pairs and solves per second, the
   split of the timed region and the peak device memory are printed. Every
   pair at an outlier rate <= 0.9 must succeed under
   SuccessCriteria.threedmatch() at known scale; for the first six pairs
   the serial eval.realdata.run_scene must give the batched harness's
   PairResult apart from time_s; a second run with resume=True must reuse
   the sidecar and one with another ddtime must not;
20. the certifier — certify.drs.DRSCertifier.certify at its defaults (float64 on
   the card) against the same call with device="cpu" (float64 on the host) on
   the three cases of tests/test_certify.py:151-191 (the SVD optimum of 10
   noisy points with polish=True certifies; a rotation 0.2 rad off does not, at
   max_iterations=50; 12 noise-free points with two outliers at theta = -1
   certify): is_optimal equal and as stated, best_suboptimality within
   CERT_CARD_HOST_TOL, the results float64 tensors on the card; float32 on the
   card within 2e-2 of float64 (the JAX package's tolerance) on the case that
   is not near-noiseless (the other two are printed: mu ~ noise^2 floors a
   float32 gap). The wall a certify at N = 12 and 64 TIMs on the
   card and on the host, in turns (card, host, host, card);
21. the front end — eval.frontend_protocol.make_frontend_pair at its defaults
   (24000 scene points, bucket 8192, max_corr 6144) on the card for seeds 62,
   11 and 1375, each in the regime of JAX's test_match_quality_regime (C >= 800,
   >= 20 true inliers); one cloud's _extract_padded on the card against the
   CPU (the points and the active mask equal, ISS keypoint labels off on at
   most FE_LABELS_OFF of the points, feature rows within FE_TOL) and a
   pair's mutual matches on the card against the CPU (at least FE_MATCH_AGREE
   of them common); the wall of each stage (voxel on the host, normals, ISS,
   FPFH, matching); write_frontend_benchmark of one scene of FE_SWEEP_PAIRS
   pairs and run_benchmark_batched(dataset="kitti", frontend_solver_params at
   the caps, ddtime FE_SWEEP_DDTIME, certify=True): recall >= 5/6, every
   success carries a certificate, each winner's certificate on the card equals
   the host's float64 one on the same TIMs, consistency_degree and gnc_batch
   launched; the same scene with unknown_scale=True at ddtime 1 (the scale
   estimated: pair_ratio_hist must launch; recall printed); ICP refinement of
   one solved pair (it must stay within 5 degrees of the coarse rotation);
   eval.realscan.register_realscan on two PLYs written from a structured-scene
   pair (ICP must converge before its cap of 100 iterations); eval.corr_gen
   .generate_correspondences (ISS keypoints) on one pair;
22. entry points — psulvsb_tpu_torch.cli.main in-process on the anchor
   pair (C = 1889, written 3xN as MATLAB's writematrix writes it, known
   scale, noise 0.05), on the unknown-scale pair of phase 6 (C = 5000,
   written Nx3, the CLI's defaults but the noise bound: scale estimated,
   basic_cap 2048, hypothesis_batch 16) and on the anchor with --pipeline
   decoupled, twice each: the seven output lines in the JAX CLI's order,
   valid 1, RE < 5 deg, TE < 0.3, scale error <= 0.1; gnc_batch launched on
   both PSULVSB runs, pair_ratio_hist on the unknown-scale one. Then
   `python -m psulvsb_tpu_torch.cli` as a process on both pairs, warm (this
   tree's built kernels) and cold (a copy of the package with nothing
   built), under the same gates, with walls. Then the seven examples'
   main() on the card: psulvsb_demo at its defaults (recall >= 1/2 of 10
   trials, printed beside the JAX package's CPU recall), certify_demo (the
   estimate certified, the identity not), fpfh_icp_pipeline and
   generate_correspondences on PLYs of phase 21's real-scan pair,
   learned_descriptor_bench on npz of the port's FPFH features of it (RE <
   5 deg, TE < 0.3 against its pose; >= 10 true matches), kitti_scale_
   pipeline at its defaults (100000 points; RE, TE), benchmark_3dmatch
   --batched --ddtime 1 on phase 19's scene (recall >= 2/3); each
   example's wall and launches. Then core.linalg.batched_eigh, the front
   end's chunked 3x3 eigen-solve, at 44027 matrices (the KITTI example's
   cloud) against the host's float64 (within 1e-9). Then utils.timing: timed() around an
   anchor solve reads at least its CUDA-event time, and trace() writes a
   Chrome trace that names gnc_batch_kernel;
23. reference-scale tools — tools/fullscale_sweep_torch.py's `sweep` on
   the smallest 3DMatch scene of the full-scale protocol (sun3d-hotel_umd-
   maryland_hotel3, 54 pairs) and on kitti_seq07 (69 pairs), at ddtime 10
   and the tool's full correspondence counts: recall 1.0 on each scene, as
   FULLSCALE_r05/summary.json has for both; tools/clique_scale_audit_torch.py's
   `audit_case` on the C = 2048 ratio-window case of tests/test_clique.py
   (93% mismatch, seed 2093): the exact search finishes and tri-greedy /
   exact >= 0.95; tools/cap_sweep_torch.py's `sweep_point` at the shipped
   caps and at (2048, 512, 4, 16384), k = 3: ok on both fixtures; the five
   TEASER++ sub-solver facades once on the card, each held to its CPU result
   (rotation within 1e-4, scale and translation within 1e-5, inlier masks
   equal). gnc_batch must have launched in the sweeps and the cap sweep;
24. result — the card line, a JSON line of per-kernel figures (time,
   plain time, bound, launches on the fused path that runs it, in the
   sweeps, on the CLI and in phase 23's tools), and the final JSON line
   {"ok": true, "device": {...}}.

Every launch count is set to 0 just before a phase drives a solve path and
read just after it; launches made to compare a kernel with its plain
version are not counted in any path. A replayed graph launches the kernels
it captured without calling their wrappers: the plan adds those to the
wrappers' counts at each replay (a capture itself launches nothing and is
not counted).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
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


CLASSIC_UNKNOWN_C = ANCHOR_C  # 1.78 M complete-graph TIMs
EXACT_TURN_SEEDS = HOSTILE_SOLVE_SEEDS[:6]
VARIANT_SEEDS = (100, 101, 102)
SWEEP_SCENE = "7-scenes-redkitchen"
SWEEP_PAIRS = 30  # bench.py:96-102: the sizes below, ddtime 10, the caps of CAPS
SWEEP_SIZES = (3500, 5000, 6500)
SWEEP_DDTIME = 10
SWEEP_UNKNOWN_DDTIME = 2
SWEEP_GATED_RATE = 0.9
SWEEP_SERIAL_PAIRS = 6


def phase_classic(device, card: str) -> dict:
    """Phase 16: the classic decoupled solve through the native exact clique."""
    from psulvsb_tpu_torch import RobustRegistrationSolver, SolverParams
    from psulvsb_tpu_torch.clique import greedy_clique, pmc
    from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
    from psulvsb_tpu_torch.ops import gnc
    from psulvsb_tpu_torch.pairs.tims import compute_tims
    from psulvsb_tpu_torch.rotation.gnc import gnc_tls_rotation
    from psulvsb_tpu_torch.solver.classic import consistency_graph

    if not pmc.native_available():
        raise AssertionError("the native clique library did not build from native/maxclique.cpp")
    out = {}
    cases = {
        "anchor": (SolverParams.preset_artificial(), anchor_case()),
        "unknown": (SolverParams.preset_3dmatch(estimate_scaling=True),
                    unknown_scale_case(CLASSIC_UNKNOWN_C, 5)),
    }
    for name, (params, (src, dst, (rot_true, t_true, test_scale))) in cases.items():
        solver = RobustRegistrationSolver(params, seed=0, device=device)
        walls = []
        for _ in range(2):  # the second solve finds everything built and loaded
            searches = pmc.EXACT_SEARCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solver.solve_decoupled(src, dst)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if pmc.EXACT_SEARCHES != searches + 1:
            raise AssertionError("solve_decoupled with PMC_EXACT did not run the exact search")
        if sol.rotation.device != device:
            raise AssertionError(f"solve_decoupled ran on {sol.rotation.device}, not {device}")
        scale = float(sol.scale)
        re = angular_error_deg_np(rot_true, sol.rotation.cpu().numpy())
        # Upstream convention: dst = s R src + t.
        te = float(np.linalg.norm(sol.translation.cpu().numpy().astype(np.float64) / test_scale
                                  - t_true))
        se = abs(scale - test_scale)
        clique = solver._info["max_clique"]
        c = src.shape[1]
        _, idx_i, idx_j, _ = compute_tims(torch.as_tensor(src, device=device))
        adj = consistency_graph(idx_i, idx_j, solver.getScaleInliersMask(), c)
        members = torch.as_tensor(clique, device=device)
        sub = adj[members][:, members]
        is_clique = bool((sub | torch.eye(len(clique), dtype=torch.bool, device=device)).all())
        again = pmc.exact_max_clique(adj.cpu().numpy(), params.max_clique_time_limit)
        t0 = time.perf_counter()
        greedy, reads = greedy_clique(adj)
        greedy_n = int(greedy.sum())
        greedy_ms = (time.perf_counter() - t0) * 1e3
        # The rotation stage alone, as the solve runs it (the single-problem
        # loop), beside the batched kernel on the same TIMs, which it does
        # not take: what one route for every size of the TIM set costs.
        r_i, r_j = solver._info["basic_tims_i"], solver._info["basic_tims_j"]
        src_d, dst_d = (torch.as_tensor(x, dtype=torch.float32, device=device) for x in (src, dst))
        rot_src, rot_dst = src_d[:, r_j] - src_d[:, r_i], (dst_d[:, r_j] - dst_d[:, r_i]) / sol.scale
        rot_nb = (2.0 * params.noise_bound / sol.scale).reshape(1)
        loop = dict(max_iterations=params.rotation_max_iterations,
                    gnc_factor=params.rotation_gnc_factor,
                    cost_threshold=params.rotation_cost_threshold)
        rotation_ms = median_ms(lambda: gnc_tls_rotation(
            rot_src, rot_dst, rot_nb[0], rot_method=params.gnc_rot_method, **loop), 5, 1)
        every = torch.ones((1, r_i.numel()), dtype=torch.bool, device=device)
        kernel_ms = median_ms(lambda: gnc.gnc_batch(
            rot_src[None], rot_dst[None], every, rot_nb, torch.eye(3, device=device), False,
            **loop), 5, 1)
        out[name] = {
            "classic": name, "C": c, "tims": int(idx_i.shape[0]), "valid": bool(sol.valid),
            "rotation_tims": int(r_i.numel()), "rotation_stage_ms": rotation_ms,
            "gnc_batch_same_tims_ms": kernel_ms,
            "RE_deg": re, "TE_upstream": te, "scale_error": se, "clique": len(clique),
            "exact_again": len(again), "same_members": again == clique,
            "greedy_clique": greedy_n, "greedy_ms": greedy_ms, "greedy_host_reads": reads,
            "inliers": int(sol.final_inlier_count), "wall_ms": walls, "card": card,
        }
        print(json.dumps(out[name]))
        if not (bool(sol.valid) and re < LIMITS[0] and te < LIMITS[1] and se <= LIMITS[2]):
            raise AssertionError(f"classic {name} failed its gate: RE={re} TE={te} scale {se}")
        if not is_clique or len(again) != len(clique) or greedy_n > len(clique):
            raise AssertionError(f"classic {name}: the clique returned is not the exact one: "
                                 f"{len(clique)} members, clique {is_clique}, exact {len(again)}, "
                                 f"greedy {greedy_n}")
    return out


def phase_exact_clique(device, card: str) -> dict:
    """Phase 17: the b_rate == 1.0 round through the native exact search."""
    from psulvsb_tpu_torch import SolverParams, psulvsb_solve
    from psulvsb_tpu_torch.solver.fused import plan_for, psulvsb_register

    case = anchor_case(rate=HOSTILE_RATE, data_seed=HOSTILE_DATA_SEED)
    greedy_p = SolverParams.preset_artificial(**CAPS)
    exact_p = greedy_p.replace(exact_clique_callback=True)
    src, dst, keep = on_device(case, device)
    reset_launches()
    runs = [run_solve("exact clique", exact_p, case, seed, device, gate=False)
            for seed in HOSTILE_SOLVE_SEEDS]
    launches = read_launches()
    rounds = sum(i["clique_rounds"] for _, i, _ in runs)
    searches = sum(i["exact_clique_searches"] for _, i, _ in runs)
    fused_ok = fused_searches = 0
    for seed in HOSTILE_SOLVE_SEEDS:
        sol = psulvsb_register(src, dst, keep, seed, exact_p)
        fused_ok += score_solution("fused exact clique", sol, case[2])[4]
        fused_searches += plan_for(exact_p, src.shape[1], device).stats["exact_clique_searches"]
        eager = psulvsb_register(src, dst, keep, seed, exact_p, graphs=False)
        if solution_difference(sol, eager) != 0.0:
            raise AssertionError(f"exact clique, seed {seed}: the replayed plan differs from "
                                 f"its eager run")

    def staged(params):
        return lambda seed: psulvsb_solve(
            src, dst, keep, params, torch.Generator(device=device).manual_seed(seed))

    def fused(params):
        return lambda seed: psulvsb_register(src, dst, keep, seed, params)

    for seed in EXACT_TURN_SEEDS:  # the greedy's plan captures its segments
        fused(greedy_p)(seed)
    walls = {}
    for form, make in (("staged", staged), ("fused", fused)):
        turns = [timed_walls(make(p), EXACT_TURN_SEEDS)
                 for p in (greedy_p, exact_p, exact_p, greedy_p)]
        med = [statistics.median(t) for t in turns]
        walls[form] = {"greedy_ms": [med[0], med[3]], "exact_ms": [med[1], med[2]]}
    out = {
        "exact_clique": "hostile", "C": src.shape[1], "solves": len(runs),
        "clique_rounds": rounds, "exact_searches": searches,
        "recall_staged": sum(ok for _, _, ok in runs), "recall_fused": fused_ok,
        "exact_searches_fused": fused_searches, "walls": walls, "launches": launches,
        "gated": "the exact searches and the replay == eager check; recall is printed, "
                 "not gated, as in phase 11 (b)",
        "card": card,
    }
    print(json.dumps(out))
    if rounds == 0 or searches == 0 or fused_searches == 0:
        raise AssertionError(f"no b_rate == 1.0 round went through the exact search: {out}")
    if launches["gnc_batch"] <= 0:
        raise AssertionError("the exact-clique solves never launched the GNC kernel")
    return out


def phase_rotation_variants(device, card: str) -> dict:
    """Phase 18: FGR and gnc_rot_method="eigh" on the anchor."""
    from psulvsb_tpu_torch import RotationEstimationAlgorithm, SolverParams
    from psulvsb_tpu_torch.solver import basic
    from psulvsb_tpu_torch.solver.fused import psulvsb_register

    case = anchor_case()
    src, dst, keep = on_device(case, device)
    out = {}
    variants = {
        "fgr": SolverParams.preset_anchor(
            rotation_estimation_algorithm=RotationEstimationAlgorithm.FGR),
        "eigh": SolverParams.preset_anchor(gnc_rot_method="eigh"),
    }
    for name, params in variants.items():
        reset_launches()
        basic.PLAIN_ROUTE_CALLS = 0
        walls = [run_solve(name, params, case, seed, device)[0] for seed in VARIANT_SEEDS]
        fused_walls = []
        for seed in VARIANT_SEEDS[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = psulvsb_register(src, dst, keep, seed, params)
            torch.cuda.synchronize()
            fused_walls.append((time.perf_counter() - t0) * 1e3)
            valid, re, te, se, ok = score_solution(f"fused {name}", sol, case[2])
            eager = psulvsb_register(src, dst, keep, seed, params, graphs=False)
            diff = solution_difference(sol, eager)
            print(f"[fused {name}] seed={seed}: valid={valid} RE={re:.4f} deg TE={te:.5f} "
                  f"replay - eager = {diff}")
            if not ok or diff != 0.0:
                raise AssertionError(f"fused {name} seed {seed}: gate {ok}, replay - eager {diff}")
        launches = read_launches()
        out[name] = {
            "variant": name, "wall_ms_staged": [w * 1e3 for w in walls],
            "wall_ms_fused": fused_walls, "gnc_batch_launches": launches["gnc_batch"],
            "plain_route_calls": basic.PLAIN_ROUTE_CALLS, "card": card,
        }
        print(json.dumps(out[name]))
        if launches["gnc_batch"] != 0:
            raise AssertionError(f"{name} must not launch the GNC kernel: {launches}")
    if out["eigh"]["plain_route_calls"] <= 0 or out["fgr"]["plain_route_calls"] != 0:
        raise AssertionError(f"the plain route's count is wrong: {out}")
    reset_launches()
    run_solve("power after eigh", SolverParams.preset_anchor(), case, VARIANT_SEEDS[0], device)
    if read_launches()["gnc_batch"] <= 0:
        raise AssertionError('a "power" solve after the "eigh" solves did not launch the kernel')
    return out


def sweep_params():
    from psulvsb_tpu_torch import SolverParams

    return SolverParams.preset_3dmatch(**CAPS)  # bench.py:95 REALDATA_CAPS


def phase_sweep(device, card: str, data: str | None = None) -> dict:
    """Phase 19: the dataset sweep through the batched harness. The scene
    is written under `data` when it is given (phase 22 reads it again),
    else into the phase's own temporary directory."""
    from psulvsb_tpu_torch.eval import batch_harness, make_dataset, realdata
    from psulvsb_tpu_torch.solver.fused import clear_plan_cache, plan_for
    from psulvsb_tpu_torch.utils.padding import pad_to_bucket

    clear_plan_cache()
    params = sweep_params()
    rates = (0.6, 0.75, 0.85, 0.9, 0.93, 0.95)  # write_scene's default cycle
    out = {}
    with tempfile.TemporaryDirectory(prefix="psulvsb_sweep_") as root:
        data = data or os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset.write_benchmark(
            data, [SWEEP_SCENE], dataset="3dmatch", n_pairs=SWEEP_PAIRS, n_corr=SWEEP_SIZES,
            seed=0, outlier_rates=rates,
        )
        write_s = time.perf_counter() - t0
        scene_dir = os.path.join(data, SWEEP_SCENE)
        labels = realdata.read_pair_labels(os.path.join(scene_dir, "pairs.txt"))
        buckets = sorted({pad_to_bucket(n) for n in SWEEP_SIZES})
        print(f"[sweep] {SWEEP_SCENE}: {len(labels)} pairs of {SWEEP_SIZES} correspondences "
              f"(buckets {buckets}) written in {write_s:.2f} s")

        def sweep(tag, ddtime, unknown, resume=False):
            res_dir = os.path.join(root, tag)
            stats = batch_harness.run_benchmark_batched(
                data, res_dir, dataset="3dmatch", scenes=[SWEEP_SCENE], params=params,
                ddtime=ddtime, unknown_scale=unknown, seed=0, resume=resume,
            )[SWEEP_SCENE]
            csv_path = os.path.join(res_dir, f"{SWEEP_SCENE}_fpfh_{int(unknown)}.csv")
            return stats, csv_path

        def read_rows(csv_path):
            with open(csv_path) as f:
                rows = [ln.strip().split(",") for ln in f][1:]
            return {r[0]: realdata.PairResult(*(float(x) for x in r[1:6]), bool(int(r[6])))
                    for r in rows}

        for tag, ddtime, unknown in (("known", SWEEP_DDTIME, False),
                                     ("unknown", SWEEP_UNKNOWN_DDTIME, True)):
            run_params = params.replace(estimate_scaling=unknown)
            t0 = time.perf_counter()
            batch_harness.warm_scene(scene_dir, run_params)
            warm_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launches()
            stats, csv_path = sweep(tag, ddtime, unknown)
            launches = read_launches()
            split = stats["split"]
            rows = read_rows(csv_path)
            gated = [t for i, t in enumerate(rows) if rates[i % len(rates)] <= SWEEP_GATED_RATE]
            failed = [t for t in gated if not rows[t].success]
            plans = {b: plan_for(run_params, b, device).nbytes for b in buckets}
            out[tag] = {
                "sweep": tag, "pairs": stats["pairs"], "ddtime": ddtime,
                "solves": split["solves"], "recall": stats["recall"],
                "recall_gated": f"{len(gated) - len(failed)}/{len(gated)}",
                "pairs_per_s": stats["pairs_per_s"],
                "solves_per_s": split["solves"] / split["wall_s"], "split": split,
                "warm_s": warm_s, "launches": launches,
                "peak_allocated_GiB": torch.cuda.max_memory_allocated(device) / 2**30,
                "reserved_GiB": torch.cuda.memory_reserved(device) / 2**30,
                "plan_MiB": {str(b): round(n / 2**20, 1) for b, n in plans.items()},
                "card": card,
            }
            print(json.dumps(out[tag]))
            if launches["gnc_batch"] <= 0:
                raise AssertionError(f"the {tag} sweep never launched the GNC kernel: {launches}")
            if unknown and launches["pair_ratio_hist"] <= 0:
                raise AssertionError(f"the unknown-scale sweep never launched the histogram "
                                     f"kernel: {launches}")
            if not unknown and failed:
                raise AssertionError(f"pairs at an outlier rate <= {SWEEP_GATED_RATE} failed "
                                     f"the 3DMatch criteria: {[(t, rows[t]) for t in failed]}")

        # The serial harness on the first pairs: the same results but the time.
        known_rows = read_rows(os.path.join(root, "known", f"{SWEEP_SCENE}_fpfh_0.csv"))
        first = os.path.join(root, "first_pairs.txt")
        with open(first, "w") as f:
            f.writelines(f"{a} {b}\n" for a, b in labels[:SWEEP_SERIAL_PAIRS])
        serial_csv = os.path.join(root, "serial", "first.csv")
        t0 = time.perf_counter()
        realdata.run_scene(
            scene_dir, first, params.replace(estimate_scaling=False),
            realdata.SuccessCriteria.threedmatch(), serial_csv, ddtime=SWEEP_DDTIME, seed=0,
        )
        serial_s = time.perf_counter() - t0
        for tag, res in read_rows(serial_csv).items():
            if res._replace(time_s=0.0) != known_rows[tag]._replace(time_s=0.0):
                raise AssertionError(f"pair {tag}: serial {res} != batched {known_rows[tag]}")
        print(f"[sweep] the serial harness on the first {SWEEP_SERIAL_PAIRS} pairs "
              f"({SWEEP_SERIAL_PAIRS * SWEEP_DDTIME} solves, {serial_s:.2f} s) gives the batched "
              f"harness's results; card: {card}")

        # Resume: the sidecar is reused for the same protocol and no other.
        again, _ = sweep("known", SWEEP_DDTIME, False, resume=True)
        other, _ = sweep("known", 1, False, resume=True)
        if again["timing"] != "resumed" or other["timing"] == "resumed":
            raise AssertionError(f"resume: same protocol {again['timing']!r}, another ddtime "
                                 f"{other['timing']!r}")
        if again["recall"] != out["known"]["recall"]:
            raise AssertionError("the resumed stats differ from the run's")
        print(f"[sweep] resume=True reused the sidecar; ddtime 1 re-ran the scene "
              f"(recall {other['recall']:.3f}, {other['pairs_per_s']:.2f} pairs/s)")
    return out


CERT_CARD_HOST_TOL = 1e-6  # |gap card - gap host| in float64, plus as much relative
CERT_F32_TOL = 2e-2  # psulvsb_tpu/certify/drs.py:460-466
CERT_WALL_N = (12, 64)
FE_SEEDS = (62, 11, 1375)  # 62: JAX's test_match_quality_regime
FE_TOL = 1e-2  # a feature row "off" beyond this (tests/test_torch_frontend.py)
FE_ROWS_OFF = 0.05  # the CPU tests' share for the structured scene
FE_LABELS_OFF = 0.025  # keypoint labels, as the CPU tests allow against JAX (the active mask: 0)
FE_MATCH_AGREE = 0.99
FE_SWEEP_PAIRS = 6
FE_SWEEP_DDTIME = 3


def certifier_cases():
    """tests/test_certify.py:151-191 as numpy inputs: (name, certifier
    kwargs, R, src, dst, theta, polish, expected is_optimal, float32 holds)."""
    from psulvsb_tpu_torch.core.linalg import _quat_to_rot, svd_rot

    rng = np.random.default_rng(12345)

    def rotation():
        q = rng.normal(size=4)
        return _quat_to_rot(torch.as_tensor(q / np.linalg.norm(q))).numpy()

    r = rotation()
    src = rng.normal(size=(3, 10))
    dst = r @ src + rng.normal(size=(3, 10)) * 0.002
    r_est = svd_rot(torch.as_tensor(src), torch.as_tensor(dst)).numpy()
    # float32 floors this case's gap near 0.8 (mu ~ noise^2): the JAX
    # package's float32 mode refuses it too.
    cases = [("svd_optimum_polished", {}, r_est, src, dst, np.ones(10), True, True, False)]
    r = rotation()
    src = rng.normal(size=(3, 10))
    turn = np.array([[np.cos(0.2), -np.sin(0.2), 0], [np.sin(0.2), np.cos(0.2), 0], [0, 0, 1]])
    cases.append(("rotation_0.2_off", {"max_iterations": 50}, r @ turn, src, r @ src,
                  np.ones(10), False, False, True))
    r = rotation()
    src = rng.normal(size=(3, 12))
    dst = r @ src
    dst[:, :2] += 5.0
    theta = np.ones(12)
    theta[:2] = -1.0
    # Noise-free inliers: mu -> 0 amplifies the eigen-solve's error without
    # bound, so the JAX package holds such inputs to float64 only
    # (psulvsb_tpu/certify/drs.py:466-469).
    cases.append(("two_outliers", {}, r, src, dst, theta, False, True, False))
    return cases


def wall_problem(n, seed):
    """N noisy TIMs (noise 0.01) of a random rotation, two of them gross
    outliers at theta = -1: a certify that runs all 200 iterations."""
    from psulvsb_tpu_torch.core.linalg import _quat_to_rot

    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    r = _quat_to_rot(torch.as_tensor(q / np.linalg.norm(q))).numpy()
    src = rng.normal(size=(3, n))
    dst = r @ src + rng.normal(size=(3, n)) * 0.01
    dst[:, :2] += 5.0
    theta = np.ones(n)
    theta[:2] = -1.0
    return r, src, dst, theta


def certificates_agree(card: dict, host: dict) -> bool:
    """{"certified", "gap"} of the card and of the host: the same verdict,
    gaps within CERT_CARD_HOST_TOL (absolute and relative), inf for inf."""
    if card["certified"] != host["certified"]:
        return False
    if np.isinf(host["gap"]) or np.isinf(card["gap"]):
        return card["gap"] == host["gap"]
    return abs(card["gap"] - host["gap"]) <= CERT_CARD_HOST_TOL * (1.0 + abs(host["gap"]))


def phase_certifier(device, card: str) -> dict:
    """Phase 20: the DRS certifier in float64 on the card against the host."""
    from psulvsb_tpu_torch.certify.drs import DRSCertifier

    out = {"cases": {}, "walls_s": {}}
    for name, kw, r, src, dst, theta, polish, expected, f32_holds in certifier_cases():
        cert = DRSCertifier(**kw)
        on_card = cert.certify(r, src, dst, theta, polish=polish)
        host = cert.certify(r, src, dst, theta, polish=polish, device="cpu")
        f32 = cert.certify(r, src, dst, theta, polish=polish, dtype=torch.float32)
        gap = on_card.best_suboptimality
        if gap.device.type != "cuda" or gap.dtype != torch.float64:
            raise AssertionError(f"{name}: the certificate is {gap.dtype} on {gap.device}")
        row = {"card": float(gap), "host": float(host.best_suboptimality),
               "card_f32": float(f32.best_suboptimality), "optimal": bool(on_card.is_optimal),
               "iterations": int(torch.isfinite(on_card.suboptimality_traj).sum())}
        out["cases"][name] = row
        print(f"[certify] {name}: {row}")
        verdicts = [{"certified": bool(c.is_optimal), "gap": float(c.best_suboptimality)}
                    for c in (on_card, host)]
        if not certificates_agree(*verdicts) or row["optimal"] != expected:
            raise AssertionError(f"{name}: card {row} against host, expected optimal={expected}")
        if f32_holds and (bool(f32.is_optimal) != expected
                          or abs(row["card_f32"] - row["host"]) > CERT_F32_TOL):
            raise AssertionError(f"{name}: float32 on the card {row['card_f32']} against "
                                 f"{row['host']}")
    for n in CERT_WALL_N:
        args = wall_problem(n, n)
        cert = DRSCertifier(noise_bound=0.03)
        walls = {"cuda": [], "cpu": []}
        for dev in ("cuda", "cpu", "cpu", "cuda"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cert.certify(*args, device=dev)
            float(res.best_suboptimality)
            walls[dev].append(time.perf_counter() - t0)
        out["walls_s"][n] = walls
        print(f"[certify] N={n} TIMs, {int(torch.isfinite(res.suboptimality_traj).sum())} "
              f"iterations: wall card {walls['cuda']} s, host {walls['cpu']} s (in turns); "
              f"card: {card}")
    return out


def phase_frontend_sweep(device, card: str) -> dict:
    """Phase 21: the front end on the card and the certified sweep."""
    from psulvsb_tpu_torch import RobustRegistrationSolver
    from psulvsb_tpu_torch.eval import batch_harness, corr_gen, realdata, realscan
    from psulvsb_tpu_torch.core.se3 import random_se3
    from psulvsb_tpu_torch.eval import frontend_protocol as fp
    from psulvsb_tpu_torch.frontend.icp import icp_point_to_point
    from psulvsb_tpu_torch.frontend.voxel import voxel_downsample
    from psulvsb_tpu_torch.io.ply import write_ply
    from psulvsb_tpu_torch.utils.padding import pad_columns

    out = {"pairs": {}}
    # 1. Pairs at full size, in the regime of JAX's test.
    pairs = {}
    for seed in FE_SEEDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src, dst, gt = fp.make_frontend_pair(seed)
        wall = time.perf_counter() - t0
        resid = np.linalg.norm(gt[:3, :3] @ src + gt[:3, 3:4] - dst, axis=0)
        row = {"C": src.shape[1], "inliers": int((resid < fp.NOISE_BOUND).sum()), "wall_s": wall}
        out["pairs"][seed] = row
        pairs[seed] = (src, dst, gt)
        print(f"[frontend] make_frontend_pair({seed}) on the card: {row}")
        if row["C"] < 800 or row["inliers"] < 20:
            raise AssertionError(f"pair {seed} is outside the regime C >= 800, >= 20 inliers")

    # 2. The card against the CPU on one cloud, and one pair's matches.
    seed = FE_SEEDS[0]
    src_cloud, dst_cloud, gt = fp.frontend_views(seed)
    agree = {}
    for keypoints in ("all", "iss"):
        pc, kc, fc = fp._extract_padded(src_cloud, keypoints=keypoints, device="cpu")
        pg, kg, fg = fp._extract_padded(src_cloud, keypoints=keypoints, device=device)
        rows_off = float(((fg.cpu() - fc).abs().amax(1) > FE_TOL).float().mean())
        agree[keypoints] = {"keypoints": int(kc.sum()), "labels_off": int((kc != kg.cpu()).sum()),
                            "rows_off": rows_off, "max_diff": float((fg.cpu() - fc).abs().max())}
        if not torch.equal(pc, pg.cpu()) or rows_off > FE_ROWS_OFF \
                or agree[keypoints]["labels_off"] > (
                    0 if keypoints == "all" else FE_LABELS_OFF * int(kc.numel())):
            raise AssertionError(f"_extract_padded({keypoints!r}) card against CPU: {agree}")
    cpu_pair = fp.make_frontend_pair(seed, pose=(gt[:3, :3], gt[:3, 3]), device="cpu")
    rows = [{tuple(np.round(c, 5)) for c in np.concatenate(p[:2]).T}
            for p in (pairs[seed], cpu_pair)]
    agree["matches"] = {"card": len(rows[0]), "cpu": len(rows[1]),
                        "common": len(rows[0] & rows[1])}
    agree["matches"]["agree"] = agree["matches"]["common"] / max(len(rows[1]), len(rows[0]))
    out["card_vs_cpu"] = agree
    print(f"[frontend] card against the CPU: {json.dumps(agree)}")
    if agree["matches"]["agree"] < FE_MATCH_AGREE:
        raise AssertionError(f"mutual matches agree on {agree['matches']['agree']:.4f}")

    # 3. Stage walls, each ending in a synchronization (one warm pass first).
    def stages():
        walls = {}

        def lap(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            return result

        down = lap("voxel_host", lambda: voxel_downsample(src_cloud, fp.NOISE_BOUND))
        m = min(down.shape[1], fp.FRONT_BUCKET)
        down = down[:, np.linspace(0, down.shape[1] - 1, m).astype(int)]
        pts = torch.as_tensor(pad_columns(down.astype(np.float32), fp.FRONT_BUCKET), device=device)
        act = torch.arange(fp.FRONT_BUCKET, device=device) < m
        normals = lap("normals", lambda: fp.estimate_normals(pts, k=20, active=act,
                                                             solve_dtype=torch.float64))
        lap("iss", lambda: fp.iss_keypoints(pts, 6 * fp.NOISE_BOUND, 4 * fp.NOISE_BOUND, k=64,
                                            active=act))
        feats = lap("fpfh", lambda: fp.compute_fpfh(pts, normals, 5 * fp.NOISE_BOUND, k=64,
                                                    active=act))
        lap("matching", lambda: fp.mutual_matches(feats, act, feats, act))
        return walls

    stages()
    out["stage_s"] = stages()
    print(f"[frontend] stage walls (one cloud at the {fp.FRONT_BUCKET} bucket): "
          f"{json.dumps(out['stage_s'])}; card: {card}")

    # 4. The certified sweep, the winners' certificates held to the host's.
    calls = []
    certify_winner = batch_harness._certify_winner

    def recorded(*args):
        result = certify_winner(*args)
        calls.append((args, result))
        return result

    params = fp.frontend_solver_params(**CAPS)
    with tempfile.TemporaryDirectory(prefix="psulvsb_frontend_") as root:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        fp.write_frontend_benchmark(data, ["fe"], n_pairs=FE_SWEEP_PAIRS, seed=11)
        write_s = time.perf_counter() - t0
        batch_harness._certify_winner = recorded
        try:
            sweeps = {}
            for tag, ddtime, unknown in (("known", FE_SWEEP_DDTIME, False), ("unknown", 1, True)):
                reset_launches()
                stats = batch_harness.run_benchmark_batched(
                    data, os.path.join(root, tag), dataset="kitti", scenes=["fe"],
                    params=params, ddtime=ddtime, unknown_scale=unknown, certify=True,
                )["fe"]
                sweeps[tag] = (stats, read_launches(), list(calls))
                calls.clear()
        finally:
            batch_harness._certify_winner = certify_winner
        with open(os.path.join(root, "known", "fe_fpfh_0.csv")) as f:
            success = {ln.split(",")[0]: ln.strip().endswith(",1") for ln in list(f)[1:]}
    launches = {k: sweeps["known"][1][k] + sweeps["unknown"][1][k] for k in sweeps["known"][1]}
    for tag, (stats, tag_launches, tag_calls) in sweeps.items():
        for args, result in tag_calls:
            if args[-1].type != "cuda":
                raise AssertionError(f"the {tag} sweep certified on {args[-1]}")
            host = certify_winner(*args[:-1], torch.device("cpu"))
            if not certificates_agree(result, host):
                raise AssertionError(f"{tag}: card certificate {result} != host {host}")
        row = {k: stats[k] for k in ("pairs", "recall", "certified_frac", "avg_cert_gap",
                                     "pairs_per_s")}
        row.update(sweep=tag, split=stats["split"], launches=tag_launches,
                   certificates=stats["certificates"], winners_held_to_host=len(tag_calls),
                   write_s=write_s, card=card)
        out[tag] = row
        print(json.dumps(row))
    known = out["known"]
    if known["recall"] < 5 / 6:
        raise AssertionError(f"front-end sweep recall {known['recall']} < 5/6")
    missing = [t for t, ok in success.items()
               if ok and not np.isfinite(known["certificates"][t]["gap"])]
    if len(success) != FE_SWEEP_PAIRS or missing:
        raise AssertionError(f"successes without a certificate: {missing}")
    for name in ("consistency_degree", "pair_ratio_hist", "gnc_batch"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} did not launch in the front-end sweeps: {launches}")
    out["launches"] = launches

    # 5. ICP on one solved pair.
    src, dst, gt = pairs[seed]
    sol = RobustRegistrationSolver(params, seed=0, device=device).solve(
        src.astype(np.float32), dst.astype(np.float32))
    down_src = voxel_downsample(src_cloud, fp.NOISE_BOUND)
    down_dst = voxel_downsample(dst_cloud, fp.NOISE_BOUND)
    t0 = time.perf_counter()
    icp = icp_point_to_point(down_src, down_dst, sol.rotation, sol.translation,
                             max_correspondence_distance=2 * fp.NOISE_BOUND, max_iterations=100)
    icp_s = time.perf_counter() - t0
    from psulvsb_tpu_torch.core.metrics import angular_error_deg_np

    r_icp = icp.rotation.cpu().numpy().astype(np.float64)
    out["icp"] = {"rmse": float(icp.rmse), "iterations": icp.iterations, "wall_s": icp_s,
                  "deg_vs_coarse": angular_error_deg_np(
                      sol.rotation.cpu().numpy().astype(np.float64), r_icp),
                  "deg_vs_gt": angular_error_deg_np(gt[:3, :3], r_icp)}
    print(f"[frontend] ICP on pair {seed}: {json.dumps(out['icp'])}")
    # At this pair's translation (|t| up to 10) a float32 update moves by
    # about 1e-6 from one iteration to the next, ICP's default tolerance, so
    # the loop may run to its cap; the gate is that it stays in the basin.
    if not np.isfinite(out["icp"]["rmse"]) or out["icp"]["deg_vs_coarse"] > 5.0:
        raise AssertionError(f"ICP left the coarse pose's basin: {out['icp']}")

    # 6. The real-scan path on two PLYs written from a structured-scene pair
    #    (moved by a turn of seed 11's and a translation of norm 1.14, within
    #    which float32 ICP converges to its 1e-6 tolerance).
    # 7. Correspondences from ISS keypoints.
    turn = random_se3(np.random.default_rng(FE_SEEDS[1])).rotation
    a_cloud, b_cloud, _ = fp.frontend_views(FE_SEEDS[1], pose=(turn, np.array([1.0, -0.5, 0.2])))
    with tempfile.TemporaryDirectory(prefix="psulvsb_scans_") as root:
        paths = os.path.join(root, "a.ply"), os.path.join(root, "b.ply")
        write_ply(paths[0], a_cloud)
        write_ply(paths[1], b_cloud)
        t0 = time.perf_counter()
        res = realscan.register_realscan(*paths, voxel=fp.NOISE_BOUND, caps=CAPS)
        scan_s = time.perf_counter() - t0
    out["realscan"] = {k: res[k] for k in ("n_raw_src", "n_down_src", "n_corr", "solve_s",
                                           "icp_rmse", "icp_fitness", "icp_iters",
                                           "rot_vs_icp_deg")}
    out["realscan"]["wall_s"] = scan_s
    print(f"[frontend] register_realscan: {json.dumps(out['realscan'])}")
    if not np.isfinite(res["icp_rmse"]) or res["icp_iters"] >= 100:
        raise AssertionError(f"the real-scan path's ICP did not converge: {out['realscan']}")
    t0 = time.perf_counter()
    ks, _ = corr_gen.generate_correspondences(a_cloud, b_cloud, fp.NOISE_BOUND)
    out["corr_gen"] = {"C": ks.shape[1], "wall_s": time.perf_counter() - t0}
    print(f"[frontend] generate_correspondences (ISS keypoints): {out['corr_gen']}")
    if ks.shape[1] == 0:
        raise AssertionError("generate_correspondences found no correspondence")
    return out


CLI_KEYS = ["scale", "rotation", "rotation", "rotation", "translation", "time_ms", "valid"]
CLI_NOISE = {"anchor": 0.05, "unknown": 0.01}  # each protocol's noise bound
# The demo's published protocol (500 points, 90% outliers) fails some
# trials in both packages: the JAX package recalls 7/10 on the CPU
# (tools/port_jax_reference.py demo), the port 8/10 on the CPU.
JAX_CPU_DEMO_RECALL = "7/10"
DEMO_RECALL_MIN = 0.5
# Phase 19's scene at ddtime 1: 20 of its 30 pairs lie at <= 90% outliers.
EXAMPLE_SWEEP_RECALL_MIN = 2 / 3
SCAN_SHIFT = (1.0, -0.5, 0.2)


def write_cli_inputs(root: str) -> dict:
    """{tag: (src file, dst file, truth, C)}: the anchor pair as 3xN CSVs
    (the layout of MATLAB's writematrix) and the unknown-scale pair
    (C = 5000) as Nx3."""
    cases = {}
    for tag, (src, dst, truth), rows in (("anchor", anchor_case(), False),
                                         ("unknown", unknown_scale_case(UNKNOWN_C, 5), True)):
        paths = []
        for name, pts in (("src", src), ("dst", dst)):
            path = os.path.join(root, f"{tag}_{name}.csv")
            np.savetxt(path, pts.T if rows else pts, delimiter=",", fmt="%.9g")
            paths.append(path)
        cases[tag] = (*paths, truth, src.shape[1])
    return cases


def cli_argv(case, tag, pipeline="psulvsb") -> list[str]:
    """The CLI's arguments for a case: its defaults, apart from the noise
    bound, and known scale on the anchor."""
    argv = ["--src", case[0], "--dst", case[1], "--noise-bound", str(CLI_NOISE[tag]),
            "--pipeline", pipeline]
    return argv + (["--estimate-scaling", "0"] if tag == "anchor" else [])


def check_cli_output(what: str, text: str, truth, upstream: bool = False) -> dict:
    """Parse the CLI's seven lines and hold the pose to the truth as the
    batch harness scores it (`upstream`: the decoupled solve's dst = s R src
    + t); raises on a wrong schema or a missed gate."""
    from psulvsb_tpu_torch.core.metrics import angular_error_deg_np

    lines = [ln.split() for ln in text.strip().splitlines()]
    keys = [ln[0] for ln in lines]
    if keys != CLI_KEYS:
        raise AssertionError(f"{what}: the CLI wrote {keys}, not {CLI_KEYS}")
    s = float(lines[0][1])
    r = np.array([[float(v) for v in lines[i][1:]] for i in (1, 2, 3)])
    t = np.array([float(v) for v in lines[4][1:]])
    rot_true, t_true, test_scale = truth
    re = angular_error_deg_np(rot_true, r)
    te = float(np.linalg.norm((t / s if upstream else t * s / test_scale) - t_true))
    row = {"valid": int(lines[6][1]), "RE": re, "TE": te, "scale_error": abs(s - test_scale),
           "time_ms": float(lines[5][1])}
    if not (row["valid"] == 1 and re < LIMITS[0] and te < LIMITS[1]
            and row["scale_error"] <= LIMITS[2] and row["time_ms"] > 0):
        raise AssertionError(f"{what}: {row}")
    return row


def run_cli_process(argv, tree: str) -> tuple[str, float]:
    """`python -m psulvsb_tpu_torch.cli` from `tree` (a copy of the package's
    parent directory) as MATLAB's system() runs it: (stdout, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (tree, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "psulvsb_tpu_torch.cli", *argv], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI process exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def run_example(name: str, argv: list[str]) -> tuple[dict, float, dict]:
    """One example's main(argv) on the card (its default device): (its dict,
    wall seconds to a synchronization, launches)."""
    import importlib

    module = importlib.import_module(f"psulvsb_tpu_torch.examples.{name}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"[examples] {name}: {wall:.3f} s, launches {launches}")
    return out, wall, launches


def pose_errors(truth_4x4, rotation, translation) -> tuple[float, float]:
    from psulvsb_tpu_torch.core.metrics import angular_error_deg_np

    re = angular_error_deg_np(truth_4x4[:3, :3], np.asarray(rotation, np.float64))
    return re, float(np.linalg.norm(np.asarray(translation, np.float64) - truth_4x4[:3, 3]))


def phase_entry_points(device, card: str, sweep_data: str) -> dict:
    """Phase 22: the CLI in-process and as a process, the seven examples,
    and utils.timing, on the card."""
    import shutil

    from psulvsb_tpu_torch import RobustRegistrationSolver, SolverParams, cli
    from psulvsb_tpu_torch.core.se3 import random_se3
    from psulvsb_tpu_torch.eval import frontend_protocol as fp
    from psulvsb_tpu_torch.io.ply import write_ply
    from psulvsb_tpu_torch.utils.timing import timed, trace

    out = {"cli": {}, "examples": {}}
    repo = str(Path(__file__).resolve().parent)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="psulvsb_entry_") as root:
        cases = write_cli_inputs(root)
        # 1. The CLI in-process: twice a run, the launch counts over both.
        runs = (("anchor", "anchor", "psulvsb"), ("unknown", "unknown", "psulvsb"),
                ("anchor decoupled", "anchor", "decoupled"))
        for what, tag, pipeline in runs:
            argv = cli_argv(cases[tag], tag, pipeline) + ["--out", os.path.join(root, "sol.txt")]
            reset_launches()
            rows = []
            for _ in range(2):
                t0 = time.perf_counter()
                if cli.main(argv) != 0:
                    raise AssertionError(f"cli.main returned non-zero on {what}")
                wall = time.perf_counter() - t0
                with open(os.path.join(root, "sol.txt")) as f:
                    row = check_cli_output(what, f.read(), cases[tag][2],
                                           upstream=pipeline == "decoupled")
                rows.append(dict(row, wall_s=wall))
            launches = read_launches()
            out["cli"][what] = {"C": cases[tag][3], "in_process": rows, "launches": launches,
                                "card": card}
            print(f"[cli] {what} in-process: {json.dumps(out['cli'][what])}")
            if pipeline == "psulvsb" and launches["gnc_batch"] <= 0:
                raise AssertionError(f"the CLI's {what} solves never launched gnc_batch")
            if tag == "unknown" and launches["pair_ratio_hist"] <= 0:
                raise AssertionError("the CLI's unknown-scale solves never launched "
                                     "pair_ratio_hist")
        # 2. The CLI as a process: warm (the kernels this process built), and
        #    cold from a copy of the package with nothing built.
        for tag in ("anchor", "unknown"):
            argv = cli_argv(cases[tag], tag)
            text, warm = run_cli_process(argv, repo)
            row = {"warm": dict(check_cli_output(f"{tag} process", text, cases[tag][2]),
                                wall_s=warm)}
            cold_tree = os.path.join(root, f"cold_{tag}")
            shutil.copytree(os.path.join(repo, "psulvsb_tpu_torch"),
                            os.path.join(cold_tree, "psulvsb_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            text, cold = run_cli_process(argv, cold_tree)
            row["cold"] = dict(check_cli_output(f"{tag} cold process", text, cases[tag][2]),
                               wall_s=cold)
            out["cli"][tag]["process"] = row
            print(f"[cli] {tag} as a process: {json.dumps(row)}; card: {card}")

        # 3. The seven examples, each at its defaults where it needs no input.
        ex = out["examples"]
        demo, wall, launches = run_example("psulvsb_demo", ["--out", os.path.join(root, "demo")])
        ex["psulvsb_demo"] = {"wall_s": wall, "recall": demo["recall"]["synthetic"],
                              "jax_cpu_recall": JAX_CPU_DEMO_RECALL, "launches": launches}
        if demo["recall"]["synthetic"] < DEMO_RECALL_MIN or launches["gnc_batch"] <= 0:
            raise AssertionError(f"psulvsb_demo: {ex['psulvsb_demo']}")
        cert, wall, _ = run_example("certify_demo", [])
        ex["certify_demo"] = dict(cert, wall_s=wall)
        if not cert["estimate_certified"] or cert["identity_certified"]:
            raise AssertionError(f"certify_demo: {cert}")

        # A structured-scene pair moved by a known pose (phase 21's real-scan
        # pair) as PLYs, and the port's FPFH features of its clouds as npz.
        turn = random_se3(np.random.default_rng(FE_SEEDS[1])).rotation
        a_cloud, b_cloud, gt = fp.frontend_views(FE_SEEDS[1], pose=(turn, np.array(SCAN_SHIFT)))
        plys = os.path.join(root, "a.ply"), os.path.join(root, "b.ply")
        gt_file = os.path.join(root, "gt.txt")
        np.savetxt(gt_file, gt)
        npzs = []
        for path, cloud in zip(plys, (a_cloud, b_cloud)):
            write_ply(path, cloud)
            pts, kp, feats = fp._extract_padded(cloud)
            m = int(kp.sum())
            npzs.append(path[:-4] + ".npz")
            np.savez(npzs[-1], points=pts[:, :m].cpu().numpy(), features=feats[:m].cpu().numpy())

        fpfh, wall, launches = run_example("fpfh_icp_pipeline", [*plys, "--voxel", "0.3"])
        re, te = pose_errors(gt, fpfh["rotation"], fpfh["translation"])
        ex["fpfh_icp_pipeline"] = {"wall_s": wall, "correspondences": fpfh["correspondences"],
                                   "icp_iterations": fpfh["icp_iterations"], "RE": re, "TE": te,
                                   "launches": launches}
        if re >= LIMITS[0] or te >= LIMITS[1] or launches["gnc_batch"] <= 0:
            raise AssertionError(f"fpfh_icp_pipeline: {ex['fpfh_icp_pipeline']}")

        corr_file = os.path.join(root, "pair@corr.txt")
        gen, wall, _ = run_example("generate_correspondences", [*plys, corr_file,
                                                                "--noise-bound", "0.3"])
        rows = np.loadtxt(corr_file).reshape(-1, 6)
        true = int((np.linalg.norm(gt[:3, :3] @ rows[:, :3].T + gt[:3, 3:4] - rows[:, 3:].T,
                                   axis=0) < fp.NOISE_BOUND).sum())
        ex["generate_correspondences"] = {"wall_s": wall, "correspondences":
                                          gen["correspondences"], "true_matches": true}
        if gen["correspondences"] != rows.shape[0] or true < 10:
            raise AssertionError(f"generate_correspondences: {ex['generate_correspondences']}")

        learned, wall, launches = run_example(
            "learned_descriptor_bench", [*npzs, "--gt", gt_file, "--noise-bound", "0.3"])
        ex["learned_descriptor_bench"] = dict(learned, wall_s=wall, launches=launches)
        if (learned["rotation_error_deg"] >= LIMITS[0] or learned["translation_error"]
                >= LIMITS[1] or launches["gnc_batch"] <= 0):
            raise AssertionError(f"learned_descriptor_bench: {ex['learned_descriptor_bench']}")

        kitti, wall, launches = run_example("kitti_scale_pipeline", [])
        ex["kitti_scale_pipeline"] = dict(kitti, wall_s=wall, launches=launches)
        if (not kitti["valid"] or kitti["rotation_error_deg"] >= LIMITS[0]
                or kitti["translation_error"] >= LIMITS[1] or launches["gnc_batch"] <= 0):
            raise AssertionError(f"kitti_scale_pipeline: {ex['kitti_scale_pipeline']}")

        bench, wall, launches = run_example(
            "benchmark_3dmatch", ["--data-root", sweep_data, "--out", os.path.join(root, "bench"),
                                  "--scenes", SWEEP_SCENE, "--batched", "--ddtime", "1"])
        ex["benchmark_3dmatch"] = {"wall_s": wall, "recall": bench["mean_recall"],
                                   "launches": launches}
        if bench["mean_recall"] < EXAMPLE_SWEEP_RECALL_MIN or launches["gnc_batch"] <= 0:
            raise AssertionError(f"benchmark_3dmatch: {ex['benchmark_3dmatch']}")
        for name, row in ex.items():
            print(f"[examples] {name}: {json.dumps(row, default=float)}")

        # The front end's 3x3 eigen-solves go through batched_eigh in chunks;
        # the chunked solve at the KITTI example's 44027 points (its voxel
        # grid of 100000) must equal the host's float64 solve.
        from psulvsb_tpu_torch.core.linalg import batched_eigh

        cov = torch.as_tensor(np.random.default_rng(0).normal(size=(44027, 3, 3)))
        cov = cov @ cov.transpose(1, 2)
        gap = float((batched_eigh(cov.to(device), vectors=False).cpu()
                     - torch.linalg.eigvalsh(cov)).abs().max())
        out["eigh"] = {"chunked_vs_host": gap}
        print(f"[eigh] {json.dumps(out['eigh'])}")
        if gap > 1e-9:
            raise AssertionError(f"batched_eigh on the card is {gap} off the host's")

        # 4. utils.timing: a timed span reads at least the CUDA-event time of
        #    the same solve; a trace names the GNC kernel.
        params, case = path_case("anchor")
        src, dst = (torch.as_tensor(x, device=device) for x in case[:2])
        solver = RobustRegistrationSolver(params, seed=0, device=device)
        solver.solve(src, dst)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        done = []
        with timed("solve", sync_on=done) as span:
            start.record()
            done.append(solver.solve(src, dst).rotation)
            end.record()
        event_ms = start.elapsed_time(end)
        out["timing"] = {"timed_ms": span["elapsed_s"] * 1e3, "event_ms": event_ms}
        if span["elapsed_s"] * 1e3 < event_ms:
            raise AssertionError(f"timed() read less than the solve's CUDA events: "
                                 f"{out['timing']}")
        trace_dir = os.path.join(root, "trace")
        with trace(trace_dir):
            solver.solve(src, dst)
        (name,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, name)) as f:
            kernels = {e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"}
        gnc = sorted(k for k in kernels if "gnc_batch_kernel" in k)
        out["timing"].update(trace_kernels=len(kernels), gnc=gnc)
        print(f"[timing] {json.dumps(out['timing'])}")
        if not gnc:
            raise AssertionError(f"the trace names no gnc_batch_kernel among {sorted(kernels)}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[entry] phase 22 in {out['phase_s']:.1f} s; card: {card}")
    return out


FULLSCALE_SCENES = {"3dmatch": "sun3d-hotel_umd-maryland_hotel3", "kitti": "kitti_seq07"}
AUDIT_CASE = dict(c=2048, rate=0.93, mode="mismatch", estimate_scaling=True, seed=2093)
AUDIT_TIME_LIMIT_S = 120.0
AUDIT_MIN_RATIO = 0.95  # tests/test_clique.py::TestGreedyVsExactAtScale
CAP_POINTS = ((2048, 256, 4, 8192), (2048, 512, 4, 16384))
CAP_K = 3
FACADE_SCALAR_TOL = 1e-5


def facade_cases() -> list:
    """(name, call) pairs: call(device) runs one facade and gives its outputs
    as a tuple of tensors. Inputs from a numpy seed, as tests/test_variants.py
    builds them; the scale mode's draws are the same uniforms on both sides."""
    from psulvsb_tpu_torch.core.linalg import _quat_to_rot
    from psulvsb_tpu_torch.robust.scalar_tls import ScalarTLSEstimator
    from psulvsb_tpu_torch.robust.scale import ScaleInliersSelector, TLSScaleSolver
    from psulvsb_tpu_torch.robust.translation import TLSTranslationSolver
    from psulvsb_tpu_torch.rotation.gnc import GNCTLSRotationSolver

    rng = np.random.default_rng(0)
    x = np.array([0.5, 1.0, 0.6, 0.7, 1.2, 10.0], np.float32)
    r = np.array([0.9, 0.9, 0.4, 0.5, 0.4, 0.5], np.float32)
    xt = np.array([2.0, 2.1, 1.9, 7.0], np.float32)
    u = torch.as_tensor(rng.uniform(size=256).astype(np.float32))
    src = rng.normal(size=(3, 50)).astype(np.float32)
    q = rng.normal(size=4)
    rot = _quat_to_rot(torch.as_tensor(q / np.linalg.norm(q))).numpy().astype(np.float32)
    dst = rot @ src
    t_true = np.array([0.3, -0.2, 0.7], np.float32)
    return [
        ("ScalarTLSEstimator.estimate_tiled",
         lambda d: ScalarTLSEstimator(device=d).estimate_tiled(x, r)),
        ("ScalarTLSEstimator.estimate scale",
         lambda d: ScalarTLSEstimator(device=d).estimate(x, r, mode="scale", u=u)),
        ("ScalarTLSEstimator.estimate translation",
         lambda d: ScalarTLSEstimator(device=d).estimate(xt, r[:4], mode="translation",
                                                        noise=0.2)),
        ("TLSScaleSolver", lambda d: TLSScaleSolver(0.01, 1.0, device=d).solveForScale(
            src, 1.5 * src, u=u)),
        ("ScaleInliersSelector", lambda d: ScaleInliersSelector(0.01, 1.0, device=d)
         .solveForScale(src, src)),
        ("TLSTranslationSolver", lambda d: TLSTranslationSolver(0.01, 1.0, device=d)
         .solveForTranslation(src, src + t_true[:, None])),
        ("GNCTLSRotationSolver", lambda d: GNCTLSRotationSolver(noise_bound=0.01, device=d)
         .solveForRotation(src, dst)),
    ]


def phase_reference_tools(device, card: str) -> dict:
    """Phase 23: the three reference-scale tools at a cut size and the five
    sub-solver facades, on the card."""
    from psulvsb_tpu_torch.solver.fused import clear_plan_cache
    from tools import cap_sweep_torch, clique_scale_audit_torch, fullscale_sweep_torch

    t_phase = time.perf_counter()
    out = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="psulvsb_fullscale_") as root:
        for dataset, scene in FULLSCALE_SCENES.items():
            clear_plan_cache()
            reset_launches()
            agg = fullscale_sweep_torch.sweep(
                dataset, os.path.join(root, "data"), os.path.join(root, "out", dataset), 10,
                device, scenes=[scene],
            )
            out["launches"][f"fullscale_{dataset}"] = launches = read_launches()
            out[dataset] = agg
            print(f"[tools] fullscale {dataset} {scene}: {json.dumps(agg)}; launches {launches}")
            if agg["per_scene_recall"][scene] != 1.0:
                raise AssertionError(f"{scene}: recall {agg['per_scene_recall'][scene]} < 1.0 "
                                     "(FULLSCALE_r05 has 1.0)")
            if launches["gnc_batch"] <= 0:
                raise AssertionError(f"the {dataset} sweep never launched the GNC kernel")
    clear_plan_cache()

    clique_scale_audit_torch.warm_up(device)
    row = clique_scale_audit_torch.audit_case(**AUDIT_CASE, time_limit_s=AUDIT_TIME_LIMIT_S,
                                              device=device)
    out["audit"] = row
    print(f"[tools] clique audit: {row}; card: {card}")
    if row["exact_timed_out"] or row["exact"] <= 0 or row["ratio"] < AUDIT_MIN_RATIO:
        raise AssertionError(f"clique audit at C = 2048: {row}")

    reset_launches()
    out["caps"] = [cap_sweep_torch.sweep_point(caps, CAP_K, device) for caps in CAP_POINTS]
    out["launches"]["cap_sweep"] = launches = read_launches()
    for r in out["caps"]:
        print(f"[tools] cap sweep {json.dumps(r)}; card: {card}")
        if not (r["easy90"]["ok"] and r["hard95"]["ok"]):
            raise AssertionError(f"cap point {r['caps']} is not ok on both fixtures: {r}")
    if launches["gnc_batch"] <= 0:
        raise AssertionError("the cap sweep never launched the GNC kernel")

    for name, call in facade_cases():
        got, want = call(device), call("cpu")
        if any(g.device.type != "cuda" for g in got):
            raise AssertionError(f"{name} did not run on the card")
        diffs = []
        for g, w in zip(got, want):
            if g.dtype == torch.bool:
                if not torch.equal(g.cpu(), w):
                    raise AssertionError(f"{name}: the inlier masks differ card vs CPU")
            else:
                diffs.append(float((g.cpu() - w).abs().max()))
        tol = ROT_TOL if "Rotation" in name else FACADE_SCALAR_TOL
        if max(diffs) > tol:
            raise AssertionError(f"{name}: card vs CPU {max(diffs)} > {tol}")
        print(f"[tools] facade {name}: max |card - CPU| {max(diffs):.3g} (tol {tol}), "
              "masks equal")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[tools] phase 23 in {out['phase_s']:.1f} s; card: {card}")
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
    phase_classic(device, card)
    phase_exact_clique(device, card)
    phase_rotation_variants(device, card)
    with tempfile.TemporaryDirectory(prefix="psulvsb_scene_") as scene_root:
        sweeps = phase_sweep(device, card, scene_root)
        phase_certifier(device, card)
        frontend = phase_frontend_sweep(device, card)
        sweeps["frontend"] = {"launches": frontend["launches"]}
        entry = phase_entry_points(device, card, scene_root)
    tools = phase_reference_tools(device, card)

    def row(name, source, replaces, path, staged, err, timed):
        """`launches`: over the fused path's N_TIMED_SOLVES solves, replayed
        launches included; `launches_staged`: over the staged path's solves;
        `launches_sweep`: over phase 19's two dataset sweeps and phase 21's
        two front-end sweeps; `launches_cli`: over phase 22's in-process CLI
        solves (two at known scale on the anchor, two at estimated scale at
        C = 5000, the CLI's defaults otherwise); `launches_tools`: over phase
        23's full-scale sweeps and cap-sweep points."""
        ms, plain_ms, (bound, bound_by) = timed
        if staged <= 0 or fused[path]["launches"][name] <= 0:
            raise AssertionError(f"{name} did not launch on the {path} path")
        return {
            "name": name, "route": "cuda", "source": f"psulvsb_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": fused[path]["launches"][name],
            "launches_staged": staged, "path": path,
            "launches_sweep": {tag: sw["launches"][name] for tag, sw in sweeps.items()},
            "launches_cli": sum(entry["cli"][tag]["launches"][name]
                                for tag in ("anchor", "unknown")),
            "launches_tools": {tag: n[name] for tag, n in tools["launches"].items()},
            "max_abs_err": err, "ms": ms,
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
