"""Smoke run of the PyTorch/CUDA port (psulvsb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device — the card's name and power limit (nvidia-smi); no CUDA device
   is a failure;
2. build — compile the three kernels (csrc/gnc_batch.cu,
   csrc/pair_ratio_hist.cu, csrc/pair_beta_count.cu) with nvcc, one process
   each, all started together, and print ptxas's register lines;
3. kernel vs plain — ops.gnc.gnc_batch (the kernel) against
   gnc_batch_reference (plain PyTorch) on the card, at (B, N) = (4, 256),
   (16, 1024), (4, 2048), (3, 197), with 30% gross outliers, half the
   columns masked, with and without a warm start: max |dR| <= 1e-4 and
   inlier masks agreeing on >= 99.5% of active columns; an all-inactive
   hypothesis gives the identity and no inliers; N = 0 raises; medians of
   20 timed runs (CUDA events) at (4, 256) and (16, 1024);
4. slice — the bench anchor pair (C = 1889, 90% displaced outliers, noise
   0.05) solved through RobustRegistrationSolver(SolverParams.
   preset_anchor()) on the card: one warm-up and 5 timed solves with
   different seeds, each valid with RE < 5 deg and TE < 0.3, and the
   kernel's launch count, reset just before, must have grown;
5. pair-grid kernels vs plain — ops.hist.pair_ratio_histogram and
   pair_beta_count (the kernels) against their plain PyTorch versions on
   the card at C = 197, 1889, 5000, 12000 with about 20% of the points
   inactive: the coarse window (128 bins, stride 16, clamped), the fine
   window (48 bins, stride 1, dropped, lo > 0) and the exact_hist window
   (512 bins, clamped), and beta at the 3DMatch and artificial presets'
   values; counts must be equal (a razor-edge flip would be allowed up to
   2 pairs per call with equal totals and argmax, and is printed).
   exact_peak_bin's peak, count and certificate must equal the plain
   version's, and a 200x scale must not be certified. Medians of 20 timed
   runs (CUDA events) at C = 5000 and 16384;
6. slice, unknown scale — the 3DMatch unknownScale protocol at C = 5000
   (noise 0.01, 85% mismatch outliers, dst stretched by a test scale drawn
   in [1, 5) from the seed) solved through RobustRegistrationSolver(
   SolverParams.preset_3dmatch(estimate_scaling=True, ...)) with the clique
   stages off: one warm-up and 5 timed solves, each valid with RE < 5 deg,
   TE < 0.3 and scale error <= 0.1; the histogram kernel and the GNC
   kernel must have launched;
7. slice, beyond the dense window — at C = 12000 one known-scale solve
   (preset_anchor, the anchor protocol) routed to "exact_beta", which must
   launch the beta-count kernel, and one unknown-scale solve (the protocol
   of phase 6) routed to "exact_hist", which must launch the histogram
   kernel, each gated like its protocol;
8. result — the card line, a JSON line of per-kernel figures, and the
   final JSON line {"ok": true, "device": {...}}.

Every launch count is set to 0 just before a phase drives a solve path and
read just after it; launches made to compare a kernel with its plain
version are not counted in any path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROT_TOL = 1e-4  # float32 sums in another order over <= 100 iterations
MASK_AGREE = 0.995
KERNEL_SHAPES = [(4, 256), (16, 1024), (4, 2048), (3, 197)]
TIMED_SHAPES = [(4, 256), (16, 1024)]
LOOP = dict(max_iterations=100, gnc_factor=1.4, cost_threshold=0.005)
ANCHOR_C = 1889
N_TIMED_SOLVES = 5
KERNELS = ("gnc_batch", "pair_ratio_hist", "pair_beta_count")
HIST_SIZES = [197, 1889, 5000, 12000]
HIST_TIMED_SIZES = [5000, 16384]
BETAS = {"3dmatch": 0.02, "artificial": 0.1}  # 2 noise_bound sqrt(cbar2)
MAX_FLIPS = 2  # pairs per call a razor-edge ratio may move (none expected)
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


def phase_kernel_vs_plain(device) -> dict:
    from psulvsb_tpu_torch.ops import gnc

    rng = np.random.default_rng(0)
    max_err = 0.0
    for b, n in KERNEL_SHAPES:
        for use_warm in (False, True):
            src, dst, act, nb, warm = gnc_problem(rng, b, n, device)
            args = (src, dst, act, nb, warm, use_warm)
            rk, ik = gnc.gnc_batch(*args, **LOOP)
            rr, ir = gnc.gnc_batch_reference(*args, **LOOP)
            torch.cuda.synchronize()
            err = float((rk - rr).abs().max())
            agree = float(((ik == ir) & act).sum() / act.sum())
            print(f"[kernel] B={b} N={n} warm={use_warm}: max|dR|={err:.3e} "
                  f"mask agreement={agree:.5f}")
            if not err <= ROT_TOL:
                raise AssertionError(f"rotation mismatch {err} > {ROT_TOL} at B={b} N={n}")
            if not agree >= MASK_AGREE:
                raise AssertionError(f"inlier masks agree on {agree} < {MASK_AGREE}")
            if (ik & ~act).any():
                raise AssertionError("kernel marked an inactive column as inlier")
            max_err = max(max_err, err)

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

    times = {}
    for b, n in TIMED_SHAPES:
        src, dst, act, nb, warm = gnc_problem(rng, b, n, device)
        args = (src, dst, act, nb, warm, False)
        ms = median_ms(lambda: gnc.gnc_batch(*args, **LOOP))
        plain = median_ms(lambda: gnc.gnc_batch_reference(*args, **LOOP))
        times[(b, n)] = (ms, plain)
        print(f"[kernel] B={b} N={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              "(median of 20, CUDA events)")
    return {"max_abs_err": max_err, "times": times}


def phase_slice(device, card: str) -> dict:
    from psulvsb_tpu_torch import RobustRegistrationSolver, SolverParams, psulvsb_solve
    from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
    from psulvsb_tpu_torch.ops import gnc

    params = SolverParams.preset_anchor()
    pair = make_synthetic_pair(
        np.random.default_rng(1), synthetic_cloud(ANCHOR_C, seed=0), 0.05, 0.9
    )
    src = torch.as_tensor(pair.src, device=device)
    dst = torch.as_tensor(pair.dst, device=device)

    def solve(seed):
        solver = RobustRegistrationSolver(params, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver.solve(src, dst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rot = sol.rotation.cpu().numpy()
        trans = sol.translation.cpu().numpy()
        if sol.rotation.device != device:
            raise AssertionError(f"the solve ran on {sol.rotation.device}, not {device}")
        if not (np.isfinite(rot).all() and np.isfinite(trans).all()):
            raise AssertionError("non-finite solution")
        re = angular_error_deg_np(pair.transform.rotation, rot)
        te = float(np.linalg.norm(trans - pair.transform.translation))
        valid = bool(sol.valid)
        info = solver._info
        print(f"[slice] seed={seed}: valid={valid} RE={re:.4f} deg TE={te:.5f} "
              f"inliers={int(sol.final_inlier_count)} rounds={info['rounds']} "
              f"batches={info['total_local_batches']} host_syncs={info['host_syncs']} "
              f"wall={wall * 1e3:.2f} ms")
        if not (valid and re < 5.0 and te < 0.3):
            raise AssertionError(f"anchor solve failed: valid={valid} RE={re} TE={te}")
        return wall, info["host_syncs"]

    reset_launches()
    solve(0)  # warm-up
    runs = [solve(100 + i) for i in range(N_TIMED_SOLVES)]
    launches = gnc.KERNEL_LAUNCHES
    if launches <= 0:
        raise AssertionError("the anchor solves never launched the GNC kernel")
    walls = [w for w, _ in runs]
    syncs = [s for _, s in runs]
    print(f"[slice] C={ANCHOR_C}: median wall {statistics.median(walls) * 1e3:.2f} ms "
          f"over {N_TIMED_SOLVES} solves (min {min(walls) * 1e3:.2f}, max "
          f"{max(walls) * 1e3:.2f}); host syncs per solve {syncs}; kernel launches "
          f"{launches} over {N_TIMED_SOLVES + 1} solves; card: {card}")

    # Per-stage wall time of one solve, with a device sync after each stage.
    _, info = psulvsb_solve(
        src, dst, torch.ones(ANCHOR_C, dtype=torch.int64, device=device), params,
        torch.Generator(device=device).manual_seed(7), profile=True,
    )
    stages = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in info["stage_s"].items())
    print(f"[slice] profiled solve stages: {stages}")
    return {"launches": launches}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from psulvsb_tpu_torch.ops import gnc, hist

    gnc.KERNEL_LAUNCHES = 0
    for name in hist.KERNEL_LAUNCHES:
        hist.KERNEL_LAUNCHES[name] = 0


def read_launches() -> dict:
    from psulvsb_tpu_torch.ops import gnc, hist

    return {"gnc_batch": gnc.KERNEL_LAUNCHES, **hist.KERNEL_LAUNCHES}


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
    """Total count difference between kernel and plain; more than
    MAX_FLIPS pairs, or different totals or argmax, is a failure."""
    g = got.cpu().numpy().reshape(-1)
    w = want.cpu().numpy().reshape(-1)
    diff = int(np.abs(g - w).sum())
    if diff and (diff > MAX_FLIPS or (g.size > 1 and (g.sum() != w.sum() or g.argmax() != w.argmax()))):
        raise AssertionError(f"{what}: kernel counts differ from the plain version's by {diff}")
    return diff


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
        k = [int(x) for x in hist.exact_peak_bin(src, dst, act)]
        p = [int(x) for x in hist.exact_peak_bin_reference(src, dst, act)]
        if k != p:
            raise AssertionError(f"C={c}: exact_peak_bin {k} != plain {p}")
        print(f"[pairs] C={c} exact_peak_bin (peak, count, certified) = {tuple(k)}, as plain")
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
            "hist coarse 128/16": (
                lambda: hist.pair_ratio_histogram(src, dst, act, num_bins=128, stride=16),
                lambda: hist.pair_ratio_histogram_reference(src, dst, act, num_bins=128, stride=16),
            ),
            "hist exact_hist 512": (
                lambda: hist.pair_ratio_histogram(src, dst, act, num_bins=512),
                lambda: hist.pair_ratio_histogram_reference(src, dst, act, num_bins=512),
            ),
            "beta 0.1": (
                lambda: hist.pair_beta_count(src, dst, 0.1, act),
                lambda: hist.pair_beta_count_reference(src, dst, 0.1, act),
            ),
        }
        for label, (kern, plain) in cases.items():
            ms = median_ms(kern)
            plain_ms = median_ms(plain)
            times[(label, c)] = (ms, plain_ms)
            print(f"[pairs] C={c} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  "(median of 20, CUDA events)")
    return {"max_diff": worst, "times": times}


def run_solve(tag, params, pair, seed, device, route):
    """One solve through RobustRegistrationSolver on the card, gated by the
    protocol's success criteria (valid, RE < 5 deg, TE < 0.3, scale error
    <= 0.1) and by the init route it must take."""
    from psulvsb_tpu_torch import RobustRegistrationSolver
    from psulvsb_tpu_torch.eval.synthetic import registration_errors

    src = torch.as_tensor(pair.src, device=device)
    dst = torch.as_tensor(pair.dst, device=device)
    solver = RobustRegistrationSolver(params, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(src, dst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sol.rotation.device != device:
        raise AssertionError(f"the solve ran on {sol.rotation.device}, not {device}")
    rot = sol.rotation.cpu().numpy()
    trans = sol.translation.cpu().numpy()
    scale = float(sol.scale)
    if not (np.isfinite(rot).all() and np.isfinite(trans).all() and np.isfinite(scale)):
        raise AssertionError(f"{tag}: non-finite solution")
    re, te, se = registration_errors(pair, scale, rot, trans)
    valid = bool(sol.valid)
    info = solver._info
    print(f"[{tag}] seed={seed}: valid={valid} RE={re:.4f} deg TE={te:.5f} scale={scale:.4f} "
          f"(true {float(pair.transform.scale):.4f}, error {se:.5f}) init={info['init_mode']} "
          f"rounds={info['rounds']} batches={info['total_local_batches']} "
          f"host_syncs={info['host_syncs']} wall={wall * 1e3:.2f} ms")
    if info["init_mode"] != route:
        raise AssertionError(f"{tag}: init took {info['init_mode']!r}, expected {route!r}")
    if not (valid and re < 5.0 and te < 0.3 and se <= 0.1):
        raise AssertionError(f"{tag} solve failed: valid={valid} RE={re} TE={te} scale error={se}")
    return wall, info


def unknown_scale_pair(c, seed):
    """The 3DMatch unknownScale protocol: noise 0.01, 85% mismatch
    outliers, dst stretched by a test scale drawn in [1, 5) from the seed."""
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

    rng = np.random.default_rng(seed)
    test_scale = 1.0 + 4.0 * rng.uniform()
    return make_synthetic_pair(
        rng, synthetic_cloud(c, seed=seed), 0.01, UNKNOWN_RATE, outlier_mode="mismatch",
        test_scale=test_scale,
    )


def unknown_scale_params():
    from psulvsb_tpu_torch import InlierSelectionMode, SolverParams

    return SolverParams.preset_3dmatch(
        estimate_scaling=True, sampled_cap=2048, basic_cap=256, hypothesis_batch=4,
        clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE,
    )


def phase_unknown_scale(device, card: str) -> dict:
    from psulvsb_tpu_torch import psulvsb_solve

    params = unknown_scale_params()
    pair = unknown_scale_pair(UNKNOWN_C, 5)
    reset_launches()
    run_solve("unknown", params, pair, 0, device, "dense")  # warm-up
    runs = [run_solve("unknown", params, pair, 100 + i, device, "dense")
            for i in range(N_TIMED_SOLVES)]
    launches = read_launches()
    if launches["pair_ratio_hist"] <= 0 or launches["gnc_batch"] <= 0:
        raise AssertionError(f"the unknown-scale solves did not launch both kernels: {launches}")
    walls = [w for w, _ in runs]
    print(f"[unknown] C={UNKNOWN_C}: median wall {statistics.median(walls) * 1e3:.2f} ms over "
          f"{N_TIMED_SOLVES} solves (min {min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
          f"host syncs per solve {[i['host_syncs'] for _, i in runs]}; launches over "
          f"{N_TIMED_SOLVES + 1} solves {launches}; card: {card}")
    _, info = psulvsb_solve(
        torch.as_tensor(pair.src, device=device), torch.as_tensor(pair.dst, device=device),
        torch.ones(UNKNOWN_C, dtype=torch.int64, device=device), params,
        torch.Generator(device=device).manual_seed(7), profile=True,
    )
    stages = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in info["stage_s"].items())
    print(f"[unknown] profiled solve stages: {stages}")
    return {"launches": launches}


def phase_wide(device) -> dict:
    from psulvsb_tpu_torch import SolverParams
    from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

    known = make_synthetic_pair(
        np.random.default_rng(3), synthetic_cloud(WIDE_C, seed=3), 0.05, 0.9
    )
    reset_launches()
    run_solve("wide", SolverParams.preset_anchor(), known, 1, device, "exact_beta")
    beta = read_launches()
    if beta["pair_beta_count"] <= 0 or beta["gnc_batch"] <= 0:
        raise AssertionError(f"the C={WIDE_C} known-scale solve missed a kernel: {beta}")
    reset_launches()
    run_solve("wide", unknown_scale_params(), unknown_scale_pair(WIDE_C, 4), 1, device,
              "exact_hist")
    hist_run = read_launches()
    if hist_run["pair_ratio_hist"] <= 0 or hist_run["gnc_batch"] <= 0:
        raise AssertionError(f"the C={WIDE_C} unknown-scale solve missed a kernel: {hist_run}")
    print(f"[wide] C={WIDE_C}: launches, known scale {beta}; unknown scale {hist_run}")
    return {"beta": beta, "hist": hist_run}


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

    ms, plain_ms = kern["times"][(4, 256)]
    hist_ms, hist_plain = pairs["times"][("hist coarse 128/16", UNKNOWN_C)]
    beta_ms, beta_plain = pairs["times"][("beta 0.1", 16384)]
    print(card_line())
    print(json.dumps({"kernels": [
        {
            "name": "gnc_batch",
            "route": "cuda",
            "source": "psulvsb_tpu_torch/csrc/gnc_batch.cu",
            "replaces": "psulvsb_tpu/ops/pallas_gnc.py:235",
            "launches": sl["launches"],
            "max_abs_err": kern["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "pair_ratio_hist",
            "route": "cuda",
            "source": "psulvsb_tpu_torch/csrc/pair_ratio_hist.cu",
            "replaces": "psulvsb_tpu/ops/pallas_hist.py:120",
            "launches": unknown["launches"]["pair_ratio_hist"],
            "max_abs_err": pairs["max_diff"]["hist"],
            "ms": hist_ms,
            "plain_ms": hist_plain,
        },
        {
            "name": "pair_beta_count",
            "route": "cuda",
            "source": "psulvsb_tpu_torch/csrc/pair_beta_count.cu",
            "replaces": "psulvsb_tpu/ops/pallas_hist.py:241",
            "launches": wide["beta"]["pair_beta_count"],
            "max_abs_err": pairs["max_diff"]["beta"],
            "ms": beta_ms,
            "plain_ms": beta_plain,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
