"""Smoke run of the PyTorch/CUDA port (psulvsb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device — the card's name and power limit (nvidia-smi); no CUDA device
   is a failure;
2. build — compile the GNC-TLS kernel (csrc/gnc_batch.cu) with nvcc;
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
5. result — the card line, a JSON line of per-kernel figures, and the
   final JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROT_TOL = 1e-4  # float32 sums in another order over <= 100 iterations
MASK_AGREE = 0.995
KERNEL_SHAPES = [(4, 256), (16, 1024), (4, 2048), (3, 197)]
TIMED_SHAPES = [(4, 256), (16, 1024)]
LOOP = dict(max_iterations=100, gnc_factor=1.4, cost_threshold=0.005)
ANCHOR_C = 1889
N_TIMED_SOLVES = 5


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

    gnc.KERNEL_LAUNCHES = 0
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    from psulvsb_tpu_torch.ops._build import BUILD_INFO, load_library
    from psulvsb_tpu_torch.utils.precision import pin_float32

    pin_float32()
    t0 = time.perf_counter()
    load_library("gnc_batch")
    regs = [ln.strip() for ln in BUILD_INFO["gnc_batch"]["log"].splitlines() if "registers" in ln]
    print(f"[build] gnc_batch.cu: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {BUILD_INFO['gnc_batch']['seconds']:.2f} s); " + " | ".join(regs))

    kern = phase_kernel_vs_plain(device)
    sl = phase_slice(device, card)

    ms, plain_ms = kern["times"][(4, 256)]
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "gnc_batch",
        "route": "cuda",
        "source": "psulvsb_tpu_torch/csrc/gnc_batch.cu",
        "replaces": "psulvsb_tpu/ops/pallas_gnc.py:235",
        "launches": sl["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
