"""Rotation certification demo (port of examples/certify_demo.py).

The DRS certifier (the reference's teaser::DRSCertifier, exposed in its
pybind11 module) verifies global optimality of a rotation estimate for the
QUASAR SDP. This demo fits a rotation to noisy points, certifies it, and
shows that a wrong rotation (the identity) is not certified.

Usage:
    python -m psulvsb_tpu_torch.examples.certify_demo [--noise 0.002] [--n 12] \
        [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from psulvsb_tpu_torch.certify import DRSCertifier
from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.core.linalg import svd_rot
from psulvsb_tpu_torch.core.se3 import random_se3
from psulvsb_tpu_torch.eval.synthetic import synthetic_cloud


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.certify_demo")
    ap.add_argument("--noise", type=float, default=0.002)
    ap.add_argument("--n", type=int, default=12)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)

    src = np.asarray(synthetic_cloud(args.n, seed=0), np.float64)
    gt = random_se3(np.random.default_rng(3), max_translation=0.0)
    rng = np.random.default_rng(0)
    dst = np.asarray(gt.rotation, np.float64) @ src + rng.normal(size=src.shape) * args.noise
    src32 = src.astype(np.float32)
    dst32 = dst.astype(np.float32)
    theta = np.ones(args.n, np.float32)

    r_est = svd_rot(torch.as_tensor(src32, device=device), torch.as_tensor(dst32, device=device))
    cert = DRSCertifier(noise_bound=0.01, cbar2=1.0)
    res = cert.certify(r_est, src32, dst32, theta, polish=True, device=device)
    print(f"estimate optimal: {bool(res.is_optimal)} "
          f"(suboptimality gap {float(res.best_suboptimality):.2e})")

    # A deliberately wrong rotation must fail certification.
    res_bad = cert.certify(np.eye(3, dtype=np.float32), src32, dst32, theta, device=device)
    print(f"identity-rotation certified: {bool(res_bad.is_optimal)} (expected False)")
    return {
        "estimate_certified": bool(res.is_optimal),
        "estimate_gap": float(res.best_suboptimality),
        "identity_certified": bool(res_bad.is_optimal),
    }


if __name__ == "__main__":
    main()
