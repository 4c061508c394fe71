"""PSULVSB synthetic-protocol demo (port of examples/psulvsb_demo.py).

Equivalent of the published experiment program
(the reference's examples/teaser_cpp_ply/PSULVSB.cc) and the binding smoke
example (python/teaserpp_python/teaserpp_example.py): load or synthesize a
cloud, apply a random SE(3) + noise + 90% outliers, register, report errors.

Usage:
    python -m psulvsb_tpu_torch.examples.psulvsb_demo [cloud.ply ...] \
        [--trials N] [--outliers 0.9] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os

from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.eval.protocol import run_protocol
from psulvsb_tpu_torch.eval.synthetic import synthetic_cloud
from psulvsb_tpu_torch.io.ply import read_ply
from psulvsb_tpu_torch.solver.config import SolverParams


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.psulvsb_demo")
    ap.add_argument("ply", nargs="*", help="input PLY clouds (synthetic if none)")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--outliers", type=float, default=0.9)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--out", default=os.path.join("build", "psulvsb_demo"))
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)

    if args.ply:
        clouds = {os.path.basename(p).removesuffix(".ply"): read_ply(p) for p in args.ply}
    else:
        clouds = {"synthetic": synthetic_cloud(500, seed=0)}

    agg = run_protocol(
        clouds,
        SolverParams.preset_artificial(),
        args.out,
        trials=args.trials,
        noise_bound=args.noise,
        outlier_rate=args.outliers,
        device=device,
    )
    recall = {}
    for name, stats in agg.items():
        print(f"== {name} ==")
        for field, (mean, std) in stats.items():
            print(f"  {field}: {mean:.5f} ± {std:.5f}")
        # A trial succeeds at RE < 5 deg and TE < 0.3 (bench.py:423-426).
        with open(os.path.join(args.out, f"{name}.csv")) as f:
            rows = list(csv.DictReader(f))
        ok = sum(float(r["AngleError"]) < 5.0 and float(r["TransError"]) < 0.3 for r in rows)
        recall[name] = ok / len(rows)
        print(f"  recall: {ok}/{len(rows)}")
    print(f"CSV reports in {args.out}/")
    return {"clouds": agg, "recall": recall, "out": args.out}


if __name__ == "__main__":
    main()
