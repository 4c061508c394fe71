"""3DMatch / 3DLoMatch / KITTI real-data benchmark CLI (port of
examples/benchmark_3dmatch.py).

Equivalent of the reference's nested benchmark program
(TEASER-plusplus/examples/teaser_cpp_ply/teaser_cpp_ply_main.cc).
Expects the reference's file layout under --data-root:
    <scene>/cloud_bin_A+cloud_bin_B@corr.txt      (or @corr_fcgf.txt)
    <scene>/cloud_bin_A+cloud_bin_B@GTmat.txt     (or @GTmat_fcgf.txt)
    <scene>/pairs.txt                              (fragment id pairs)

Usage:
    python -m psulvsb_tpu_torch.examples.benchmark_3dmatch --data-root DATA --out OUT \
        [--dataset 3dmatch|3dlomatch|kitti|whu_tls] [--descriptor fpfh|fcgf] \
        [--ddtime 10] [--unknown-scale] [--batched] [--sharded] [--resume] \
        [--device cuda]

--batched runs all (pair, retry) solves of a scene through one batch of
replayed solves (eval/batch_harness.py over parallel.pairs.register_batch;
--sharded spreads the batch over every visible card). The default serial
path keeps faithful per-pair wall times and per-pair checkpoints.
"""

from __future__ import annotations

import argparse
import json

from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.eval.batch_harness import run_benchmark_batched
from psulvsb_tpu_torch.eval.realdata import run_benchmark


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.benchmark_3dmatch")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="3dmatch",
                    choices=["3dmatch", "3dlomatch", "kitti", "whu_tls"])
    ap.add_argument("--descriptor", default="fpfh", choices=["fpfh", "fcgf"])
    ap.add_argument("--ddtime", type=int, default=10)
    ap.add_argument("--unknown-scale", action="store_true")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--batched", action="store_true",
                    help="all solves of a scene in one batch of replayed solves")
    ap.add_argument("--sharded", action="store_true",
                    help="with --batched: spread the batch over all cards")
    ap.add_argument("--resume", action="store_true",
                    help="with --batched: skip scenes whose completed sidecar"
                         " meta (<csv>.meta.json) matches this run's protocol"
                         " fingerprint (a bare CSV is not enough)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)

    common = dict(dataset=args.dataset, scenes=args.scenes, descriptor=args.descriptor,
                  ddtime=args.ddtime, unknown_scale=args.unknown_scale, device=device)
    if args.batched or args.sharded:
        summary = run_benchmark_batched(args.data_root, args.out, sharded=args.sharded,
                                        resume=args.resume, **common)
    else:
        summary = run_benchmark(args.data_root, args.out, **common)
    print(json.dumps(summary, indent=2))
    recalls = [s["recall"] for s in summary.values()]
    mean_recall = sum(recalls) / len(recalls) if recalls else float("nan")
    if recalls:
        print(f"mean recall: {mean_recall:.4f}")
    return {"summary": summary, "mean_recall": mean_recall}


if __name__ == "__main__":
    main()
