"""Correspondence-file generator: raw PLY pair -> @corr.txt (port of
examples/generate_correspondences.py).

Equivalent of the reference's nested correspondence generator
(TEASER-plusplus/examples/teaser_cpp_ply/teaser_cpp_ply.cc:
voxel downsample -> ISS keypoints -> FPFH -> NN correspondences -> text file).

Usage:
    python -m psulvsb_tpu_torch.examples.generate_correspondences src.ply dst.ply \
        out@corr.txt [--noise-bound 0.05] [--device cuda]
"""

from __future__ import annotations

import argparse

from psulvsb_tpu_torch.cli import add_device_flag, resolve_or_exit
from psulvsb_tpu_torch.eval.corr_gen import generate_correspondences, write_corr_file
from psulvsb_tpu_torch.io.ply import read_ply


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="psulvsb_tpu_torch.examples.generate_correspondences")
    ap.add_argument("src_ply")
    ap.add_argument("dst_ply")
    ap.add_argument("out")
    ap.add_argument("--noise-bound", type=float, default=0.05)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_or_exit(args.device)

    src = read_ply(args.src_ply)
    dst = read_ply(args.dst_ply)
    s, d = generate_correspondences(src, dst, args.noise_bound, device=device)
    write_corr_file(args.out, s, d)
    print(f"{s.shape[1]} correspondences -> {args.out}")
    return {"correspondences": int(s.shape[1]), "out": args.out}


if __name__ == "__main__":
    main()
