"""Run one cell of the benchmark of psulvsb_tpu_torch once, on the CUDA card
of this machine, and print its result as the last line of standard output:

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Without a card, or with fewer cards than the
cell asks for, it exits non-zero and prints no result; it never falls back
to the CPU. Caches go to `build/` inside the checkout, where the port also
builds its kernels."""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "psulvsb_tpu_torch"
# One host thread for the libraries' CPU pools, so that a run is one process
# with few threads beside the card; the spread between runs comes from the
# plans' own speed, not from the host (PERF.md, section 2).
HOST_THREADS = 1


def set_environment() -> None:
    """Before numpy and torch load: caches inside the checkout, one host
    thread, no JAX behind any library, the checkout on the path."""
    cache = ROOT / "build" / "cardbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = str(HOST_THREADS)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"{PROGRAM}/ is not in {ROOT}: this checkout holds no program to measure",
              file=sys.stderr)
        return 2
    set_environment()
    from cardbench import harness

    cell = harness.Cell(ROOT, args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    print(f"card: {harness.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
