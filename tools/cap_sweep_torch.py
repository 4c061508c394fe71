"""Cap sweep of the PyTorch port: the static caps (sampled_cap, basic_cap,
hypothesis_batch, pool_cap) against the fused solve's wall on the card, at
equal correctness.

The counterpart of tools/cap_sweep.py, on its grid (GRID x POOL_GRID) and
its two fixtures: the bunny-sized anchor (1889 correspondences, 90%
displaced outliers, noise 0.05, "easy90") and a hostile pair (95% mismatch
outliers, noise 0.01, "hard95"), both from the port's numpy generator. For
each point and fixture, `psulvsb_register` first solves once and captures
the point's plan as one graph (outside the timing); then k
back-to-back solves run between two CUDA events, and the figure is their
wall over k. The grid is swept twice, in order and back, so each point has
two figures taken at different times of the run. Each solve stages its
inputs and draws from the host and launches its graph once, so this is the
wall of a solve on the card, not a device time amortized inside one program
as the JAX tool's `lax.scan` measures it.
"ok" means RE < 5 deg and TE < 0.3 on the fixture, as the JAX tool's column.

Usage:
    python tools/cap_sweep_torch.py [--k 10] [--out docs/CAP_SWEEP_torch.md]
        [--device cuda]
The run is on the card unless `--device cpu` is given (the CPU's figure is
host time and says nothing of the card); without a card it exits at once
and says why. No default changes with the outcome.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import card_line  # noqa: E402

from psulvsb_tpu_torch.core.metrics import angular_error_deg_np  # noqa: E402
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud  # noqa: E402
from psulvsb_tpu_torch.solver.config import SolverParams  # noqa: E402
from psulvsb_tpu_torch.solver.fused import (  # noqa: E402
    clear_plan_cache,
    plan_for,
    psulvsb_register,
    resolve_device,
)
from psulvsb_tpu_torch.utils.precision import pin_float32  # noqa: E402

GRID = [
    (2048, 256, 4),
    (2048, 512, 4),
    (2048, 256, 8),
    (2048, 256, 16),
    (1024, 256, 4),
    (4096, 512, 8),
]
POOL_GRID = [8192, 16384, 32768]
SHIPPED = (2048, 256, 4, 8192)
SOLVE_SEED = 3


def fixtures():
    """[(name, pair, noise bound)]: easy90 and hard95 on a 1889-point cloud."""
    src = synthetic_cloud(1889, seed=0)
    easy = make_synthetic_pair(np.random.default_rng(1), src, noise_bound=0.05, outlier_rate=0.9)
    hard = make_synthetic_pair(np.random.default_rng(2), src, noise_bound=0.01, outlier_rate=0.95,
                               outlier_mode="mismatch")
    return [("easy90", easy, 0.05), ("hard95", hard, 0.01)]


def point_params(caps, noise_bound) -> SolverParams:
    sc, bc, hb, pc = caps
    return SolverParams.preset_artificial(
        noise_bound=noise_bound, noise_bound_dataset=noise_bound, sampled_cap=sc, basic_cap=bc,
        hypothesis_batch=hb, pool_cap=pc,
    )


def measure(caps, pair, noise_bound, k: int, device: torch.device) -> dict:
    """One fixture at one point: the wall of a solve over k solves in a row
    (plan built and captured first), the pose's errors, and the host rounds
    and local batches of a solve (every timed solve is the same one)."""
    params = point_params(caps, noise_bound)
    src = torch.as_tensor(np.asarray(pair.src, np.float32), device=device)
    dst = torch.as_tensor(np.asarray(pair.dst, np.float32), device=device)
    keep = torch.ones(src.shape[1], dtype=torch.int64, device=device)
    psulvsb_register(src, dst, keep, SOLVE_SEED, params, device=device)  # captures the graph
    sol = psulvsb_register(src, dst, keep, SOLVE_SEED, params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            sol = psulvsb_register(src, dst, keep, SOLVE_SEED, params, device=device)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / k
    else:
        t0 = time.perf_counter()
        for _ in range(k):
            sol = psulvsb_register(src, dst, keep, SOLVE_SEED, params, device=device)
        ms = (time.perf_counter() - t0) / k * 1e3
    re = angular_error_deg_np(np.asarray(pair.transform.rotation, np.float64),
                              sol.rotation.cpu().numpy().astype(np.float64))
    te = float(np.linalg.norm(sol.translation.cpu().numpy().astype(np.float64)
                              - np.asarray(pair.transform.translation, np.float64)))
    stats = plan_for(params, src.shape[1], device).stats
    return {"ms": round(ms, 3), "ok": bool(re < 5.0 and te < 0.3), "re": round(re, 4),
            "te": round(te, 5), "rounds": stats["rounds"], "batches": stats["local_batches"]}


def sweep_point(caps, k: int, device, fx=None) -> dict:
    """A row: the point's caps and, per fixture, ms, ok, RE and TE."""
    device = resolve_device(device)
    pin_float32()
    row = {"caps": list(caps)}
    for name, pair, nb in fx or fixtures():
        row[name] = measure(caps, pair, nb, k, device)
    clear_plan_cache()
    return row


def merge(turns: list[list[dict]]) -> list[dict]:
    """Rows of several sweeps of the grid, each in the grid's order, as one
    row a point: `ms` a list (one figure a turn), `ok` on every turn, RE and
    TE of the first."""
    rows = []
    for runs in zip(*turns):
        row = {"caps": runs[0]["caps"]}
        for name in ("easy90", "hard95"):
            row[name] = dict(runs[0][name], ms=[r[name]["ms"] for r in runs],
                             ok=all(r[name]["ok"] for r in runs))
        rows.append(row)
    return rows


def render(rows: list[dict], card: str, k: int, device: torch.device) -> str:
    what = ("the wall of one `psulvsb_register` solve, k = "
            f"{k} solves in a row between two CUDA events" if device.type == "cuda"
            else f"host time of one solve on the CPU over k = {k} (not a card figure)")
    lines = [
        "# Static-cap sweep (PyTorch port)",
        "",
        f"Card: {card}. Generated by `tools/cap_sweep_torch.py` over the JAX tool's grid",
        "(`tools/cap_sweep.py` GRID x POOL_GRID) and fixtures (easy90: 1889 correspondences,",
        "90% displaced outliers, noise 0.05; hard95: 95% mismatch outliers, noise 0.01; both",
        "from the port's numpy generator). Each point's plan was built and its graph",
        "captured before the timing.",
        f"Figure: {what}, solve seed {SOLVE_SEED};",
        "the grid ran twice, in order and then back, and each cell gives both turns.",
        "Each solve stages its inputs and draws and launches its graph once, so the figure",
        "is a solve's wall on the card, not a device time amortized inside one program as",
        "docs/CAP_SWEEP.md's `lax.scan` figure is; the two tables are not comparable and",
        "neither is the other's yardstick. \"ok\" = RE < 5 deg and TE < 0.3; r and b are",
        "the host rounds and local batches of the solve.",
        "",
        "| (sampled, basic, hyp_batch, pool) | easy90 | hard95 |",
        "|---|---|---|",
    ]
    for r in rows:
        caps = tuple(r["caps"])
        label = f"**{caps}** (shipped)" if caps == SHIPPED else str(caps)
        cells = [f"{', '.join(map(str, r[n]['ms']))} ms {'ok' if r[n]['ok'] else 'BAD'} "
                 f"({r[n]['re']} deg, {r[n]['rounds']} r, {r[n]['batches']} b)"
                 for n in ("easy90", "hard95")]
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    def mean(r):  # a point's mean wall over both fixtures and every turn
        walls = r["easy90"]["ms"] + r["hard95"]["ms"]
        return round(sum(walls) / len(walls), 3)

    ok_rows = [r for r in rows if r["easy90"]["ok"] and r["hard95"]["ok"]]
    if ok_rows:
        best = min(ok_rows, key=mean)
        shipped = next((r for r in rows if tuple(r["caps"]) == SHIPPED), None)
        lines += ["", f"Fastest point that is ok on both fixtures (mean wall over both fixtures "
                      f"and turns): {tuple(best['caps'])}, {mean(best)} ms"]
        if shipped is not None:
            lines[-1] += f"; shipped {SHIPPED}: {mean(shipped)} ms."
    lines += ["", "The shipped caps are not changed by this table."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10, help="solves timed a point and fixture")
    ap.add_argument("--out", default="docs/CAP_SWEEP_torch.md")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"cap_sweep_torch: {e}; pass --device cpu to run on the host", file=sys.stderr)
        return 1
    fx = fixtures()
    grid = [(sc, bc, hb, pc) for (sc, bc, hb) in GRID for pc in POOL_GRID]
    turns = []
    for order in (grid, grid[::-1]):
        turn = []
        for caps in order:
            turn.append(sweep_point(caps, args.k, device, fx))
            print(json.dumps(turn[-1]), flush=True)
        turns.append(sorted(turn, key=lambda r: grid.index(tuple(r["caps"]))))
    rows = merge(turns)
    with open(args.out, "w") as f:
        f.write(render(rows, card_line() if device.type == "cuda" else "cpu", args.k, device))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
