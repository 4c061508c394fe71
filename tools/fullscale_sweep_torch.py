"""Full-cardinality dataset sweep of the PyTorch port: the reference
benchmark's real pair counts through the batched harness, on the card.

The counterpart of tools/fullscale_sweep.py, on the same protocol: the 1623
pairs of the 3DMatch test split over its 8 scenes (506/156/208/226/104/54/
292/77, teaser_cpp_ply_main.cc:244-795) at 3500/5000/6500 correspondences a
pair, and 555 KITTI pairs over kitti_seq00-07 at 1500/2500, ddtime 10, the
caps (2048, 256, 4), data seed 11. Scenes are generated by the port's
`make_dataset.write_benchmark` (numpy draws, so the pairs differ from the JAX
tool's), the buckets' replay plans are built and captured by `warm_scene`,
and `run_benchmark_batched(..., resume=True)` sweeps them. A sweep cut short
resumes at the completed-scene boundary; each scene's wall is kept in
`walls.json` beside its CSVs, so `sweep_wall_s` sums the walls of the calls
that swept it.

summary.json holds the JAX tool's keys (pairs, pairs_expected, ddtime,
recall, per_scene_recall, sweep_wall_s, swept_this_run, caps, n_corr), the
card's name and power limit as nvidia-smi gives them, the solves and the
harness's timed region over the sidecars, and this call's peak device
memory.

Usage:
    python tools/fullscale_sweep_torch.py [--out FULLSCALE_h100]
        [--data build/fullscale_data] [--datasets 3dmatch,kitti]
        [--ddtime 10] [--device cuda]
The run is on the card unless `--device cpu` is given; without a card it
exits at once and says why. Resume is always on.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line  # noqa: E402

from psulvsb_tpu_torch.eval.batch_harness import run_benchmark_batched, warm_scene  # noqa: E402
from psulvsb_tpu_torch.eval.make_dataset import write_benchmark  # noqa: E402
from psulvsb_tpu_torch.eval.realdata import THREEDMATCH_SCENES, write_average_csv  # noqa: E402
from psulvsb_tpu_torch.solver.config import SolverParams  # noqa: E402
from psulvsb_tpu_torch.solver.fused import clear_plan_cache, resolve_device  # noqa: E402

# The published per-scene pair counts of the 3DMatch test split (sum 1623).
THREEDMATCH_PAIRS = {
    "7-scenes-redkitchen": 506,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 156,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 208,
    "sun3d-hotel_uc-scan3": 226,
    "sun3d-hotel_umd-maryland_hotel1": 104,
    "sun3d-hotel_umd-maryland_hotel3": 54,
    "sun3d-mit_76_studyroom-76-1studyroom2": 292,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 77,
}
KITTI_PAIRS = 555  # teaser_cpp_ply_main.cc:714 / BASELINE.md
KITTI_SCENES = [f"kitti_seq{i:02d}" for i in range(8)]
CAPS = dict(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)
N_CORR = {"3dmatch": (3500, 5000, 6500), "kitti": (1500, 2500)}  # 3DMatch: mean 5000
SEED = 11


def card_fields(device: torch.device) -> dict:
    """{"card", "power_limit"} as nvidia-smi names them; the host is "cpu"."""
    if device.type != "cuda":
        return {"card": "cpu", "power_limit": None}
    name, limit = (s.strip() for s in card_line().rsplit(",", 1))
    return {"card": name, "power_limit": limit}


def protocol(dataset: str) -> tuple[list[str], dict[str, int], SolverParams, int]:
    """(scenes, pairs a scene, params, pairs expected) of a dataset."""
    if dataset == "3dmatch":
        return (list(THREEDMATCH_SCENES), THREEDMATCH_PAIRS, SolverParams.preset_3dmatch(**CAPS),
                sum(THREEDMATCH_PAIRS.values()))
    if dataset == "kitti":
        base = KITTI_PAIRS // 8
        n_pairs = {s: base + (1 if i < KITTI_PAIRS % 8 else 0) for i, s in enumerate(KITTI_SCENES)}
        return KITTI_SCENES, n_pairs, SolverParams.preset_kitti(**CAPS), KITTI_PAIRS
    raise ValueError(dataset)


def generate(dataset: str, root: str, scenes: list[str], n_pairs: dict, n_corr) -> None:
    """Write the dataset's scenes unless `gen_config.json` records exactly
    this generation (a bare existence check would sweep stale data after a
    change of protocol)."""
    cfg = {"dataset": dataset, "scenes": scenes, "n_pairs": n_pairs, "n_corr": list(n_corr),
           "seed": SEED}
    cfg_path = os.path.join(root, "gen_config.json")
    try:
        with open(cfg_path) as f:
            if json.load(f) == cfg:
                return
    except (OSError, ValueError):
        pass
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.monotonic()
    # One scene at a time, each with the seed its place in the dataset's whole
    # list gives it (write_benchmark seeds scene i with seed + 17 i): a sweep
    # of some scenes writes the very pairs of the whole dataset's sweep.
    everyone = protocol(dataset)[0]
    for scene in scenes:
        write_benchmark(root, [scene], dataset=dataset, n_pairs=n_pairs, n_corr=n_corr,
                        seed=SEED + 17 * everyone.index(scene))
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    print(f"[fullscale] generated {dataset} in {time.monotonic() - t0:.0f} s", file=sys.stderr)


def sweep(dataset: str, data_root: str, out_dir: str, ddtime: int, device="cuda",
          scenes: list[str] | None = None) -> dict:
    """Sweep `dataset` (all its scenes, or the named ones: their pairs are
    those of the whole sweep) through the batched harness with resume;
    returns its summary."""
    device = resolve_device(device)
    all_scenes, n_pairs, params, total_expect = protocol(dataset)
    # The harness solves at known scale whatever the preset says
    # (realdata.sweep_setup, main.cc:319): warm the plans of that program.
    params = params.replace(estimate_scaling=False)
    n_corr = N_CORR[dataset]
    scenes = list(scenes or all_scenes)
    n_pairs = {s: n_pairs[s] for s in scenes}
    if len(scenes) < len(all_scenes):
        total_expect = sum(n_pairs.values())
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.join(data_root, dataset)
    generate(dataset, root, scenes, n_pairs, n_corr)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    warm_scene(os.path.join(root, scenes[0]), params, device=device)
    walls_path = os.path.join(out_dir, "walls.json")
    try:
        with open(walls_path) as f:
            walls = json.load(f)
    except (OSError, ValueError):
        walls = {}
    summary = {}
    for scene in scenes:
        t0 = time.monotonic()
        stats = run_benchmark_batched(
            root, out_dir, dataset=dataset, scenes=[scene], params=params, ddtime=ddtime,
            resume=True, device=device,
        )[scene]
        if stats.get("timing") != "resumed" or scene not in walls:
            walls[scene] = time.monotonic() - t0
            with open(walls_path + ".tmp", "w") as f:
                json.dump(walls, f, indent=1)
            os.replace(walls_path + ".tmp", walls_path)
        summary[scene] = stats
    write_average_csv(out_dir, dataset, "fpfh", summary)

    total = sum(s["pairs"] for s in summary.values())
    succ = sum(round(s["recall"] * s["pairs"]) for s in summary.values())
    swept = [s for s in summary.values() if s.get("timing") != "resumed"]
    agg = {
        "dataset": dataset,
        "pairs": total,
        "pairs_expected": total_expect,
        "ddtime": ddtime,
        "recall": round(succ / max(total, 1), 4),
        "per_scene_recall": {k: round(s["recall"], 4) for k, s in summary.items()},
        "sweep_wall_s": round(sum(walls[s] for s in scenes), 1),
        "swept_this_run": sum(s["pairs"] for s in swept),
        "caps": CAPS,
        "n_corr": list(n_corr),
        **card_fields(device),
        "solves": sum(s["split"]["solves"] for s in summary.values()),
        "timed_wall_s": round(sum(s["split"]["wall_s"] for s in summary.values()), 3),
        "per_scene_wall_s": {s: round(walls[s], 2) for s in scenes},
    }
    agg["solves_per_s"] = round(agg["solves"] / max(agg["timed_wall_s"], 1e-9), 2)
    if device.type == "cuda":
        agg["peak_allocated_GiB"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 2)
        agg["peak_reserved_GiB"] = round(torch.cuda.max_memory_reserved(device) / 2**30, 2)
    return agg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="FULLSCALE_h100")
    ap.add_argument("--data", default=str(ROOT / "build" / "fullscale_data"))
    ap.add_argument("--datasets", default="3dmatch,kitti")
    ap.add_argument("--ddtime", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"fullscale_sweep_torch: {e}; pass --device cpu to run on the host",
              file=sys.stderr)
        return 1

    results = {}
    summary_path = os.path.join(args.out, "summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            results = json.load(f)
    for ds in args.datasets.split(","):
        # A dataset's plans go before the next one's are built (6.4 GiB a
        # plan at the 8192 bucket).
        clear_plan_cache()
        agg = sweep(ds, args.data, os.path.join(args.out, ds), args.ddtime, device)
        results[ds] = agg
        os.makedirs(args.out, exist_ok=True)
        with open(summary_path + ".tmp", "w") as f:
            json.dump(results, f, indent=1)
        os.replace(summary_path + ".tmp", summary_path)
        print(json.dumps(agg), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
