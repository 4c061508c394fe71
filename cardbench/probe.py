"""Readings for the limits of `correct`, kept apart from the benchmark's own
runs: a cell run on many seeds in one process, sound, with the control in
the program's place, or with a fault planted in the timed path.

    python3 cardbench/probe.py --workload <name> --seeds 1,2,3 --seconds 5 \\
        --modes sound,control,control_f32,stale,half,altered[,keep][,unscaled] \\
        [--out <file.jsonl>] [--gaps <dir>]

Modes:
- sound: the program as it is;
- control: each answer replaced, once the window has closed, by the plain
  reference's (reference/oracle.py, and reference/prefilter.py for keep
  masks) computed in bfloat16, the precision below the solver's float32
  (a similarity fit, with its scale, for a configuration with a
  `test_scale`);
- control_f32: the same, with each rotation made orthonormal again in
  float32 before it is handed out (bfloat16 arithmetic that `orth_err`
  cannot see);
- stale: the plan's solve returns its state unchanged (the graph is not
  launched; the buffers keep the last solve's solution);
- half: half of each batch's answers left out (zeros; in the online cell
  every second request's);
- altered: each answer's translation moved by 40 noise bounds where the
  plan hands it out;
- keep: the pre-filter's keep mask altered where it is produced (every
  tenth column thrown out; a cell with keep masks only);
- unscaled: each answer's scale set to 1 where the plan hands it out, as a
  program that skipped the scale estimate would return it (a cell whose
  configuration has a `test_scale`).
One line of JSON a run: mode, seed, correct, the numbers compared, the
answers neither missed nor filtered (`hits`) and those of them to clean
pairs (harness.judge_window), the metrics, the run's memory peak (and what
was allocated when it began) and the plans' sizes; with --gaps, each run's
per-answer readings, flags and answers as
`<dir>/<cell>.<mode>.<seed>.npz`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("sound", "control", "control_f32", "stale", "half", "altered", "keep", "unscaled")


class Patches:
    """Attributes replaced for one run and put back after it."""

    def __init__(self):
        self.saved = []

    def set(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


def _zeroed(sol):
    import torch

    return type(sol)(*(torch.zeros_like(field) for field in sol))


def _on_solution(patches: Patches, field: str, change) -> None:
    """`change(plan, tensor)` alters the solution's `field` in place where
    the plan hands it out (fresh tensors, or rows of a batch's solution)."""
    from psulvsb_tpu_torch.solver import fused

    solution = fused.ReplayPlan.solution

    def changed(self, out=None, index=None, count=None):
        res = solution(self, out, index, count)
        if out is None:
            change(self, getattr(res, field))
        else:
            rows = index if self.pairs is None else slice(index, index + (count or self.pairs))
            change(self, getattr(out, field)[rows])
        return res
    patches.set(fused.ReplayPlan, "solution", changed)


def plant(mode: str, patches: Patches) -> None:
    """Plant the fault `mode` in the program (for the window only)."""
    from psulvsb_tpu_torch.eval import pipeline
    from psulvsb_tpu_torch.parallel import pairs
    from psulvsb_tpu_torch.solver import fused

    if mode == "stale":
        def run_unchanged(self):
            self.solves += 1
        patches.set(fused.ReplayPlan, "_run", run_unchanged)
    elif mode == "half":
        batch = pairs.register_batch
        single = pipeline.solve_with_prefilter
        calls = [0]

        def half_batch(src, *args, **kw):
            sol = batch(src, *args, **kw)
            b = len(sol.valid)
            for field in sol:
                field[b - b // 2:] = 0
            return sol

        def every_second(*args, **kw):
            res = single(*args, **kw)
            calls[0] += 1
            return res._replace(solution=_zeroed(res.solution)) if calls[0] % 2 else res
        patches.set(pairs, "register_batch", half_batch)
        patches.set(pipeline, "solve_with_prefilter", every_second)
    elif mode == "altered":
        _on_solution(patches, "translation",
                     lambda plan, t: t.add_(40.0 * plan.params.noise_bound))
    elif mode == "unscaled":
        _on_solution(patches, "scale", lambda plan, s: s.fill_(1.0))
    elif mode == "keep":
        hist = pipeline.normal_angle_histogram_filter

        def thrown_out(*args, **kw):
            keep, angles = hist(*args, **kw)
            keep = keep.clone()
            keep[::10] = -1
            return keep, angles
        patches.set(pipeline, "normal_angle_histogram_filter", thrown_out)
    elif mode not in ("sound", "control", "control_f32"):
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def control(run, out_dtype=None) -> None:
    """Replace every answer of the window by the plain reference's in
    bfloat16, keep masks included; with `out_dtype`, each rotation made
    orthonormal again in that type."""
    import numpy as np
    import torch

    from cardbench.reference import judge, oracle, prefilter

    nb = run.config["noise_bound"]
    keeps, answers = {}, {}
    for rec in run.records:
        if "answers" not in rec:
            continue
        out = []
        for key, answer in list(run.traffic.answers(rec)):
            pair = run.traffic.pair(key)
            keep = None
            if "keep" in answer:
                if key not in keeps:
                    keeps[key] = prefilter.keep_mask(pair.src, pair.dst, torch.bfloat16)
                keep = keeps[key]
            thr = judge.inlier_threshold(nb, np.ones(pair.src.shape[1]) if keep is None else keep)
            if (key, thr) not in answers:
                answers[(key, thr)] = oracle.oracle_answer(
                    pair, thr, torch.bfloat16, out_dtype, similarity="test_scale" in run.config)
            out.append((answers[(key, thr)], keep))
        rec["answers"] = tuple(np.stack([np.asarray(a[0][f]) for a in out])
                               for f in ("valid", "scale", "rotation", "translation", "count"))
        if "keep" in rec:
            rec["keep"] = [k for _, k in out]


def save_gaps(path: Path, run) -> None:
    """Each judged answer's readings and flags, with the answer itself and
    its pool key (size, index), in the order judged."""
    import numpy as np

    def column(key):
        return np.array([np.nan if r[key] is None else float(r[key]) for r in run.judged])
    keys, answers = [], []
    for rec in run.records:
        for key, answer in run.traffic.answers(rec):
            keys.append(key)
            answers.append(answer)
    fields = ("valid", "scale", "rotation", "translation", "count")
    np.savez_compressed(path, **{k: column(k) for k in (
        "rot_gap_deg", "trans_gap", "scale_err", "missed", "count_off", "filtered", "recall",
        "clean")}, key=np.array(keys).reshape(-1, 2),
        **{f"answer_{f}": np.array([np.asarray(a[f], np.float64) for a in answers])
           for f in fields})


def probe(workload: str, seeds: list[int], seconds: float, modes: list[str], device,
          root: Path = ROOT, out=None, gaps: Path | None = None) -> list[dict]:
    import torch

    from cardbench import harness

    cell = harness.Cell(root, workload)
    lines = []
    for mode in modes:
        for seed in seeds:
            patches = Patches()
            runs = []

            def after_window(run):
                runs.append(run)
                if mode == "control":
                    control(run)
                elif mode == "control_f32":
                    control(run, torch.float32)
            start_bytes = 0
            if device.type == "cuda" and torch.cuda.is_initialized():
                # each run's own peak, over what earlier runs left
                torch.cuda.reset_peak_memory_stats(device)
                start_bytes = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            try:
                result = harness.run_cell(
                    cell, seed, seconds, False, device, t0,
                    at_window=lambda: plant(mode, patches), after_window=after_window)
            finally:
                patches.undo()
            if gaps is not None:
                save_gaps(Path(gaps) / f"{workload}.{mode}.{seed}.npz", runs[0])
            line = {"workload": workload, "mode": mode, "seed": seed,
                    "correct": result["correct"], "attempted": result["attempted"],
                    "failed": result["failed"],
                    "checks": {k: v["value"] for k, v in result["checks"].items()},
                    "filtered_share": sum(bool(r["filtered"]) for r in runs[0].judged)
                    / max(len(runs[0].judged), 1),
                    "hits": sum(r["rot_gap_deg"] is not None for r in runs[0].judged),
                    "clean_hits": sum(r["rot_gap_deg"] is not None and r["clean"]
                                      for r in runs[0].judged),
                    "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                    "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                    "memory_start_bytes": start_bytes,
                    "plans": runs[0].plans, "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out is not None:
                out.write(json.dumps(line) + "\n")
                out.flush()
            lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="sound")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gaps", default=None, help="a directory for each run's pose gaps")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cardbench.run import HOST_THREADS, set_environment

    set_environment()
    import torch

    torch.set_num_threads(HOST_THREADS)

    if not torch.cuda.is_available():
        print("probe needs a CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    with (open(args.out, "a") if args.out else contextlib.nullcontext()) as out:
        probe(args.workload, seeds, args.seconds, args.modes.split(","),
              torch.device("cuda", 0), out=out, gaps=args.gaps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
