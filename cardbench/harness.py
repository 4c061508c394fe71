"""The benchmark's general part: it finds a cell's files by the names in
BENCHMARK.json, sets the cell up, drives its window, reads its metrics, judges
its answers and prints the result line.

What belongs to one configuration, traffic mix or metric lies in files of
its own, found by name under the checkout's `cardbench/`:

- `configs/<config>.json` (the file BENCHMARK.json names): the deployment;
- `workloads/<cell>.json`: the cell's traffic kind, its parameters and the
  limits of its correctness check (its configuration and traffic mix are
  named in BENCHMARK.json alone);
- `traffic/<kind>.py`: a `Traffic` class on `traffic_base.PairTraffic`
  (`setup`, `request`, `pairs_per_request`, `plans`; the base gives `pair`,
  `answers`, `collect`, `release`);
- `metrics/<metric>.py`: a `read(run)` that gives the metric's value, or
  None where it finds nothing to read.

Adding any of these needs no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from cardbench.reference import judge as ref_judge
from cardbench.reference.oracle import oracle_answer as ref_fit
from cardbench.reference.prefilter import keep_mask as ref_keep_mask

BENCH = "cardbench"
# Top-level modules that may not be loaded in a run: JAX and the JAX package
# (compared whole, since the port's name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "psulvsb_tpu")
SMI_PERIOD_MS = 100


class Cell:
    """One entry of BENCHMARK.json's `workloads` with its files."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        config = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((self.root / config["file"]).read_text())
        self.workload = json.loads(self.bench_file("workloads", f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def bench_file(self, *parts: str) -> Path:
        path = self.root.joinpath(BENCH, *parts)
        if not path.is_file():
            raise FileNotFoundError(f"{self.name}: {path} is missing")
        return path

    def traffic_class(self):
        return load_module(self.bench_file("traffic", f"{self.workload['kind']}.py")).Traffic

    def reader(self, metric: str):
        return load_module(self.bench_file("metrics", f"{metric}.py")).read


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"cardbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def solver_params(config: dict):
    """The configuration's SolverParams: its preset with its settings."""
    from psulvsb_tpu_torch.solver.config import SolverParams

    return getattr(SolverParams, f"preset_{config['preset']}")(**config["solver"])


class Run:
    """What a metric reader may read: the cell, the set-up, the window's
    records and what the device reported beside it."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool):
        self.cell = cell
        self.config = cell.config
        self.workload = cell.workload
        self.seed = int(seed)
        self.device = device
        self.trace = trace
        self.params = solver_params(cell.config)
        self.setup_s = 0.0
        self.window_s = 0.0
        self.records: list[dict] = []
        self.judged: list[dict] = []
        self.plans: list[dict] = []  # `plan_summary` of each plan the set-up built
        self.util: list[float] = []  # NVML utilization.gpu samples beside the window, %
        self.mem_peak = 0
        self.attempted = 0
        self.traffic = None
        self.cache: dict = {}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"


class _Sampler:
    """nvidia-smi's utilization.gpu every SMI_PERIOD_MS, beside the window."""

    def __init__(self, index: int):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--id={index}", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", f"-lms={SMI_PERIOD_MS}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> list[float]:
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        samples = []
        for line in out.splitlines():
            try:
                samples.append(float(line.strip()))
            except ValueError:
                pass
        return samples


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi gave nothing"


def drive_window(run: Run, seconds: float) -> None:
    """Requests one after another until `seconds` have passed; with the
    trace on, NVML samples beside."""
    sampler = _Sampler(run.device.index or 0) if run.trace and run.cuda else None
    try:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            try:
                rec = run.traffic.request(i)
            except Exception as exc:  # a request that raises is counted; the window goes on
                print(f"request {i} raised {type(exc).__name__}: {exc}", file=sys.stderr)
                rec = {"failed": run.traffic.pairs_per_request(i), "t_end": time.perf_counter()}
            run.records.append(rec)
            i += 1
        run.window_s = run.records[-1]["t_end"] - t0
    finally:
        if sampler is not None:
            run.util = sampler.stop()


def judge_window(run: Run) -> dict:
    """Each answer of the window judged by the plain reference; with keep
    masks, a sample of them drawn from the seed against the plain
    pre-filter. Returns the numbers compared, each with its limit.

    The pose gaps' medians are taken over the answers to pairs whose true
    inliers all lie within the threshold of the truth (`clean`), where the
    float64 fit's inliers are the pair's; a window with no such answer reads
    inf. At known scale every pair is clean: the noise, uniform in
    [-nb, nb]^3, stays within sqrt(3) nb of the truth, and the threshold is
    2 nb or more. At a test scale sigma (a configuration's `test_scale`) the
    stretched noise reaches sigma sqrt(3) nb, and where it crosses the
    threshold the solver's inliers, and its weights over them, differ from
    the fit's by the columns near it, so that a sound answer strays from the
    fit half as far as bfloat16 arithmetic moves it (PERF.md, section 4).
    There each pair is judged at its own scale against a similarity fit,
    and `scale_err` is the widest over the answers neither missed nor
    filtered (a miss's scale says nothing; the misses are `missed_share`'s).
    The counts of answers, hits and clean hits go to standard error."""
    import torch

    config, limits = run.config, run.workload["limits"]
    nb = config["noise_bound"]
    scaled = "test_scale" in config
    residuals: dict = {}  # the truth's, a pool pair
    fits: dict = {}  # the float64 fit over the truth's inliers, a pair and threshold
    keeps = []
    for rec in run.records:
        for pair_key, answer in run.traffic.answers(rec):
            pair = run.traffic.pair(pair_key)
            keep = answer.get("keep")
            thr = ref_judge.inlier_threshold(nb, np.ones(pair.src.shape[1]) if keep is None
                                             else keep)
            if pair_key not in residuals:
                residuals[pair_key] = ref_judge.residuals(pair.src, pair.dst, pair.scale,
                                                          pair.rotation, pair.translation)
            if (pair_key, thr) not in fits:
                fits[(pair_key, thr)] = ref_fit(pair, thr, torch.float64, similarity=scaled)
            explained = residuals[pair_key] <= thr
            kept = None if keep is None else int((explained & (np.asarray(keep) == 1)).sum())
            reading = ref_judge.judge(pair, answer, thr, int(explained.sum()),
                                      config["criteria"], fits[(pair_key, thr)], kept)
            reading["clean"] = bool(explained[~pair.outlier_mask].all())
            run.judged.append(reading)
            if keep is not None:
                keeps.append((pair, keep))
    j = run.judged
    hits = [r for r in j if r["rot_gap_deg"] is not None]
    clean = [r for r in hits if r["clean"]]
    values = {
        "orth_err": max((r["orth_err"] for r in j), default=float("inf")),
        "scale_err": max((r["scale_err"] for r in j), default=float("inf")),
        "count_off_share": _share([r["count_off"] for r in j if r["count_off"] is not None]),
        "missed_share": _share(judged) if (judged := [r["missed"] for r in j
                                                        if r["missed"] is not None]) else 1.0,
        "rot_gap_deg_p50": _median([r["rot_gap_deg"] for r in clean]),
        "trans_gap_p50": _median([r["trans_gap"] for r in clean]),
    }
    if scaled:
        values["scale_err"] = max((r["scale_err"] for r in hits), default=float("inf"))
    print(f"judged {len(j)} answers: {len(hits)} hits, {len(clean)} of them clean",
          file=sys.stderr)
    if keeps:
        rng = np.random.default_rng([run.seed % (1 << 64), 1 << 33])
        n = min(int(run.workload["params"]["keep_sample"]), len(keeps))
        values["keep_off_share"] = _share([
            ref_judge.keep_off(keep, ref_keep_mask(pair.src, pair.dst, torch.float64))
            for pair, keep in (keeps[k] for k in rng.choice(len(keeps), size=n, replace=False))])
    missing = set(values) ^ set(limits)
    if missing:
        raise KeyError(f"{run.cell.name}: limits and checks differ in {sorted(missing)}")
    return {name: {"value": v, "limit": limits[name]} for name, v in values.items()}


def _share(flags: list) -> float:
    return sum(flags) / len(flags) if flags else 0.0


def _median(values: list) -> float:
    return float(np.median(values)) if values else float("inf")


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def plan_summary(plan) -> dict:
    return {"c": plan.c, "pairs": plan.pairs, "build_s": plan.build_s,
            "capture_s": plan.capture_s, "nbytes": plan.nbytes}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, at_window=None, after_window=None) -> dict:
    """One run of `cell`: set-up (timed from `t_start`), the window, the
    program's state freed, the check, the metrics. `at_window()` runs just
    before the window, `after_window(run)` once the window's outputs are on
    the host (tests and probes plant faults or controls there). Returns the
    result line as a dict."""
    import torch

    run = Run(cell, seed, device, trace)
    run.traffic = cell.traffic_class()(run)
    run.traffic.setup()
    run.plans = [plan_summary(p) for p in run.traffic.plans()]
    if run.cuda:
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start
    for p in run.plans:
        print(f"plan C={p['c']} pairs={p['pairs']}: build {p['build_s']:.3f} s, capture "
              f"{p['capture_s']:.3f} s, {p['nbytes'] / 2**30:.3f} GiB", file=sys.stderr)
    if at_window is not None:
        at_window()
    drive_window(run, seconds)
    if run.cuda:
        torch.cuda.synchronize(device)
        run.mem_peak = int(torch.cuda.max_memory_allocated(device))
    run.traffic.collect()  # the window's device outputs to the host
    if after_window is not None:
        after_window(run)
    run.traffic.release()
    failed = sum(rec.get("failed", 0) for rec in run.records)
    run.attempted = failed + sum(len(rec.get("idx", ())) for rec in run.records)
    checks = judge_window(run)
    correct = failed == 0 and run.attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if run.cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if run.cuda else device.type,
           "count": cell.chips if run.cuda else 1,
           "memory_peak_bytes": run.mem_peak}
    if trace:
        # The share of the window in which a kernel ran, by NVML: torch.profiler
        # cannot read the plans' conditional graphs (PERF.md). No samples, no time.
        dev["busy_s"] = statistics.fmean(run.util) / 100.0 * run.window_s if run.util else 0.0
        dev["window_s"] = run.window_s
    return {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(failed),
            "metrics": metrics, "device": dev, "checks": checks}


def emit(result: dict) -> int:
    """Print the checks (last on standard error) and the result line (last
    on standard output); a run that loaded JAX prints no result."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    found = forbidden_loaded()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
