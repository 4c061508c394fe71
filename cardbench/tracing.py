"""The program's own tracing, read for the per-layer metrics of the stages,
the pipeline entry and the device (`psulvsb_tpu_torch.utils.timing`).

The harness reads a cell's per-layer metrics after its window, once the
program's plans are freed, and runs the window with the program's tracing
off. So the first reader that needs the trace runs a traced window of its
own, on the cell's traffic, right after the cell's window: tracing on, one
request of each size to build the traced plans, `timing.start()`, requests
for `min(TRACE_WINDOW_S, the cell's window)` seconds, `timing.snapshot()`,
the plans freed and tracing off again. The readers share what it read
(`run.cache`), and the window's device breakdown goes to standard error.
A program without the tracing gives None to every reader."""

from __future__ import annotations

import sys
import time
import traceback

TRACE_WINDOW_S = 8.0
KEY = "program_trace"


def _timing():
    try:
        from psulvsb_tpu_torch.utils import timing
    except ImportError:
        return None
    needed = ("enable", "start", "snapshot", "breakdown", "SOLVE_SPANS")
    return timing if all(hasattr(timing, n) for n in needed) else None


def _sync(run) -> None:
    if run.cuda:
        import torch

        torch.cuda.synchronize(run.device)


def traced_window(run):
    """The traced window's reading, {"snap", "records", "seconds"}, run once
    for the run; None where the program has no tracing or the window
    failed (the failure goes to standard error)."""
    if KEY in run.cache:
        return run.cache[KEY]
    run.cache[KEY] = None
    timing = _timing()
    if timing is None or run.traffic is None:
        return None
    traffic = run.traffic
    seconds = min(TRACE_WINDOW_S, run.window_s) if run.window_s > 0 else TRACE_WINDOW_S
    i = len(run.records)
    records = []
    timing.enable(True)
    try:
        for _ in traffic.sizes:  # each size's traced plans are built here
            traffic.request(i)
            i += 1
        _sync(run)
        timing.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            records.append(traffic.request(i))
            i += 1
        _sync(run)
        window_s = time.perf_counter() - t0
        snap = timing.snapshot()
    except Exception:  # the run goes on without the trace's metrics
        print(f"the traced window failed:\n{traceback.format_exc()}", file=sys.stderr)
        return None
    finally:
        timing.enable(False)
        traffic.release()
    run.cache[KEY] = {"snap": snap, "records": records, "seconds": window_s}
    report(run.cache[KEY], timing.breakdown(snap))
    return run.cache[KEY]


def solve_ms_per_pair(snap):
    solve, pairs = snap["device"].get("solve"), snap["counters"]["pairs"]
    return solve["ns"] / 1e6 / pairs if solve and pairs else None


def prefilter_ms(snap):
    pre = snap["device"].get("pipeline.prefilter")
    return pre["ns"] / 1e6 / pre["count"] if pre and pre["count"] else None


def control_pct(snap):
    solve, control = snap["device"].get("solve"), snap["device"].get("solve.control")
    return 100.0 * control["ns"] / solve["ns"] if solve and control and solve["ns"] else None


def local_batches_per_pair(snap):
    pairs = snap["counters"]["pairs"]
    return snap["counters"]["local_batches"] / pairs if pairs else None


def window_ns(snap) -> int:
    lo, hi = snap["window_ns"]
    return hi - lo


def gap_pct(snap):
    span = window_ns(snap)
    if span <= 0 or not snap["calls"]:
        return None
    return 100.0 * sum(g["end_ns"] - g["start_ns"] for g in snap["gaps"]) / span


def agreement(reading) -> dict:
    """How the readings agree: the pre-filter and the solve against the
    pipeline's own `elapsed_s` (a request's mean), and the solves plus the
    gaps against the window; whether solves overlap and whether a gap
    overlaps a solve."""
    snap = reading["snap"]
    solves = sorted((s, e) for s, e, *_ in snap["solves"])
    total = sum(e - s for s, e in solves)
    gaps = sum(g["end_ns"] - g["start_ns"] for g in snap["gaps"])
    out = {"solves_plus_gaps_pct": 100.0 * (total + gaps) / window_ns(snap)
           if window_ns(snap) > 0 else None,
           "solves_overlap": any(b[0] < a[1] for a, b in zip(solves, solves[1:])),
           "gap_in_solve": False}
    for g in snap["gaps"]:
        if any(s < g["end_ns"] and g["start_ns"] < e for s, e in solves):
            out["gap_in_solve"] = True
            break
    elapsed = [r["elapsed_s"] for r in reading["records"] if "elapsed_s" in r]
    pre, solve = prefilter_ms(snap), solve_ms_per_pair(snap)
    if elapsed and pre is not None and solve is not None:
        out["prefilter_plus_solve_pct_of_elapsed"] = \
            100.0 * (pre + solve) / (1e3 * sum(elapsed) / len(elapsed))
    return out


def report(reading, breakdown) -> None:
    snap = reading["snap"]
    print(f"traced window: {reading['seconds']:.3f} s, {len(reading['records'])} requests, "
          f"{snap['counters']}", file=sys.stderr)
    for op in breakdown["ops"]:
        print(f"  device {op['name']}: {op['ms']:.3f} ms over {op['count']}", file=sys.stderr)
    for g in breakdown["gaps"]:
        print(f"  gap under {g['name']}: {g['ms']:.3f} ms over {g['count']}, longest "
              f"{g['longest_ms']:.3f} ms", file=sys.stderr)
    cal = snap["calibration"]
    print(f"  clock: residual {cal['residual_ns']:.0f} ns, half-width {cal['halfwidth_ns']:.0f} "
          f"ns, drift {cal['drift_ppm']:.3f} ppm; agreement {agreement(reading)}",
          file=sys.stderr)
