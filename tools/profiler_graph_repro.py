"""torch.profiler sessions over CUDA graphs with conditional nodes, by when
the graph was instantiated: before the process's first profiler session, or
after it. Each case runs in a process of its own.

    python tools/profiler_graph_repro.py [--sessions N] [case ...]

CUPTI, which torch.profiler drives, is set up at a process's first session.
A graph instantiated after that carries CUPTI's records for the kernels
inside its conditional nodes' bodies (its replays then run slower, profiled
or not); one instantiated before is recorded at its top level only. The
cases:

- "toy_before", "toy_after": a graph of one WHILE node
  (`solver/conditional.GraphControl`) whose body runs three elementwise
  kernels TOY_ITERATIONS times, instantiated before the first session or
  after a first session over one elementwise kernel;
- "nested_after", "nested_big_after": an outer WHILE around an inner one
  (NESTED and NESTED_BIG iterations), instantiated after a first session;
- "fgr_before", "fgr_after": chip_smoke's phase-14 FGR batch (B = 8, the
  anchor protocol) in order through one single-pair plan, instantiated before
  or after a first session;
- "eigh_after": the same batch with gnc_rot_method="eigh", after;
- "fgr_eager", "fgr_batched_eager", "eigh_eager", "eigh_batched_eager": the
  FGR and "eigh" batches in order and batched through the same plans run
  eagerly (graphs=False), after a first session: no graph, each kernel
  launched from the host.

A child replays its graph (or calls register_batch) REPLAYS times with no
profiler and checks every result against the first bit for bit, then runs N
profiler sessions over one call each. It prints a JSON line a session (the
device records, the result equal to the first) and the wall of one call
(median of 3, one for the eager cases; CUDA events) before the first
session and after the last. The
parent prints one JSON line a child: its exit code, the sessions it
completed, and the first error line it wrote. The card's name and power
limit head the output.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TOY_ITERATIONS = 64
NESTED = (128, 128)
NESTED_BIG = (256, 256)
REPLAYS = 5
CHILD_TIMEOUT_S = 300
CASES = ("toy_before", "toy_after", "nested_after", "nested_big_after", "fgr_before",
         "fgr_after", "eigh_after", "fgr_eager", "fgr_batched_eager", "eigh_eager",
         "eigh_batched_eager")
# Sessions of the cases that take other than --sessions: the nested graph's
# records thin out over sessions; an eager FGR call takes seconds.
SESSIONS = {"nested_after": 12, "fgr_eager": 2, "fgr_batched_eager": 2, "eigh_eager": 2,
            "eigh_batched_eager": 2}


def toy_call(device, outer: int, inner: int | None):
    """One replay of a graph of WHILE nodes: `outer` iterations, each of an
    inner WHILE of `inner` (None: three kernels in the outer body)."""
    from psulvsb_tpu_torch.solver.conditional import GraphControl

    x = torch.zeros(1 << 16, device=device)
    i = torch.zeros((), dtype=torch.int64, device=device)
    j = torch.zeros((), dtype=torch.int64, device=device)
    control = GraphControl(device, torch.zeros(0, dtype=torch.int64, device=device))
    control.warm(2, lambda: None)

    def kernels():
        x.add_(1.0)
        x.mul_(0.5)

    def inner_body():
        kernels()
        j.add_(1)
        return j < inner

    def outer_body():
        if inner is None:
            kernels()
        else:
            j.zero_()
            control.repeat(j < inner, inner_body)
        i.add_(1)
        return i < outer

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=control.capture_stream):
        i.zero_()
        x.zero_()
        control.repeat(i < outer, outer_body)
    control.close()

    def call():
        graph.replay()
        return torch.stack([i.to(torch.float32), x.sum()])

    return call, (graph, control)


def batch_call(device, name: str, vectorized: bool = False, graphs: bool = True):
    """One register_batch call of chip_smoke's FGR batch, or of the same
    pairs with the "eigh" GNC."""
    from psulvsb_tpu_torch import register_batch

    src_np, dst_np, keep_np, _, params = cs.batch_cases(name, 8)
    src, dst, keep = (torch.as_tensor(a, device=device) for a in (src_np, dst_np, keep_np))
    seeds = [300 + i for i in range(8)]

    def call():
        sol = register_batch(src, dst, keep, seeds, params, vectorized=vectorized,
                             graphs=graphs)
        return torch.cat([sol.rotation.flatten(), sol.translation.flatten()])

    return call, None


def call_ms(call, reps: int) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def child(case: str, sessions: int) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from psulvsb_tpu_torch.utils.precision import pin_float32

    pin_float32()
    device = torch.device("cuda", 0)
    if not case.endswith("_before"):  # CUPTI set up before the graph exists
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(8, device=device).add_(1.0)
            torch.cuda.synchronize()
    name = case.split("_", 1)[0]
    eager = case.endswith("_eager")
    if name == "toy":
        call, _held = toy_call(device, TOY_ITERATIONS, None)
    elif name == "nested":
        call, _held = toy_call(device, *(NESTED_BIG if "_big" in case else NESTED))
    else:
        call, _held = batch_call(device, name, "_batched" in case, graphs=not eager)
    first = call()
    for _ in range(1 if eager else REPLAYS):
        if not torch.equal(call(), first):
            raise AssertionError(f"{case}: a replay with no profiler differs from the first")
    torch.cuda.synchronize()
    print(json.dumps({"case": case, "ms_before": call_ms(call, 1 if eager else 3)}), flush=True)
    for s in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = call()
            torch.cuda.synchronize()
        records = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        print(json.dumps({"case": case, "session": s, "records": records,
                          "equal": bool(torch.equal(got, first))}), flush=True)
    print(json.dumps({"case": case, "ms_after": call_ms(call, 1 if eager else 3)}), flush=True)
    return 0


def run_child(case: str, sessions: int) -> dict:
    try:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", case, "--sessions", str(sessions)],
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = "timeout"
        stdout, stderr = (b.decode() if isinstance(b, bytes) else (b or "")
                          for b in (e.stdout, e.stderr))
    lines = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    done = [ln for ln in lines if "session" in ln]
    errors = [ln for ln in stderr.splitlines() if "rror" in ln]
    return {
        "case": case, "rc": rc, "sessions_done": len(done), "of": sessions,
        "records": [d["records"] for d in done],
        "every_result_equal": all(d["equal"] for d in done),
        "ms_before": next((ln["ms_before"] for ln in lines if "ms_before" in ln), None),
        "ms_after": next((ln["ms_after"] for ln in lines if "ms_after" in ln), None),
        "error": errors[0] if errors else None,
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profiler_graph_repro: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sessions = 6
    if "--sessions" in argv:
        k = argv.index("--sessions")
        sessions = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    if argv[:1] == ["--child"]:
        return child(argv[1], sessions)
    print(cs.card_line(), flush=True)
    cs.build_all()
    for case in argv or CASES:
        print(json.dumps(run_child(case, SESSIONS.get(case, sessions))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
