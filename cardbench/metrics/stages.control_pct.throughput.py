"""stages.control_pct.throughput: `solve.control` as a share of `solve`: the
device time of a solve outside its stage spans (the conditional nodes, the
stamps and launch marks, the gaps between the chain's kernels)
(`cardbench/tracing.py`)."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    return None if reading is None else tracing.control_pct(reading["snap"])
