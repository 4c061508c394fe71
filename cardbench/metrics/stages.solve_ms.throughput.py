"""stages.solve_ms.throughput: device ms of the fused plan's `solve` spans (the
card's clock, stamped inside the graph) over the traced window, divided by the
pairs they solved (`cardbench/tracing.py`)."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    return None if reading is None else tracing.solve_ms_per_pair(reading["snap"])
