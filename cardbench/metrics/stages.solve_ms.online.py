"""stages.solve_ms.online: device ms of the fused plan's `solve` spans (the
card's clock, stamped inside the graph) over the traced window, divided by the
pairs they solved (one a request) (`cardbench/tracing.py`)."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    return None if reading is None else tracing.solve_ms_per_pair(reading["snap"])
