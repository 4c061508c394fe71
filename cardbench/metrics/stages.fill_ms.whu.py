"""stages.fill_ms.whu: device ms of the fused plans' `solve.init.fill` spans
(the known-scale init's rejection fill past the dense kernel: the window
test of init_reject_budget drawn pairs and their compaction into the pool;
the card's clock, stamped inside the graph) over the traced window, divided
by the pairs solved (`cardbench/tracing.py`). None where the program stamps
no such span."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    if reading is None:
        return None
    snap = reading["snap"]
    fill, pairs = snap["device"].get("solve.init.fill"), snap["counters"]["pairs"]
    return fill["ns"] / 1e6 / pairs if fill and pairs else None
