"""stages.peak_ms.unknown: device ms of the fused plans' `solve.init.peak`
spans (the init's scale peak: the histogram kernel's `exact_peak_bin`, its
certificate, the subsample peak and the choice between them; the card's
clock, stamped inside the graph) over the traced window, divided by the
pairs solved (`cardbench/tracing.py`). None where the program stamps no
such span."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    if reading is None:
        return None
    snap = reading["snap"]
    peak, pairs = snap["device"].get("solve.init.peak"), snap["counters"]["pairs"]
    return peak["ns"] / 1e6 / pairs if peak and pairs else None
