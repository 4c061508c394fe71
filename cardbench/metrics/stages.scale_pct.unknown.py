"""stages.scale_pct.unknown: device time of the fused plans'
`solve.local.scale` spans (the 1-point scale estimate of every local
batch) as a share of their `solve.local` spans (the local batches), over
the traced window (`cardbench/tracing.py`). None where the program stamps
no such span."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    if reading is None:
        return None
    ops = reading["snap"]["device"]
    scale, local = ops.get("solve.local.scale"), ops.get("solve.local")
    return 100.0 * scale["ns"] / local["ns"] if scale and local and local["ns"] else None
