"""device.gap_pct.throughput: the card's gaps between one call's last device
stamp and the next call's first, as a share of the traced window on the card's
clock (`cardbench/tracing.py`)."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    return None if reading is None else tracing.gap_pct(reading["snap"])
