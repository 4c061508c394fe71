"""stages.local_batches.throughput: local batches a pair, from the traced plans'
cumulative device counter (added by each solve's closing stamp from its own
counts), over the traced window (`cardbench/tracing.py`)."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    return None if reading is None else tracing.local_batches_per_pair(reading["snap"])
