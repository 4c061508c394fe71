"""pipeline.prefilter_ms.online: device ms of the pre-filter (normals and
histogram: the device span between the pipeline's eager stamps), mean a
request, over the traced window (`cardbench/tracing.py`)."""

from cardbench import tracing


def read(run):
    reading = tracing.traced_window(run)
    return None if reading is None else tracing.prefilter_ms(reading["snap"])
