"""latency_ms_p50: one request, from the call to its pose in host memory;
the median over every request of the window."""

import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run.records if "answers" in r]
    return 1e3 * float(np.percentile(lat, 50)) if lat else None
