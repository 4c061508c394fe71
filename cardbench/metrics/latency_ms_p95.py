"""latency_ms_p95: the 95th percentile of the request latencies of the
window (from the call to the pose in host memory), over every request."""

import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run.records if "answers" in r]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
