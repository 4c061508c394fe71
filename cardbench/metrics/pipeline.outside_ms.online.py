"""pipeline.outside_ms.online: a request's latency less the port's own
`PipelineResult.elapsed_s` (pre-filter and solve to a sync), as a mean per
request: the numpy conversion, padding and staging before, the pose's
readback after."""


def read(run):
    gaps = [r["latency_s"] - r["elapsed_s"] for r in run.records if "elapsed_s" in r]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
