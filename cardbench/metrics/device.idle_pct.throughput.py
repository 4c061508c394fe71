"""device.idle_pct.throughput: 100 less the mean of NVML's utilization.gpu
(the share of time a kernel ran), sampled by nvidia-smi beside the traced
window of a throughput cell."""

from cardbench.roofline import idle_pct


def read(run):
    return idle_pct(run)
