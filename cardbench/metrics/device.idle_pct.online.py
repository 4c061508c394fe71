"""device.idle_pct.online: 100 less the mean of NVML's utilization.gpu,
sampled by nvidia-smi beside the traced window of the online cell."""

from cardbench.roofline import idle_pct


def read(run):
    return idle_pct(run)
