"""gnc_batch.roofline_pct.online: as the throughput cells' reading, at the
online cell's single-pair launch shape."""

from cardbench.roofline import gnc_roofline_pct


def read(run):
    return gnc_roofline_pct(run)
