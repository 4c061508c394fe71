"""gnc_batch.roofline_pct.throughput: `ops.gnc.gnc_batch` alone at the
launch shape of the cell's plan (hypothesis_batch x basic_cap, times P pairs
in a batched plan), timed with CUDA events over a graph of launches, against
the bound of counts.py."""

from cardbench.roofline import gnc_roofline_pct


def read(run):
    return gnc_roofline_pct(run)
