"""plan.mem_gib.vectorized: the device bytes of the plans the cell's set-up
built, by the program's own count (`ReplayPlan.nbytes`: buffers and the
reserved graph pool), in GiB: the plan's bytes cap P, the pairs of one
launch, and P sets the rate."""


def read(run):
    return sum(p["nbytes"] for p in run.plans) / 2**30 if run.plans else None
