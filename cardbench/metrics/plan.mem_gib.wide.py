"""plan.mem_gib.wide: the device bytes of the plans the cell's set-up built,
by the program's own count (`ReplayPlan.nbytes`: buffers and the reserved
graph pool), in GiB, for the cells whose plans are the widest: at the
8192 bucket the plan's bytes cap P, the pairs of one launch; at 10240 and
14336 columns they decide whether both single-pair plans stay resident."""


def read(run):
    return sum(p["nbytes"] for p in run.plans) / 2**30 if run.plans else None
