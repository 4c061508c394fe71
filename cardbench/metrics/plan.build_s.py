"""plan.build_s: the seconds of the first solve of each plan the cell's
set-up built (its plain run, capture and instantiation; the plan's own
`build_s`), summed."""


def read(run):
    return sum(p["build_s"] for p in run.plans) if run.plans else None
