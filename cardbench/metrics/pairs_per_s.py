"""pairs_per_s: the pairs whose poses reached host memory, over the whole
window (from its start to the end of its last request)."""


def read(run):
    done = sum(len(r["idx"]) for r in run.records if "answers" in r)
    return done / run.window_s if run.window_s > 0 else None
