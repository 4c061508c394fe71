"""recall_pct: the share of the window's pairs whose pose meets the
configuration's criteria against the generator's truth (single solves),
judged by the benchmark's own numpy (reference/judge.py); a failed request
counts as a miss."""


def read(run):
    if not run.attempted:
        return None
    return 100.0 * sum(j["recall"] for j in run.judged) / run.attempted
