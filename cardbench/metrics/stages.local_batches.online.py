"""stages.local_batches.online: the local batches a solve ran, from the
plan's own counter (`plan_for(...).stats["local_batches"]`, read after each
request of the traced window), as a mean per request."""


def read(run):
    counts = [r["local_batches"] for r in run.records if "local_batches" in r]
    return sum(counts) / len(counts) if counts else None
