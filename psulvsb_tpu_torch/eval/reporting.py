"""CSV / JSONL experiment reporters (a copy of psulvsb_tpu/eval/reporting.py).

Equivalent of the reference programs' ad-hoc ofstream CSVs (PSULVSB.cc:395-514 per-cloud
CSVs + Average.csv; teaser_cpp_ply_main.cc:469-515 per-scene CSVs +
summary.txt).
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import Iterable


def write_csv(path: str, header: Iterable[str], rows: Iterable[Iterable]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(header))
        for r in rows:
            w.writerow(list(r))


def append_jsonl(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def mean_std(values: list[float]) -> tuple[float, float]:
    """Mean and population sigma as the reference computes them
    (PSULVSB.cc:444-471: sum / n and sqrt(E[x^2] - E[x]^2))."""
    n = max(len(values), 1)
    mean = sum(values) / n
    var = sum(v * v for v in values) / n - mean * mean
    return mean, math.sqrt(max(var, 0.0))
