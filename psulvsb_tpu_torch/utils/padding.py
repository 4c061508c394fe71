"""Static-shape padding helpers (counterpart of psulvsb_tpu/utils/padding.py).

A replay plan of the one-dispatch solve (solver/fused.py) is built for one
correspondence count C. Callers pad to size buckets, so a dataset sweep with
varying C reuses a handful of plans instead of building one per pair.
"""

from __future__ import annotations

import numpy as np

# One bucket table for the whole package (eval/pipeline.py shares it).
DEFAULT_PAD_BUCKETS: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 6144, 8192)


def pad_to_bucket(n: int, buckets: tuple[int, ...] = DEFAULT_PAD_BUCKETS) -> int:
    """Smallest bucket >= n. Inputs beyond the largest bucket get their own
    1024-aligned size (a plan of their own: truncating to the last bucket
    would cut correspondences off)."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def pad_columns(arr: np.ndarray, target: int, fill: float = 0.0) -> np.ndarray:
    """Pad a (3, N) array to (3, target) with `fill` columns; target must be
    >= N (shrinking would drop correspondences)."""
    n = arr.shape[1]
    if target < n:
        raise ValueError(
            f"pad_columns: target {target} < array width {n} "
            "(refusing to truncate correspondences)"
        )
    if n == target:
        return arr
    out = np.full((arr.shape[0], target), fill, dtype=arr.dtype)
    out[:, :n] = arr
    return out
