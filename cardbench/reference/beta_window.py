"""The plain known-scale TIM window test of the init past the dense kernel
(the "exact_beta" route), in numpy: a pair of correspondences i < j is a
member of the reduced set when

    | |s_j - s_i| - |d_j - d_i| | <= beta = 2 noise_bound sqrt(cbar2)

(registration.cc:744-767), over the pairs whose columns are both active.

- `count`: how many active pairs i < j pass, swept over blocks of rows;
- `member`: whether each given pair passes;
- both in float64 on the given clouds (the test's exact answer), or in the
  arithmetic the solver states for the test ("float32": each distance the
  IEEE root of (dx dx + dy dy) + dz dz of float32 differences, rounded at
  every step, one rounded difference of the two, beta rounded to float32),
  which a program's count has to equal to the pair;
- `slack`: a band around beta, 16 float32 ulps of the clouds' largest
  distance, past which float32 arithmetic decides as float64 does; the two
  counts differ only by the pairs inside it (`count(..., widen=±slack)`
  bound the float32 count).

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

ROW_BLOCK = 512  # rows of the pair grid swept at once
DTYPES = {"float64": np.float64, "float32": np.float32}


def beta(noise_bound: float, cbar2: float) -> float:
    return 2.0 * noise_bound * float(np.sqrt(cbar2))


def _length(e: np.ndarray) -> np.ndarray:
    """|e| over the first axis, each operation rounded in e's dtype (numpy
    does not contract)."""
    return np.sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])


def _limit(noise_bound: float, cbar2: float, arithmetic: str, widen: float):
    return DTYPES[arithmetic](beta(noise_bound, cbar2) + widen)


def count(src, dst, active, noise_bound: float, cbar2: float = 1.0,
          arithmetic: str = "float64", widen: float = 0.0) -> int:
    """The active pairs i < j that pass the window (beta + `widen`)."""
    dtype = DTYPES[arithmetic]
    s, d = np.asarray(src, dtype), np.asarray(dst, dtype)
    act = np.asarray(active, bool)
    limit = _limit(noise_bound, cbar2, arithmetic, widen)
    c = s.shape[1]
    total = 0
    for r0 in range(0, c, ROW_BLOCK):
        rows = np.arange(r0, min(r0 + ROW_BLOCK, c))
        cols = np.arange(r0, c)
        v1 = _length(s[:, None, cols] - s[:, rows, None])  # (rows, cols): |s_j - s_i|
        v2 = _length(d[:, None, cols] - d[:, rows, None])
        valid = (rows[:, None] < cols[None, :]) & act[rows, None] & act[None, cols]
        total += int(((np.abs(v1 - v2) <= limit) & valid).sum())
    return total


def member(src, dst, i, j, noise_bound: float, cbar2: float = 1.0,
           arithmetic: str = "float64", widen: float = 0.0) -> np.ndarray:
    """Whether each pair (i, j) passes the window (beta + `widen`)."""
    dtype = DTYPES[arithmetic]
    s, d = np.asarray(src, dtype), np.asarray(dst, dtype)
    i, j = np.asarray(i), np.asarray(j)
    gap = np.abs(_length(s[:, j] - s[:, i]) - _length(d[:, j] - d[:, i]))
    return gap <= _limit(noise_bound, cbar2, arithmetic, widen)


def slack(src, dst) -> float:
    """16 float32 ulps (2^-19 relative) of the largest distance within
    either cloud, bounded by twice its largest point norm."""
    extent = max(float(np.linalg.norm(np.asarray(p, np.float64), axis=0).max())
                 for p in (src, dst))
    return 2.0 * extent * 2.0 ** -19
