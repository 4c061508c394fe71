"""counts.py gives the bounds chip_smoke.py gave (PERF.md, kernel table)."""

import numpy as np
import pytest

from cardbench import counts


@pytest.mark.parametrize("name,c,n_active,out_bytes,expected", [
    ("pair_ratio_hist", 5000, 4009, counts.PEAK_BINS * 8 + 17, 0.002758),  # exact_peak_bin
    ("pair_beta_count", 12000, 9583, 8, 0.014390),
    ("consistency_degree", 1889, 1488, 1889 * 4, 0.000380),
])
def test_pair_grid_bounds(name, c, n_active, out_bytes, expected):
    ms, by = counts.pair_grid_bound(name, c, n_active, out_bytes)
    assert by == "operations"
    assert round(ms, 6) == expected


def test_gnc_bound_at_the_anchor_shape():
    ms, by = counts.bound_ms(counts.gnc_bytes(4, 256, 1), 0.0)
    assert by == "bytes"
    assert f"{ms:.7f}" == "0.0000080"


def test_gnc_iterations_follow_the_loop():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(3, 3, 64))
    dst = src.copy()
    dst[:, :, :20] += rng.normal(size=(3, 3, 20)) * 2.0
    act = np.ones((3, 64), bool)
    iters = counts.gnc_iterations(src, dst, act, 0.1, 100, 1.4, 0.005)
    assert iters.shape == (3,) and np.all(iters >= 2) and np.all(iters <= 100)
    # Every column exact: the residuals are zero, and the first step is degenerate.
    assert counts.gnc_iterations(src, src, act, 0.1, 100, 1.4, 0.005).tolist() == [1, 1, 1]
    assert counts.gnc_ops(iters, act) == float(
        (iters * (64 * counts.GNC_OPS_PER_COLUMN + counts.GNC_OPS_PER_ITERATION)).sum())
