"""Line-vector (translation-invariant measurement, TIM) set machinery.

The reference builds the full upper-triangular pair set (registration.cc:
693-732) with a scale-ratio histogram (MaxScale = 10000, 20 bins per unit,
bin width 0.05) whose peak bin ±1 forms the initial reduced set
(registration.cc:744-752). Pair indices are numpy constants per size, TIMs
one gather and subtract, the peak an integer scatter-add histogram, and
the compaction of a masked pair list one stable sort over random keys.

Every function that draws random numbers takes its draws as an optional
input (`keys`), so a test can feed the JAX package's draws.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_KEY_SPAN = 1 << 30  # random sort keys lie in [0, 2^30); non-members sort last


@functools.lru_cache(maxsize=32)
def triu_pair_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(i, j) index arrays of all i < j pairs in the reference's
    segment-major order (registration.cc:479-505). Length n(n-1)/2."""
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int64), iu[1].astype(np.int64)


def compute_tims(
    v: torch.Tensor, active: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-pairs TIMs of a (3, N) point matrix: (tims (3, L), idx_i (L,),
    idx_j (L,), pair_active (L,)) with tim_l = v[:, j_l] - v[:, i_l]
    (registration.cc:470-509, 697-711)."""
    # Row-major i < j, the order of `triu_pair_indices`, made on the device.
    ii, jj = torch.triu_indices(v.shape[1], v.shape[1], 1, device=v.device)
    tims = v[:, jj] - v[:, ii]
    if active is None:
        pair_active = torch.ones(ii.shape[0], dtype=torch.bool, device=v.device)
    else:
        pair_active = active[ii] & active[jj]
    return tims, ii, jj, pair_active


def gather_tims(v: torch.Tensor, idx_i: torch.Tensor, idx_j: torch.Tensor) -> torch.Tensor:
    """TIMs for explicit pair lists: v[:, j] - v[:, i]."""
    return v[:, idx_j] - v[:, idx_i]


def ratio_bin_indices(
    ratios: torch.Tensor,
    max_scale: float = 10000.0,
    bins_per_unit: int = 20,
    num_bins: int | None = None,
) -> tuple[torch.Tensor, int]:
    """Bin index per ratio under the reference's histogram geometry
    (registration.cc:687-729): floor(ratio / max_scale * num_bins) clipped
    to [0, num_bins), and bin 0 for a non-finite ratio. Returns (idx (L,)
    int64, num_bins)."""
    if num_bins is None:
        num_bins = int(max_scale) * bins_per_unit
    f = torch.floor(ratios / max_scale * num_bins)
    # Clip in float before the integer cast (out-of-range casts are
    # undefined); the JAX cast saturates, which clips to the same bins.
    f = torch.clamp(f, -1.0, float(num_bins))
    f = torch.where(torch.isfinite(ratios), f, torch.zeros_like(f))
    return torch.clamp(f.to(torch.int64), 0, num_bins - 1), num_bins


def scale_ratio_histogram(
    ratios: torch.Tensor,
    pair_active: torch.Tensor,
    max_scale: float = 10000.0,
    bins_per_unit: int = 20,
    num_bins: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram of |dst_tim| / |src_tim| over the active pairs, out-of-range
    ratios clamped into the edge bins (registration.cc:687-729). Returns
    (counts (num_bins,) int64, bin index per ratio (L,))."""
    idx, num_bins = ratio_bin_indices(ratios, max_scale, bins_per_unit, num_bins)
    counts = torch.zeros(num_bins, dtype=torch.int64, device=ratios.device)
    counts = counts.index_add(0, idx, pair_active.to(torch.int64))
    return counts, idx


def sort_peak_bin(
    bin_idx: torch.Tensor, active: torch.Tensor, num_bins: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The most frequent bin among the active entries and its count; the
    lowest such bin wins a tie, and with no active entry the peak is bin 0
    with count 0. The JAX package sorts the indices and takes the longest
    run because TPU scatters serialize; here an integer scatter-add
    histogram and its first argmax give the same (peak, count) without the
    sort and the scan. Returns (peak, count)."""
    counts = torch.zeros(num_bins, dtype=torch.int64, device=bin_idx.device)
    counts = counts.index_add(0, bin_idx.to(torch.int64), active.to(torch.int64))
    return torch.argmax(counts), counts.max()


def random_sort_keys(
    n: int, generator: torch.Generator | None, device
) -> torch.Tensor:
    """n uniform sort keys in [0, 2^30), the draw masked_random_compact
    consumes (JAX: jax.random.randint(key, (n,), 0, 1 << 30))."""
    return torch.randint(0, _KEY_SPAN, (n,), generator=generator, device=device)


def masked_random_compact(
    mask: torch.Tensor,
    idx_i: torch.Tensor,
    idx_j: torch.Tensor,
    cap: int,
    max_index: int = 1 << 30,
    keys: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact a uniformly random subset of the masked pairs into (cap,)
    arrays by one stable sort over random keys (the keys double as the
    uniform decimation when more than `cap` pairs are masked). `keys`:
    optional (L,) integers in [0, 2^30); equal keys give the same order as
    the JAX package's stable lax.sort.

    max_index: exclusive bound on the index values. Up to 2^15, (i, j)
    travel packed in one integer (i * 65536 + j) through one gather;
    beyond, as two gathers. Returns (red_i, red_j, min(#mask, cap))."""
    if keys is None:
        keys = random_sort_keys(mask.shape[0], generator, mask.device)
    keys = keys.to(mask.device)
    keys = torch.where(mask, keys, torch.full_like(keys, _KEY_SPAN))
    order = torch.sort(keys, stable=True).indices[:cap]
    total = torch.clamp(mask.sum(), max=cap)
    if max_index <= 1 << 15:
        packed = (idx_i.to(torch.int64) * 65536 + idx_j.to(torch.int64))[order]
        return packed // 65536, packed % 65536, total
    return idx_i.to(torch.int64)[order], idx_j.to(torch.int64)[order], total


def peak_bin_mask(
    counts: torch.Tensor, bin_idx: torch.Tensor, pair_active: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership of the histogram peak bin ±1, the initial reduced set
    (registration.cc:744-752). Returns (mask over pairs, peak bin)."""
    peak = torch.argmax(counts)
    return (torch.abs(bin_idx - peak) <= 1) & pair_active, peak
