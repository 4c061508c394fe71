"""Normal-angle histogram correspondence pre-filter (counterpart of
psulvsb_tpu/frontend/histogram_filter.py; histogram_outlier_removal,
PSULVSB.cc:87-172):

1. angle_i = acos(<src_normal_i, dst_normal_i>) in degrees;
2. Scott's-rule bin width 3.49 sigma n^(-1/3) over the angles;
3. bins taller than mean + 1 sigma keep their points (keep_mask = 1);
4. bins farther than 2 from the peak bin discard theirs (keep_mask = -1);
5. everything else stays 0 (dropped, but the self-update may re-admit it).

The reference's bin count depends on the data; as in the JAX package bins are
capped at a static `max_bins` and the dynamic count masks the tail, so the
shapes are fixed and nothing is read on the host. NaN angles (zero normals)
take no part in the statistics and keep 0 (PSULVSB.cc:103-104).
"""

from __future__ import annotations

import math

import torch


def normal_angle_histogram_filter(
    src_normals: torch.Tensor,
    dst_normals: torch.Tensor,
    active: torch.Tensor | None = None,
    max_bins: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (keep_mask (N,) int64 in {1, 0, -1}, angles in degrees (N,))."""
    n = src_normals.shape[1]
    dev, dtype = src_normals.device, src_normals.dtype
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)

    def norm(v):
        return torch.sqrt((v * v).sum(0))

    def unit(v):
        return v / torch.clamp(norm(v)[None, :], min=1e-30)

    cos = torch.clamp((unit(src_normals) * unit(dst_normals)).sum(0), -1.0, 1.0)
    angles = torch.arccos(cos) * (180.0 / math.pi)
    valid = active & torch.isfinite(angles) & (norm(src_normals) > 0) & (norm(dst_normals) > 0)

    zero = torch.zeros((), dtype=dtype, device=dev)
    cnt = torch.clamp(valid.to(dtype).sum(), min=1.0)
    mean = torch.where(valid, angles, zero).sum() / cnt
    std = torch.sqrt(torch.where(valid, (angles - mean) ** 2, zero).sum() / cnt)

    a_min = torch.where(valid, angles, torch.inf).min()
    a_max = torch.where(valid, angles, -torch.inf).max()
    width = torch.clamp(3.49 * std / torch.pow(cnt, 1.0 / 3.0), min=1e-6)
    nbins = torch.clamp(torch.ceil((a_max - a_min) / width), min=1.0)
    # Clip in float before the integer cast (no valid angle gives inf - -inf).
    nbins_i = torch.clamp(torch.nan_to_num(nbins, nan=1.0), max=float(max_bins)).to(torch.int64)
    # If the dynamic bin count saturates max_bins, widen bins to span.
    eff_width = torch.maximum(width, (a_max - a_min) / nbins_i.to(dtype))

    pos = torch.floor((angles - a_min) / eff_width)
    pos = torch.clamp(torch.nan_to_num(pos, nan=0.0), 0.0, float(max_bins)).to(torch.int64)
    bin_idx = torch.minimum(pos, nbins_i - 1)
    bin_idx = torch.where(valid, bin_idx, max_bins - 1)  # park invalids in the tail

    heights = torch.zeros(max_bins, dtype=torch.int64, device=dev)
    heights.index_add_(0, bin_idx, valid.to(torch.int64))
    bins = torch.arange(max_bins, device=dev)
    bin_live = bins < nbins_i
    peak = torch.argmax(torch.where(bin_live, heights, -1))

    hf = heights.to(dtype)
    live_n = torch.clamp(nbins_i.to(dtype), min=1.0)
    h_mean = torch.where(bin_live, hf, zero).sum() / live_n
    h_var = torch.where(bin_live, (hf - h_mean) ** 2, zero).sum() / live_n
    h_thr = h_mean + torch.sqrt(h_var)  # stdDevMultiplier = 1 (PSULVSB.cc:128)

    tall_bin = hf > h_thr
    far_bin = torch.abs(bins - peak) > 2

    keep = torch.zeros(n, dtype=torch.int64, device=dev)
    # Order matters in the reference (PSULVSB.cc:156-168): far from the peak
    # marks -1 first, tall bins then overwrite with 1 (a bin can be both).
    keep = torch.where(valid & far_bin[bin_idx], -1, keep)
    keep = torch.where(valid & tall_bin[bin_idx], 1, keep)
    keep = torch.where(~active, -1, keep)
    return keep, angles
