"""The plain pre-filter, in any torch dtype on the host: PCL-style normals
(the k nearest by brute force, the covariance's smallest eigenvector,
flipped towards the origin; PSULVSB.cc:35-85) and the normal-angle histogram
filter (PSULVSB.cc:87-172): Scott's bin width 3.49 sigma n^(-1/3), at most
`max_bins` bins, bins farther than 2 from the peak give -1, bins taller than
mean + 1 sigma give 1, the rest 0. Nothing here imports the program."""

from __future__ import annotations

import math

import numpy as np
import torch


def _eigh_dtype(dtype: torch.dtype) -> torch.dtype:
    # torch's eigh takes float32 and float64 only; a lower precision's
    # covariance is widened for the decomposition alone.
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def normals(points: torch.Tensor, k: int = 20, block: int = 512) -> torch.Tensor:
    """Unit normals (3, N) of a (3, N) cloud, in its dtype."""
    n = points.shape[1]
    idx = []
    for q0 in range(0, n, block):
        q = points[:, q0:q0 + block]
        d2 = ((q[:, :, None] - points[:, None, :]) ** 2).sum(0)
        idx.append(torch.topk(d2, min(k, n), dim=1, largest=False, sorted=True).indices)
    idx = torch.cat(idx)
    neigh = points[:, idx]  # (3, N, k)
    centered = neigh - neigh.mean(2, keepdim=True)
    cov = torch.einsum("ink,jnk->nij", centered, centered) / idx.shape[1]
    _, vecs = torch.linalg.eigh(cov.to(_eigh_dtype(points.dtype)))
    normal = vecs[:, :, 0].T.to(points.dtype)
    flip = (normal * -points).sum(0) < 0
    normal = torch.where(flip[None, :], -normal, normal)
    return normal / torch.clamp(torch.sqrt((normal * normal).sum(0, keepdim=True)), min=1e-30)


def histogram_filter(src_normals: torch.Tensor, dst_normals: torch.Tensor,
                     max_bins: int = 512) -> torch.Tensor:
    """keep (N,) int64 in {1, 0, -1}."""
    dtype = src_normals.dtype

    def norm(v):
        return torch.sqrt((v * v).sum(0))

    def unit(v):
        return v / torch.clamp(norm(v)[None, :], min=1e-30)

    cos = torch.clamp((unit(src_normals) * unit(dst_normals)).sum(0), -1.0, 1.0)
    angles = torch.arccos(cos) * (180.0 / math.pi)
    valid = torch.isfinite(angles) & (norm(src_normals) > 0) & (norm(dst_normals) > 0)
    a = angles[valid]
    keep = torch.zeros(angles.shape[0], dtype=torch.int64)
    if a.numel() == 0:
        return keep
    cnt = torch.tensor(float(a.numel()), dtype=dtype)
    mean = a.sum() / cnt
    std = torch.sqrt(((a - mean) ** 2).sum() / cnt)
    a_min, a_max = a.min(), a.max()
    width = torch.clamp(3.49 * std / torch.pow(cnt, 1.0 / 3.0), min=1e-6)
    nbins = int(min(max(math.ceil(float((a_max - a_min) / width)), 1), max_bins))
    eff_width = torch.maximum(width, (a_max - a_min) / nbins)
    pos = torch.clamp(torch.floor((angles - a_min) / eff_width), 0, max_bins)
    bin_idx = torch.minimum(torch.nan_to_num(pos, nan=0.0).to(torch.int64),
                            torch.tensor(nbins - 1))
    heights = torch.bincount(bin_idx[valid], minlength=nbins)[:nbins]
    peak = int(torch.argmax(heights))
    hf = heights.to(dtype)
    h_mean = hf.sum() / nbins
    h_thr = h_mean + torch.sqrt(((hf - h_mean) ** 2).sum() / nbins)
    tall = hf > h_thr
    far = (torch.arange(nbins) - peak).abs() > 2
    b = bin_idx.clamp(max=nbins - 1)
    keep = torch.where(valid & far[b], -1, keep)
    keep = torch.where(valid & tall[b], 1, keep)
    return keep


def keep_mask(src: np.ndarray, dst: np.ndarray, dtype: torch.dtype, k: int = 20) -> np.ndarray:
    """The pre-filter's keep mask of a (3, C) correspondence set."""
    s = torch.as_tensor(np.asarray(src, np.float64)).to(dtype)
    d = torch.as_tensor(np.asarray(dst, np.float64)).to(dtype)
    return histogram_filter(normals(s, k), normals(d, k)).numpy()
