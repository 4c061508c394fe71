"""A plain answer to a pair, in any torch dtype on the host: the
least-squares pose over the correspondences that the true pose explains,
and that pose's consensus: a rigid fit (Kabsch) at known scale, a
similarity (Umeyama) for a pair stretched by a test scale, handed out in the
solver's convention s (R p + t). In float64 it is the pose the judge
holds each answer against; computed in bfloat16, the precision below the
solver's float32, it stands in the program's place for the control of
`correct`, and the judge has to refuse it, also with its rotation made
orthonormal again in float32 before it is handed out. Nothing here imports
the program."""

from __future__ import annotations

import numpy as np
import torch


def _svd_dtype(dtype: torch.dtype) -> torch.dtype:
    # torch's SVD takes float32 and float64 only; a lower precision's
    # covariance is widened for the decomposition alone.
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def _nearest_rotation(r: torch.Tensor) -> torch.Tensor:
    u, _, vh = torch.linalg.svd(r)
    fix = torch.diag(torch.tensor([1.0, 1.0, float(torch.sign(torch.det(u @ vh)))],
                                  dtype=r.dtype))
    return u @ fix @ vh


def oracle_answer(pair, threshold: float, dtype: torch.dtype,
                  out_dtype: torch.dtype | None = None, similarity: bool = False) -> dict:
    """The fit in `dtype`; with `out_dtype`, its rotation is made
    orthonormal again in that type and the pose handed out in it. With
    `similarity`, the truth is the pair's sigma (R p + t) and the fit is
    Umeyama's: the rotation as Kabsch's, the scale tr(R^T cov) over the
    source's spread, the translation the fitted offset over the scale."""
    src = torch.as_tensor(np.asarray(pair.src, np.float64)).to(dtype)
    dst = torch.as_tensor(np.asarray(pair.dst, np.float64)).to(dtype)
    rot = torch.as_tensor(np.asarray(pair.rotation, np.float64)).to(dtype)
    trans = torch.as_tensor(np.asarray(pair.translation, np.float64)).to(dtype)
    thr = torch.tensor(threshold, dtype=dtype)

    def inliers(r, t, scale=None):
        moved = r @ src + t[:, None]
        res = torch.sqrt(((dst - (moved if scale is None else scale * moved)) ** 2).sum(0))
        return res <= thr

    mask = inliers(rot, trans, torch.tensor(float(pair.scale), dtype=dtype) if similarity else None)
    s, d = src[:, mask], dst[:, mask]
    mu_s, mu_d = s.mean(1), d.mean(1)
    cov = (d - mu_d[:, None]) @ (s - mu_s[:, None]).T
    r = _nearest_rotation(cov.to(_svd_dtype(dtype))).to(dtype)
    if similarity:
        scale = (r * cov).sum() / ((s - mu_s[:, None]) ** 2).sum()
        t = mu_d / scale - r @ mu_s
    else:
        scale = None
        t = mu_d - r @ mu_s
    count = int(inliers(r, t, scale).sum())
    if out_dtype is not None:
        r, t = _nearest_rotation(r.to(out_dtype)), t.to(out_dtype)
        scale = None if scale is None else scale.to(out_dtype)
    return {"valid": count > 0, "scale": 1.0 if scale is None else float(scale),
            "rotation": r.double().numpy(), "translation": t.double().numpy(), "count": count}
