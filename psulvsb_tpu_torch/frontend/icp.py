"""Point-to-point ICP refinement (port of psulvsb_tpu/frontend/icp.py; the
Open3D registration_icp stage of the reference's FPFH+ICP example): the
nearest neighbour by frontend/knn.py, a weighted Procrustes update, and a
stop on the transform's change. The loop reads its stop flag on the host
once an iteration (the JAX package's while_loop reads it on the device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.core.linalg import weighted_procrustes_srt
from psulvsb_tpu_torch.frontend.knn import knn
from psulvsb_tpu_torch.utils.precision import mm, pin_float32


class ICPResult(NamedTuple):
    rotation: torch.Tensor
    translation: torch.Tensor
    iterations: int
    rmse: torch.Tensor  # inlier RMSE of the transform returned


def icp_point_to_point(
    src,
    dst,
    init_rotation=None,
    init_translation=None,
    max_correspondence_distance: float = 0.1,
    max_iterations: int = 30,
    tolerance: float = 1e-6,
    src_active=None,
    dst_active=None,
    device="cuda",
) -> ICPResult:
    """Refine the alignment of a (3, N) src onto a (3, M) dst. Tensors run
    where `src` lies; numpy input goes to `device`, the card unless the
    caller asks for the CPU."""
    if isinstance(src, torch.Tensor):
        device = src.device
    else:
        from psulvsb_tpu_torch.solver.fused import resolve_device

        device = resolve_device(device)
    pin_float32()

    def on_device(x, dtype=torch.float32):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(device=device, dtype=dtype)

    src = on_device(src)
    dst = on_device(dst)
    dtype = src.dtype
    n = src.shape[1]
    r = torch.eye(3, dtype=dtype, device=device) if init_rotation is None else on_device(init_rotation)
    t = (torch.zeros(3, dtype=dtype, device=device) if init_translation is None
         else on_device(init_translation))
    src_active = (torch.ones(n, dtype=torch.bool, device=device) if src_active is None
                  else on_device(src_active, torch.bool))
    if dst_active is not None:
        dst_active = on_device(dst_active, torch.bool)
    max_d2 = on_device(torch.as_tensor(max_correspondence_distance, dtype=dtype) ** 2)

    def correspond(r, t):
        idx, d2 = knn(mm(r, src) + t[:, None], dst, k=1, point_active=dst_active)
        w = ((d2[:, 0] <= max_d2) & src_active).to(dtype)
        n_in = w.sum()
        # No correspondence within range is a DIVERGED state, not a perfect
        # fit: the RMSE reads inf.
        rmse = torch.where(n_in > 0, torch.sqrt((d2[:, 0] * w).sum() / torch.clamp(n_in, min=1.0)),
                           torch.inf)
        return dst[:, idx[:, 0]], w, n_in, rmse

    it = 0
    while it < max_iterations:
        nn, w, n_in, _ = correspond(r, t)
        r_new, t_new = weighted_procrustes_srt(src, nn, w)
        diverged = n_in == 0
        r_new = torch.where(diverged, r, r_new)
        t_new = torch.where(diverged, t, t_new)
        delta = (r_new - r).abs().max() + (t_new - t).abs().max()
        r, t, it = r_new, t_new, it + 1
        if bool((delta < tolerance) | diverged):
            break
    # The residual of the transform returned (inside the loop it lags one
    # update behind).
    return ICPResult(rotation=r, translation=t, iterations=it, rmse=correspond(r, t)[3])
