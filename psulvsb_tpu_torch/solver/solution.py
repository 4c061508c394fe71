"""Registration solution.

Equivalent of teaser::RegistrationSolution (registration.h:34-41) with the
PSULVSB `final_inlier_count` field (registration.cc:1528) and the validity
flag (registration.cc:1031-1036, 1531).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RegistrationSolution(NamedTuple):
    """The pose dst = s (R src + t), whether the solve found any inlier
    (`valid`), and `final_inlier_count`: the consensus of the pose returned,
    that is the real correspondences within the solver's threshold 2 nb (1 +
    kept/real) of s (R src + t) (registration.cc:669, :1417-1444), counted
    after the final refinement and any translation rescue, and the host
    best's count itself where neither moved the pose. Here the port departs
    from the reference (registration.cc:1528) and the JAX package, which
    return the host best's count from before the refinement: the port's
    staged solve gives that count as `info["best_count"]`, and a fused plan
    keeps it in its `hs.best_count` buffer."""

    valid: torch.Tensor  # () bool
    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    final_inlier_count: torch.Tensor  # () int64
