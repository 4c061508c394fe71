"""Registration solution.

Equivalent of teaser::RegistrationSolution (registration.h:34-41) with the
PSULVSB `final_inlier_count` field (registration.cc:1528) and the validity
flag (registration.cc:1031-1036, 1531).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RegistrationSolution(NamedTuple):
    valid: torch.Tensor  # () bool
    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    final_inlier_count: torch.Tensor  # () int64
