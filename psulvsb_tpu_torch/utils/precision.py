"""Float32 pin for the registration compute path.

The registration math compares residuals against noise bounds of 1e-2..5e-2
on unit-scale coordinates, where reduced-precision matmul passes flip inlier
tests. On an NVIDIA card a float32 product may run in TF32 (about three
decimal digits) when PyTorch's TF32 switches are on; `pin_float32` turns
them off so every product on the path is full float32. The solver's entry
points call it; `mm` is the one matmul the port's modules use.
"""

from __future__ import annotations

import torch


def pin_float32() -> None:
    """Disable TF32 for matmuls and cuDNN and request "highest" float32
    matmul precision (process-wide PyTorch settings)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product (batched over leading dims) in full float32."""
    return torch.matmul(a, b)
