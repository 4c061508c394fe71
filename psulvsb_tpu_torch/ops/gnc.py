"""Batched GNC-TLS rotation: the CUDA kernel `csrc/gnc_batch.cu` and its
plain PyTorch version.

`gnc_batch` keeps the signature and layout of the JAX package's front door
(psulvsb_tpu/ops/pallas_gnc.py::gnc_batch): TIMs as (B, 3, N), results as
(rotations (B, 3, 3), inliers (B, N) bool). Around the loop it applies the
noise-bound floor, the weight >= 0.5 rule and the <= 10-inlier fail-safe
(registration.cc:1676-1691).

Which version runs is decided by where the tensors lie: CPU tensors take
`gnc_batch_reference`; CUDA tensors launch the kernel or raise. Each launch
adds one to `KERNEL_LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from psulvsb_tpu_torch.ops._build import load_library
from psulvsb_tpu_torch.rotation.gnc import floor_noise_sq, gnc_tls_batched, tls_inliers

MAX_N = 2048  # the kernel keeps at most 8 columns per thread in registers
KERNEL_LAUNCHES = 0


def _check_shapes(src_tims_b: torch.Tensor, active_b: torch.Tensor) -> None:
    if src_tims_b.dim() != 3 or src_tims_b.shape[1] != 3:
        raise ValueError(f"TIMs must be (B, 3, N), got {tuple(src_tims_b.shape)}")
    b, _, n = src_tims_b.shape
    if b == 0 or n == 0:
        raise ValueError(f"gnc_batch needs B >= 1 and N >= 1, got B={b}, N={n}")
    if n > MAX_N:
        raise ValueError(f"gnc_batch serves N <= {MAX_N} TIMs, got N={n}")
    if tuple(active_b.shape) != (b, n):
        raise ValueError(f"active mask must be ({b}, {n}), got {tuple(active_b.shape)}")


def gnc_batch_reference(
    src_tims_b: torch.Tensor,  # (B, 3, N)
    dst_tims_b: torch.Tensor,  # (B, 3, N)
    active_b: torch.Tensor,  # (B, N) bool
    noise_bound_b: torch.Tensor,  # (B,)
    warm_rotation: torch.Tensor,  # (3, 3), shared warm start
    use_warm,  # bool
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `gnc_batch` (rotation/gnc.py's loop with the
    power-iteration rotation), with the same front-door rules."""
    _check_shapes(src_tims_b, active_b)
    nb_sq = floor_noise_sq(noise_bound_b.to(torch.float32))
    rot, w, _, _ = gnc_tls_batched(
        src_tims_b.to(torch.float32), dst_tims_b.to(torch.float32), active_b,
        nb_sq, warm_rotation, bool(use_warm),
        max_iterations, gnc_factor, cost_threshold, rot_method="power",
    )
    return rot, tls_inliers(w, active_b)


def _launch_kernel(
    src: torch.Tensor,
    dst: torch.Tensor,
    act_f: torch.Tensor,
    nb_sq: torch.Tensor,
    warm9: torch.Tensor,
    use_warm: bool,
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/gnc_batch.cu on the current stream. All inputs are
    contiguous float32 CUDA tensors on one device. Returns (rot (B, 3, 3),
    weights (B, N))."""
    global KERNEL_LAUNCHES
    lib = load_library("gnc_batch")
    fn = lib.gnc_batch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p
    ] * 3
    b, _, n = src.shape
    rot = torch.empty((b, 3, 3), dtype=torch.float32, device=src.device)
    w = torch.empty((b, n), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(
            src.data_ptr(), dst.data_ptr(), act_f.data_ptr(), nb_sq.data_ptr(),
            warm9.data_ptr(), int(use_warm), b, n, max_iterations,
            gnc_factor, cost_threshold, rot.data_ptr(), w.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gnc_batch kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return rot, w


def gnc_batch(
    src_tims_b: torch.Tensor,  # (B, 3, N)
    dst_tims_b: torch.Tensor,  # (B, 3, N)
    active_b: torch.Tensor,  # (B, N) bool
    noise_bound_b: torch.Tensor,  # (B,)
    warm_rotation: torch.Tensor,  # (3, 3), shared warm start
    use_warm,  # bool
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch GNC-TLS front door. Returns (rotations (B, 3, 3), inliers
    (B, N) bool). CPU tensors run `gnc_batch_reference`; CUDA tensors run
    the kernel (no fallback)."""
    if not src_tims_b.is_cuda:
        return gnc_batch_reference(
            src_tims_b, dst_tims_b, active_b, noise_bound_b, warm_rotation,
            use_warm, max_iterations, gnc_factor, cost_threshold,
        )
    _check_shapes(src_tims_b, active_b)
    dev = src_tims_b.device
    for name, t in (
        ("dst_tims_b", dst_tims_b), ("active_b", active_b),
        ("noise_bound_b", noise_bound_b), ("warm_rotation", warm_rotation),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if tuple(dst_tims_b.shape) != tuple(src_tims_b.shape):
        raise ValueError("src_tims_b and dst_tims_b must have the same shape")
    f32 = torch.float32
    nb_sq = floor_noise_sq(noise_bound_b.to(f32)).contiguous()
    rot, w = _launch_kernel(
        src_tims_b.to(f32).contiguous(),
        dst_tims_b.to(f32).contiguous(),
        active_b.to(f32).contiguous(),
        nb_sq,
        warm_rotation.to(f32).reshape(9).contiguous(),
        bool(use_warm),
        int(max_iterations), float(gnc_factor), float(cost_threshold),
    )
    return rot, tls_inliers(w, active_b)
