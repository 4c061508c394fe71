"""Batched GNC-TLS rotation: the CUDA kernel `csrc/gnc_batch.cu` and its
plain PyTorch version.

`gnc_batch` keeps the signature and layout of the JAX package's front door
(psulvsb_tpu/ops/pallas_gnc.py::gnc_batch): TIMs as (B, 3, N), results as
(rotations (B, 3, 3), inliers (B, N) bool). Around the loop come the
noise-bound floor, the weight >= 0.5 rule and the <= 10-inlier fail-safe
(registration.cc:1676-1691): the kernel applies them itself, so a CUDA call
is two allocations and one launch, with no other device operation.

`use_warm` is a flag on the device: a 0-d bool tensor whose byte the kernel
reads, so a launch captured into a CUDA graph follows the flag's value at
each replay. A Python bool is accepted too and becomes such a tensor
(utils.scalars.device_flag: one cached per device and value).

Which version runs is decided by where the tensors lie: CPU tensors take
`gnc_batch_reference`; CUDA tensors launch the kernel or raise. Each launch
adds one to `KERNEL_LAUNCHES`.

The kernel computes each rotation by shifted power iteration and nothing
else, as the Pallas kernel does. The exact eigenvector that
`SolverParams.gnc_rot_method="eigh"` asks for is not this function's to give:
`solver.basic.rotation_batch`, which owns the choice of the rotation
estimator, calls `gnc_batch_reference` itself for that setting and counts it
there.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p

import torch

from psulvsb_tpu_torch.ops._build import launcher
from psulvsb_tpu_torch.rotation.gnc import floor_noise_sq, gnc_tls_batched, tls_inliers
from psulvsb_tpu_torch.utils.scalars import device_flag

MAX_N = 2048  # the kernel keeps at most 8 columns per thread in registers
KERNEL_LAUNCHES = 0
# gnc_batch_launch: src and its (batch, coordinate) strides, dst and its
# strides, mask and its batch stride, noise bounds and stride, warm rotation
# and strides, the use_warm flag's byte; B, N, max_iterations; gnc_factor,
# cost_threshold; rotations, inliers, stream.
_ARGTYPES = (
    [c_void_p, c_longlong, c_longlong] * 2 + [c_void_p, c_longlong] * 2
    + [c_void_p, c_longlong, c_longlong] + [c_void_p] + [c_int] * 3 + [c_float] * 2
    + [c_void_p] * 3
)

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
    use_warm,  # bool, or a 0-d bool tensor (then no host read)
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
    rot_method: str = "power",
    early_exit: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `gnc_batch` (rotation/gnc.py's loop, by default
    with the power-iteration rotation), with the same front-door rules. With
    `use_warm` a tensor, iteration 0 selects between the warm rotation and
    the solve on the device. `rot_method`, `early_exit`: as
    `rotation.gnc.gnc_tls_batched` takes them."""
    _check_shapes(src_tims_b, active_b)
    nb_sq = floor_noise_sq(noise_bound_b.to(torch.float32))
    rot, w, _, _ = gnc_tls_batched(
        src_tims_b.to(torch.float32), dst_tims_b.to(torch.float32), active_b,
        nb_sq, warm_rotation, use_warm,
        max_iterations, gnc_factor, cost_threshold, rot_method=rot_method,
        early_exit=early_exit,
    )
    return rot, tls_inliers(w, active_b)


def gnc_batch(
    src_tims_b: torch.Tensor,  # (B, 3, N)
    dst_tims_b: torch.Tensor,  # (B, 3, N)
    active_b: torch.Tensor,  # (B, N) bool
    noise_bound_b: torch.Tensor,  # (B,)
    warm_rotation: torch.Tensor,  # (3, 3), shared warm start
    use_warm,  # bool, or a 0-d bool tensor on the device
    max_iterations: int,
    gnc_factor: float,
    cost_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch GNC-TLS front door. Returns (rotations (B, 3, 3), inliers
    (B, N) bool). CPU tensors run `gnc_batch_reference`; CUDA tensors run
    the kernel (no fallback): float32 TIMs and noise bounds, a bool mask,
    each with unit column stride, on one device; anything else raises."""
    global KERNEL_LAUNCHES
    if not src_tims_b.is_cuda:
        return gnc_batch_reference(
            src_tims_b, dst_tims_b, active_b, noise_bound_b, warm_rotation,
            use_warm, max_iterations, gnc_factor, cost_threshold,
        )
    _check_shapes(src_tims_b, active_b)
    b, _, n = src_tims_b.shape
    dev = src_tims_b.device
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("src_tims_b", src_tims_b, f32, (b, 3, n)), ("dst_tims_b", dst_tims_b, f32, (b, 3, n)),
        ("active_b", active_b, torch.bool, (b, n)), ("noise_bound_b", noise_bound_b, f32, (b,)),
        ("warm_rotation", warm_rotation, f32, (3, 3)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    for name, t in (("src_tims_b", src_tims_b), ("dst_tims_b", dst_tims_b), ("active_b", active_b)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit column stride, got strides {t.stride()}")
    flag = device_flag(use_warm, dev)
    rot = torch.empty((b, 3, 3), dtype=f32, device=dev)
    inliers = torch.empty((b, n), dtype=torch.bool, device=dev)
    fn = launcher("gnc_batch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            src_tims_b.data_ptr(), src_tims_b.stride(0), src_tims_b.stride(1),
            dst_tims_b.data_ptr(), dst_tims_b.stride(0), dst_tims_b.stride(1),
            active_b.data_ptr(), active_b.stride(0),
            noise_bound_b.data_ptr(), noise_bound_b.stride(0),
            warm_rotation.data_ptr(), warm_rotation.stride(0), warm_rotation.stride(1),
            flag.data_ptr(), b, n, int(max_iterations), float(gnc_factor),
            float(cost_threshold), rot.data_ptr(), inliers.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gnc_batch kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return rot, inliers
